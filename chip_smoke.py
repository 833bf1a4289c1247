#!/usr/bin/env python3
"""Drive the PyTorch port (vita_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build the hand-written CUDA kernels from vita_tpu_torch/csrc with nvcc
     (sm_90a, one nvcc per source, all at once) into build/kernels/;
  2. hold every kernel against its plain PyTorch version at the main
     paths' shapes in bf16 and at a small shape in fp32, and time both with
     CUDA events (median of 25 runs after warm-up), beside the least time
     the card could take (bound) and, where one PyTorch call computes the
     same function, that call's time: B1 (with its lse; also at the 9216
     training bucket with 5735 real tokens, over the Generator's 12288-row
     prefill with 8500 keys, one decode row over those keys, and at
     Whale's flash shape, a 120 s clip of 2999 x 2999 keys, 16 heads of
     65, non-causal, zero-padded to the kernel's 128, with the bound of
     the useful and of the padded work; and the tiny Whale's d 9), B2-B4,
     the grouped matmuls B5a/B5b (B5a also as dx at a 9216-token step's R,
     and on rows that are no TMA tensor; B5b as dx at a 1024-token step's
     R), bf16 B3/B4 on tensor cores (T 1, 3; T 4, 8, 16 and a plan with
     padding rows, which must give zeros; run twice for equal bits; its
     resources are printed, and two planted faults, built from
     csrc/expert_ffn_bf16.cu under build/faults/, must fail its
     tolerance), the quantized expert FFNs B6/B7 and B8a/B8b (bf16 B6,
     B7, B8a and B8b, on tensor cores, are run twice for equal bits, B6
     and B7 at T 3 over the pairs sorted by expert, B8a also on a plan
     with padding rows, which must give zeros; the kernel's resources are
     printed, two planted faults built from csrc/expert_ffn_q.cu under
     build/faults/ must fail B6's, B7's and B8a's tolerance, and two of
     B8b's own must fail its), B9 over int8 pages
     (bf16 B2 and B9 are run twice for equal bits, the split kernel's
     resources are printed, and two planted faults of the split, built
     from csrc/paged_attn.cu under build/faults/, must fail their
     tolerance),
     and the training backward: B10/B11 at a causal 4096-token sequence
     and at the 9216 training bucket, and B12 at a 9216-token step's R
     (tile 512); each bf16 B1, B5a, B5b, B10, B11 and B12 kernel is run
     twice for equal bits, and the resources (registers, spills, shared
     memory, blocks per SM) of the tensor-core kernels B1, B10/B11 and
     B5a/B5b/B12 are printed;
  3. serve the full-width VITA-8x7B slice (Mixtral cut to 4 of 32 layers,
     InternViT-300M at 448px, Whale 24x1024; random weights from a seed)
     through Engine, four times on the same weights: bf16 experts (one
     text request alone, then one image+audio request with three text
     requests); int4 experts with int8 KV pages on 8 slots (alone, then
     image+audio with seven text requests); int8 experts with int8 KV
     pages (alone, then a wave of four); bf16 experts with gmm prefill
     (as the first). Launch counts are zeroed before each run and read
     after it; every kernel of a run's path must have launched in it;
  4. the same slice through Generator (max_len 12288, gmm prefill, gather
     decode): an image+audio request (bucket 512, B5b) and a text request
     of about 8500 tokens (bucket 12288, T*k 24576, B5a), each first token
     held against the cacheless dense forward; then the CLI in process
     (python -m vita_tpu_torch.cli --model tiny-random --prefill-moe-mode
     gmm);
  5. the same Engine on the card and on the CPU, narrow fp32 config, same
     weights and prompts: float experts with dense and with gmm prefill,
     then int4 experts with int8 KV pages: greedy streams must be
     identical (for the quantized run, a request may split only at a step
     where the CPU's own top two logits were the two tokens, within
     NEAR_TIE below);
  6. train the full-width slice with the LLM cut to 2 of 32 layers
     (stage 2, gmm MoE, flash attention, per-layer remat, bf16) through
     Trainer for one step per sample: two text samples past 4096 tokens
     (bucket 9216: B5a), shorter ones (B5b) and an image+audio sample;
     B1, B5a, B5b, B10, B11 and B12 must launch, the losses be finite,
     the trainable components change and the frozen towers not;
  7. the train CLI in process (python -m vita_tpu_torch.train.cli --model
     tiny-random --moe-mode gmm), then three train steps of the narrow
     fp32 config (gmm, flash) on the card and on the CPU: losses and the
     first step's gradients must agree (GRAD_TOL, LOSS_RTOL below), up to
     the first step where the CPU's router had a near tie;
  8. export the full-width slice with the LLM cut to 2 of 32 layers (bf16,
     about 4.0e9 parameters, 16 GB of float32 safetensors) with
     export_hf_vita_checkpoint under build/smoke_ckpt/, load it onto the
     card with load_vita_checkpoint (every leaf bitwise equal), and serve
     a text request, then an image+audio request with two text requests,
     from the loaded weights and from the in-memory ones under the loaded
     config (gmm prefill; bf16 experts, then int8 experts with int8 KV
     pages): identical greedy streams, and B5b with B2, B3 and B4 (bf16)
     or B9, B6 and B8a (int8) must launch;
  9. multi-turn and duplex serving on phase 3's weights (run right after
     phase 4's Generator, before the weights are freed and the CLI runs),
     launch counts zeroed before it and read after: (a) a three-turn
     session (text; image+audio extending it; another image in the same
     span, whose digest stops the reuse before it) through an Engine with
     bf16 experts, then one with int8 experts and int8 KV pages, each turn
     alone and then a wave of four other sessions: the reused offset
     (256, a whole 256-row chunk of prompt rows) and reused_prefix_rows
     are printed and checked, and B1 must launch with q_offset = the
     offset and none lower; the bf16 streams must equal a cold Engine's on
     the same prompts up to a step where the cold run's top two logits lie
     within NEAR_TIE; the int8 reuse Engine is held on the card against
     the CPU at phase 5's narrow fp32 configuration (the dequantized
     prefix is lossy by design); (b) the port's ServingApp on 127.0.0.1
     (ephemeral port) over the bf16 Engine: two /v1/generate turns of one
     session_id, then a streamed /v1/chat/completions, and /stats must
     show reused rows; (c) DuplexWebApp with two Engines over the weights
     (gmm prefill), streaming Whale encode at 24 x 1024, fed
     duplex_demo.synth_session through feed_pcm/drain_audio without
     real-time sleeps and with a decode mapping every id to a letter:
     exactly 2 utterances (the noise rejected by the VAD), an interrupt
     with a role swap, the interrupted request cancelled and both pools
     full after the drain, and each utterance's streamed features held to
     whale.forward under the matching chunk mask (STREAM_ATOL,
     STREAM_COS); speech end -> first text and interrupt -> role swap are
     printed as readings. B1, B2, B3, B4, B9, B6 and B8a must launch;
 10. the rest of the model registry on phase 3's weights (run right after
     phase 9), launch counts zeroed before it and read after: (a) Whale
     (24 x 1024, bf16) on clips of 4, 30 and 120 s with attn_backend
     'flash' and 'xla': features held to each other (STREAM_ATOL,
     STREAM_COS), each forward's time printed, and 24 B1 launches at
     d 65 per flash forward; (b) three Engines (gmm prefill, bf16
     experts) with SigLIP-so400m-patch14-384 + mlp2x_gelu, CLIP
     ViT-L/14-336 + ldp and EVA02-L/14-336 + spp_v1 with Whale flash,
     towers and projectors drawn from the seed: an image+audio request
     with two text requests, each first token held against the
     cacheless forward, B1, B2, B3, B4 and B5b launched (and B1 at d 65
     with Whale flash); (c) the Engine on the card and on the CPU at
     phase 5's narrow fp32 configuration with clip + ldp, siglip +
     mlp3x_gelu and eva + spp_v1 with Whale flash: identical streams.

Prints the card's name and power limit first, a JSON line of per-kernel
results (launches summed over phases 3-10) before the last, and as the last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_TIMED = 25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, n: int = N_TIMED, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``n`` runs after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# H100 SXM: dense bf16 tensor-core rate and HBM3 rate (NVIDIA's data sheet);
# every timed case of phase 2 is bf16
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops > t_mem else "bytes"


def library_ms(name, make):
    """CUDA-event ms of the one PyTorch call ``make()`` returns, or None
    (with the reason printed) where that call does not run here. Timed as a
    yardstick only: the port never calls it."""
    try:
        fn = make()
        fn()
    except Exception as e:  # a private or backend-specific call may be missing
        print(f"  {name}: library call unavailable ({type(e).__name__}: {e})", flush=True)
        return None
    return cuda_ms(fn)


def attn_pairs(sq, kv_len, q_off, causal) -> int:
    """(q row, key) pairs that attention computes for these masks."""
    r = np.arange(sq)
    return int(sum(np.clip(np.minimum(kl, qo + r + 1) if causal else np.full(sq, kl), 0, None)
                   .sum() for kl, qo in zip(kv_len, q_off)))


def compare(name, got, want, atol, rtol):
    """Max abs error of got vs want; raises past atol + rtol * |want| (atol
    a number, or a tensor that broadcasts against want)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        lim = f"atol {atol}" if isinstance(atol, float) else "the element's atol"
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past {lim} + rtol {rtol}; "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def flash_fwd_tols(sq, kv_len, q_off, dev, causal=True):
    """bf16 B1's tolerances, (atol, rtol) for o [B, Sq, Hq, D] and for
    lse: o's atol 2e-3 on rows that see 1024 keys or more, else 2e-2; lse
    (float32, about log of the keys) 1e-3. On a row of n >= 1024 keys with
    N(0, 1) scores a bf16 rounding step of one p moves o by at most 2^-8
    |v| p / l, under 5e-4, while o itself is about sqrt(e / n), near 0.02:
    2e-2 would let a kernel that drops a tile of 128 keys pass (it moves o
    by about 3e-3, lse by about 0.02). Rows of few keys keep 2e-2, where
    one rounding step of p can move an o that cancels near zero by a few
    1e-3."""
    import torch

    r = torch.arange(sq, device=dev)
    seen = torch.stack([torch.clamp(torch.minimum(torch.tensor(kl, device=dev), qo + r + 1)
                                    if causal else torch.full_like(r, kl), min=0)
                        for kl, qo in zip(kv_len, q_off)])  # keys each row sees
    atol_o = torch.where(seen >= 1024, 2e-3, 2e-2)[:, :, None, None]
    return (atol_o, 2e-2), (1e-3, 0.0)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def _flash_case(rng, b, sq, skv, hq, hkv, kv_len, q_off, dtype, dev, d=128, causal=True,
                scale=128 ** -0.5):
    import torch

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)

    q, k, v = t(b, sq, hq, d), t(b, skv, hkv, d), t(b, skv, hkv, d)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q_off = torch.tensor(q_off, dtype=torch.int32, device=dev)
    return (q, k, v, kv_len, q_off, causal, scale)


def _tables_and_q(rng, lengths, hq, n_pool, page, max_pages, dtype, dev):
    """(q, tables, lengths): distinct random pages per slot, unused table
    entries the out-of-range sentinel."""
    import torch

    b = len(lengths)
    q = torch.from_numpy(rng.standard_normal((b, hq, 128), np.float32)).to(dev, dtype)
    tables = np.full((b, max_pages), n_pool, np.int32)
    perm = rng.permutation(n_pool)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-n // page)
        tables[i, :k] = perm[used:used + k]
        used += k
    return (q, torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _paged_case(rng, lengths, hq, hkv, n_layers, n_pool, page, max_pages, dtype, dev):
    import torch

    pool_shape = (n_layers, hkv, n_pool, page, 128)
    kp = torch.from_numpy(rng.standard_normal(pool_shape, np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal(pool_shape, np.float32)).to(dev, dtype)
    q, tables, lengths = _tables_and_q(rng, lengths, hq, n_pool, page, max_pages, dtype, dev)
    return (q, kp, vp, tables, lengths, n_layers - 1, 128 ** -0.5)


def _paged_q_case(rng, lengths, hq, hkv, n_layers, n_pool, page, max_pages, dtype, dev):
    """_paged_case over int8 pages with float32 row scales."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    shape, sshape = (n_layers, hkv, n_pool, page, 128), (n_layers, hkv, n_pool, 1, page)
    kp, vp = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=dev)
              for _ in range(2))
    ks, vs = (torch.rand(sshape, generator=gen, device=dev) * 0.02 for _ in range(2))
    q, tables, lengths = _tables_and_q(rng, lengths, hq, n_pool, page, max_pages, dtype, dev)
    return (q, kp, vp, tables, lengths, n_layers - 1, 128 ** -0.5, ks, vs)


# Planted faults, each a build of one source with a macro of its header:
# key: (source, macro, {value: what it breaks}, C functions its wrapper calls)
FAULTS = {
    "paged": ("paged_attn.cu", "VITA_PAGED_FAULT",
              {1: "the last split's partial skipped", 2: "each split's last 16 rows dropped"},
              ("vita_paged_attn", "vita_paged_attn_q")),
    "expert": ("expert_ffn_bf16.cu", "VITA_EXPERT_FAULT",
               {1: "gate/up's last k-step of 16 rows dropped",
                2: "the last F split's partial of down skipped"},
               ("vita_expert_ffn_bf16", "vita_expert_ffn_bf16_splits")),
    "expert_q": ("expert_ffn_q.cu", "VITA_EXPERT_Q_FAULT",
                 {1: "gate/up's last k-step of 16 (packed) rows dropped",
                  2: "the last F split's partial of down skipped"},
                 ("vita_expert_ffn_q", "vita_expert_ffn_q_splits")),
}


@functools.lru_cache(maxsize=None)
def _fault_libs():
    """Each source of FAULTS built alone with each of its planted faults
    under build/faults/, all at once: {key: [(what, library)]}."""
    import ctypes

    from vita_tpu_torch import kernels

    root = kernels.BUILD_DIR.parent / "faults"
    root.mkdir(parents=True, exist_ok=True)
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, f"-D{macro}={v}", "-shared",
                       "-o", str(root / f"{key}{v}.so"), str(kernels.CSRC / src)]
                      for key, (src, macro, faults, _) in FAULTS.items() for v in faults])
    out = {}
    for key, (_, _, faults, names) in FAULTS.items():
        out[key] = []
        for v, what in faults.items():
            lib = ctypes.CDLL(str(root / f"{key}{v}.so"))
            for name in names:
                getattr(lib, name).argtypes = kernels._SIGNATURES[name]
                getattr(lib, name).restype = ctypes.c_int
            out[key].append((what, lib))
    return out


def _faults(key, run):
    """check()'s faults: ``run`` (a wrapper call) through each build of
    _fault_libs()[key] in place of the kernel library."""
    from vita_tpu_torch import kernels

    def with_lib(lib):
        saved, kernels._lib = kernels._lib, lib
        try:
            return run()
        finally:
            kernels._lib = saved

    return [(what, lambda lib=lib: with_lib(lib)) for what, lib in _fault_libs()[key]]


def _expert_weights(rng, rows, d, f, dtype, dev):
    import torch

    def t(shape, scale):
        w = torch.empty(shape, dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        return w.normal_(generator=gen).mul_(scale)

    return (t((rows, d, f), d ** -0.5), t((rows, d, f), d ** -0.5),
            t((rows, f, d), f ** -0.5))


def _q4_faults(x, act, m, qp):
    """Two wrong int4 kernels for B8b's check to catch, each run as the real
    kernel on weights altered so that it computes what the fault would: the
    last k-step of 16 packed rows of gate/up dropped (32 rows of D: r and
    r + D/2), and the low and high nibble outputs of the first down tile of
    128 packed columns swapped."""
    from vita_tpu_torch.ops import moe_decode as md

    def run(**changed):
        return md.masked_expert_ffn_q_cuda(x, act, m, {**qp, **changed}, 4)

    def drop_last_k_step():
        wg, wu = qp["w_gate"].clone(), qp["w_up"].clone()
        wg[:, -16:] = 0
        wu[:, -16:] = 0
        return run(w_gate=wg, w_up=wu)

    def swap_nibbles():
        wd = qp["w_down"].clone()
        b = wd[..., :128].clone()
        wd[..., :128] = ((b & 0xF) << 4) | ((b >> 4) & 0xF)
        return run(w_down=wd)

    return [("gate/up's last k-step of 16 packed rows dropped", drop_last_k_step),
            ("down's nibble outputs swapped in its first column tile", swap_nibbles)]


def _routing(rng, t, k, n_experts, layer, dtype, dev):
    import torch

    idx = np.stack([rng.choice(n_experts, k, replace=False) for _ in range(t)])
    w = rng.random((t, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return (torch.from_numpy(w).to(dev),
            torch.from_numpy((idx + layer * n_experts).astype(np.int32)).to(dev))


def _sorted_pairs(x, idx):
    """x's rows and the expert ids [T * k, 1] of the (token, k) pairs sorted
    by expert, as _sorted_pair_gather hands them to the gather kernel."""
    import torch

    order = torch.argsort(idx.reshape(-1), stable=True)
    return x.repeat_interleave(idx.shape[1], dim=0)[order], idx.reshape(-1)[order][:, None]


def _gmm_case(rng, t, d, f, e, dtype, dev, down):
    """x in the sorted layout of T tokens routed top-2 over e experts (the
    shapes moe_ffn_gmm gives gmm), its gids and tile_m, and the gate-shaped
    [e, d, f] or (``down``) down-shaped [e, f, d] weight."""
    import torch

    from vita_tpu_torch.ops import moe_gmm as mg

    _, idx = _routing(rng, t, 2, e, 0, dtype, dev)
    tile_m = mg.SMALL_TILE_M if 2 * t <= mg.SMALL_R_MAX else mg.TILE_M
    dest, _, _, gids, r = mg.sorted_layout(idx, e, tile_m)
    k_dim, n_dim = (f, d) if down else (d, f)
    x = torch.zeros(r, k_dim, dtype=dtype, device=dev)
    x[dest.long()] = torch.from_numpy(
        rng.standard_normal((2 * t, k_dim), np.float32)).to(dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    w = torch.empty(e, k_dim, n_dim, dtype=dtype, device=dev).normal_(generator=gen)
    return x, w.mul_(k_dim ** -0.5), gids, tile_m


def kernel_phase(card: str):
    """Every kernel against its plain version; returns per-kernel rows for
    the result line (times at the serving path's main shape)."""
    import torch

    from vita_tpu_torch.ops import flash_attention as fa
    from vita_tpu_torch.ops import moe_decode as md
    from vita_tpu_torch.ops import moe_gmm as mg
    from vita_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: (2e-2, 2e-2), f32: (1e-4, 1e-4)}
    # quantized experts round h to bf16 on both sides: float32 sums in
    # another order can move an h value across a bf16 rounding boundary,
    # which moves an output by up to 2^-8 |h| |w|; a kernel that left the
    # rounding out would be off by a few 1e-3 on hundreds of elements
    tol_q = {bf16: (2e-2, 2e-2), f32: (5e-4, 5e-4)}
    rows = {}

    def check(kernel, case, run_kernel, run_plain, dtype, timed, tols=tol, work=None,
              library=None, out_tols=None, faults=()):
        """Kernel against plain (each output of a tuple, at tols[dtype], or
        ``out_tols``: (text, one (atol, rtol) per output)); each of
        ``faults`` (text, run) runs a deliberately wrong kernel whose output
        must fail that tolerance. A
        timed case also gives the row of the result line: times, the bound
        of ``work`` (flops, bytes) and the ``library`` call's time (None:
        there is none)."""
        want = run_plain()
        got = run_kernel()
        torch.cuda.synchronize()
        tol_text, per_out = out_tols or (str(tols[dtype]), None)

        def outputs(got):  # (got, want, atol, rtol) per output
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            return [(g, w, *(per_out[i] if per_out else tols[dtype]))
                    for i, (g, w) in enumerate(pairs)]

        err = max(compare(f"{kernel} {case}", *o) for o in outputs(got))
        del got
        line = f"  {kernel:20s} {case:44s} max_abs_err {err:.3e} (tol {tol_text})"
        for what, run_fault in faults:
            readings, caught = [], False
            for g, w, atol, rtol in outputs(run_fault()):
                e = (g.float() - w.float()).abs()
                past = int((~(e <= atol + rtol * w.float().abs())).sum())  # NaN is past
                readings.append(f"max abs err {float(e.max()):.3e}, {past} elements past")
                caught |= past > 0
            if not caught:
                raise AssertionError(f"{kernel} {case}: the tolerance passes a kernel with {what}")
            line += f"\n  {'':20s} planted fault, {what}: {'; '.join(readings)}"
        del want
        if timed:
            ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
            lib_ms = library_ms(kernel, library) if library is not None else None
            bound_ms, bound_by = bound(*work)
            line += (f"  kernel {ms:.4f} ms ({work[0] / ms / 1e9:.1f} TFLOP/s)  "
                     f"plain {plain_ms:.4f} ms  library "
                     f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
                     f"{bound_ms:.4f} ms ({bound_by}: {work[0]:.4g} FLOP, {work[1]:.4g} B)"
                     f"  [{card}]")
            if kernel not in rows:
                rows[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=lib_ms)
        print(line, flush=True)

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # B1: prefill chunk 256 over bucket 512 (both chunks), 384 as one chunk;
    # then the long paths: the training bucket of 9216 with 5735 real
    # tokens, the Generator's 12288-row prefill over 8500 keys and its
    # decode row over them. At those lengths the plain version runs one GQA
    # group at a time (its float32 scores would not fit otherwise). Then
    # Whale's flash path, head dim hd + 1 (the key-bias column; the
    # kernel's 128 zero-padded; scale 1/sqrt(hd)): a 120 s clip (T' 2999,
    # 16 heads of 64, non-causal) in bf16 and the tiny Whale's 8 in fp32. bf16
    # must give equal bits twice, is held at flash_fwd_tols, and the kernel
    # with the last 128 keys of each batch row dropped (kv_len - 128) must
    # fail them.
    for case, sq, skv, kv_len, q_off, dt, timed, d, causal, heads in (
        ("bf16 chunk 256/512, offset 256", 256, 512, [512], [256], bf16, True, 128, True, None),
        ("bf16 chunk 256/512, offset 0", 256, 512, [256], [0], bf16, False, 128, True, None),
        ("bf16 whole bucket 384", 384, 384, [384], [0], bf16, False, 128, True, None),
        ("bf16 train bucket 9216, kv_len 5735", 9216, 9216, [5735], [0], bf16, True, 128, True,
         None),
        ("bf16 prefill 12288 over kv_len 8500", 12288, 12288, [8500], [0], bf16, True, 128, True,
         None),
        ("bf16 decode row over kv_len 8500", 1, 12288, [8500], [8499], bf16, True, 128, True,
         None),
        ("fp32 B=2 ragged, kv_len pad, q_offset", 100, 150, [150, 77], [50, 0], f32, False, 128,
         True, None),
        ("bf16 Whale flash 2999 x 2999, d 65", 2999, 2999, [2999], [0], bf16, True, 65, False,
         (16, 16)),
        ("fp32 tiny Whale B=2, kv_len pad, d 9", 100, 100, [100, 61], [0, 0], f32, False, 9,
         False, (4, 4)),
    ):
        b = len(kv_len)
        hq, hkv = heads or ((32, 8) if dt == bf16 else (4, 2))
        args = _flash_case(rng, b, sq, skv, hq, hkv, kv_len, q_off, dt, dev, d, causal,
                           (d - 1 if d < fa.KERNEL_D else d) ** -0.5)
        q, k, v = args[:3]

        def work_at(width):
            """(FLOP, bytes) at head dim ``width``: the q rows that see a key
            and the key rows some row sees, read once; o and lse written."""
            row = q.shape[2] * width * q.element_size()
            seen = [np.clip(np.minimum(kl, qo + np.arange(sq) + 1) if causal
                            else np.full(sq, kl), 0, skv) for kl, qo in zip(kv_len, q_off)]
            return (4 * attn_pairs(sq, kv_len, q_off, causal) * width * hq,
                    sum(int((n > 0).sum()) * row + 2 * int(n.max()) * row // (hq // hkv)
                        for n in seen) + b * sq * row + 4 * b * hq * sq)

        work = work_at(d)
        plain = _by_group(fa.flash_fwd_plain, (2, 1)) if sq > 4096 else fa.flash_fwd_plain
        bf = dt == bf16
        check("flash_fwd", case, lambda a=args: fa.flash_fwd_cuda(*a),
              lambda a=args, f=plain: f(*a), dt, timed, work=work,
              library=lambda a=args: _sdpa_fwd(*a),
              out_tols=("o 2e-3/2e-2 by keys seen + rtol 2e-2, lse 1e-3",
                        flash_fwd_tols(sq, kv_len, q_off, dev, causal)) if bf else None,
              faults=[("the last 128 keys dropped",
                       lambda a=args: fa.flash_fwd_cuda(*a[:3], a[3] - 128, *a[4:]))] if bf else ())
        if dt == bf16 and not _same_bits(fa.flash_fwd_cuda(*args), fa.flash_fwd_cuda(*args)):
            raise AssertionError(f"flash_fwd {case}: two launches differ")
        if d < fa.KERNEL_D and timed:
            padded = work_at(fa.KERNEL_D)
            p_ms, p_by = bound(*padded)
            print(f"  {'':20s} bound of the padded work the kernel does (d {fa.KERNEL_D}): "
                  f"{p_ms:.4f} ms ({p_by}: {padded[0]:.4g} FLOP, {padded[1]:.4g} B)  [{card}]",
                  flush=True)
        del q, k, v, args
        torch.cuda.empty_cache()
    for name, r in fa.flash_fwd_info().items():
        print(f"  {name} bf16 wgmma kernel: {r['registers']} registers, {r['spill_bytes']} "
              f"spilled bytes a thread, {r['smem_bytes']} B shared a block, {r['blocks_per_sm']} "
              f"blocks per SM  [{card}]", flush=True)

    # B2: decode over the serving pool (4 layers, 128 pages of 64). The
    # timed case must catch two planted faults of the split (FAULTS)
    # and, as every bf16 case of B2 and B9, give equal bits twice.
    for case, lengths, dt, timed in (
        ("bf16 B=4 ragged, one inactive", [1000, 37, 0, 2048], bf16, True),
        ("bf16 B=1", [300], bf16, False),
        ("fp32 B=3 page 16", [5, 0, 70], f32, False),
    ):
        if dt == bf16:
            args = _paged_case(rng, lengths, 32, 8, 4, 128, 64, 32, dt, dev)
        else:
            args = _paged_case(rng, lengths, 4, 2, 2, 16, 16, 6, dt, dev)
        n = sum(lengths)
        hq = args[0].shape[1]
        hkv = args[1].shape[1]
        work = (4 * n * hq * 128, (2 * n * hkv * 128 + 2 * len(lengths) * hq * 128)
                * args[0].element_size())  # the used k/v rows, q, o
        check("paged_attention", case, lambda a=args: pa.paged_attention_cuda(*a),
              lambda a=args: pa.paged_attention_plain(*a), dt, timed, work=work,
              faults=_faults("paged", lambda a=args: pa.paged_attention_cuda(*a)) if timed
              else ())
        if dt == bf16 and not _same_bits(pa.paged_attention_cuda(*args),
                                         pa.paged_attention_cuda(*args)):
            raise AssertionError(f"paged_attention {case}: two launches differ")
    for name, r in pa.paged_attn_info(4, 8, 32).items():
        print(f"  paged_attention {name}: {r['registers']} registers, {r['spill_bytes']} "
              f"spilled bytes a thread, {r['smem_bytes']} B shared a block, {r['blocks_per_sm']} "
              f"blocks per SM, clusters of {r['splits']} at B 4, 8 kv heads, 32 table entries"
              f"  [{card}]", flush=True)

    # B9: decode over an int8 pool (4 layers, 64 pages of 128, the
    # quantized engine's page size), and page 64
    for case, lengths, page, dt, timed in (
        ("bf16 B=4 ragged, one inactive, page 128", [1000, 37, 0, 2048], 128, bf16, True),
        ("bf16 B=2 page 64", [300, 64], 64, bf16, False),
        ("fp32 B=3 page 64", [5, 0, 130], 64, f32, False),
    ):
        if dt == bf16:
            args = _paged_q_case(rng, lengths, 32, 8, 4, 4096 // page * 4, page,
                                 2048 // page, dt, dev)
        else:
            args = _paged_q_case(rng, lengths, 4, 2, 2, 12, page, 3, dt, dev)
        n = sum(lengths)
        hq, hkv = args[0].shape[1], args[1].shape[1]
        work = (4 * n * hq * 128,  # int8 k/v rows with a float32 scale each, q, o
                2 * n * hkv * (128 + 4) + 2 * len(lengths) * hq * 128 * args[0].element_size())
        check("paged_attention_q", case, lambda a=args: pa.paged_attention_cuda(*a),
              lambda a=args: pa.paged_attention_plain(*a), dt, timed, work=work,
              faults=_faults("paged", lambda a=args: pa.paged_attention_cuda(*a)) if timed
              else ())
        if dt == bf16 and not _same_bits(pa.paged_attention_cuda(*args),
                                         pa.paged_attention_cuda(*args)):
            raise AssertionError(f"paged_attention_q {case}: two launches differ")

    # B3/B4: the selected experts of layer 3 of 4 (flat ids into [L*E, ...]).
    # bf16 runs the tensor-core kernel of csrc/expert_ffn_bf16.cu: B3 at T 1
    # and 3, B4 at T 4, 8 (the served wave's) and 16 and on a plan with
    # padding rows (T 8 routed over 3 experts), each run twice for equal
    # bits; the timed B3 and B4 cases must catch its two planted faults
    # (FAULTS), and its resources are printed
    for dt, d, f, n_layers in ((bf16, 4096, 14336, 4), (f32, 256, 512, 2)):
        layer = n_layers - 1
        wg, wu, wd = _expert_weights(rng, n_layers * 8, d, f, dt, dev)
        bf = dt == bf16

        def ffn_work(t, idx, weight_bytes):
            """Top-k FLOPs of T tokens; each distinct expert's weights read
            once (weight_bytes per gate/up/down element, scales included)."""
            n_exp = len(torch.unique(idx))
            return 2 * 3 * t * idx.shape[1] * d * f, n_exp * 3 * d * f * weight_bytes

        def same_bits(case, x, slot_rows, padded):
            run = lambda: md._expert_ffn_mma(x, *slot_rows, wg, wu, wd, padded)
            if not _same_bits(run(), run()):
                raise AssertionError(f"bf16 expert kernel {case}: two launches differ")

        for t in (1, 3):
            x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
            _, idx = _routing(rng, t, 2, 8, layer, dt, dev)
            run = lambda x=x, i=idx: md.gather_expert_ffn_cuda(x, i, wg, wu, wd)
            check("gather_expert_ffn", f"{dt} T={t}", run,
                  lambda x=x, i=idx: md.gather_expert_ffn_plain(x, i, wg, wu, wd),
                  dt, t == 1 and bf, work=ffn_work(t, idx, wg.element_size()),
                  faults=_faults("expert", run) if t == 1 and bf else ())
            if bf:
                same_bits(f"T={t}", x, md._pair_rows(x, idx), False)
        # (case, T, experts the routing is confined to: None for all 8)
        plans = [(f"{dt} T={t}", t, None) for t in (4, 8, 16)]
        if bf:
            plans.append(("bf16 T=8 over 3 experts, 5 padding rows", 8, 3))
        for case, t, n_confined in plans:
            x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
            timed = bf and t == 4
            if n_confined is None:
                w, idx = _routing(rng, t, 2, 8, layer, dt, dev)
            else:
                experts = rng.choice(8, n_confined, replace=False) + 8 * layer
                idx = np.stack([rng.choice(experts, 2, replace=False) for _ in range(t)])
                w = rng.random((t, 2)).astype(np.float32)
                w, idx = (torch.from_numpy(w / w.sum(1, keepdims=True)).to(dev),
                          torch.from_numpy(idx.astype(np.int32)).to(dev))
            act, m = md._active_expert_plan(w, idx, 8)
            run = lambda x=x, a=act, m=m: md.masked_expert_ffn_cuda(x, a, m, wg, wu, wd)
            check("masked_expert_ffn", case, run,
                  lambda x=x, a=act, m=m: md.masked_expert_ffn_plain(x, a, m, wg, wu, wd),
                  dt, timed, work=ffn_work(t, idx, wg.element_size()),
                  faults=_faults("expert", run) if timed else ())
            if bf:
                plan_rows = md._active_rows(x, act)
                same_bits(case, x, plan_rows, True)
                n_real = len(torch.unique(act))
                y = md._expert_ffn_mma(x, *plan_rows, wg, wu, wd, True)
                if y[n_real:].any() or not bool(y[:n_real, :t].abs().amax(-1).min() > 0):
                    raise AssertionError(f"masked_expert_ffn {case}: the plan's {len(act) - n_real}"
                                         " padding rows must give zeros and no other row")
        if bf:
            for name, r in md.expert_ffn_bf16_info().items():
                print(f"  {name} bf16 mma kernel: {r['registers']} registers, "
                      f"{r['spill_bytes']} spilled bytes a thread, {r['smem_bytes']} B shared "
                      f"a block, {r['blocks_per_sm']} blocks per SM  [{card}]", flush=True)

        # B6/B7 (gather) and B8a/B8b (masked) over the same experts,
        # quantized layer by layer; grouped int4 only has the gather schedule
        # on the main path (group 128 at the serving width). In bf16, B6
        # (int8) and B7 (int4) at T 1 and 3 (T 3 over the pairs sorted by
        # expert), B8a (int8, T 4 and 16, and a plan with 5 padding rows) and
        # B8b (int4, T 8 and 16) run the tensor-core kernel of
        # csrc/expert_ffn_q.cu: each is run twice for equal bits, the plan's
        # padding rows must give zeros and no other row, B6's, B7's and
        # B8a's cases must catch its two planted faults (FAULTS), B8b's two
        # of its own (_q4_faults), and its resources are printed
        stack = {"router": wg.new_zeros(d, 8),
                 **{k: w.view(n_layers, 8, *w.shape[1:])
                    for k, w in (("w_gate", wg), ("w_up", wu), ("w_down", wd))}}
        group = 128 if dt == bf16 else 64
        for kind, bits, qp in (
                ("int8", 8, md.quantize_expert_weights(stack)),
                ("int4", 4, md.quantize_expert_weights_int4(stack)),
                (f"int4 group {group}", 4, md.quantize_expert_weights_int4(stack, group))):
            qp = {k: v.flatten(0, 1) for k, v in qp.items() if k != "router"}
            sfx = "_q4" if bits == 4 else "_q"
            main = kind in ("int8", "int4")
            # bytes per weight element: the packed value plus its share of the
            # float32 scales (one per output column, or per group of rows)
            qbytes = bits / 8 + (4 / group if "group" in kind else 4 * (2 / d + 1 / f) / 3)

            def q_same_bits(case, x, slot_rows, padded, qp=qp, bits=bits):
                run = lambda: md._expert_ffn_q_mma(x, *slot_rows, qp, bits, padded)
                if not _same_bits(run(), run()):
                    raise AssertionError(f"quantized expert kernel {case}: two launches differ")

            for t in (1, 3):
                x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
                _, idx = _routing(rng, t, 2, 8, layer, dt, dev)
                mma = main and dt == bf16  # B6 (int8) and B7 (int4) on tensor cores
                # T 3 runs the pairs sorted by expert, as the main path does
                xs, ids = (x, idx) if t == 1 else _sorted_pairs(x, idx)

                def run(x=x, i=idx, q=qp, b=bits, t=t):
                    gather = lambda xr, ir: md.gather_expert_ffn_q_cuda(xr, ir, q, b)
                    return gather(x, i) if t == 1 else md._sorted_pair_gather(x, i, gather)

                check("gather_expert_ffn" + sfx, f"{kind} {dt} T={t}", run,
                      lambda x=x, i=idx, q=qp, b=bits: md.gather_expert_ffn_q_plain(x, i, q, b),
                      dt, mma, tol_q, work=ffn_work(t, idx, qbytes),
                      faults=_faults("expert_q", run) if mma else ())
                if mma:
                    q_same_bits(f"{'B6' if bits == 8 else 'B7'} T={t}", xs,
                                md._pair_rows(xs, ids), False)
            # (case, T, experts the routing is confined to: None for all 8)
            plans = [(f"{kind} {dt} T={t}", t, None)
                     for t in ((4, 16) if bits == 8 else (8, 16)) if main]
            if kind == "int8" and dt == bf16:
                plans.append(("int8 bf16 T=8 over 3 experts, 5 padding rows", 8, 3))
            for case, t, n_confined in plans:
                x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
                if n_confined is None:
                    w, idx = _routing(rng, t, 2, 8, layer, dt, dev)
                else:
                    experts = rng.choice(8, n_confined, replace=False) + 8 * layer
                    idx = np.stack([rng.choice(experts, 2, replace=False) for _ in range(t)])
                    w = rng.random((t, 2)).astype(np.float32)
                    w, idx = (torch.from_numpy(w / w.sum(1, keepdims=True)).to(dev),
                              torch.from_numpy(idx.astype(np.int32)).to(dev))
                act, m = md._active_expert_plan(w, idx, 8)
                mma = dt == bf16  # B8a, B8b on tensor cores
                run = (lambda x=x, a=act, m=m, q=qp, b=bits:
                       md.masked_expert_ffn_q_cuda(x, a, m, q, b))
                faults = ()
                if mma and bits == 8 and n_confined is None:
                    faults = _faults("expert_q", run)
                elif mma and bits == 4:
                    faults = _q4_faults(x, act, m, qp)
                check("masked_expert_ffn" + sfx, case, run,
                      lambda x=x, a=act, m=m, q=qp, b=bits:
                          md.masked_expert_ffn_q_plain(x, a, m, q, b),
                      dt, t < 16 and n_confined is None and mma, tol_q,
                      work=ffn_work(t, idx, qbytes), faults=faults)
                if mma:
                    plan_rows = md._active_rows(x, act)
                    q_same_bits(case, x, plan_rows, True)
                    n_real = len(torch.unique(act))
                    y = md._expert_ffn_q_mma(x, *plan_rows, qp, bits, True)
                    if y[n_real:].any() or not bool(y[:n_real, :t].abs().amax(-1).min() > 0):
                        raise AssertionError(f"masked_expert_ffn{sfx} {case}: the plan's "
                                             f"{len(act) - n_real} padding rows must give zeros "
                                             "and no other row")
            del qp
        if dt == bf16:
            for name, r in md.expert_ffn_q_info().items():
                print(f"  {name} quantized mma kernel: {r['registers']} registers, "
                      f"{r['spill_bytes']} spilled bytes a thread, {r['smem_bytes']} B shared "
                      f"a block, {r['blocks_per_sm']} blocks per SM  [{card}]", flush=True)
        del wg, wu, wd, stack
        torch.cuda.empty_cache()

    # B5b: an Engine prefill chunk of 256 tokens (R 1536, tile 128); B5a:
    # a Generator prompt bucket of 12288 tokens (R 28672, tile 512); the
    # gate/up and the down projection each; then the dx of a training step
    # (dy [R, F] times the gate/up weight [E, D, F] with transpose_rhs): B5b
    # at 1024 tokens (R 3072), B5a at 9216 (R 22528). bf16 B5a and B5b
    # (wgmma + TMA) must give equal bits twice.
    # Then small cases off the main path: fp32 with transpose_rhs (B5a at a
    # small R through a lowered SMALL_R_MAX), bf16 B5a on rows that are no
    # TMA tensor (K 201, N 75) and on ragged TMA tiles, both operand majors
    for t, name, down, trans in ((256, "gmm_small", False, False),
                                 (256, "gmm_small", True, False),
                                 (1024, "gmm_small", True, True),
                                 (12288, "gmm", False, False), (12288, "gmm", True, False),
                                 (9216, "gmm", True, True)):
        x, w, gids, tile_m = _gmm_case(rng, t, 4096, 14336, 8, bf16, dev, down)
        if trans:  # the down-shaped [E, F, D] as the gate/up weight [E, D, F]
            w = w.transpose(1, 2).contiguous()
        r, k_dim, n_dim = x.shape[0], x.shape[1], w.shape[1 if trans else 2]
        args = (x, w, gids, trans, tile_m)
        label = "dx, transpose_rhs" if trans else "down" if down else "gate/up"
        check(name, f"bf16 T={t} R={r} tile {tile_m} {label} [{'x'.join(map(str, w.shape))}]",
              lambda a=args: mg.gmm_cuda(*a), lambda a=args: mg.gmm_plain(*a), bf16, True,
              work=(2 * r * k_dim * n_dim, nbytes(x, w) + 2 * r * n_dim),
              library=lambda a=args: _grouped_mm(*a))
        if not _same_bits(mg.gmm_cuda(*args), mg.gmm_cuda(*args)):
            raise AssertionError(f"{name} {label}: two launches differ")
        del x, w, args
        torch.cuda.empty_cache()
    real_max = mg.SMALL_R_MAX
    mg.SMALL_R_MAX = 0
    try:
        for d, f in ((201, 75), (200, 136)):
            x, w, gids, tile_m = _gmm_case(rng, 600, d, f, 4, bf16, dev, False)
            for trans, wt in ((False, w), (True, w.transpose(1, 2).contiguous())):
                check("gmm", f"bf16 R={x.shape[0]} tile {tile_m} K {d} N {f}"
                             f"{', transpose_rhs' if trans else ''}",
                      lambda a=(x, wt, gids, trans, tile_m): mg.gmm_cuda(*a),
                      lambda a=(x, wt, gids, trans, tile_m): mg.gmm_plain(*a), bf16, False)
    finally:
        mg.SMALL_R_MAX = real_max
    for name, r_max in (("gmm_small", real_max), ("gmm", 0)):
        mg.SMALL_R_MAX = r_max
        try:
            x, w, gids, tile_m = _gmm_case(rng, 300 if r_max else 600, 200, 136, 4, f32, dev,
                                           False)
            w = w.transpose(1, 2).contiguous()  # [E, N, K]
            check(name, f"fp32 R={x.shape[0]} tile {tile_m} transpose_rhs, ragged K/N",
                  lambda a=(x, w, gids, True, tile_m): mg.gmm_cuda(*a),
                  lambda a=(x, w, gids, True, tile_m): mg.gmm_plain(*a), f32, False)
        finally:
            mg.SMALL_R_MAX = real_max

    # B10/B11 (bf16: tensor cores, fp32: FMA): the backward of a causal
    # training sequence of 4096 tokens and of the training step's 9216
    # bucket with 5735 real tokens (32/8 heads of 128) in bf16, on the plain
    # forward's o and lse; a ragged bf16 case (200 q rows over 333 keys, GQA
    # 4, a row with kv_len 0, a negative q_offset) and a ragged fp32 case.
    # At 9216 the plain versions run one GQA group at a time: the same
    # function, where all 32 heads' [9216, 9216] float32 temporaries would
    # not fit the card. Each bf16 kernel must give the same bits twice.
    for case, sq, skv, hq, hkv, kv_len, q_off, dt, timed in (
        ("bf16 B=1 S=4096 causal", 4096, 4096, 32, 8, [4096], [0], bf16, True),
        ("bf16 B=1 S=9216 kv_len 5735 causal", 9216, 9216, 32, 8, [5735], [0], bf16, True),
        ("bf16 B=3 ragged 200/333, GQA 4, kv_len 0, q_offset<0", 200, 333, 16, 4,
         [333, 0, 150], [133, 0, -20], bf16, False),
        ("fp32 B=2 ragged, kv_len pad, q_offset", 100, 150, 4, 2, [150, 77], [50, 0], f32, False),
    ):
        b = len(kv_len)
        by_group = sq > 4096
        q, k, v, kl, qo, causal, scale = _flash_case(rng, b, sq, skv, hq, hkv, kv_len, q_off,
                                                     dt, dev)
        do = torch.from_numpy(rng.standard_normal(q.shape, np.float32)).to(dev, dt)
        fwd = _by_group(fa.flash_fwd_plain, (2, 1)) if by_group else fa.flash_fwd_plain
        o, lse = fwd(q, k, v, kl, qo, causal, scale)
        args = (q, k, v, do, lse, fa.flash_delta(do, o), kl, qo, causal, scale)
        del o
        pairs = attn_pairs(sq, kv_len, q_off, causal)
        stats = 2 * 4 * b * hq * sq  # lse and delta
        sdpa = (lambda: _sdpa_bwd(q, k, v, do, scale)) if not by_group else None
        for name, run, plain, work in (
            ("flash_bwd_dq", fa.flash_bwd_dq_cuda,
             _by_group(fa.flash_bwd_dq_plain, (2,)) if by_group else fa.flash_bwd_dq_plain,
             (2 * 3 * pairs * 128 * hq, 3 * nbytes(q) + 2 * nbytes(k) + stats)),
            ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda,
             _by_group(fa.flash_bwd_dkv_plain, (2, 2)) if by_group else fa.flash_bwd_dkv_plain,
             (2 * 4 * pairs * 128 * hq, 2 * nbytes(q) + 4 * nbytes(k) + stats)),
        ):
            check(name, case, lambda f=run: f(*args), lambda f=plain: f(*args), dt, timed,
                  work=work, library=sdpa)
            if dt == bf16 and not _same_bits(run(*args), run(*args)):
                raise AssertionError(f"{name} {case}: two launches differ")
        del q, k, v, do, lse, args
        torch.cuda.empty_cache()
    for name, r in fa.flash_bwd_mma_info().items():
        print(f"  {name} bf16 kernel: {r['registers']} registers, {r['spill_bytes']} spilled "
              f"bytes a thread, {r['smem_bytes']} B shared a block, {r['blocks_per_sm']} blocks "
              f"per SM  [{card}]", flush=True)

    # B12: the weight gradients of a training step of 9216 tokens (T*k 18432 >
    # 16384: tile 512, R 22528), gate/up and down shapes, bf16 (wgmma + TMA:
    # equal bits twice); at tile 128 with an expert that has no token (its
    # tile is padding: dw exactly 0) in fp32 and in bf16 on rows that are no
    # TMA tensor (K 201, N 75)
    for t, d, f, e, dt, timed, unused in ((9216, 4096, 14336, 8, bf16, True, ()),
                                          (300, 200, 136, 4, f32, False, (2,)),
                                          (300, 201, 75, 4, bf16, False, (2,))):
        for down in (False, True):
            a, bmat, gids, tile_m = _wgrad_case(rng, t, d, f, e, dt, dev, down, unused)
            r, k_dim, n_dim = a.shape[0], a.shape[1], bmat.shape[1]
            z = (a, bmat, gids, e, tile_m)
            check("gmm_wgrad", f"{dt} T={t} R={r} tile {tile_m} {'down' if down else 'gate/up'} "
                               f"[{e}x{k_dim}x{n_dim}]",
                  lambda z=z: mg.gmm_wgrad_cuda(*z), lambda z=z: mg.gmm_wgrad_plain(*z), dt, timed,
                  work=(2 * r * k_dim * n_dim, nbytes(a, bmat) + e * k_dim * n_dim * a.element_size()),
                  library=lambda z=(a, bmat, gids, tile_m): _grouped_mm_wgrad(*z))
            if timed and not _same_bits(mg.gmm_wgrad_cuda(*z), mg.gmm_wgrad_cuda(*z)):
                raise AssertionError("gmm_wgrad: two launches differ")
            if unused:
                dw = mg.gmm_wgrad_cuda(*z)
                if bool(dw[list(unused)].any()):
                    raise AssertionError("gmm_wgrad: an expert without tokens got a nonzero dw")
            del a, bmat, z
            torch.cuda.empty_cache()
    for name, r in mg.gmm_wgmma_info().items():
        print(f"  {name} bf16 wgmma kernel: {r['registers']} registers, {r['spill_bytes']} spilled "
              f"bytes a thread, {r['smem_bytes']} B shared a block, {r['blocks_per_sm']} blocks "
              f"per SM  [{card}]", flush=True)
    return rows


def _sdpa_fwd(q, k, v, kv_len, q_off, causal, scale):
    """scaled_dot_product_attention with flash_mha's masks (B = 1)."""
    import torch
    import torch.nn.functional as F

    sq, skv = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kpos = torch.arange(skv, device=q.device)
    mask = kpos[None, :] < kv_len[0]
    if causal:
        mask = mask & (kpos[None, :] <= torch.arange(sq, device=q.device)[:, None] + q_off[0])
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)


def _by_group(fn, cat_dims):
    """``fn`` over q, k, v, dO, lse, delta (the first six arguments that
    are given) one GQA group at a time, its outputs joined along
    ``cat_dims`` (one per output): the same function in 1/Hkv of the
    plain version's memory."""
    import torch

    def run(q, k, v, *rest):
        hkv = k.shape[2]
        rep = q.shape[2] // hkv
        outs = []
        for h in range(hkv):
            qh, kh = slice(h * rep, (h + 1) * rep), slice(h, h + 1)
            extra = list(rest)
            if len(rest) > 4:  # the backward's dO, lse and delta
                extra[:3] = rest[0][:, :, qh], rest[1][:, qh], rest[2][:, qh]
            outs.append(fn(q[:, :, qh], k[:, :, kh], v[:, :, kh], *extra))
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        joined = tuple(torch.cat(parts, d) for parts, d in zip(zip(*outs), cat_dims))
        return joined if len(joined) > 1 else joined[0]

    return run


def _same_bits(a, b) -> bool:
    import torch

    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _sdpa_bwd(q, k, v, do, scale):
    """The backward of causal scaled_dot_product_attention: one call giving
    dq, dk and dv together."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)


def _group_ends(gids, n_groups, tile_m):
    import torch

    return (torch.bincount(gids.long(), minlength=n_groups) * tile_m).cumsum(0).to(torch.int32)


def _grouped_mm(x, w, gids, transpose_rhs, tile_m):
    """PyTorch's grouped matmul over the same row groups (w [E, N, K] with
    transpose_rhs, read as its transposed view)."""
    import torch

    offs = _group_ends(gids, w.shape[0], tile_m)
    rhs = w.transpose(1, 2) if transpose_rhs else w
    return lambda: torch._grouped_mm(x, rhs, offs=offs)


def _grouped_mm_wgrad(a, b, gids, tile_m):
    """PyTorch's grouped matmul with the groups along the contraction:
    a^T b per group."""
    import torch

    offs = _group_ends(gids, int(gids.max()) + 1, tile_m)
    at = a.t()
    return lambda: torch._grouped_mm(at, b, offs=offs)


def _wgrad_case(rng, t, d, f, e, dtype, dev, down, unused=()):
    """B12's operands in the sorted layout of T tokens routed top-2 over e
    experts (never any of ``unused``): a = the matmul's input rows, b = its
    output gradient rows (zero on padding rows, as in training), gids,
    tile_m. Gate/up shapes a [R, d], b [R, f]; down a [R, f], b [R, d]."""
    import torch

    from vita_tpu_torch.ops import moe_gmm as mg

    pool = [x for x in range(e) if x not in unused]
    idx = torch.from_numpy(np.stack([rng.choice(pool, 2, replace=False) for _ in range(t)])
                           .astype(np.int32)).to(dev)
    tile_m = mg.SMALL_TILE_M if 2 * t <= mg.SMALL_R_MAX else mg.TILE_M
    dest, _, _, gids, r = mg.sorted_layout(idx, e, tile_m)
    k_dim, n_dim = (f, d) if down else (d, f)

    def rows(n):
        x = torch.zeros(r, n, dtype=dtype, device=dev)
        x[dest.long()] = torch.from_numpy(rng.standard_normal((2 * t, n), np.float32)).to(dev, dtype)
        return x

    return rows(k_dim), rows(n_dim), gids, tile_m


# --------------------------------------------------------------------------
# phase 3: the full-width slice through the Engine
# --------------------------------------------------------------------------
def slice_config():
    """VITA-8x7B at full width; the only cut is the LLM's depth, 32 -> 4
    layers (the bf16 8x7B, about 93 GB, does not fit one 80 GB card)."""
    from vita_tpu_torch.models import vita

    cfg = vita.VITAConfig.vita_8x7b()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, n_layers=4))


def media_request(cfg, rng, max_new_tokens, frames=400):
    """One 448px tile + 400 fbank frames (4 s) + text, expanded to its
    feature slots (256 image + 50 audio tokens)."""
    from vita_tpu_torch.serve.engine import Request
    from vita_tpu_torch.tokenization import audio_token_count

    n_img, n_aud = cfg.image_tokens_per_group, audio_token_count(frames)
    s = n_img + n_aud + 40
    ids = rng.integers(3, cfg.llm.vocab_size, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[20:20 + n_img] = True
    am[20 + n_img:20 + n_img + n_aud] = True
    ids[im | am] = 0
    sz = cfg.vision.image_size
    return Request(
        input_ids=ids, image_mask=im, audio_mask=am,
        images=rng.standard_normal((1, sz, sz, 3)).astype(np.float32),
        speech=rng.standard_normal((frames, cfg.audio.input_dim)).astype(np.float32),
        speech_length=frames, max_new_tokens=max_new_tokens, eos_id=-1,
    )


def text_request(cfg, rng, n, max_new_tokens):
    from vita_tpu_torch.serve.engine import Request

    return Request(input_ids=rng.integers(3, cfg.llm.vocab_size, n).astype(np.int32),
                   max_new_tokens=max_new_tokens, eos_id=-1)


def serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    return reqs


# (label, Engine options, text prompt lengths of the wave beside the
# image+audio request, the kernels of the run's path)
SERVED_RUNS = (
    ("bf16 experts, bf16 KV pages",
     dict(n_slots=4, page_size=64, decode_moe_mode="gather"), (20, 150, 60),
     ("flash_fwd", "paged_attention", "gather_expert_ffn", "masked_expert_ffn")),
    ("int4 experts, int8 KV pages",
     dict(n_slots=8, page_size=128, decode_moe_mode="gather_q4", kv_int8=True,
          max_concurrent_prefills=8), (20, 150, 60, 33, 90, 12, 200),
     ("flash_fwd", "paged_attention_q", "gather_expert_ffn_q4", "masked_expert_ffn_q4")),
    ("int8 experts, int8 KV pages",
     dict(n_slots=4, page_size=128, decode_moe_mode="gather_q", kv_int8=True), (20, 150, 60),
     ("flash_fwd", "paged_attention_q", "gather_expert_ffn_q", "masked_expert_ffn_q")),
    ("bf16 experts, gmm prefill",
     dict(n_slots=4, page_size=64, decode_moe_mode="gather", prefill_moe_mode="gmm"),
     (20, 150, 60),
     ("flash_fwd", "gmm_small", "paged_attention", "gather_expert_ffn", "masked_expert_ffn")),
)


def served_run(card: str, engine, cfg, wave_texts, max_new_tokens: int):
    """Warm-up, then (launch counts zeroed) one text request alone and a
    wave of one image+audio request with text requests; prints TTFT and
    decode tok/s per request and in aggregate. Returns (launch counts of
    the run, the solo request)."""
    from vita_tpu_torch import kernels

    rng = np.random.default_rng(SEED)
    # warm-up, so that TTFT excludes first-use costs (cuDNN, module loading)
    serve(engine, [text_request(cfg, rng, 30, 4), media_request(cfg, rng, 4)])
    kernels.reset_launches()
    solo = serve(engine, [text_request(cfg, rng, 100, max_new_tokens)])
    t0 = time.time()
    wave = serve(engine, [media_request(cfg, rng, max_new_tokens)]
                 + [text_request(cfg, rng, n, max_new_tokens) for n in wave_texts])
    wall = time.time() - t0
    counts = dict(kernels.launches)
    print(f"  kernel launches in the served run: {counts}", flush=True)
    vocab = cfg.llm.vocab_size
    n_text = len(wave_texts)
    for name, r in [("text alone", solo[0]), ("image+audio", wave[0])] + [
            (f"text {i} of {n_text} with it", r) for i, r in enumerate(wave[1:], 1)]:
        if len(r.tokens) != max_new_tokens or not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"{name}: {len(r.tokens)} tokens {r.tokens[:8]}...")
        print(f"  {name:22s} prompt {len(r.input_ids):4d}  TTFT {r.ttft_s * 1e3:9.2f} ms  "
              f"decode {r.decode_tokens_per_s:8.2f} tok/s  [{card}]", flush=True)
    n_req = len(wave)
    print(f"  {n_req} concurrent requests: {n_req * max_new_tokens} tokens in {wall:.3f} s, "
          f"{n_req * max_new_tokens / wall:.2f} tok/s aggregate  [{card}]", flush=True)
    return counts, solo[0]


def first_token_gap(params, cfg, ids, token, embeds=None) -> float:
    """How far ``token`` lies below the top logit of the last row of the
    cacheless forward (dense MoE) over the prompt; raises on a wrong shape
    or a non-finite row."""
    from vita_tpu_torch.models import mixtral

    kw = (dict(inputs_embeds=embeds) if embeds is not None
          else dict(input_ids=ids))
    logits, _, _ = mixtral.forward(params["llm"], cfg.llm, **kw)
    last = logits[0, -1].float()
    if logits.shape != (1, ids.shape[1], cfg.llm.vocab_size) or not bool(
            last.isfinite().all()):
        raise AssertionError(f"cacheless logits {tuple(logits.shape)} not finite")
    gap = float(last.max() - last[token])
    print(f"  cacheless forward: logits {tuple(logits.shape)} finite; first token is "
          f"{gap:.4f} below the top logit", flush=True)
    if gap > 0.1:
        raise AssertionError(f"first token {gap:.4f} below the reference's top logit")
    return gap


def slice_params(cfg, device):
    import torch

    from vita_tpu_torch.models import vita

    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = vita.init_params(cfg, gen, device)
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    _sync(device)
    print(f"  init {n_bytes / 2**30:.2f} GiB of weights on {device}: "
          f"{time.time() - t0:.1f} s", flush=True)
    return params


def slice_phase(card: str, cfg, params, device, max_new_tokens: int = 32):
    """Serve the slice through the Engine once per SERVED_RUNS entry, on
    the same weights; returns the launch counts summed over the runs."""
    import torch

    from vita_tpu_torch.serve.engine import Engine

    total = {}
    for label, options, wave_texts, path in SERVED_RUNS:
        print(f"  -- {label}: Engine({options})", flush=True)
        t0 = time.time()
        engine = Engine(params, cfg, max_len=2048, device=device, **options)
        _sync(device)
        print(f"  engine built in {time.time() - t0:.1f} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        counts, solo = served_run(card, engine, cfg, wave_texts, max_new_tokens)
        missing = [k for k in path if counts[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on its path: {missing}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        # reference: the cacheless bf16 forward over the solo prompt, whose
        # last row must be finite and rank the engine's first token (from
        # the bf16 prefill in every run) at or within bf16 rounding of the top
        ids = torch.as_tensor(solo.input_ids, dtype=torch.int64, device=device)[None]
        first_token_gap(params, cfg, ids, solo.tokens[0])
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return total


# the kernels the Generator phase must launch
GENERATOR_PATH = ("flash_fwd", "gmm", "gmm_small", "gather_expert_ffn")


def generator_phase(card: str, cfg, params, device, max_new_tokens: int = 32,
                    max_len: int = 12288, text_len: int = 8500):
    """The slice through Generator(max_len=12288, gmm prefill, gather
    decode): an image+audio request (bucket 512: B5b) and a text request of
    8500 tokens (bucket 12288: T*k 24576 > SMALL_R_MAX, so B5a). Returns
    the launch counts of the two requests."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.generate import GenerationConfig, Generator, embed_prompt

    gen = Generator(params, cfg, max_len=max_len, prefill_moe_mode="gmm",
                    decode_moe_mode="gather", device=device)
    print(f"  Generator prompt buckets {gen.prompt_buckets}", flush=True)
    rng = np.random.default_rng(SEED + 2)
    media = media_request(cfg, rng, max_new_tokens)
    text_ids = rng.integers(3, cfg.llm.vocab_size, text_len).astype(np.int32)
    prompts = [("image+audio", dict(
        input_ids=media.input_ids, image_mask=media.image_mask, audio_mask=media.audio_mask,
        images=media.images, speech=media.speech, speech_length=media.speech_length)),
        (f"text {text_len}", dict(input_ids=text_ids))]
    gcfg = GenerationConfig(max_new_tokens=max_new_tokens, eos_id=-1)
    kernels.reset_launches()
    outs = []
    for name, prompt in prompts:
        stamps = []
        t0 = time.time()
        toks = gen.generate(gen=gcfg, on_token=lambda _: stamps.append(time.time()), **prompt)
        t1 = time.time()
        if len(toks) != max_new_tokens or not all(0 <= x < cfg.llm.vocab_size for x in toks):
            raise AssertionError(f"{name}: {len(toks)} tokens {toks[:8]}...")
        ttft = stamps[0] - t0
        rate = (len(toks) - 1) / (t1 - stamps[0])
        print(f"  {name:12s} prompt {len(prompt['input_ids']):5d}  TTFT {ttft * 1e3:9.2f} ms  "
              f"decode {rate:8.2f} tok/s  [{card}]", flush=True)
        outs.append((prompt, toks))
    counts = dict(kernels.launches)
    print(f"  kernel launches in the Generator run: {counts}", flush=True)
    missing = [k for k in GENERATOR_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"Generator: kernels never launched on its path: {missing}")
    for prompt, toks in outs:
        ids = np.asarray(prompt["input_ids"], np.int64)
        embeds = embed_prompt(params, cfg, ids, device, gen.tile_buckets, gen.frame_buckets,
                              **{k: v for k, v in prompt.items() if k != "input_ids"})
        first_token_gap(params, cfg, torch.as_tensor(ids[None], device=device), toks[0],
                        embeds=embeds)
        del embeds
        torch.cuda.empty_cache()
    return counts


def cli_phase():
    """python -m vita_tpu_torch.cli --model tiny-random --prefill-moe-mode
    gmm, in process; returns its launch counts (B5b must be among them)."""
    from vita_tpu_torch import cli, kernels

    kernels.reset_launches()
    rc = cli.main(["--model", "tiny-random", "--question", "Hello", "--prefill-moe-mode", "gmm",
                   "--max-new-tokens", "16"])
    counts = dict(kernels.launches)
    print(f"  kernel launches in the CLI run: {counts}", flush=True)
    if rc != 0 or counts["gmm_small"] == 0:
        raise AssertionError(f"CLI: exit code {rc}, gmm_small launches {counts['gmm_small']}")
    ref = [m for m in sys.modules if m == "vita_tpu" or m.startswith("vita_tpu.")]
    if ref or "jax" in sys.modules:
        raise AssertionError(f"the CLI loaded the reference package: {ref}")
    return counts


# --------------------------------------------------------------------------
# phase 4: the same Engine on the card and on the CPU
# --------------------------------------------------------------------------
def narrow_config():
    """fp32, shapes the kernels take: d 512, 4 q / 2 kv heads of 128."""
    from vita_tpu_torch.models import mixtral, vita

    llm = mixtral.MixtralConfig.tiny(d_model=512, n_heads=4, n_kv_heads=2, d_ff=1024,
                                     vocab_size=1024, attn_backend="flash")
    return dataclasses.replace(vita.VITAConfig.tiny(), llm=llm)


# An int8 KV page rounds each cached k/v element to a step of max|row|/127,
# and a quantized expert rounds h to bf16: both are discontinuous in the
# last bits of float32 sums, which differ between the card and the CPU. One
# flipped step moves a score by |q_i| max|k| / 127, so two tokens whose
# logits lie within NEAR_TIE of each other at a step on the reference
# device may swap there; the quantized run's streams are compared up to
# such a step and no further (the streams differ after it).
NEAR_TIE = 1e-2


@contextlib.contextmanager
def _recording_top2(engine, top2):
    """While open, every decode step of ``engine`` records, for each active
    request, its top two logits' tokens and gap as top2[(request_id, i)] =
    (first, second, gap), where i indexes the request's generated token
    that the step samples."""
    import torch

    from vita_tpu_torch import sampling
    from vita_tpu_torch.serve import engine as engine_mod

    real_chunk, real_sample = engine_mod.decode_chunk, sampling.sample_tokens

    def chunk(llm_params, cache, tok, pos, *args, **kw):
        # decode rows are the occupied slots in order, then padding
        reqs = [r for r in engine.slot_req if r is not None]
        first = [int(p) + 1 - len(r.input_ids) for p, r in zip(pos.tolist(), reqs)]
        step = [0]

        def sample(logits, *a, **k):
            v, i = torch.topk(logits.float(), 2, dim=-1)
            for row, r in enumerate(reqs):
                top2[(r.request_id, first[row] + step[0])] = (
                    int(i[row, 0]), int(i[row, 1]), float(v[row, 0] - v[row, 1]))
            step[0] += 1
            return real_sample(logits, *a, **k)

        sampling.sample_tokens = sample
        try:
            return real_chunk(llm_params, cache, tok, pos, *args, **kw)
        finally:
            sampling.sample_tokens = real_sample

    engine_mod.decode_chunk = chunk
    try:
        yield
    finally:
        engine_mod.decode_chunk = real_chunk


def equivalence_phase(devices, near_tie: float = 0.0, cfg=None, **engine_kw):
    """Greedy streams of the Engine on each device, same weights, prompts
    and options (``cfg``, narrow_config() by default); the last device is
    the reference. Raises on any difference, except (with ``near_tie`` >
    0) where the reference's own top two logits at that request's step
    were the two tokens and lay within ``near_tie``: that request is
    compared up to the step."""
    import torch

    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.serve.engine import Engine

    cfg = cfg or narrow_config()
    params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    streams, top2 = [], {}
    for dev in devices:
        p = _to(params, dev)
        engine = Engine(p, cfg, n_slots=4, max_len=512, page_size=64,
                        prefill_chunk=128, device=dev, **engine_kw)
        with (_recording_top2(engine, top2) if dev is devices[-1]
              else contextlib.nullcontext()):
            rng = np.random.default_rng(SEED + 1)
            first = serve(engine, [text_request(cfg, rng, 200, 12)])
            wave = serve(engine, [media_request(cfg, rng, 12, frames=40)]
                         + [text_request(cfg, rng, n, 12) for n in (5, 130, 33)])
        streams.append([r.tokens for r in first + wave])
        prompts = [np.asarray(r.input_ids) for r in first + wave]
        ref_ids = [r.request_id for r in first + wave]
    ref, got = streams[-1], streams[0]
    # the record must hold the reference's own decode steps: its top token
    # at (request, i) is the token it streamed (token 0 is prefill's)
    wrong = [(i, j) for i, b in enumerate(ref) for j in range(1, len(b))
             if top2.get((ref_ids[i], j), (None,))[0] != b[j]]
    if wrong:
        raise AssertionError(f"top-2 record does not match the reference stream at {wrong[:4]}")
    compared = 0
    for i, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            compared += len(b)
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        t1, t2, gap = top2.get((ref_ids[i], j), (None, None, None))
        if near_tie > 0 and (t1, t2) == (b[j], a[j]) and gap <= near_tie:
            print(f"  request {i} splits at token {j}: {a[j]} vs {b[j]}, a near tie "
                  f"(reference's own top-2 gap at that step {gap:.3e} <= {near_tie}); "
                  f"compared up to it", flush=True)
            compared += j
            continue
        ids = np.concatenate([prompts[i], np.asarray(b[:j], np.int32)])
        logits, _, _ = mixtral.forward(params["llm"], cfg.llm,
                                       input_ids=torch.as_tensor(ids[None]).long())
        row = logits[0, -1]
        print(f"  request {i} differs at token {j}: {a[j]} vs {b[j]}; reference's own "
              f"top two at that step {(t1, t2)}, gap {gap}; cacheless bf16-expert logit "
              f"gap {float(row[b[j]] - row[a[j]]):.3e}", flush=True)
        raise AssertionError(f"greedy streams differ on {devices} ({engine_kw})")
    what = dict(engine_kw, tower=cfg.vision_tower, projector=cfg.vision_projector,
                whale=cfg.audio.attn_backend)
    print(f"  greedy streams identical on {devices} ({what}): {len(ref)} requests, "
          f"{compared} of {sum(map(len, ref))} tokens compared", flush=True)


# --------------------------------------------------------------------------
# phases 6-7: training
# --------------------------------------------------------------------------
TRAIN_DIR = os.path.join(ROOT, "build", "smoke_train")
# the kernels the training phase must launch, and the largest Collator
# bucket its longest sample reaches
TRAIN_PATH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gmm", "gmm_small", "gmm_wgrad")
TRAIN_TOP_BUCKET = 9216


def train_slice_config():
    """VITA-8x7B at full width with the LLM cut to 2 of 32 layers, gmm MoE,
    flash attention and per-layer remat (the 8x7B preset's), bf16. A layer
    is about 1.45 B parameters at 8 bytes per trainable parameter (weight,
    gradient, two Adam moments): 2 layers and embed/lm_head come to about
    27 GB before a 9216-token step's activations."""
    from vita_tpu_torch.models import vita

    cfg = vita.VITAConfig.vita_8x7b()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, n_layers=2, moe_mode="gmm"))


def write_wav(path, seconds, seed):
    """A 16 kHz mono PCM wav of noise, written with the stdlib."""
    import wave

    rng = np.random.default_rng(seed)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((rng.standard_normal(int(16000 * seconds)) * 3000).astype(np.int16).tobytes())
    return path


def _turns(rng, n_words):
    words = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa"]
    text = " ".join(rng.choice(words, n_words))
    return [{"from": "human", "value": text[: len(text) // 2]},
            {"from": "gpt", "value": text[len(text) // 2:]}]


class SmokeData:
    """Conversation samples for the training phase, through the port's data
    pipeline with the byte tokenizer: text samples from a JSON file via
    ConversationDataset (two long ones past 4096 tokens, which the Collator
    pads to its 9216 bucket, and short ones), and one image+audio sample
    built the way ConversationDataset builds one, with its tiles from a
    numpy array (the card's host has no PIL) and its audio from a wav."""

    def __init__(self, cfg, directory, seed=SEED, text_words=(900, 60, 300, 900)):
        from vita_tpu_torch.cli import ByteTokenizer
        from vita_tpu_torch.data import dataset as ds
        from vita_tpu_torch.data import image, preprocess
        from vita_tpu_torch.data.audio import wav_to_features
        from vita_tpu_torch.tokenization import audio_token_count

        os.makedirs(directory, exist_ok=True)
        rng = np.random.default_rng(seed)
        tok = ByteTokenizer()
        chat = os.path.join(directory, "chat.json")
        with open(chat, "w") as f:
            json.dump([{"conversations": _turns(rng, n)} for n in text_words], f)
        args = ds.DataArgs(image_size=cfg.vision.image_size, max_patches=1, use_thumbnail=False,
                           image_tokens_per_group=cfg.image_tokens_per_group)
        text = ds.ConversationDataset([ds.DatasetSpec(chat)], tok.encode, tok.bos_id, tok.eos_id,
                                      pad_id=0, args=args)
        self.samples = [text[i] for i in range(len(text))]

        feats, _ = wav_to_features(write_wav(os.path.join(directory, "q.wav"), 2.0, seed))
        turns = [{"from": "human", "value": "<image>\n<audio>\n"},
                 {"from": "gpt", "value": "a picture and a sound"}]
        ids, labels = preprocess.build_training_sample(
            preprocess.normalize_media_tokens(turns, patch_nums=[1]), tok.encode, "image", True,
            tok.bos_id, tok.eos_id, pad_id=0)
        ids, labels = ds.expand_sample(ids, labels, cfg.image_tokens_per_group,
                                       [audio_token_count(len(feats))])
        sz = cfg.vision.image_size
        tile = rng.integers(0, 256, (sz, sz, 3), dtype=np.uint8)
        self.samples.append({"modality": "image", "images": image.normalize([tile]),
                             "audio": feats, "input_ids": ids, "labels": labels})
        self.lengths = [-len(s["input_ids"]) for s in self.samples[:-1]] + [
            len(self.samples[-1]["input_ids"])]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def modality_lengths(self):
        return self.lengths


def train_phase(card: str, device):
    """Trainer over SmokeData on the full-width slice, stage 2 (the LLM and
    both projectors train, the towers are frozen) with a warm-up of one
    step, batch size 1: one step per sample. Checks the path's kernels
    launched, a batch reached TRAIN_TOP_BUCKET, the losses are finite,
    every trainable component changed and the frozen towers did not
    (bitwise). Returns the launch counts."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.data.dataset import Collator
    from vita_tpu_torch.train.step import TrainConfig, tree_leaves
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    cfg = train_slice_config()
    on_card = device.type == "cuda"
    params = slice_params(cfg, device)
    before = {p: w.detach().to("cpu", copy=True) for p, w in tree_leaves(params)}
    data = SmokeData(cfg, TRAIN_DIR)
    seqs = []
    collate = Collator(pad_id=0)

    def collator(samples):
        batch = collate(samples)
        seqs.append((batch["input_ids"].shape[1], int(batch["attn_valid"].sum())))
        return batch

    tc = dataclasses.replace(TrainConfig.stage2_finetune(), warmup_steps=1)
    run = RunConfig(output_dir=os.path.join(TRAIN_DIR, "run"), batch_size=1,
                    save_every_steps=10 ** 9, loader_workers=2, resume=False)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer = Trainer(cfg, tc, run, params)
    log = trainer.train(data, collator)
    _sync(device)
    counts = dict(kernels.launches)
    print(f"  kernel launches in the training run: {counts}", flush=True)
    # one timed run per step; a step's time includes the first launches at
    # its bucket's shapes, so the second step at the top bucket is the warm one
    for m, (seq, real) in zip(log, seqs):
        print(f"  step {m['step']}: bucket {seq:5d} ({real:5d} real tokens), loss {m['loss']:.4f}"
              f" (ce {m['ce']:.4f}, aux {m['aux']:.4f}), step {m['step_time'] * 1e3:9.2f} ms, "
              f"{real / m['step_time']:9.1f} real tokens/s ({seq / m['step_time']:9.1f} bucket "
              f"positions/s)  [{card}]", flush=True)
    if on_card:
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
              f"[{card}]", flush=True)
    missing = [k for k in TRAIN_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"training: kernels never launched on its path: {missing}")
    if len(log) != len(data) or not all(np.isfinite(m["loss"]) for m in log):
        raise AssertionError(f"training: {len(log)} steps, losses {[m['loss'] for m in log]}")
    if max(seq for seq, _ in seqs) != TRAIN_TOP_BUCKET:
        raise AssertionError(f"training: no batch reached the {TRAIN_TOP_BUCKET} bucket: {seqs}")
    changed = {}
    for p, w in tree_leaves(params):
        n = int((w.detach().cpu() != before[p]).sum())
        changed[p[0]] = changed.get(p[0], 0) + n
        if not w.requires_grad and n:
            raise AssertionError(f"training: frozen {'/'.join(p)} changed in {n} elements")
    print(f"  elements changed per component: {changed}", flush=True)
    for comp in ("llm", "vision_proj", "audio_proj"):
        if changed[comp] == 0:
            raise AssertionError(f"training: trainable {comp} did not change")
    del trainer, params, before
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return counts


def train_cli_phase():
    """python -m vita_tpu_torch.train.cli --model tiny-random --moe-mode gmm
    on the card, in process, over a text sample and an audio sample."""
    from vita_tpu_torch import kernels
    from vita_tpu_torch.train import cli

    directory = os.path.join(TRAIN_DIR, "cli")
    os.makedirs(directory, exist_ok=True)
    wav = write_wav(os.path.join(directory, "q.wav"), 1.0, SEED + 1)
    chat = os.path.join(directory, "chat.json")
    with open(chat, "w") as f:
        json.dump([{"conversations": [{"from": "human", "value": "<audio>\n"},
                                      {"from": "gpt", "value": "a sound"}], "audio": wav},
                   {"conversations": _turns(np.random.default_rng(SEED), 40)}] * 2, f)
    kernels.reset_launches()
    rc = cli.main(["--model", "tiny-random", "--data", chat, "--output-dir",
                   os.path.join(directory, "run"), "--batch-size", "2", "--no-resume",
                   "--moe-mode", "gmm"])
    counts = dict(kernels.launches)
    print(f"  kernel launches in the train CLI run: {counts}", flush=True)
    if rc != 0 or min(counts["gmm_wgrad"], counts["gmm_small"]) == 0:
        raise AssertionError(f"train CLI: exit code {rc}, launches {counts}")
    return counts


# Router near ties: the card's and the CPU's float32 router probabilities
# differ by about 1e-7; a token whose k-th and (k+1)-th expert
# probabilities lie within ROUTE_NEAR_TIE may pick another expert on the
# other device, which changes its gradients by O(1).
ROUTE_NEAR_TIE = 1e-5
# per leaf, max |g_cuda - g_cpu| <= GRAD_TOL * max |g_cpu|: float32 sums in
# another order (kernels, cuBLAS and the CPU's BLAS) differ by about 1e-6
# relative per op, which a 2-layer forward and backward compound to about
# 1e-5; a wrong kernel is off by O(1)
GRAD_TOL = 1e-3
# per step, |loss_cuda - loss_cpu| <= LOSS_RTOL * |loss_cpu|: the loss is a
# mean over a few hundred tokens; after an update Adam may move a weight
# whose gradient is at rounding level by up to 2 lr differently on the two
# devices, which moves that mean far less than this
LOSS_RTOL = 1e-4


def train_equivalence_phase(devices, steps=3):
    """Three train steps (stage 2, gmm MoE, flash attention) of the narrow
    fp32 config on each device from the same weights and batches; the last
    device is the reference. Compares each step's loss and the first
    step's gradient of every trainable leaf. A router near tie
    (ROUTE_NEAR_TIE) in the reference's step i excuses step i and the
    steps after it, whose weights it moved; never an earlier step."""
    import torch

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.ops import moe
    from vita_tpu_torch.train import step
    from vita_tpu_torch.tokenization import AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX

    base = narrow_config()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, moe_mode="gmm"))
    params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    rng = np.random.default_rng(SEED + 3)
    sz, n_img = cfg.vision.image_size, cfg.image_tokens_per_group
    batches = []
    for _ in range(steps):
        ids = rng.integers(3, cfg.llm.vocab_size, (2, 256)).astype(np.int32)
        ids[0, 4:4 + n_img] = IMAGE_TOKEN_INDEX
        ids[0, 6 + n_img:13 + n_img] = AUDIO_TOKEN_INDEX  # 7 slots: 60 fbank frames
        im, am = ids == IMAGE_TOKEN_INDEX, ids == AUDIO_TOKEN_INDEX
        valid = np.ones((2, 256), bool)
        valid[1, 200:] = False
        batches.append({
            "input_ids": np.where(im | am, 0, ids), "labels": np.where(im | am | ~valid, -100, ids),
            "image_mask": im, "audio_mask": am, "attn_valid": valid,
            "images": rng.standard_normal((2, sz, sz, 3)).astype(np.float32),
            "speech": rng.standard_normal((2, 60, 80)).astype(np.float32),
            "speech_lengths": np.array([60, 60], np.int32)})
    tc = step.TrainConfig(learning_rate=1e-3, projector_lr=1e-2, warmup_steps=1, total_steps=10)
    gaps, runs = [], []  # gaps: per reference step, its router gaps
    real_route = moe.route_topk

    def recording_route(logits, k):
        out = real_route(logits, k)
        top = torch.topk(out[2].detach(), k + 1, dim=-1).values
        gaps[-1].append(float((top[:, k - 1] - top[:, k]).min()))
        return out

    for dev in devices:
        p = _to(params, dev)
        opt = step.make_optimizer(tc, p)
        state = opt.init(p)
        grads, real_update = [], opt.update

        def recording_update(params, g, state, real_update=real_update, grads=grads):
            if not grads:
                grads.append({k: v.detach().cpu() for k, v in g.items()})
            return real_update(params, g, state)

        opt.update = recording_update
        fn = step.make_train_step(cfg, tc, opt)
        reference = dev is devices[-1]
        if reference:
            moe.route_topk = recording_route
        try:
            losses = []
            for b in batches:
                if reference:
                    gaps.append([])
                losses.append(float(fn(p, state, b)[2]["loss"]))
        finally:
            moe.route_topk = real_route
        runs.append((losses, grads[0]))
    (losses, grads), (ref_losses, ref_grads) = runs
    step_gaps = [min(g) for g in gaps]
    tied = [i for i, g in enumerate(step_gaps) if g <= ROUTE_NEAR_TIE]
    first_tie = tied[0] if tied else steps
    worst = max((float((grads[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)), "/".join(k))
                for k, g in ref_grads.items())
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"  losses {devices[0]} {losses} vs {devices[-1]} {ref_losses}: rel errs "
          f"{[f'{e:.3e}' for e in loss_errs]} (tol {LOSS_RTOL}); first step's worst leaf "
          f"gradient rel err {worst[0]:.3e} ({worst[1]}, tol {GRAD_TOL}); reference's smallest "
          f"router gap per step {[f'{g:.3e}' for g in step_gaps]} (near tie <= {ROUTE_NEAR_TIE})",
          flush=True)
    bad = [f"step {i + 1} loss" for i, e in enumerate(loss_errs[:first_tie]) if e > LOSS_RTOL]
    if first_tie > 0 and worst[0] > GRAD_TOL:
        bad.append("step 1 gradients")
    if bad:
        raise AssertionError(f"training steps differ on {devices}: {bad}")
    if first_tie < steps:
        print(f"  steps {first_tie + 1}-{steps} not compared: the reference's router had a near "
              f"tie in step {first_tie + 1}", flush=True)


# --------------------------------------------------------------------------
# phase 8: export and reload the 2-layer slice, then serve from it
# --------------------------------------------------------------------------
# (label, Engine options, the kernels the run must launch)
CHECKPOINT_RUNS = (
    ("bf16 experts", dict(n_slots=4, page_size=64, decode_moe_mode="gather"),
     ("paged_attention", "gather_expert_ffn", "masked_expert_ffn", "gmm_small")),
    ("int8 experts, int8 KV pages",
     dict(n_slots=4, page_size=128, decode_moe_mode="gather_q", kv_int8=True),
     ("paged_attention_q", "gather_expert_ffn_q", "masked_expert_ffn_q", "gmm_small")),
)


def checkpoint_requests(cfg, max_new_tokens: int = 16):
    """A text request alone (decode T 1: the gather schedule), then the
    image+audio request with two text requests (3 slots, padded to T 4:
    the masked schedule)."""
    rng = np.random.default_rng(SEED + 8)
    return [[text_request(cfg, rng, 100, max_new_tokens)],
            [media_request(cfg, rng, max_new_tokens)]
            + [text_request(cfg, rng, n, max_new_tokens) for n in (60, 150)]]


def checkpoint_phase(card: str, device):
    """Export the full-width slice with the LLM cut to 2 of 32 layers
    (bf16, random weights from the seed) with export_hf_vita_checkpoint
    under build/smoke_ckpt/, load it onto the card with
    load_vita_checkpoint, hold every leaf bitwise to the weights it was
    written from, then serve CHECKPOINT_RUNS (gmm prefill) from the loaded
    weights and from the in-memory ones under the loaded config: the
    greedy streams must be identical and each run's kernels launch.
    Returns the launch counts of the runs on the loaded weights."""
    import shutil

    import torch

    from vita_tpu_torch import checkpoint, kernels
    from vita_tpu_torch.serve.engine import Engine
    from vita_tpu_torch.train.step import tree_leaves

    cfg = slice_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, n_layers=2))
    params = slice_params(cfg, device)
    n_params = sum(x.numel() for x in _leaves(params))
    path = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    need = 4 * n_params + 2**30  # float32 weights and a GiB of headroom
    free = shutil.disk_usage(path).free
    if free < need:
        raise RuntimeError(f"exporting {n_params:.4g} parameters needs {need / 2**30:.1f} GiB "
                           f"free under {path}, found {free / 2**30:.1f} GiB")
    try:
        t0 = time.time()
        checkpoint.export_hf_vita_checkpoint(path, cfg, params)
        os.sync()
        written = time.time() - t0
        n_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(path) for f in files)
        t0 = time.time()
        lcfg, loaded = checkpoint.load_vita_checkpoint(path, device)
        _sync(device)
        read = time.time() - t0
        print(f"  exported {n_params:.4g} parameters, {n_bytes} bytes, in {written:.1f} s; "
              f"loaded onto the card in {read:.1f} s  [{card}]", flush=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    def dims(c):
        return (c.llm.vocab_size, c.llm.d_model, c.llm.n_layers, c.llm.n_heads, c.llm.n_kv_heads,
                c.llm.d_ff, c.llm.n_experts, c.llm.top_k, c.vision.image_size, c.vision.hidden,
                c.vision.n_layers, c.audio.hidden, c.audio.n_layers, c.llm.dtype)

    if dims(lcfg) != dims(cfg):
        raise AssertionError(f"loaded config {lcfg} does not hold the exported {cfg}")
    got, want = dict(tree_leaves(loaded)), dict(tree_leaves(params))
    if got.keys() != want.keys():
        raise AssertionError(f"loaded leaves {sorted(set(got) ^ set(want))} differ by name")
    bad = [k for k, w in want.items() if got[k].dtype != w.dtype or not torch.equal(got[k], w)]
    if bad:
        raise AssertionError(f"{len(bad)} loaded leaves differ from the exported weights: "
                             f"{bad[:4]}")
    print(f"  {len(want)} leaves bitwise equal to the exported weights", flush=True)

    total = {}
    for label, options, path_kernels in CHECKPOINT_RUNS:
        streams = []
        for source, weights in (("loaded", loaded), ("in-memory", params)):
            engine = Engine(weights, lcfg, max_len=2048, device=device, prefill_moe_mode="gmm",
                            **options)
            kernels.reset_launches()
            reqs = [r for wave in checkpoint_requests(lcfg) for r in serve(engine, wave)]
            counts = dict(kernels.launches)
            streams.append([r.tokens for r in reqs])
            if source == "loaded":
                print(f"  kernel launches serving {label} from the checkpoint: {counts}",
                      flush=True)
                missing = [k for k in path_kernels if counts[k] == 0]
                if missing:
                    raise AssertionError(f"{label} from the checkpoint: kernels never "
                                         f"launched: {missing} ({counts})")
                for k, n in counts.items():
                    total[k] = total.get(k, 0) + n
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        if streams[0] != streams[1] or any(len(t) != 16 for t in streams[0]):
            raise AssertionError(f"{label}: the loaded weights' greedy streams {streams[0]} "
                                 f"differ from the in-memory weights' {streams[1]}")
        print(f"  {label}: {len(streams[0])} requests, greedy streams from the checkpoint "
              f"identical to the in-memory weights' (first: {streams[0][0][:6]}...)",
              flush=True)
    return total


# --------------------------------------------------------------------------
# phase 9: multi-turn and duplex serving on the card
# --------------------------------------------------------------------------
# the kernels phase 9 must launch
SESSION_PATH = ("flash_fwd", "paged_attention", "gather_expert_ffn", "masked_expert_ffn",
                "paged_attention_q", "gather_expert_ffn_q", "masked_expert_ffn_q")
# the Whale streaming encoder against its own forward under the matching
# chunk mask, both bf16 on the card through 24 layers: max |error| within
# 64 bf16 units of roundoff (2^-8) of the layer-normed outputs, and the
# cosine of the two feature matrices at least 0.999
STREAM_ATOL = 64 * 2.0 ** -8
STREAM_COS = 0.999


@contextlib.contextmanager
def _recording_q_offsets(offsets):
    """While open, every B1 launch appends its q_offset (row 0) to
    ``offsets``."""
    from vita_tpu_torch.ops import flash_attention as fa

    real = fa.flash_fwd_cuda

    def fwd(q, k, v, kv_len, q_offset, *a):
        offsets.append(int(q_offset[0]))
        return real(q, k, v, kv_len, q_offset, *a)

    fa.flash_fwd_cuda = fwd
    try:
        yield
    finally:
        fa.flash_fwd_cuda = real


@contextlib.contextmanager
def _recording_offsets(engine, offsets):
    """While open, every prefill ``engine`` starts appends the offset it
    starts at (the reused rows) to ``offsets``."""
    start = engine._start_prefill

    def spy(slot, req, pages):
        start(slot, req, pages)
        offsets.append(engine._prefill_jobs[-1].offset)

    engine._start_prefill = spy
    try:
        yield
    finally:
        engine._start_prefill = start


@contextlib.contextmanager
def _recording_first_top2(store):
    """While open, every prefill sample of the Engine appends (first,
    second, gap) of its logits row to ``store``: the last entry of a
    request's prefill is the one its first token came from."""
    import torch

    from vita_tpu_torch.serve import engine as engine_mod

    real = engine_mod.sample_tokens

    def sample(logits, *a, **k):
        v, i = torch.topk(logits[0].float(), 2)
        store.append((int(i[0]), int(i[1]), float(v[0] - v[1])))
        return real(logits, *a, **k)

    engine_mod.sample_tokens = sample
    try:
        yield
    finally:
        engine_mod.sample_tokens = real


def session_turns(cfg, seed, n_text=300, new_tokens=16, frames=400):
    """Three turns of one session, each a function of the earlier answers
    giving a Request: (1) a text prompt; (2) it, its answer, then text, an
    image, an audio clip and text; (3) turn 2's prompt with another image
    in the same span, its answer and text. With 256-row prefill chunks the
    reuse of turn 2 (315 rows shared) and of turn 3 (stopped by the image
    digest at the image's start, 336) is 256 rows, all of them prompt rows
    computed by prefill."""
    from vita_tpu_torch.serve.engine import Request
    from vita_tpu_torch.tokenization import audio_token_count

    rng = np.random.default_rng(seed)
    vocab = cfg.llm.vocab_size
    ids1 = rng.integers(3, vocab, n_text).astype(np.int32)
    n_img, n_aud = cfg.image_tokens_per_group, audio_token_count(frames)
    sz = cfg.vision.image_size
    tiles = [rng.standard_normal((1, sz, sz, 3)).astype(np.float32) for _ in range(2)]
    speech = rng.standard_normal((frames, cfg.audio.input_dim)).astype(np.float32)
    head, tail = rng.integers(3, vocab, 20), rng.integers(3, vocab, 40)
    more = rng.integers(3, vocab, 30).astype(np.int32)

    def media_prompt(answer1, tile):
        ids = np.concatenate([ids1, answer1, head, np.zeros(n_img + n_aud, np.int32), tail])
        im, am = np.zeros(len(ids), bool), np.zeros(len(ids), bool)
        a = len(ids1) + len(answer1) + len(head)
        im[a:a + n_img] = True
        am[a + n_img:a + n_img + n_aud] = True
        return ids.astype(np.int32), im, am, tile

    def request(ids, im=None, am=None, tile=None):
        media = {} if tile is None else dict(image_mask=im, audio_mask=am, images=tile,
                                             speech=speech, speech_length=frames)
        return Request(input_ids=ids, max_new_tokens=new_tokens, eos_id=-1, **media)

    def turn1(answers):
        return request(ids1)

    def turn2(answers):
        return request(*media_prompt(np.asarray(answers[0], np.int32), tiles[0]))

    def turn3(answers):
        ids, im, am, _ = media_prompt(np.asarray(answers[0], np.int32), tiles[1])
        ids = np.concatenate([ids, np.asarray(answers[1], np.int32), more])
        pad = np.zeros(len(ids) - len(im), bool)
        return request(ids, np.concatenate([im, pad]), np.concatenate([am, pad]), tiles[1])

    return [turn1, turn2, turn3]


def _first_split(got, ref, top2, rid, near_tie):
    """None when the streams are equal; else the step where ``got`` leaves
    ``ref`` if the reference's top two logits there were the two tokens
    within ``near_tie``; raises otherwise."""
    if got == ref:
        return None
    j = next((j for j, (x, y) in enumerate(zip(got, ref)) if x != y), min(len(got), len(ref)))
    t1, t2, gap = top2.get((rid, j), (None, None, None))
    if near_tie > 0 and j < min(len(got), len(ref)) and (t1, t2) == (ref[j], got[j]) \
            and gap <= near_tie:
        print(f"    splits at token {j}: {got[j]} vs {ref[j]}, a near tie (reference's "
              f"top-2 gap {gap:.3e} <= {near_tie}); compared up to it", flush=True)
        return j
    raise AssertionError(f"streams differ at token {j}: {got[j:j + 4]} vs {ref[j:j + 4]}; "
                         f"reference's top two there {(t1, t2)}, gap {gap}")


def serve_session(card, engine, turns, label, cold=None, wave=4):
    """The turns of one session on ``engine`` (session key 's'), each
    alone; with ``cold`` (an Engine without session keys), each turn's
    prompt also there, and the streams compared up to a near tie of the
    cold run. Prints and checks per turn the reuse offset, the reused
    rows and B1's q_offsets; then a wave of ``wave`` other sessions'
    first turns (decode batch ``wave``). Returns the offsets."""
    answers, offsets = [], []
    with _recording_offsets(engine, offsets):
        for k, make in enumerate(turns, 1):
            req = make(answers)
            req.session_key = "s"
            rows0 = engine.stats()["reused_prefix_rows"]
            n_off = len(offsets)
            q_offs = []
            t0 = time.time()
            with _recording_q_offsets(q_offs):
                serve(engine, [req])
            wall = time.time() - t0
            off = offsets[n_off]
            rows = engine.stats()["reused_prefix_rows"] - rows0
            tokens = req.tokens
            if len(tokens) != req.max_new_tokens or not all(
                    0 <= x < engine.cfg.llm.vocab_size for x in tokens):
                raise AssertionError(f"{label} turn {k}: tokens {tokens}")
            print(f"  {label} turn {k}: prompt {len(req.input_ids)}, reused offset {off}, "
                  f"reused_prefix_rows +{rows:.0f}, B1 q_offsets {sorted(set(q_offs))}, "
                  f"TTFT {req.ttft_s * 1e3:.2f} ms, wall {wall * 1e3:.1f} ms  [{card}]",
                  flush=True)
            if rows != off or (k > 1 and (off <= 0 or min(q_offs) != off)):
                raise AssertionError(f"{label} turn {k}: offset {off}, reused rows {rows}, "
                                     f"B1 q_offsets {q_offs}")
            if cold is not None:
                top2, first = {}, []
                ref = make(answers)
                with _recording_top2(cold, top2), _recording_first_top2(first):
                    serve(cold, [ref])
                top2[(ref.request_id, 0)] = first[-1]
                split = _first_split(tokens, ref.tokens, top2, ref.request_id, NEAR_TIE)
                print(f"    cold Engine on the same prompt: TTFT {ref.ttft_s * 1e3:.2f} ms, "
                      f"{'identical stream' if split is None else f'equal up to token {split}'}"
                      f"  [{card}]", flush=True)
            answers.append(tokens)
        # long enough that all of them decode together (T 4: the masked plan)
        rng = np.random.default_rng(SEED + 9)
        reqs = [text_request(engine.cfg, rng, 100, 32) for _ in range(wave)]
        for i, r in enumerate(reqs):
            r.session_key = f"w{i}"
        serve(engine, reqs)
    return offsets


def session_equivalence(devices):
    """The three turns (narrow fp32 config, int8 experts, int8 KV pages,
    prefill chunk 128) on each device with session reuse; the last device
    is the reference. Each turn's stream must equal the reference's up to
    a near tie of the reference (NEAR_TIE); the offsets must agree while
    the streams do."""
    import torch

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.serve.engine import Engine

    cfg = narrow_config()
    params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    runs = []
    for dev in devices:
        engine = Engine(_to(params, dev), cfg, n_slots=2, max_len=1024, page_size=64,
                        prefill_chunk=128, decode_moe_mode="gather_q", kv_int8=True, device=dev)
        top2, first, answers, offsets, rids = {}, [], [], [], []
        for make in session_turns(cfg, SEED + 10, n_text=150, frames=40):
            req = make(answers)
            req.session_key = "s"
            with (_recording_offsets(engine, offsets), _recording_top2(engine, top2),
                  _recording_first_top2(first)):
                serve(engine, [req])
            top2[(req.request_id, 0)] = first[-1]
            answers.append(req.tokens)
            rids.append(req.request_id)
        runs.append((answers, offsets, top2, rids))
    (got, got_off, _, _), (ref, ref_off, top2, rids) = runs[0], runs[-1]
    for k, (a, b) in enumerate(zip(got, ref)):
        split = _first_split(a, b, top2, rids[k], NEAR_TIE)
        if split is not None:
            break
        if got_off[k] != ref_off[k]:
            raise AssertionError(f"turn {k + 1}: offset {got_off[k]} vs {ref_off[k]}")
    print(f"  int8 session reuse on {devices}, narrow fp32: offsets {got_off} (reference "
          f"{ref_off}); streams equal{'' if split is None else ' up to a near tie'}",
          flush=True)
    if max(ref_off) <= 0:
        raise AssertionError("no turn reused a prefix")


def letter_decode(ids):
    """Every id as one lowercase letter: with random weights the byte
    tokenizer's decode is almost always empty, and the duplex gate decides
    on the first visible text."""
    return "".join(chr(97 + t % 26) for t in ids)


def duplex_run(card, cfg, params, max_new_tokens=256):
    """DuplexWebApp on two Engines over the slice weights (gmm prefill,
    gather decode), streaming Whale encode on the card: the synthetic
    session of duplex_demo.synth_session through feed_pcm/drain_audio,
    without real-time sleeps (the second utterance waits only for the
    first answer's gate). Checks 2 utterances (the noise rejected by the
    VAD), an interrupt with a role swap, the interrupted request cancelled
    and its engine's pages back in the pool, and each utterance's streamed
    features against whale.forward under the matching chunk mask."""
    import torch

    from vita_tpu_torch.cli import ByteTokenizer
    from vita_tpu_torch.data.audio import fbank
    from vita_tpu_torch.models import whale
    from vita_tpu_torch.serve.duplex_demo import synth_session
    from vita_tpu_torch.serve.duplex_http import DuplexWebApp

    tok = ByteTokenizer()
    gcfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, moe_mode="gmm"))
    t0 = time.time()
    app = DuplexWebApp(params, gcfg, tok.encode, letter_decode, tok.bos_id, -1,
                       max_new_tokens=max_new_tokens, max_len=2048, tts=False)
    print(f"  duplex app with two Engines warm in {time.time() - t0:.1f} s  [{card}]", flush=True)
    utts, queries, events, swaps = [], [], [], []
    process, submit, emit, promote = (app._frontend.process, app.ctl.submit_query, app._emit,
                                      app.ctl._promote)

    def timed_process(chunk):
        t = time.time()
        out = process(chunk)
        if out is not None:
            utts.append((t, out))
        return out

    def timed_emit(type_, **kw):
        events.append((type_, time.time()))
        return emit(type_, **kw)

    def timed_promote(request):
        promote(request)
        swaps.append((request, time.time(), app.ctl.generator_idx))

    app._frontend.process, app._emit, app.ctl._promote = timed_process, timed_emit, timed_promote
    app.ctl.submit_query = lambda r: (queries.append(r), submit(r))[1]
    try:
        chunks = synth_session()
        t_feed = time.time()
        for chunk in chunks:
            app.feed_pcm(chunk)
            if not app.drain_audio(120):
                raise AssertionError("audio worker stuck")
            # the second utterance must find the first answer promoted
            t_gate = time.time()
            while len(queries) == 1 and app.ctl.current is None and time.time() - t_gate < 60:
                time.sleep(0.001)
        fed = time.time() - t_feed
        pcm = np.concatenate(chunks)
        deadline = time.time() + 120
        while time.time() < deadline and not all(r.finish_time > 0 for r in queries):
            time.sleep(0.01)
        for e in app.engines:
            while e.active_count() or e._prefill_jobs or not e.queue.empty():
                time.sleep(0.01)
    finally:
        app.close()
    ctl = app.ctl
    print(f"  {len(pcm) / 16000:.1f} s of audio fed in {fed:.2f} s; utterances "
          f"{app.n_utterances}, interrupts {ctl.interrupts}, gate rejections "
          f"{ctl.rejected_noise}, generator engine {ctl.generator_idx}", flush=True)
    if app.n_utterances != 2 or len(queries) != 2:
        raise AssertionError(f"{app.n_utterances} utterances segmented, expected 2 "
                             "(the noise must not form one)")
    r1, r2 = queries
    if ctl.interrupts < 1 or len(swaps) < 2 or swaps[0][2] == swaps[1][2]:
        raise AssertionError(f"no interrupt with a role swap: {ctl.interrupts}, "
                             f"{[(s[0].request_id, s[2]) for s in swaps]}")
    if not r1.cancelled or len(r1.tokens) >= max_new_tokens:
        raise AssertionError(f"the first answer was not interrupted: {len(r1.tokens)} tokens")
    if len(r2.tokens) != max_new_tokens:
        raise AssertionError(f"the second answer has {len(r2.tokens)} tokens")
    for i, e in enumerate(app.engines):
        st = e.stats()
        if st["free_pages"] != st["total_pages"] or st["active"]:
            raise AssertionError(f"engine {i} holds pages after the drain: {st}")
    print(f"  first answer interrupted after {len(r1.tokens)} tokens and cancelled; both "
          f"page pools full again", flush=True)
    # a query's first text follows its promotion (the other answer may
    # still be streaming between its speech end and then)
    texts = [t for kind, t in events if kind == "text"]
    for k, ((t_end, _), (_, t_swap, _)) in enumerate(zip(utts, swaps)):
        first = min((t for t in texts if t >= t_swap), default=float("nan"))
        print(f"  utterance {k + 1}: speech end -> first text {(first - t_end) * 1e3:.1f} ms  "
              f"[{card}]", flush=True)
    print(f"  interrupt -> role swap (second speech end to the swap): "
          f"{(swaps[1][1] - utts[1][0]) * 1e3:.1f} ms  [{card}]", flush=True)

    dev = params["audio"]["cmvn"]["mean"].device
    for k, (_, utt) in enumerate(utts):
        feats = fbank(utt.wav)
        outs, tail, n = [], 0, feats.shape[0]
        for lo in range(0, n, 64):
            m = min(64, n - lo)
            t_out = max(int(whale.subsampled_length(tail + m)), 0)
            outs.append(t_out)
            tail = min(tail + m - 4 * t_out, whale.TAIL_MAX)
        full_t = int(whale.subsampled_length(n))
        bounds = np.cumsum(outs)
        mask = np.zeros((full_t, full_t), bool)
        for qi in range(full_t):
            ci = int(np.searchsorted(bounds, qi, side="right"))
            mask[qi, :bounds[min(ci, len(bounds) - 1)]] = True
        with torch.no_grad():
            want, _ = whale.forward(params["audio"], cfg.audio,
                                    torch.from_numpy(feats[None]).to(dev),
                                    torch.tensor([n], device=dev),
                                    torch.from_numpy(mask).to(dev))
        want = want[0, :sum(outs)].float().cpu().numpy()
        got = utt.features
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
        print(f"  utterance {k + 1}: {n} fbank frames -> {got.shape[0]} streamed features; "
              f"vs forward with the chunk mask: max |err| {err:.4f} (limit {STREAM_ATOL:.4f}), "
              f"cosine {cos:.6f} (limit {STREAM_COS})", flush=True)
        if not np.isfinite(got).all() or err > STREAM_ATOL or cos < STREAM_COS:
            raise AssertionError(f"utterance {k + 1}: streamed features off the forward")


def http_run(card, engine):
    """The port's ServingApp on 127.0.0.1 (an ephemeral port) over
    ``engine``: two /v1/generate turns of one session_id, then a streamed
    /v1/chat/completions; /stats must show the second turn's reuse."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from vita_tpu_torch.cli import ByteTokenizer
    from vita_tpu_torch.serve.http_server import ServingApp, make_handler

    tok = ByteTokenizer()
    app = ServingApp(engine, engine.cfg, tok.encode, tok.decode, tok.bos_id, -1,
                     image_size=engine.cfg.vision.image_size)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers.get("Content-Type"), r.read()

    def stats():
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            return json.loads(r.read())

    try:
        before = stats()["reused_prefix_rows"]
        for k, prompt in enumerate(("Tell me about the weather on the coast today.",
                                    "And tomorrow?"), 1):
            t0 = time.time()
            post("/v1/generate", {"prompt": prompt, "session_id": "http", "max_tokens": 16})
            print(f"  POST /v1/generate turn {k}: {(time.time() - t0) * 1e3:.1f} ms, "
                  f"reused_prefix_rows {stats()['reused_prefix_rows'] - before:.0f}  [{card}]",
                  flush=True)
        ctype, body = post("/v1/chat/completions",
                           {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 16,
                            "stream": True})
        events = [e for e in body.decode().split("\n\n") if e.startswith("data: ")]
        last = json.loads(events[-2][6:]) if len(events) >= 2 else {}
        reused = stats()["reused_prefix_rows"] - before
    finally:
        server.shutdown()
        app.thread.stop()
        app.thread.join(timeout=60)
    print(f"  streamed /v1/chat/completions: {ctype}, {len(events)} SSE events, finish "
          f"{last.get('choices', [{}])[0].get('finish_reason')}", flush=True)
    if (ctype != "text/event-stream" or events[-1] != "data: [DONE]"
            or last["choices"][0]["finish_reason"] != "length" or reused <= 0):
        raise AssertionError(f"HTTP run: {ctype}, {events[-2:]}, reused rows {reused}")


def session_phase(card, cfg, params, device):
    """Phase 9 on phase 3's full-width weights: (a) the session turns on a
    bf16 Engine against a cold Engine and on an int8-expert int8-KV Engine,
    then the int8 reuse Engine on the card against the CPU (narrow fp32);
    (b) the HTTP server over the bf16 Engine; (c) the duplex app. Returns
    the launch counts of the phase."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.serve.engine import Engine

    kernels.reset_launches()
    kw = dict(max_len=2048, n_slots=4, prefill_chunk=256, device=device)
    turns = session_turns(cfg, SEED + 9)
    print("  (a) session KV-prefix reuse, bf16 experts and pages", flush=True)
    bf16 = Engine(params, cfg, page_size=64, decode_moe_mode="gather", **kw)
    cold = Engine(params, cfg, page_size=64, decode_moe_mode="gather", **kw)
    for e in (bf16, cold):  # first-use costs out of the TTFT readings
        e.warmup(prompt_lens=(512, 1024), media=True, max_new_tokens=2)
    serve_session(card, bf16, turns, "bf16", cold=cold)
    del cold
    print("  (a) session KV-prefix reuse, int8 experts and int8 KV pages", flush=True)
    q8 = Engine(params, cfg, page_size=128, decode_moe_mode="gather_q", kv_int8=True, **kw)
    serve_session(card, q8, turns, "int8")
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    session_equivalence([torch.device("cuda"), torch.device("cpu")])
    print("  (b) the HTTP server over the bf16 Engine", flush=True)
    http_run(card, bf16)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    print("  (c) duplex serving: two Engines, streaming Whale encode", flush=True)
    duplex_run(card, cfg, params)
    counts = dict(kernels.launches)
    print(f"  kernel launches in phase 9: {counts}", flush=True)
    missing = [k for k in SESSION_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"phase 9: kernels never launched on its path: {missing}")
    return counts


# --------------------------------------------------------------------------
# phase 10: the rest of the model registry at full width
# --------------------------------------------------------------------------
# (label, tower key, projector, Whale backend): each tower at its published
# width, bf16
TOWER_RUNS = (
    ("SigLIP-so400m-patch14-384 (27 x 1152, 729 tokens) + mlp2x_gelu", "siglip", "mlp2x_gelu",
     "xla"),
    ("CLIP ViT-L/14-336 (24 x 1024, 576 tokens) + ldp (144)", "clip", "ldp", "xla"),
    ("EVA02-L/14-336 (23 x 1024, 576 tokens) + spp_v1 (144), Whale flash", "eva", "spp_v1",
     "flash"),
)
# the kernels each tower Engine must launch: B1, B2, B3, B4, B5b
TOWER_PATH = ("flash_fwd", "paged_attention", "gather_expert_ffn", "masked_expert_ffn",
              "gmm_small")
# Whale's clips for the flash-vs-xla comparison: (seconds, fbank frames)
WHALE_CLIPS = ((4, 400), (30, 3000), (120, 12000))


def _tower_config(tower: str, dtype, tiny: bool = False):
    from vita_tpu_torch.models import clip, eva_clip, siglip

    cls = {"clip": clip.CLIPConfig, "siglip": siglip.SigLIPConfig,
           "eva": eva_clip.EVAConfig}[tower]
    return cls.tiny(dtype=dtype) if tiny else cls(dtype=dtype)


def _launches():
    from vita_tpu_torch import kernels

    return dict(kernels.launches), dict(kernels.launch_keys)


def _delta(before):
    after = _launches()
    return tuple({k: v - b.get(k, 0) for k, v in a.items()} for a, b in zip(after, before))


def whale_flash_run(card, cfg, params, device):
    """Whale at full width (24 x 1024, 16 heads of 64, bf16) on clips of 4,
    30 and 120 s under attn_backend 'flash' and 'xla': the features agree
    on the valid rows (STREAM_ATOL, STREAM_COS), each forward's CUDA-event
    time is printed, and a flash forward launches B1 24 times, at d 65."""
    import torch

    from vita_tpu_torch.models import whale

    acfg = {b: dataclasses.replace(cfg.audio, attn_backend=b) for b in ("flash", "xla")}
    d_key = f"flash_fwd:d{cfg.audio.head_dim + 1}"
    rng = np.random.default_rng(SEED + 10)
    for seconds, frames in WHALE_CLIPS:
        speech = torch.from_numpy(rng.standard_normal((1, frames, cfg.audio.input_dim),
                                                      np.float32)).to(device)
        lens = torch.tensor([frames], device=device)
        outs, ms = {}, {}
        with torch.no_grad():
            for b in ("flash", "xla"):
                before = _launches()
                outs[b], valid = whale.forward(params["audio"], acfg[b], speech, lens)
                torch.cuda.synchronize()
                counts, keys = _delta(before)
                want = (cfg.audio.n_layers, {d_key: cfg.audio.n_layers}) \
                    if b == "flash" else (0, {})
                got = (counts["flash_fwd"], {k: v for k, v in keys.items() if v})
                if got != want:
                    raise AssertionError(f"Whale {b}, {seconds} s: B1 launches {got}, "
                                         f"expected {want}")
                ms[b] = cuda_ms(lambda b=b: whale.forward(params["audio"], acfg[b], speech,
                                                          lens), n=10, warmup=1)
        v = valid[0]
        got, want = (outs[b][0, v].float().cpu().numpy() for b in ("flash", "xla"))
        err = float(np.abs(got - want).max())
        cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
        print(f"  Whale {seconds:3d} s ({frames} frames, T' {int(v.sum())}): flash "
              f"{ms['flash']:.3f} ms, xla {ms['xla']:.3f} ms a forward; flash vs xla max |err| "
              f"{err:.4f} (limit {STREAM_ATOL:.4f}), cosine {cos:.6f} (limit {STREAM_COS}); B1 "
              f"{cfg.audio.n_layers} launches a flash forward ({d_key})  [{card}]", flush=True)
        if not np.isfinite(got).all() or err > STREAM_ATOL or cos < STREAM_COS:
            raise AssertionError(f"Whale {seconds} s: flash features off the xla branch's")
        del outs, speech
        torch.cuda.empty_cache()


def tower_engines_run(card, cfg, params, device, max_new_tokens=(16, 32, 32)):
    """One Engine per TOWER_RUNS entry over phase 3's LLM and Whale, with
    the tower and projector drawn from the seed on the card: one
    image+audio request with two text requests, each first token held
    against the cacheless dense forward; B1, B2, B3, B4 and B5b must
    launch, and B1 at d 65 where Whale runs flash."""
    import torch

    from vita_tpu_torch.generate import (DEFAULT_FRAME_BUCKETS, DEFAULT_TILE_BUCKETS,
                                         embed_prompt, tile_buckets_for)
    from vita_tpu_torch.models import projectors
    from vita_tpu_torch.serve.engine import Engine

    d_key = f"flash_fwd:d{cfg.audio.head_dim + 1}"
    for i, (label, tower, projector, backend) in enumerate(TOWER_RUNS):
        t0 = time.time()
        tcfg = dataclasses.replace(
            cfg, vision_tower=tower, vision=_tower_config(tower, cfg.llm.dtype),
            vision_projector=projector,
            audio=dataclasses.replace(cfg.audio, attn_backend=backend))
        gen = torch.Generator(device=device).manual_seed(SEED + 20 + i)
        tparams = {**params,
                   "vision": tcfg.tower_module.init_params(tcfg.vision, gen, device),
                   "vision_proj": projectors.init_vision_projector_kind(
                       tcfg.vision_proj_in_dim, cfg.llm.d_model, gen, projector, device,
                       cfg.llm.dtype)}
        engine = Engine(tparams, tcfg, max_len=2048, n_slots=4, page_size=64,
                        decode_moe_mode="gather", prefill_moe_mode="gmm", device=device)
        # first-use costs (the tower's and Whale's shapes) out of the wave,
        # so that its three requests decode together (B4 at a batch of 4)
        engine.warmup(prompt_lens=(64, 256), media=True, max_new_tokens=2)
        rng = np.random.default_rng(SEED + 30 + i)
        reqs = [media_request(tcfg, rng, max_new_tokens[0]),
                text_request(tcfg, rng, 60, max_new_tokens[1]),
                text_request(tcfg, rng, 150, max_new_tokens[2])]
        before = _launches()
        serve(engine, reqs)
        counts, keys = _delta(before)
        vocab = tcfg.llm.vocab_size
        for name, r, n in zip(("image+audio", "text 60", "text 150"), reqs, max_new_tokens):
            if len(r.tokens) != n or not all(0 <= x < vocab for x in r.tokens):
                raise AssertionError(f"{label}, {name}: {len(r.tokens)} tokens {r.tokens[:8]}")
            print(f"  {name:12s} prompt {len(r.input_ids):4d}  TTFT {r.ttft_s * 1e3:9.2f} ms  "
                  f"decode {r.decode_tokens_per_s:8.2f} tok/s  [{card}]", flush=True)
        missing = [k for k in TOWER_PATH if counts[k] == 0]
        if backend == "flash" and not keys.get(d_key):
            missing.append(d_key)
        print(f"  {label}: image span {tcfg.image_tokens_per_group} tokens; launches "
              f"{ {k: v for k, v in counts.items() if v} }, by shape "
              f"{ {k: v for k, v in keys.items() if v} }", flush=True)
        if missing:
            raise AssertionError(f"{label}: kernels never launched on its path: {missing}")
        media = reqs[0]
        embeds = embed_prompt(tparams, tcfg, np.asarray(media.input_ids, np.int64), device,
                              tile_buckets_for(tcfg, DEFAULT_TILE_BUCKETS),
                              DEFAULT_FRAME_BUCKETS, image_mask=media.image_mask,
                              audio_mask=media.audio_mask, images=media.images,
                              speech=media.speech, speech_length=media.speech_length)
        for r in reqs:
            ids = torch.as_tensor(np.asarray(r.input_ids, np.int64)[None], device=device)
            first_token_gap(tparams, tcfg, ids, r.tokens[0],
                            embeds=embeds if r is media else None)
        del engine, tparams, embeds
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {label}: {time.time() - t0:.1f} s  [{card}]", flush=True)


def narrow_tower_config(tower: str, projector: str, whale_backend: str = "xla"):
    """narrow_config() with a tiny ``tower`` and ``projector`` (fp32)."""
    import torch

    base = narrow_config()
    return dataclasses.replace(
        base, vision_tower=tower, vision=_tower_config(tower, torch.float32, tiny=True),
        vision_projector=projector,
        audio=dataclasses.replace(base.audio, attn_backend=whale_backend))


def registry_phase(card, cfg, params, device):
    """Phase 10 on phase 3's full-width weights, launch counts zeroed
    before it and returned after: (a) Whale flash vs xla at 4, 30 and 120
    s; (b) three full-width tower Engines; (c) the narrow fp32 tower and
    projector pairs on the card and on the CPU, identical greedy streams."""
    import torch

    from vita_tpu_torch import kernels

    kernels.reset_launches()
    print("  (a) Whale at full width, attn_backend flash vs xla", flush=True)
    whale_flash_run(card, cfg, params, device)
    print("  (b) full-width towers through the Engine (gmm prefill, bf16 experts)",
          flush=True)
    tower_engines_run(card, cfg, params, device)
    print("  (c) narrow fp32 tower and projector pairs, cuda vs cpu", flush=True)
    pair = [torch.device("cuda"), torch.device("cpu")]
    for tower, projector, backend in (("clip", "ldp", "xla"), ("siglip", "mlp3x_gelu", "xla"),
                                      ("eva", "spp_v1", "flash")):
        equivalence_phase(pair, cfg=narrow_tower_config(tower, projector, backend),
                          decode_moe_mode="gather", prefill_moe_mode="gmm")
    counts = dict(kernels.launches)
    print(f"  kernel launches in phase 10: {counts}; by shape: {dict(kernels.launch_keys)}",
          flush=True)
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _to(tree, device):
    """A copy of the tree on ``device`` (a copy on the CPU too)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    import vita_tpu_torch
    from vita_tpu_torch import kernels

    if not os.path.abspath(vita_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise RuntimeError(f"vita_tpu_torch loaded from outside {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    print("phase 1: build the kernels", flush=True)
    t0 = time.time()
    path = kernels.build()
    kernels.lib()
    print(f"  built {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s", flush=True)

    print("phase 2: kernels against their plain versions", flush=True)
    rows = kernel_phase(card)

    print("phase 3: full-width VITA-8x7B slice (4 of 32 LLM layers) through Engine",
          flush=True)
    t0 = time.time()
    cfg, dev = slice_config(), torch.device("cuda")
    params = slice_params(cfg, dev)
    parts = [slice_phase(card, cfg, params, dev)]
    print(f"  phase 3 wall {time.time() - t0:.1f} s  [{card}]", flush=True)

    print("phase 4: the slice through Generator (gmm prefill), then the CLI", flush=True)
    t0 = time.time()
    parts.append(generator_phase(card, cfg, params, dev))
    print(f"  phase 4 Generator wall {time.time() - t0:.1f} s  [{card}]", flush=True)

    print("phase 9: multi-turn and duplex serving on the card (phase 3's weights)", flush=True)
    t0 = time.time()
    parts.append(session_phase(card, cfg, params, dev))
    print(f"  phase 9 wall {time.time() - t0:.1f} s  [{card}]", flush=True)

    print("phase 10: the rest of the model registry at full width (phase 3's weights)",
          flush=True)
    t0 = time.time()
    parts.append(registry_phase(card, cfg, params, dev))
    print(f"  phase 10 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    print("phase 4 (continued): the CLI", flush=True)
    t0 = time.time()
    parts.append(cli_phase())
    print(f"  phase 4 CLI wall {time.time() - t0:.1f} s  [{card}]", flush=True)

    print("phase 5: Engine on cuda vs cpu, narrow fp32 config", flush=True)
    t0 = time.time()
    pair = [torch.device("cuda"), torch.device("cpu")]
    kernels.reset_launches()
    equivalence_phase(pair, decode_moe_mode="gather")
    equivalence_phase(pair, decode_moe_mode="gather", prefill_moe_mode="gmm")
    equivalence_phase(pair, NEAR_TIE, decode_moe_mode="gather_q4", kv_int8=True)
    parts.append(dict(kernels.launches))
    print(f"  phase 5 wall {time.time() - t0:.1f} s", flush=True)

    print("phase 6: full-width VITA-8x7B slice (2 of 32 LLM layers) through Trainer", flush=True)
    t0 = time.time()
    parts.append(train_phase(card, dev))
    print(f"  phase 6 wall {time.time() - t0:.1f} s  [{card}]", flush=True)

    print("phase 7: the train CLI, then train steps on cuda vs cpu, narrow fp32 config",
          flush=True)
    t0 = time.time()
    parts.append(train_cli_phase())
    kernels.reset_launches()
    train_equivalence_phase(pair)
    parts.append(dict(kernels.launches))
    print(f"  phase 7 wall {time.time() - t0:.1f} s", flush=True)

    print("phase 8: the 2-layer slice exported, loaded onto the card and served", flush=True)
    t0 = time.time()
    parts.append(checkpoint_phase(card, dev))
    print(f"  phase 8 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
    counts = {k: sum(p.get(k, 0) for p in parts) for k in kernels.launches}

    meta = {
        "flash_fwd": ("csrc/flash_fwd.cu", "vita_tpu/ops/flash_attention.py:54"),
        "paged_attention": ("csrc/paged_attn.cu", "vita_tpu/ops/paged_attention.py:95"),
        "gather_expert_ffn": ("csrc/expert_ffn_bf16.cu", "vita_tpu/ops/moe_decode.py:30"),
        "masked_expert_ffn": ("csrc/expert_ffn_bf16.cu", "vita_tpu/ops/moe_decode.py:539"),
        "gather_expert_ffn_q": ("csrc/expert_ffn_q.cu", "vita_tpu/ops/moe_decode.py:162"),
        "gather_expert_ffn_q4": ("csrc/expert_ffn_q.cu", "vita_tpu/ops/moe_decode.py:326"),
        "masked_expert_ffn_q": ("csrc/expert_ffn_q.cu", "vita_tpu/ops/moe_decode.py:627"),
        "masked_expert_ffn_q4": ("csrc/expert_ffn_q.cu", "vita_tpu/ops/moe_decode.py:720"),
        "paged_attention_q": ("csrc/paged_attn.cu", "vita_tpu/ops/paged_attention.py:335"),
        "gmm": ("csrc/gmm.cu", "vita_tpu/ops/moe_gmm.py:72"),
        "gmm_small": ("csrc/gmm.cu", "vita_tpu/ops/moe_gmm.py:96"),
        "flash_bwd_dq": ("csrc/flash_bwd.cu", "vita_tpu/ops/flash_attention.py:195"),
        "flash_bwd_dkv": ("csrc/flash_bwd.cu", "vita_tpu/ops/flash_attention.py:247"),
        "gmm_wgrad": ("csrc/gmm.cu", "vita_tpu/ops/moe_gmm.py:201"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"vita_tpu_torch/{src}",
         "replaces": tpu, "launches": counts[name], **rows[name]}
        for name, (src, tpu) in meta.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
