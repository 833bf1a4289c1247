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

 11. the serving mesh on one card: expert 2 x model 2 as 4 ranks spawned
     on cuda:0 over gloo (parallel.launch.run_ranks, FileStore rendezvous;
     they load phase 1's library), after the unsharded runs here: (a) the
     Engine at phase 5's narrow fp32 configuration with gather, gather +
     gmm prefill, int4 experts + int8 KV and dense decode, phase 5's
     requests (an image+audio one among them): every rank's greedy streams
     identical to the unsharded ones; (b) the full-width 4-layer slice,
     written once with the port's safetensors writer under
     build/smoke_mesh/ and read by each rank through the mapped reader
     (only its blocks), served with bf16 experts (dense prefill), and with
     int4 experts + int8 KV on 8 slots (gmm prefill): every rank's streams
     equal, and apart from the unsharded run's only at a near tie of its
     top two logits (NEAR_TIE) or after the mesh routed one of the
     request's rows otherwise at a router near tie (MESH_ROUTE_NEAR_TIE);
     each rank's peak memory, TTFT and tok/s printed (time-shared, not a
     measure of scaling); every rank must launch B1, B2, B9, B3, B4, B7,
     B8b and B5b; a rank that fails or hangs past the join's timeout fails
     the phase.

 12. sequence parallelism and the duplex replicas, as 4 ranks spawned on
     cuda:0 over gloo after the unsharded runs here: (a) ring attention
     (parallel.ring_attention) at Mixtral's head geometry (32 q / 8 kv
     heads of 128, bf16, B 1, S 8192, causal, valid lengths 8192 and 6000)
     under seq 4 and under seq 2 x model 2: each rank's block of the output,
     the merged lse and dq/dk/dv held to the unsharded flash_mha (B1's bf16
     tolerances for o and lse, SEQ_GRAD_TOLS and SEQ_GRAD_REL for the
     gradients), and every rank
     launching B1, B10 and B11; the ring's forward + backward ms a rank
     beside the unsharded call's (alone on the card); (b) the seq-parallel
     forward + backward of the 2-layer training slice (gmm, flash, remat,
     bf16; next-token cross entropy + 0.02 aux) at S 8192 under seq 4: the
     loss (SEQ_LOSS_RTOL) and the gradients summed over the ranks at
     sampled elements against the unsharded step here (within
     SEQ_GRAD_SPREAD times the relative error of the same step with
     attention computed another exact way, plus SEQ_GRAD_FLOOR), every
     rank launching B1, B10, B11, B12 and B5a or B5b; (c) the duplex
     replicas at --mesh 1 2 (replica 0 on ranks 0-1, replica 1 on ranks
     2-3, rank 0 driving both through the DuplexController) at phase 5's
     narrow fp32 configuration (float32 experts and pages; int4 experts +
     int8 KV)
     and on the full-width 4-layer slice read from phase 11's export (bf16
     experts + int8 KV, gmm prefill): query A, a noise query rejected by
     '<2>', query B interrupting A; the token ids equal each prompt's
     unsharded greedy stream (identical at narrow fp32; at full width
     apart only at phase 11's near ties), as do those of the same script
     on two unsharded Engines here; every rank launching B1, B2 or B9,
     B3 or B7 (and B5b at full width); first-text and interrupt latencies
     printed beside phase 9's, with the noise query's first text on
     replica 0 beside A's on replica 1 and replica 1's link to rank 0
     (round trips and their ms).

 13. pipeline parallelism, as 4 ranks spawned on cuda:0 over gloo after
     the unsharded runs here: (a) the Engine at phase 5's narrow fp32
     configuration with 4 layers under --mesh 1 1 4 and 1 2 2 (EXPERT
     MODEL PIPE), phase 11's narrow runs and requests: every rank's
     greedy streams identical to the unsharded ones; mixtral.pp_generate
     (the GPipe prefill that keeps each stage's KV rows, then the decode
     ring) under pipe 4 identical to the unsharded greedy loop; (b) the
     full-width 4-layer slice read per stage from phase 11's export by
     load_vita_checkpoint(..., mesh=) under --mesh 1 1 4 and 2 1 2,
     phase 11's full-width runs: every rank's streams equal, and apart
     from phase 11's unsharded streams only at a logit or router near tie
     (the ring decodes through B3/B7, where the unsharded batches take
     B4/B8b); first, under pipe 4, each stage's prefill output and pool
     held bitwise to the unsharded prefill's after its layer; each rank's
     peak memory, TTFT, tok/s and the ring's host ms a substep printed;
     every rank must launch B1, B2, B9, B3, B7 and B5b; (c) one GPipe step
     (pipe 2, 2 microbatches) of phase 12(b)'s 2-layer slice with dense
     MoE on two replicas: the loss, the aux (the microbatches' mean) and
     the gradients held to the same objective taken one microbatch at a
     time without the pipe, as phase 12(b) holds its own, and every rank
     launching B1, B10 and B11.
 14. sharded training over the data and fsdp axes (ZeRO-3), as 4 ranks
     spawned on cuda:0 over gloo after the unsharded steps here: (a)
     phase 7's narrow fp32 configuration (stage 2, gmm, flash; dense and
     one microbatch under pipe), 3 steps under --mesh 1 4 1 1, 2 2 1 1,
     1 2 1 1 2 and 1 2 1 1 1 2 (DATA FSDP EXPERT MODEL [PIPE [SEQ]]):
     each step's loss and every leaf after the last update against the
     unsharded steps (FSDP_NARROW_*; a rank whose tokens took other
     experts excused only at a router near tie), the blocks bitwise equal
     on the ranks that hold the same one; (b) phase 6's 2-layer slice, 4
     rows of 2048 tokens, a warm-up step and a step through
     Trainer(mesh=) under 1 4 1 1: the losses, each group's
     gradient norm, and the step's gradients and weights at sampled
     elements against the unsharded Trainer's (FSDP_FULL_*), each rank's
     peak (below the unsharded peak) and step ms printed, every rank
     launching B1, B10, B11, B12 and B5a or B5b; (c) the train CLI
     --mesh 1 4 1 1 --moe-mode gmm on the 4 ranks, twice: every rank exits
     0, metrics.jsonl is written once, the second run resumes.
 15. tensor- and expert-parallel training, as 4 ranks spawned on cuda:0
     over gloo after phase 14 (whose unsharded references it reuses): (a)
     phase 14(a)'s narrow steps under --mesh 1 1 2 2, 1 2 1 2, 2 1 2 1,
     1 1 1 2 2 (pipe x model) and 1 1 1 2 1 2 (model x seq), held as
     phase 14(a) holds its own; (b) phase 14(b)'s full-width step under
     1 1 2 2 (16 q / 4 kv heads and 4 experts of 7168 ffn columns a rank),
     held as phase 14(b) (a leaf's sampled gradient beyond its tolerance
     held instead to the float32 gradient: TP_GRAD_F32_FACTOR) and
     printed beside its readings, every rank
     launching B1, B10, B11, B12 and B5a or B5b; (c) phase 14(c)'s
     checkpoint (saved under 1 4 1 1) resumed by a Trainer without a mesh
     and under 1 1 2 2: the saved blocks and each rank's resumed ones are
     the same whole leaves cut by each mesh's specs, bitwise (params and
     Adam moments), then the train CLI --mesh 1 1 2 2 trains two more
     steps from it and every rank exits 0.

Prints the card's name and power limit first, a JSON line of per-kernel
results (launches summed over phases 3-15, phases 11-15's over their
ranks) before the last, and as the last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
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
    got, want = got.detach().float(), want.detach().float()
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

        def recording_update(params, g, state, *a, real_update=real_update, grads=grads):
            if not grads:
                grads.append({k: v.detach().cpu() for k, v in g.items()})
            return real_update(params, g, state, *a)

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
        PHASE9_READINGS.setdefault("first_text_ms", []).append(round((first - t_end) * 1e3, 1))
    print(f"  interrupt -> role swap (second speech end to the swap): "
          f"{(swaps[1][1] - utts[1][0]) * 1e3:.1f} ms  [{card}]", flush=True)
    PHASE9_READINGS["swap_ms"] = round((swaps[1][1] - utts[1][0]) * 1e3, 1)

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


# --------------------------------------------------------------------------
# phase 11: the serving mesh on one card
# --------------------------------------------------------------------------
# expert x model: 4 ranks time-sharing cuda:0, over gloo (nccl refuses two
# ranks on one device)
MESH_AXES = (2, 2)
MESH_RANKS = MESH_AXES[0] * MESH_AXES[1]
MESH_DIR = os.path.join(ROOT, "build", "smoke_mesh")
# (label, Engine options) at phase 5's narrow fp32 configuration
MESH_NARROW_RUNS = (
    ("gather", dict(decode_moe_mode="gather")),
    ("gather, gmm prefill", dict(decode_moe_mode="gather", prefill_moe_mode="gmm")),
    ("int4 experts, int8 KV", dict(decode_moe_mode="gather_q4", kv_int8=True)),
    ("dense", dict(decode_moe_mode="dense")),
)
# (label, Engine options, text prompt lengths of the wave beside the
# image+audio request) at full width; the int4 wave decodes 8 rows, which
# B8b's masked schedule needs, and prefills through B5b
MESH_FULL_RUNS = (
    ("bf16 experts, bf16 KV pages", dict(n_slots=4, page_size=64, decode_moe_mode="gather"),
     (20, 150)),
    ("int4 experts, int8 KV pages, gmm prefill",
     dict(n_slots=8, page_size=128, decode_moe_mode="gather_q4", kv_int8=True,
          max_concurrent_prefills=8, prefill_moe_mode="gmm"), (20, 150, 60, 33, 90, 12)),
)
# the kernels every rank must launch in phase 11: B1, B2, B9, the bf16 and
# int4 expert kernels (B3/B4, B7/B8b) and B5b
MESH_PATH = ("flash_fwd", "paged_attention", "paged_attention_q", "gather_expert_ffn",
             "masked_expert_ffn", "gather_expert_ffn_q4", "masked_expert_ffn_q4", "gmm_small")
MESH_NOTE = f"{MESH_RANKS} ranks time-sharing one card: not a measure of scaling"
# the full-width meshes: expert 4 x model 1 first (the expert axis alone:
# each (token, expert) term comes from one rank and the float32 partials
# sum exactly, so its streams must equal the unsharded ones but at a logit
# near tie), then MESH_AXES (every axis at once, whose shards stay for the
# layer check)
MESH_EXACT_AXES = (4, 1)
MESH_FULL_MESHES = (MESH_EXACT_AXES, MESH_AXES)
# The model axis splits GEMMs (q/k/v by columns, wo by rows, summed in
# float32), so bf16 activations round otherwise than unsharded ones (under
# the expert axis alone the logits stay equal: `python3 chip_probe.py
# mesh`); where a token's router had its second and third experts'
# probabilities within MESH_ROUTE_NEAR_TIE, that rounding may route it to
# another expert, which moves the logits by O(1). The routes that differed
# first had gaps up to 3.3e-3 on the 4-layer slice; the bound leaves room. So a full-width request may also split
# from the unsharded run after the mesh routed one of its prompt rows or
# decode steps otherwise at such a near tie (both runs' routes recorded).
MESH_ROUTE_NEAR_TIE = 2e-2
# A route excuse cannot see a fault of rounding size in the model axis, so
# the 2 x 2 shards of layer 0 are also held, at full width, to what each
# collective must give (mesh_layer_check, on MESH_OP_ROWS rows): the
# embedding's masked lookup exactly the table's rows; the output
# projection (wo's row blocks, float32 partials summed over 'model') and
# the vocabulary-sharded head within MESH_OP_ULPS bf16 ulps of the float32
# product, and the expert-sharded gather FFN within MESH_OP_ULPS of the
# unsharded kernel (ulps of the larger of the element and the output's
# root mean square: _layer_reading); and at most MESH_OP_MISMATCH of each
# output's elements off the correctly rounded result (a float32 sum
# rounded once misses only where the float32 error straddles a rounding
# boundary: 0.13% and 0.23% on the card; bf16-rounded partials and a
# dropped sum moved 19% to 100%: PERF.md §6).
MESH_OP_ROWS = 64
MESH_OP_TOKENS = 8  # the gather FFN's decode-sized batch
MESH_FULL_REFS = {}  # label -> phase 11's unsharded (streams, ids, top-2, routes)
MESH_OP_ULPS = 1.0
MESH_OP_MISMATCH = 0.01


def mesh_narrow_requests(cfg):
    """Phase 5's requests: a 200-token text alone, then an image+audio
    request with three texts (12 new tokens each)."""
    rng = np.random.default_rng(SEED + 1)
    first = [text_request(cfg, rng, 200, 12)]
    return first, [media_request(cfg, rng, 12, frames=40)] + [
        text_request(cfg, rng, n, 12) for n in (5, 130, 33)]


def mesh_full_requests(cfg, wave_texts, max_new_tokens=16):
    """Warm-up, then a 100-token text alone and a wave of one image+audio
    request with texts of ``wave_texts`` tokens."""
    rng = np.random.default_rng(SEED + 11)
    warm = [text_request(cfg, rng, 30, 4), media_request(cfg, rng, 4)]
    solo = [text_request(cfg, rng, 100, max_new_tokens)]
    return warm, solo, [media_request(cfg, rng, max_new_tokens)] + [
        text_request(cfg, rng, n, max_new_tokens) for n in wave_texts]


@contextlib.contextmanager
def _recording_routes(engine, routes):
    """While open, every routing of ``engine``'s requests is recorded: per
    layer the two experts and the gap between the second and third router
    probabilities, as routes[(request_id, i)] for the decode step that
    samples generated token i and routes[(request_id, "prompt", p)] for
    prompt row p of a prefill chunk."""
    import torch

    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.ops import moe
    from vita_tpu_torch.serve import engine as engine_mod

    real_chunk, real_prefill = engine_mod.decode_chunk, engine_mod._prefill_chunk
    real_routes = mixtral.route_topk, moe.route_topk
    n_layers = engine.cfg.llm.n_layers
    rows = {}  # the keys of the rows the running forward routes, and its call count

    def route(logits, k):
        w, idx, probs = real_routes[0](logits, k)
        if rows:
            step = rows["calls"] // n_layers
            rows["calls"] += 1
            top = torch.topk(probs, k + 1, dim=-1).values
            gaps = (top[:, k - 1] - top[:, k]).tolist()
            for key, ids, gap in zip(rows["keys"](step), idx.tolist(), gaps):
                if key is not None:
                    routes.setdefault(key, []).append((tuple(sorted(ids)), gap))
        return w, idx, probs

    def chunk(llm_params, cache, tok, pos, *args, **kw):
        reqs = [r for r in engine.slot_req if r is not None]
        first = [int(p) + 1 - len(r.input_ids) for p, r in zip(pos.tolist(), reqs)]
        rows.update(calls=0, keys=lambda step: [(r.request_id, f + step)
                                                for r, f in zip(reqs, first)])
        try:
            return real_chunk(llm_params, cache, tok, pos, *args, **kw)
        finally:
            rows.clear()

    def prefill(llm_params, llm_cfg, job, *args, **kw):
        rid = job.req.request_id
        rows.update(calls=0, keys=lambda step: [
            (rid, "prompt", p) if p < job.true_len else None
            for p in range(job.offset, job.offset + job.chunk)])
        try:
            return real_prefill(llm_params, llm_cfg, job, *args, **kw)
        finally:
            rows.clear()

    engine_mod.decode_chunk, engine_mod._prefill_chunk = chunk, prefill
    mixtral.route_topk = moe.route_topk = route
    try:
        yield
    finally:
        engine_mod.decode_chunk, engine_mod._prefill_chunk = real_chunk, real_prefill
        mixtral.route_topk, moe.route_topk = real_routes


def _serve_full(engine, cfg, wave_texts, top2, routes):
    """mesh_full_requests through ``engine``, its top-2 logits and routes
    recorded: (streams, request ids, TTFT ms, decode tok/s)."""
    warm, solo, wave = mesh_full_requests(cfg, wave_texts)
    serve(engine, warm)
    with _recording_top2(engine, top2), _recording_routes(engine, routes):
        reqs = serve(engine, solo) + serve(engine, wave)
    return ([r.tokens for r in reqs], [r.request_id for r in reqs],
            [r.ttft_s * 1e3 for r in reqs], [r.decode_tokens_per_s for r in reqs])


def _mesh_split(i, got, ref, rid, top2, routes, own_routes):
    """None when request ``i``'s mesh stream equals the unsharded one; else
    the first differing token j, accepted where the unsharded run's top two
    logits there were the two tokens within NEAR_TIE, or (with ``routes``;
    None for the expert-only mesh) where the mesh routed one of the
    request's prompt rows, or a decode step up to j, otherwise than the
    unsharded run at a router near tie of the unsharded run
    (MESH_ROUTE_NEAR_TIE); raises otherwise."""
    if got == ref:
        return None
    j = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
    t1, t2, gap = top2.get((rid, j), (None, None, None))
    # either order: at an exact tie topk's order is arbitrary (argmax takes
    # the lower id); otherwise the unsharded run streamed its top token
    if {t1, t2} == {ref[j], got[j]} and gap <= NEAR_TIE:
        print(f"    request {i} splits at token {j}: {got[j]} vs {ref[j]}, a near tie of "
              f"the logits (unsharded top-2 gap {gap:.3e} <= {NEAR_TIE})", flush=True)
        return j
    if routes is None:
        raise AssertionError(
            f"request {i} differs at token {j}: {got[j:j + 4]} vs {ref[j:j + 4]}; unsharded "
            f"top two there {(t1, t2)}, gap {gap} (the expert axis alone allows a logit near "
            f"tie only)")
    prompt = sorted(k[2] for k in routes if k[:2] == (rid, "prompt"))
    for where, mine, theirs in ([(f"prompt row {p}", (i, "prompt", p), (rid, "prompt", p))
                                 for p in prompt]
                                + [(f"token {t}", (i, t), (rid, t)) for t in range(1, j + 1)]):
        for layer, ((a, g), (b, _)) in enumerate(zip(routes.get(theirs, []),
                                                    own_routes.get(mine, []))):
            if a == b:
                continue
            if g > MESH_ROUTE_NEAR_TIE:
                raise AssertionError(f"request {i}: the mesh routed {where} at layer {layer} to "
                                     f"{b}, the unsharded run to {a} with a router gap of {g:.3e}")
            print(f"    request {i} splits at token {j}: {got[j]} vs {ref[j]}, after the mesh "
                  f"routed {where} at layer {layer} to experts {b}, the unsharded run to {a} at "
                  f"a router near tie (gap {g:.3e} <= {MESH_ROUTE_NEAR_TIE})", flush=True)
            return j
    raise AssertionError(
        f"request {i} differs at token {j}: {got[j:j + 4]} vs {ref[j:j + 4]}; unsharded top "
        f"two there {(t1, t2)}, gap {gap}, and the same routes up to it")


def mesh_layer_inputs(params, cfg, device):
    """Seeded inputs of mesh_layer_check and what each collective must
    give, from the whole weights (float32 products with TF32 off; the
    unsharded gather FFN for the experts)."""
    import torch

    from vita_tpu_torch.ops.moe_decode import selected_expert_ffn

    llm, lc = params["llm"], cfg.llm
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    bf16 = torch.bfloat16
    t, te = MESH_OP_ROWS, MESH_OP_TOKENS
    ops = {
        "ids": torch.randint(0, lc.vocab_size, (t,), generator=g, device=device),
        "o": torch.randn(t, lc.n_heads * lc.head_dim, generator=g, device=device).to(bf16),
        "x": torch.randn(t, lc.d_model, generator=g, device=device).to(bf16),
        "xe": torch.randn(te, lc.d_model, generator=g, device=device).to(bf16),
        "w": torch.rand(te, lc.top_k, generator=g, device=device).softmax(-1),
        "idx": torch.stack([torch.randperm(lc.n_experts, generator=g, device=device)[:lc.top_k]
                            for _ in range(te)]),
    }
    experts = {k: v.flatten(0, 1) for k, v in llm["layers"]["moe"].items() if k != "router"}
    want = {
        "embed": llm["embed"][ops["ids"]],
        "out_proj": ops["o"].float() @ llm["layers"]["attn"]["wo"][0].float(),
        "lm_head": ops["x"].float() @ llm["lm_head"].float(),
        "experts": selected_expert_ffn("gather", ops["xe"], ops["w"], ops["idx"], experts,
                                       n_experts=lc.n_experts),
    }
    return {k: v.cpu() for k, v in ops.items()}, {k: v.cpu() for k, v in want.items()}


def mesh_layer_check(llm, cfg, mesh, ops):
    """Layer 0's collectives at full width on this rank's shards, on the
    inputs of mesh_layer_inputs: the embedding's masked lookup summed over
    'model', the output projection over the rank's heads (wo's row block)
    summed over 'model', the vocabulary-sharded head gathered over
    'model', and the gather FFN over the rank's experts summed over
    'expert'."""
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.mesh import local_shard
    from vita_tpu_torch.parallel.sharded_ops import sharded_gather_ffn

    dev = llm["embed"].device
    ops = {k: v.to(dev) for k, v in ops.items()}
    experts = {k: v for k, v in llm["layers"]["moe"].items() if k != "router"}
    got = {
        "embed": mixtral.embed_tokens(llm, ops["ids"], mesh),
        "out_proj": mixtral._out_proj(local_shard(ops["o"], (None, "model"), mesh),
                                      llm["layers"]["attn"]["wo"][0], mesh),
        "lm_head": mixtral.lm_logits(llm, ops["x"], mesh),
        "experts": sharded_gather_ffn(ops["xe"], ops["w"], ops["idx"], experts, 0,
                                      cfg.n_experts, "gather", mesh=mesh),
    }
    # numpy (exact for bf16): a returned tensor would travel as a handle to
    # this rank's shared memory, gone once the rank exits
    return {k: v.float().cpu().numpy() for k, v in got.items()}


def _layer_reading(got, want):
    """(max error of ``got`` in bf16 ulps of the larger of each element of
    ``want`` and its root mean square, share of elements that differ from
    ``want`` rounded to bf16). An element summed near zero carries the
    float32 error of its terms, which scale like the root mean square."""
    import torch

    got, want = torch.from_numpy(got), want.float()
    mag = torch.maximum(want.abs(), want.square().mean().sqrt()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (float(((got - want).abs() / ulp).max()),
            float((got != want.to(torch.bfloat16).float()).float().mean()))


def mesh_rank(rank, world, ckpt_dir, layer_path):
    """One rank of phase 11 on cuda:0: the narrow runs, then the
    full-width runs on each MESH_FULL_MESHES mesh over this rank's shards,
    read from the checkpoint in ``ckpt_dir`` by load_vita_checkpoint (the
    CLI's and the HTTP server's loader: only this rank's blocks of the
    mapped files are read). Launch counts are zeroed before the path and
    read after it; then the layer check on the MESH_AXES shards."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel.mesh import make_mesh
    from vita_tpu_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.lib()  # phase 1's library: loaded, not built
    meshes = {axes: make_mesh((1, 1) + axes) for axes in MESH_FULL_MESHES}
    mesh = meshes[MESH_AXES]
    out = {"narrow": {}, "full": {}}
    kernels.reset_launches()
    cfg = narrow_config()
    params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    for label, kw in MESH_NARROW_RUNS:
        engine = Engine(params, cfg, n_slots=4, max_len=512, page_size=64, prefill_chunk=128,
                        device=dev, mesh=mesh, **kw)
        first, wave = mesh_narrow_requests(cfg)
        out["narrow"][label] = [r.tokens for r in serve(engine, first) + serve(engine, wave)]
        del engine
    cfg = slice_config()
    for axes in MESH_FULL_MESHES:
        t0 = time.time()
        _, shards = load_vita_checkpoint(ckpt_dir, dev, mesh=meshes[axes])
        loaded = time.time() - t0
        for label, kw, wave_texts in MESH_FULL_RUNS:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            engine = Engine(shards, cfg, max_len=2048, device=dev, mesh=meshes[axes],
                            sharded=True, **kw)
            built = time.time() - t0
            top2, routes = {}, {}
            tokens, ids, ttft, tps = _serve_full(engine, cfg, wave_texts, top2, routes)
            # this rank's own routes at each step, by request index
            own = {(ids.index(k[0]),) + k[1:]: v for k, v in routes.items() if k[0] in ids}
            out["full"][axes, label] = dict(
                tokens=tokens, ttft_ms=ttft, tok_s=tps, loaded_s=loaded, built_s=built,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, routes=own)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        if axes != MESH_AXES:
            del shards
    out["launches"] = dict(kernels.launches)
    out["layer"] = mesh_layer_check(shards["llm"], cfg.llm, mesh, torch.load(layer_path))
    return out


def mesh_phase(card: str, device):
    """Phase 11: the serving mesh as 4 spawned ranks on cuda:0 over gloo,
    against the unsharded Engine run here first.
    Narrow fp32 (MESH_NARROW_RUNS, expert 2 x model 2): every rank's
    greedy streams identical to the unsharded ones. Full width (the
    4-layer VITA-8x7B slice, MESH_FULL_RUNS): the weights exported once
    in the HF layout (bf16 safetensors), each rank reading its blocks
    through load_vita_checkpoint(..., mesh=); every rank's streams equal;
    under expert 4 x model 1 a split from the unsharded run only at a
    logit near tie, under expert 2 x model 2 also after a router near tie
    (_mesh_split); and layer 0's collectives held to what they must give
    (mesh_layer_check). Every check runs, and the phase then fails on
    any that failed. Every rank must launch MESH_PATH. The export stays
    under MESH_DIR/ckpt for phase 12 (main removes MESH_DIR). Returns the
    launch counts summed over the ranks."""
    import shutil

    import torch

    from vita_tpu_torch.checkpoint import export_hf_vita_checkpoint
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel.launch import run_ranks
    from vita_tpu_torch.serve.engine import Engine

    ncfg = narrow_config()
    nparams = _to(vita.init_params(ncfg, torch.Generator().manual_seed(SEED), "cpu"), device)
    narrow_ref = {}
    for label, kw in MESH_NARROW_RUNS:
        engine = Engine(nparams, ncfg, n_slots=4, max_len=512, page_size=64, prefill_chunk=128,
                        device=device, **kw)
        first, wave = mesh_narrow_requests(ncfg)
        narrow_ref[label] = [r.tokens for r in serve(engine, first) + serve(engine, wave)]
        del engine
    del nparams

    cfg = slice_config()
    params = slice_params(cfg, device)
    full_ref = {}
    for label, kw, wave_texts in MESH_FULL_RUNS:
        engine = Engine(params, cfg, max_len=2048, device=device, **kw)
        top2, routes = {}, {}
        tokens, ids, ttft, tps = _serve_full(engine, cfg, wave_texts, top2, routes)
        full_ref[label] = (tokens, ids, top2, routes)
        MESH_FULL_REFS[label] = full_ref[label]  # phase 13 holds its pipe meshes to them
        print(f"  unsharded {label}: TTFT {[round(t, 2) for t in ttft]} ms, decode "
              f"{[round(t, 2) for t in tps]} tok/s  [{card}]", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    layer_ops, layer_want = mesh_layer_inputs(params, cfg, device)
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    free = shutil.disk_usage(MESH_DIR).free
    if free < n_bytes + 2**30:
        raise RuntimeError(f"the mesh phase writes {n_bytes / 2**30:.1f} GiB under {MESH_DIR}, "
                           f"found {free / 2**30:.1f} GiB free")
    ckpt_dir, layer_path = os.path.join(MESH_DIR, "ckpt"), os.path.join(MESH_DIR, "layer.pt")
    try:
        t0 = time.time()
        export_hf_vita_checkpoint(ckpt_dir, cfg, params, dtype=torch.bfloat16)
        torch.save(layer_ops, layer_path)
        print(f"  exported {n_bytes / 2**30:.2f} GiB of bf16 weights (HF layout) in "
              f"{time.time() - t0:.1f} s", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()  # the ranks get the card; this process keeps its context
        t0 = time.time()
        results = run_ranks(mesh_rank, MESH_RANKS, ckpt_dir, layer_path, backend="gloo",
                            timeout=600, store_dir=MESH_DIR)
        print(f"  {MESH_RANKS} ranks on cuda:0 over gloo returned in {time.time() - t0:.1f} s",
              flush=True)
    finally:
        if os.path.exists(layer_path):
            os.remove(layer_path)

    failed = []
    for label, _ in MESH_NARROW_RUNS:
        bad = [r for r, res in enumerate(results) if res["narrow"][label] != narrow_ref[label]]
        if bad:
            failed.append(f"narrow {label}: rank {bad[0]}'s greedy streams "
                          f"{results[bad[0]]['narrow'][label]} differ from the unsharded "
                          f"{narrow_ref[label]}")
            continue
        print(f"  narrow fp32 {label} (expert {MESH_AXES[0]} x model {MESH_AXES[1]}): "
              f"{len(narrow_ref[label])} requests, every rank's greedy streams identical to the "
              f"unsharded Engine's", flush=True)
    for axes in MESH_FULL_MESHES:
        for label, _, _ in MESH_FULL_RUNS:
            name = f"expert {axes[0]} x model {axes[1]}, {label}"
            ref, ids, top2, routes = full_ref[label]
            got = results[0]["full"][axes, label]["tokens"]
            if any(res["full"][axes, label]["tokens"] != got for res in results):
                failed.append(f"{name}: the ranks' streams differ")
                continue
            own = results[0]["full"][axes, label]["routes"]
            try:
                splits = [_mesh_split(i, g, w, rid, top2,
                                      None if axes == MESH_EXACT_AXES else routes, own)
                          for i, (g, w, rid) in enumerate(zip(got, ref, ids))]
            except AssertionError as e:
                failed.append(f"{name}: {e}")
                continue
            print(f"  full width {name}: {len(ref)} requests, every rank's streams equal; "
                  f"against the unsharded Engine: {sum(s is None for s in splits)} identical, "
                  f"splits at near ties {splits}", flush=True)
            for r, res in enumerate(results):
                run = res["full"][axes, label]
                print(f"    rank {r}: peak memory {run['peak_gib']:.2f} GiB, shards loaded in "
                      f"{run['loaded_s']:.1f} s, Engine built in {run['built_s']:.1f} s, TTFT "
                      f"{[round(t, 2) for t in run['ttft_ms']]} ms, decode "
                      f"{[round(t, 2) for t in run['tok_s']]} tok/s  ({MESH_NOTE}) [{card}]",
                      flush=True)
    for name, want in layer_want.items():
        readings = [_layer_reading(res["layer"][name], want) for res in results]
        ulps, mismatch = max(u for u, _ in readings), max(m for _, m in readings)
        exact = name == "embed"
        ok = (ulps == 0.0) if exact else (ulps <= MESH_OP_ULPS and mismatch <= MESH_OP_MISMATCH)
        print(f"  layer 0 {name} at full width (expert {MESH_AXES[0]} x model {MESH_AXES[1]}): "
              f"max error {ulps:.4f} bf16 ulps, {mismatch:.5f} of the elements off the "
              f"correctly rounded result (bound "
              f"{'exact' if exact else f'{MESH_OP_ULPS} ulps, {MESH_OP_MISMATCH}'})"
              f"{'' if ok else ': FAILED'}", flush=True)
        if not ok:
            failed.append(f"layer 0 {name}: {ulps:.3f} ulps, {mismatch:.5f} mismatched")
    total = {}
    for r, res in enumerate(results):
        counts = res["launches"]
        print(f"  rank {r} kernel launches in phase 11: {counts}", flush=True)
        missing = [k for k in MESH_PATH if counts[k] == 0]
        if missing:
            failed.append(f"rank {r} never launched {missing}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    if failed:
        raise AssertionError("phase 11 failed:\n  " + "\n  ".join(failed))
    return total


# --------------------------------------------------------------------------
# phase 12: sequence parallelism (the ring on B1/B10/B11) and the duplex
# replicas, as 4 ranks on cuda:0 over gloo
# --------------------------------------------------------------------------
SEQ_RANKS = 4
SEQ_S = 8192
# (seq, model) meshes of the ring at Mixtral's head geometry (32 q / 8 kv
# heads of 128, bf16, B 1, causal), each at two valid lengths
SEQ_RING_MESHES = ((4, 1), (2, 2))
SEQ_RING_LENGTHS = (8192, 6000)
SEQ_RING_TIMED = 3
# The ring's o is held with B1's bf16 tolerances (flash_fwd_tols: 2e-3 on
# rows of 1024+ keys, else 2e-2, + rtol 2e-2; lse 1e-3) against the
# unsharded flash_mha on the same card. dk/dv at the bf16 flash tolerance
# of phase 2, atol = rtol = 2e-2: each ring step's dk/dv is rounded to
# bf16 before the float32 sum over the steps, and the unsharded kernel
# rounds once, so one ulp of an element of 8-16 (3e-2-6e-2) is rounding.
# dq (float32 sums over the steps, rounded once) is near 0.02 an element,
# so the same bound could not see a block's share go missing: it is held
# at atol 5e-3 + rtol 1e-2 (rounding reads 1e-3-2e-3 on the card, PERF.md §6).
# Each gradient is held too by its relative error (Frobenius norm) at
# SEQ_GRAD_REL: bf16 rounding reads about 3e-3, a dropped ring step's dq
# 0.5-0.9 (`chip_probe.py ring-faults`).
SEQ_GRAD_TOLS = {"dq": (5e-3, 1e-2), "dk": (2e-2, 2e-2), "dv": (2e-2, 2e-2)}
SEQ_GRAD_REL = 1e-2
# The seq-parallel 2-layer training slice: the loss (mean next-token
# cross entropy + 0.02 aux) held at SEQ_LOSS_RTOL of the unsharded step's;
# each leaf's gradient, summed over the seq ranks, at SEQ_GRAD_SAMPLES
# elements drawn from a seed, by its relative error (Frobenius norm) from
# the unsharded step's. In bf16 at full width that error is not rounding
# size: a rounding-size change of attention's output flips the top-2
# experts of the tokens whose router lies near a tie, and their rows move
# whole (every leaf 4-5% apart on the card, PERF.md §6). So the
# bound is the spread of the model itself: the same unsharded step with
# attention computed another exact way (attn_backend 'xla', float32
# scores), and a leaf passes within SEQ_GRAD_SPREAD times that step's
# error plus SEQ_GRAD_FLOOR. A dropped block or a gradient that misses its
# owner moves the attention leaves by order 1.
SEQ_TRAIN_LAYERS = 2
SEQ_GRAD_SAMPLES = 1 << 18
SEQ_LOSS_RTOL = 1e-3
SEQ_GRAD_SPREAD = 2.0
SEQ_GRAD_FLOOR = 1e-2
SEQ_TRAIN_PATH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gmm_wgrad")
# The duplex replicas at --mesh 1 2 (two replicas of model 2): the fixed
# script's prompts (token counts) and new tokens; A streams long enough to
# be interrupted. A replica decodes at most two rows at once (its answer
# and the other query's), below B4's and B8b's masked schedule (4 and 8
# rows): the replicas run the selected-expert kernels.
DUPLEX_AXES = (1, 2)
DUPLEX_RUNS = (
    ("narrow fp32, gather", "narrow",
     dict(n_slots=2, max_len=1024, page_size=64, decode_ticks=1, decode_moe_mode="gather"),
     {"A": (60, 900), "N": (40, 8), "B": (80, 24)},
     ("flash_fwd", "paged_attention", "gather_expert_ffn")),
    ("narrow fp32, int4 experts, int8 KV", "narrow",
     dict(n_slots=2, max_len=1024, page_size=64, decode_ticks=1, decode_moe_mode="gather_q4",
          kv_int8=True),
     {"A": (60, 900), "N": (40, 8), "B": (80, 24)},
     ("flash_fwd", "paged_attention_q", "gather_expert_ffn_q4")),
    ("full width, bf16 experts, int8 KV, gmm prefill", "full",
     dict(n_slots=2, max_len=2048, page_size=64, decode_ticks=1, decode_moe_mode="gather",
          kv_int8=True, prefill_moe_mode="gmm"),
     {"A": (60, 512), "N": (40, 8), "B": (80, 32)},
     ("flash_fwd", "paged_attention_q", "gather_expert_ffn", "gmm_small")),
)
# Under --mesh 1 2 every rank holds all 8 experts of its replica's 4 layers
# (11.3 GB of bf16; the model axis splits attention and the vocabulary):
# about 15 GiB a rank with the towers, pools and activations, 4 ranks on
# the card. An int4 copy of the experts beside them (decode_moe_mode
# 'gather_q4') took a rank to 18.2 GiB and the card out of memory, so the
# int4 experts (B7) run at the narrow width.
PHASE9_READINGS = {}  # phase 9's duplex latencies, printed beside phase 12's


def _ring_inputs(length, dev):
    """Phase 12(a)'s q, k, v, dO (whole sequence, from a seed on the card)
    and the valid length."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    bf = torch.bfloat16

    def rnd(h):
        return torch.randn(1, SEQ_S, h, 128, generator=g, device=dev).to(bf)
    q, k, v, do = rnd(32), rnd(8), rnd(8), rnd(32)
    return q, k, v, do, torch.tensor([length], dtype=torch.int32, device=dev)


def _seq_block(x, mesh, heads: bool = True):
    """This rank's block of [B, S, H, d]: its seq block (and its heads)."""
    from vita_tpu_torch.parallel.mesh import local_shard
    from vita_tpu_torch.parallel.ring_attention import shard_seq

    x = shard_seq(x, mesh)
    return (local_shard(x, (None, None, "model", None), mesh) if heads else x).contiguous()


def seq_ring_rank(mesh, dev):
    """Phase 12(a) on one rank: per mesh and length, the ring's forward +
    backward (launch counts zeroed before, read after; SEQ_RING_TIMED timed
    runs after one warm-up), then its block held to the unsharded
    flash_mha_with_lse on the whole sequence."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.ops.flash_attention import flash_mha_with_lse
    from vita_tpu_torch.parallel.mesh import MODEL, SEQ, axis
    from vita_tpu_torch.parallel.ring_attention import ring_flash_mha_with_lse

    a_seq, a_mod = axis(mesh, SEQ), axis(mesh, MODEL)
    s_loc, h_loc = SEQ_S // a_seq.size, 32 // a_mod.size
    rows = slice(a_seq.rank * s_loc, (a_seq.rank + 1) * s_loc)
    hs = slice(a_mod.rank * h_loc, (a_mod.rank + 1) * h_loc)

    def held(name, got, want, atol, rtol):
        try:
            return compare(name, got, want, atol, rtol)
        except AssertionError as e:  # every check runs; the phase lists the failures
            return f"FAILED: {e}"

    out = {}
    for length in SEQ_RING_LENGTHS:
        q, k, v, do, lengths = _ring_inputs(length, dev)
        blocks = [_seq_block(x, mesh) for x in (q, k, v)]
        dob = _seq_block(do, mesh)

        def run():
            leaves = [x.clone().requires_grad_() for x in blocks]
            o, lse = ring_flash_mha_with_lse(*leaves, lengths, causal=True, mesh=mesh)
            (o.float() * dob.float()).sum().backward()
            return o, lse, [x.grad for x in leaves]

        kernels.reset_launches()
        run()
        times = []
        for _ in range(SEQ_RING_TIMED):
            torch.cuda.synchronize(dev)
            t0 = time.time()
            o, lse, grads = run()
            torch.cuda.synchronize(dev)
            times.append((time.time() - t0) * 1e3)
        launches = dict(kernels.launches)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ro, rlse = flash_mha_with_lse(*leaves, kv_len=lengths, causal=True)
        (ro.float() * do.float()).sum().backward()
        (o_tol, o_rtol), (lse_tol, _) = flash_fwd_tols(SEQ_S, [length], [0], dev)
        errs = {"o": held("ring o", o, _seq_block(ro, mesh), _seq_block(o_tol, mesh, False),
                          o_rtol),
                "lse": held("ring lse", lse, rlse[:, hs, rows], lse_tol, 0.0)}
        for name, got, full in zip(("dq", "dk", "dv"), grads, [x.grad for x in leaves]):
            want = _seq_block(full, mesh)
            errs[name] = held(f"ring {name}", got, want, *SEQ_GRAD_TOLS[name])
            # over the larger of the norm and 1: a block wholly past the valid
            # length has zero dk/dv
            rel = float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1.0))
            errs[name + " rel"] = (rel if rel <= SEQ_GRAD_REL else
                                   f"FAILED: ring {name}: relative error {rel:.3e} past "
                                   f"{SEQ_GRAD_REL}")
        out[length] = dict(errs=errs, ms=float(np.median(times)), launches=launches)
        del q, k, v, do, blocks, leaves, ro, rlse, o, grads
    return out


def _leaf_items(tree):
    """(name, leaf) of a nested dict, names joined with '/'."""
    from vita_tpu_torch.train.step import tree_leaves

    return (("/".join(path), leaf) for path, leaf in tree_leaves(tree))


def seq_train_config():
    """The 2-layer training slice's LLM (gmm, flash, remat, bf16)."""
    lcfg = train_slice_config().llm
    return dataclasses.replace(lcfg, n_layers=SEQ_TRAIN_LAYERS)


def seq_train_batch():
    """One sequence of SEQ_S ids from a seed and its next-token labels."""
    rng = np.random.default_rng(SEED + 22)
    ids = rng.integers(3, seq_train_config().vocab_size, (1, SEQ_S)).astype(np.int64)
    labels = np.full_like(ids, -100)
    labels[:, :-1] = ids[:, 1:]
    return ids, labels


def seq_train_step(params, lcfg, ids, labels, n_labels, mesh=None, with_ce=True):
    """Cross entropy summed over ``labels`` / n_labels + 0.02 aux (the aux
    term alone without ``with_ce``), and its backward: (cross entropy,
    aux)."""
    import torch
    import torch.nn.functional as F

    from vita_tpu_torch.models import mixtral

    logits, _, aux = mixtral.forward(params, lcfg, input_ids=ids, mesh=mesh)
    ce = F.cross_entropy(logits.float().flatten(0, 1), labels.flatten(), ignore_index=-100,
                         reduction="sum") / n_labels
    ((ce if with_ce else 0.0) + 0.02 * aux).backward()
    return float(ce.detach()), float(aux.detach())


def _grad_samples(params, picks):
    """Each leaf's gradient at the sampled flat indices (float32, host);
    leaves the objective does not reach are left out."""
    import torch

    return {name: leaf.grad.reshape(-1)[torch.as_tensor(picks[name], device=leaf.device)]
            .float().cpu().numpy() for name, leaf in _leaf_items(params)
            if leaf.grad is not None}


def seq_train_params(lcfg, dev):
    import torch

    from vita_tpu_torch.models import mixtral

    params = mixtral.init_params(lcfg, torch.Generator(device=dev).manual_seed(SEED + 23), dev)
    for _, leaf in _leaf_items(params):
        leaf.requires_grad_()
    return params


def seq_train_rank(mesh, dev, picks):
    """Phase 12(b) on one rank: the seq-parallel forward + backward of the
    2-layer slice on this rank's SEQ_S/n tokens (launch counts zeroed
    before, read after); its share of the loss, the aux and the sampled
    gradients."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.parallel.ring_attention import shard_seq

    lcfg = seq_train_config()
    params = seq_train_params(lcfg, dev)
    ids, labels = seq_train_batch()
    n_labels = int((labels != -100).sum())
    ids_b = shard_seq(torch.as_tensor(ids, device=dev), mesh)
    labels_b = shard_seq(torch.as_tensor(labels, device=dev), mesh)
    seq_train_step(params, lcfg, ids_b, labels_b, n_labels, mesh)  # warm-up: first-use costs
    for _, leaf in _leaf_items(params):
        leaf.grad = None
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    share, aux = seq_train_step(params, lcfg, ids_b, labels_b, n_labels, mesh)
    torch.cuda.synchronize(dev)
    ms = (time.time() - t0) * 1e3
    out = dict(share=share, aux=aux, ms=ms, launches=dict(kernels.launches),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               samples=_grad_samples(params, picks))
    for _, leaf in _leaf_items(params):
        leaf.grad = None
    seq_train_step(params, lcfg, ids_b, labels_b, n_labels, mesh, with_ce=False)
    out["samples_aux"] = _grad_samples(params, picks)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _flash_llm(cfg):
    """``cfg`` with the LLM's attention on B1, the 8x7B preset's choice: a
    loaded HF-layout config carries no attention backend."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_backend="flash"))


def duplex_prompts(cfg, tokens, seed):
    rng = np.random.default_rng(seed)
    return {name: rng.integers(3, cfg.llm.vocab_size, n).astype(np.int32)
            for name, (n, _) in tokens.items()}


def _wait_for(cond, timeout, what):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise TimeoutError(f"waited {timeout:.0f} s for {what}")
        time.sleep(0.002)


def duplex_script(engines, prompts, tokens, noise_tok, timeout=300.0, controller_cls=None):
    """The fixed script through a DuplexController (the port's, or
    ``controller_cls``) over two running engines: query A (the monitor,
    engine 1) streams and is promoted; a noise query N (engine 0) is
    rejected by '<2>' (a decode that reads a response starting with
    ``noise_tok`` as noise, any other as '<1>'); query B (engine 0)
    interrupts A, which is cancelled on its engine, and the roles swap
    back. ``tokens`` maps each query to (prompt length, new tokens).
    Returns the requests' tokens and ids, the controller's counters and
    the latencies (ms)."""
    if controller_cls is None:
        from vita_tpu_torch.serve.duplex import DuplexController as controller_cls

    def decode(ids):
        ids = list(ids)
        if not ids:
            return ""
        return ("<2>" if ids[0] == noise_tok else "<1>") + letter_decode(ids[1:])

    ctl = controller_cls(engines, decode)
    out = {"generator": [ctl.generator_idx]}
    reqs = {}
    for name in ("A", "N", "B"):
        req = ctl.new_request(prompts[name], max_new_tokens=tokens[name][1], eos_id=-1)
        reqs[name] = req
        ctl.submit_query(req)
        out[f"engine_{name}"] = req._duplex_engine_idx
        if name == "A":
            _wait_for(lambda: ctl.current is req and len(req.tokens) >= 4, timeout,
                      "A's answer")
        elif name == "N":
            _wait_for(lambda: ctl.rejected_noise == 1 and req.finish_time > 0, timeout,
                      "the noise query's rejection")
        else:
            _wait_for(lambda: req.finish_time > 0 and reqs["A"].finish_time > 0, timeout,
                      "B's answer and A's cancellation")
        out["generator"].append(ctl.generator_idx)
    a, noise, b = reqs["A"], reqs["N"], reqs["B"]
    out.update({n: list(r.tokens) for n, r in reqs.items()})
    out["ids"] = {n: r.request_id for n, r in reqs.items()}
    out.update(interrupts=ctl.interrupts, rejected=ctl.rejected_noise,
               cancelled={n: r.cancelled for n, r in reqs.items()},
               first_text_ms=(a.first_token_time - a.submit_time) * 1e3,
               noise_first_ms=(noise.first_token_time - noise.submit_time) * 1e3,
               swap_ms=(b.first_token_time - b.submit_time) * 1e3,
               cancel_ms=(a.finish_time - b.first_token_time) * 1e3)
    return out


def _check_script(label, out, tokens):
    """The script's protocol: A promoted on engine 1, N rejected, B back on
    engine 0 interrupting A (cancelled), B whole."""
    want = dict(generator=[0, 1, 1, 0], rejected=1, interrupts=1,
                cancelled={"A": True, "N": True, "B": False})
    got = {k: out[k] for k in want}
    if got != want or (out["engine_A"], out["engine_N"], out["engine_B"]) != (1, 0, 0):
        raise AssertionError(f"{label}: the duplex script went otherwise: {got}, engines "
                             f"{(out['engine_A'], out['engine_N'], out['engine_B'])}")
    if len(out["B"]) != tokens["B"][1] or not out["A"] or len(out["A"]) >= tokens["A"][1]:
        raise AssertionError(f"{label}: B has {len(out['B'])} tokens, A {len(out['A'])}")


def duplex_replica_rank(reps, dev, cfg, params, sharded, kw, prompts, tokens, noise_tok,
                        record):
    """Phase 12(c) on one rank: this rank's Engine of its replica (launch
    counts zeroed before the script, read after); rank 0 runs the script
    through replica 0's loop and the RemoteReplica of replica 1, then
    stops both. With ``record`` each rank records its Engine's routes."""
    import torch.distributed as dist

    from vita_tpu_torch import kernels
    from vita_tpu_torch.serve.engine import Engine
    from vita_tpu_torch.serve.replicas import replica_loop, start_replicas

    engine = Engine(params, cfg, seed=reps.index, mesh=reps.mesh, sharded=sharded, device=dev,
                    **kw)
    loop = replica_loop(reps, engine)
    routes = {}
    rec = _recording_routes(engine, routes) if record else contextlib.nullcontext()
    kernels.reset_launches()
    with rec:
        if dist.get_rank() != 0:
            loop.run()
            out = {}
        else:
            engines = start_replicas(reps, loop)
            try:
                out = duplex_script(engines, prompts, tokens, noise_tok)
            finally:
                for e in engines:
                    e.stop()
                for e in engines:
                    e.join(timeout=120)
            out["errors"] = [repr(e.error) for e in engines if e.error is not None]
    out.update(launches=dict(kernels.launches), error=repr(loop.error) if loop.error else None,
               routes=routes, replica=reps.index)
    if loop.link is not None:
        out["link"] = (loop.link.exchanges, loop.link.wait_s)
    return out


def seq_duplex_rank(rank, world, plan):
    """One rank of phase 12 on cuda:0: (a) the ring, (b) the seq-parallel
    training slice, (c) the duplex replicas (narrow fp32, then full width
    read from phase 11's export)."""
    # four ranks' peaks of (b) come to 68 of the card's 79 GiB: segments
    # that grow in place keep each rank's unused cached blocks small (set
    # before this process first touches the card)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel.distributed import serving_replicas
    from vita_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        kernels.lib()  # phase 1's library: loaded, not built
    out = {"ring": {}}
    for seq, model in SEQ_RING_MESHES:
        out["ring"][seq, model] = seq_ring_rank(make_mesh((1, 1, 1, model, 1, seq)), dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = seq_train_rank(make_mesh((1, 1, 1, 1, 1, SEQ_RANKS)), dev, plan["picks"])
    if not plan["duplex"]:  # (a) and (b) alone (chip_probe.py ring-faults)
        return out
    reps = serving_replicas(DUPLEX_AXES, "gloo")
    out["duplex"] = {"allocated_gib": torch.cuda.memory_allocated(dev) / 2**30}
    for label, which, kw, tokens, _ in DUPLEX_RUNS:
        if which == "narrow":
            cfg = narrow_config()
            params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
            sharded = False
        else:
            cfg, params = load_vita_checkpoint(plan["ckpt_dir"], dev, mesh=reps.mesh)
            cfg, sharded = _flash_llm(cfg), True
        p = plan["duplex"][label]
        out["duplex"][label] = duplex_replica_rank(
            reps, dev, cfg, params, sharded, kw, p["prompts"], tokens, p["noise"],
            record=which == "full")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _duplex_reference(card, label, cfg, params, kw, tokens, seed, dev, record):
    """Phase 12(c)'s unsharded side on the card: each prompt's greedy stream
    alone (its top-2 logits and routes recorded with ``record``), then the
    script on two unsharded Engines under EngineThreads. Returns the
    prompts, the noise query's first token, the streams, their request
    ids, top-2, routes and the unsharded script's output."""
    from vita_tpu_torch.serve.engine import Engine, EngineThread, Request

    prompts = duplex_prompts(cfg, tokens, seed)
    streams, ids, top2, routes = {}, {}, {}, {}
    for name, ids_ in prompts.items():
        engine = Engine(params, cfg, device=dev, **kw)
        req = Request(input_ids=ids_, max_new_tokens=tokens[name][1], eos_id=-1)
        with (_recording_top2(engine, top2) if record else contextlib.nullcontext()), \
                (_recording_routes(engine, routes) if record else contextlib.nullcontext()):
            serve(engine, [req])
        streams[name], ids[name] = list(req.tokens), req.request_id
        del engine
    noise = streams["N"][0]
    if noise in (streams["A"][0], streams["B"][0]):
        raise AssertionError(f"{label}: the script needs the noise query's first token "
                             f"{noise} to differ from A's and B's")
    engines = [Engine(params, cfg, seed=i, device=dev, **kw) for i in range(2)]
    threads = [EngineThread(e, tick_idle_s=0.001) for e in engines]
    for t in threads:
        t.start()
    try:
        script = duplex_script(engines, prompts, tokens, noise)
    finally:
        for t in threads:
            t.stop()
        for t in threads:
            t.join(timeout=120)
    _check_script(f"{label}, unsharded", script, tokens)
    for name in ("A", "N", "B"):
        got, want = script[name], streams[name]
        if got != want[:len(got)]:
            raise AssertionError(f"{label}, unsharded duplex: {name}'s tokens {got[:8]}... are "
                                 f"not its greedy stream {want[:8]}...")
    print(f"  unsharded duplex ({label}): A {len(script['A'])} tokens before B interrupted it, "
          f"first text {script['first_text_ms']:.2f} ms, B submit -> swap "
          f"{script['swap_ms']:.2f} ms, swap -> A cancelled {script['cancel_ms']:.2f} ms "
          f"[{card}]", flush=True)
    return dict(prompts=prompts, noise=noise, streams=streams, ids=ids, top2=top2,
                routes=routes, script=script)


def seq_train_reference(card, device):
    """Phase 12(b)'s unsharded side: the step on the whole sequence (after
    a warm-up step), its loss and sampled gradients, then the same step
    with attention computed another exact way (attn_backend 'xla') for the
    spread the check allows. Returns (reference, sampled indices)."""
    import torch

    lcfg = seq_train_config()
    params = seq_train_params(lcfg, device)
    ids, labels = seq_train_batch()
    rng = np.random.default_rng(SEED + 24)
    picks = {name: rng.integers(0, leaf.numel(), min(leaf.numel(), SEQ_GRAD_SAMPLES))
             for name, leaf in _leaf_items(params)}
    batch = (torch.as_tensor(ids, device=device), torch.as_tensor(labels, device=device),
             int((labels != -100).sum()))
    seq_train_step(params, lcfg, *batch)  # warm-up: first-use costs
    for _, leaf in _leaf_items(params):
        leaf.grad = None
    torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.time()
    ce, aux = seq_train_step(params, lcfg, *batch)
    _sync(device)
    train_ref = dict(loss=ce + 0.02 * aux, aux=aux, ms=(time.time() - t0) * 1e3,
                     peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                     samples=_grad_samples(params, picks))
    xcfg = dataclasses.replace(lcfg, attn_backend="xla")
    for key, cfg, with_ce in (("samples_xla", xcfg, True), ("samples_aux", lcfg, False),
                              ("samples_aux_xla", xcfg, False)):
        for _, leaf in _leaf_items(params):
            leaf.grad = None
        ce_x, aux_x = seq_train_step(params, cfg, *batch, with_ce=with_ce)
        train_ref[key] = _grad_samples(params, picks)
        if key == "samples_xla":
            train_ref["loss_xla"] = ce_x + 0.02 * aux_x
    n_params = sum(leaf.numel() for _, leaf in _leaf_items(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (b) unsharded {SEQ_TRAIN_LAYERS}-layer slice ({n_params / 1e9:.2f} B parameters) "
          f"at {SEQ_S} tokens: loss {train_ref['loss']:.6f} (aux {aux:.6f}), forward + "
          f"backward {train_ref['ms']:.1f} ms, peak {train_ref['peak_gib']:.2f} GiB [{card}]",
          flush=True)
    return train_ref, picks


def seq_train_report(card, parts, train_ref, failed):
    """Phase 12(b)'s checks of the ranks' results ``parts`` against
    ``train_ref``, failures appended to ``failed``; the ranks' launch
    counts."""
    auxes = {p["aux"] for p in parts}
    loss = sum(p["share"] for p in parts) + 0.02 * parts[0]["aux"]
    rel = abs(loss - train_ref["loss"]) / abs(train_ref["loss"])
    rel_xla = abs(train_ref["loss_xla"] - train_ref["loss"]) / abs(train_ref["loss"])
    over, lines = [], []
    for objective, key, key_xla in (("loss", "samples", "samples_xla"),
                                    ("aux term alone", "samples_aux", "samples_aux_xla")):
        errs = {}  # leaf: (seq-summed error, xla error), relative Frobenius over the samples
        for name, want in train_ref[key].items():
            got = sum(p[key][name] for p in parts)
            norm = max(float(np.linalg.norm(want)), 1e-30)
            errs[name] = (float(np.linalg.norm(got - want)) / norm,
                          float(np.linalg.norm(train_ref[key_xla][name] - want)) / norm)
        over += [f"(b) gradient of {n} ({objective}): relative error {e:.3e}, the xla step's "
                 f"{e_xla:.3e}" for n, (e, e_xla) in errs.items()
                 if e > SEQ_GRAD_SPREAD * e_xla + SEQ_GRAD_FLOOR]
        lines.append(f"gradients of the {objective}: " + ", ".join(
            f"{n} {e[0]:.3e} ({e[1]:.3e})" for n, e in sorted(errs.items())))
    print(f"  (b) seq {SEQ_RANKS}: loss {loss:.6f} (rel. err {rel:.2e}, bound {SEQ_LOSS_RTOL}; "
          f"the xla-attention step {rel_xla:.2e}), aux on every rank {sorted(auxes)}; "
          f"seq-summed at {SEQ_GRAD_SAMPLES} sampled elements a leaf, relative error (the xla "
          f"step's; bound {SEQ_GRAD_SPREAD} x xla + {SEQ_GRAD_FLOOR}): " + "; ".join(lines)
          + f"; forward + backward {[round(p['ms'], 1) for p in parts]} ms, peak "
          f"{[round(p['peak_gib'], 2) for p in parts]} GiB a rank ({MESH_NOTE}) [{card}]",
          flush=True)
    failed += over
    if len(auxes) != 1:
        failed.append(f"(b) the ranks' aux losses differ: {sorted(auxes)}")
    if rel > SEQ_LOSS_RTOL:
        failed.append(f"(b) loss {loss} vs unsharded {train_ref['loss']}")
    for r, p in enumerate(parts):
        ran = p["launches"]
        missing = [k for k in SEQ_TRAIN_PATH if ran.get(k, 0) == 0]
        if not ran.get("gmm", 0) + ran.get("gmm_small", 0):
            missing.append("gmm or gmm_small")
        if missing:
            failed.append(f"(b) rank {r} never launched {missing}")
    return [p["launches"] for p in parts]


def seq_ring_report(card, rings, ring_ref_ms, failed):
    """Phase 12(a)'s checks of the ranks' results ``rings`` (seq_ring_rank's,
    in rank order): failures appended to ``failed``; returns the launch
    counts of every rank and run."""
    counts = []
    for mesh in SEQ_RING_MESHES:
        for length in SEQ_RING_LENGTHS:
            runs = [ring[mesh][length] for ring in rings]
            bad = [f"(a) {mesh} {length}: rank {r} {v}" for r, run in enumerate(runs)
                   for v in run["errs"].values() if isinstance(v, str)]
            failed += bad
            errs = {k: max((r["errs"][k] for r in runs if not isinstance(r["errs"][k], str)),
                           default=float("nan")) for k in runs[0]["errs"]}
            print(f"  (a) ring seq {mesh[0]} x model {mesh[1]}, causal, length {length} of "
                  f"{SEQ_S}: errors against the unsharded flash_mha (max abs; rel: by Frobenius norm) "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + (f" ({len(bad)} checks FAILED)" if bad else "")
                  + f"; forward + backward {[round(r['ms'], 2) for r in runs]} ms a rank, "
                  f"unsharded {ring_ref_ms[length]:.2f} ms ({MESH_NOTE}) [{card}]", flush=True)
            for r, run in enumerate(runs):
                missing = [k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                           if run["launches"].get(k, 0) == 0]
                if missing:
                    failed.append(f"(a) {mesh} {length}: rank {r} never launched {missing}")
                counts.append(run["launches"])
    return counts


def seq_duplex_phase(card: str, device, ckpt_dir):
    """Phase 12: the unsharded references here, then SEQ_RANKS ranks
    spawned on cuda:0 over gloo (parallel.launch.run_ranks) run (a) the
    ring under each SEQ_RING_MESHES mesh at SEQ_RING_LENGTHS, (b) the
    seq-parallel forward + backward of the 2-layer training slice at
    SEQ_S under seq 4, (c) the duplex replicas at --mesh 1 2 (DUPLEX_RUNS,
    the full width read from phase 11's export in ``ckpt_dir``). Every
    check runs, and the phase then fails on any that failed. Returns the
    launch counts summed over the ranks."""
    import torch

    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.ops.flash_attention import flash_mha_with_lse
    from vita_tpu_torch.parallel.launch import run_ranks

    failed = []
    # (a) the unsharded flash_mha at the ring's shapes, alone on the card
    ring_ref_ms = {}
    for length in SEQ_RING_LENGTHS:
        q, k, v, do, lengths = _ring_inputs(length, device)

        def unsharded():
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o, _ = flash_mha_with_lse(*leaves, kv_len=lengths, causal=True)
            (o.float() * do.float()).sum().backward()

        ring_ref_ms[length] = cuda_ms(unsharded, n=5, warmup=1)
        del q, k, v, do
    train_ref, picks = seq_train_reference(card, device)
    # (c) the duplex references
    plan = {"picks": picks, "ckpt_dir": ckpt_dir, "duplex": {}, "device": "cuda:0"}
    refs = {}
    for label, which, kw, tokens, _ in DUPLEX_RUNS:
        if which == "narrow":
            cfg = narrow_config()
            params = _to(vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu"),
                         device)
        else:
            cfg, params = load_vita_checkpoint(ckpt_dir, device)
            cfg = _flash_llm(cfg)
        refs[label] = _duplex_reference(card, label, cfg, params, kw, tokens, SEED + 25, device,
                                        record=which == "full")
        plan["duplex"][label] = {k: refs[label][k] for k in ("prompts", "noise")}
        del params
        gc.collect()
        torch.cuda.empty_cache()

    print(f"  this process holds {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB of "
          f"the card before the ranks start", flush=True)
    t0 = time.time()
    results = run_ranks(seq_duplex_rank, SEQ_RANKS, plan, backend="gloo", timeout=600,
                        store_dir=os.path.join(ROOT, "build"))
    print(f"  {SEQ_RANKS} ranks on cuda:0 over gloo returned in {time.time() - t0:.1f} s "
          f"({MESH_NOTE})", flush=True)
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    # (a)
    for counts in seq_ring_report(card, [res["ring"] for res in results], ring_ref_ms, failed):
        add(counts)
    # (b)
    add_all = seq_train_report(card, [res["train"] for res in results], train_ref, failed)
    for counts in add_all:
        add(counts)
    # (c)
    print(f"  (c) allocated a rank after (a) and (b): "
          f"{[round(res['duplex']['allocated_gib'], 2) for res in results]} GiB", flush=True)
    for label, which, _, tokens, path in DUPLEX_RUNS:
        ref, first = refs[label], results[0]["duplex"][label]
        try:
            if first.get("errors"):
                raise AssertionError(f"replica errors {first['errors']}")
            _check_script(f"{label}, replicas", first, tokens)
            splits = {}
            for name in ("A", "N", "B"):
                got, want = first[name], ref["streams"][name][:len(first[name])]
                if which == "narrow":
                    if got != want:
                        raise AssertionError(f"{name}'s tokens {got} are not the unsharded "
                                             f"{want}")
                    continue
                mesh_rid = first["ids"][name]
                own = {(0,) + k[1:]: v for res in results
                       for k, v in res["duplex"][label]["routes"].items() if k[0] == mesh_rid}
                splits[name] = _mesh_split(0, got, want, ref["ids"][name], ref["top2"],
                                           ref["routes"], own)
        except (AssertionError, TimeoutError) as e:
            failed.append(f"(c) {label}: {e}")
            continue
        for r, res in enumerate(results):
            run = res["duplex"][label]
            if run["error"] is not None:
                failed.append(f"(c) {label}: rank {r} ended with {run['error']}")
            missing = [k for k in path if run["launches"].get(k, 0) == 0]
            if missing:
                failed.append(f"(c) {label}: rank {r} (replica {run['replica']}) never "
                              f"launched {missing}")
            add(run["launches"])
        p9 = PHASE9_READINGS
        print(f"  (c) duplex replicas --mesh {DUPLEX_AXES[0]} {DUPLEX_AXES[1]}, {label}: A "
              f"promoted on replica 1, the noise query rejected by '<2>' on replica 0, B "
              f"interrupted A after {len(first['A'])} tokens (A cancelled on replica 1, the "
              f"roles swapped back); token ids equal the unsharded streams"
              + ("" if which == "narrow" else f" (splits at near ties: {splits})")
              + f"; first text {first['first_text_ms']:.2f} ms, B submit -> swap "
              f"{first['swap_ms']:.2f} ms, swap -> A cancelled {first['cancel_ms']:.2f} ms "
              f"(unsharded {ref['script']['first_text_ms']:.2f} / {ref['script']['swap_ms']:.2f}"
              f" / {ref['script']['cancel_ms']:.2f}; phase 9's duplex app: speech end -> first "
              f"text {p9.get('first_text_ms')}, interrupt -> role swap {p9.get('swap_ms')}) "
              f"[{card}]", flush=True)
        (n_link, link_s), = [res["duplex"][label]["link"] for res in results
                             if "link" in res["duplex"][label]]
        print(f"    first text: A {first['first_text_ms']:.2f} ms on replica 1 (through the "
              f"link), the noise query {first['noise_first_ms']:.2f} ms on replica 0 (no link; "
              f"unsharded {ref['script']['first_text_ms']:.2f} / "
              f"{ref['script']['noise_first_ms']:.2f}); replica 1's link to rank 0: "
              f"{n_link} round trips, {link_s * 1e3 / max(n_link, 1):.3f} ms each, "
              f"{link_s:.3f} s in all [{card}]", flush=True)
        for r, res in enumerate(results):
            print(f"    rank {r} (replica {res['duplex'][label]['replica']}) launches: "
                  f"{ {k: n for k, n in res['duplex'][label]['launches'].items() if n} }",
                  flush=True)
    if failed:
        raise AssertionError("phase 12 failed:\n  " + "\n  ".join(failed))
    return total


# --------------------------------------------------------------------------
# phase 13: pipeline-parallel serving and one GPipe step, as 4 ranks on
# cuda:0 over gloo
# --------------------------------------------------------------------------
PIPE_RANKS = 4
# --mesh EXPERT MODEL PIPE of (a), narrow fp32 at PIPE_NARROW_LAYERS layers,
# and of (b), the full-width 4-layer slice read from phase 11's export
PIPE_NARROW_MESHES = ((1, 1, 4), (1, 2, 2))
PIPE_FULL_MESHES = ((1, 1, 4), (2, 1, 2))
PIPE_NARROW_LAYERS = 4
# (a) also runs mixtral.pp_generate under pipe 4 (the GPipe prefill that
# keeps each stage's KV rows, then the ring): 4 waves of 2 prompts
PIPE_GEN_WAVES, PIPE_GEN_BATCH, PIPE_GEN_PROMPT, PIPE_GEN_NEW, PIPE_GEN_LEN = 4, 2, 24, 8, 64
# the kernels every rank must launch in (a) and (b): B1, B2, B9, B3, B7, B5b
PIPE_PATH = ("flash_fwd", "paged_attention", "paged_attention_q", "gather_expert_ffn",
             "gather_expert_ffn_q4", "gmm_small")
# (c): one GPipe step of phase 12(b)'s 2-layer training slice with dense MoE
# (gmm under a pipe axis raises, as in the JAX package) under pipe 2 with 2
# microbatches of one sequence of PIPE_TRAIN_S tokens each, on two replicas
# (ranks 0-1 and 2-3). Loss and gradients are held as phase 12(b) holds
# them; aux against the mean of the unpiped per-microbatch aux (the GPipe
# aux is the microbatches' mean, not the whole batch's) at SEQ_LOSS_RTOL.
PIPE_TRAIN_S = 2048
PIPE_TRAIN_B = 2
# A full-width stream may also split where the pipe run's own logits put
# the unsharded run's token within this many bf16 ulps of its choice
# (_pipe_split): on an H100 the 4-layer slice split two requests at logit
# gaps of one ulp (0.015625) and of zero (a three-way tie), with the same
# routes (PERF.md section 6)
PIPE_NEAR_TIE_ULPS = 2
PIPE_TRAIN_PATH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def pipe_narrow_config():
    """Phase 5's narrow fp32 configuration at PIPE_NARROW_LAYERS layers."""
    cfg = narrow_config()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, n_layers=PIPE_NARROW_LAYERS))


def pipe_generate_prompts(cfg):
    rng = np.random.default_rng(SEED + 31)
    return rng.integers(3, cfg.llm.vocab_size,
                        (PIPE_GEN_WAVES, PIPE_GEN_BATCH, PIPE_GEN_PROMPT)).astype(np.int64)


def pipe_train_config():
    return dataclasses.replace(seq_train_config(), moe_mode="dense")


def pipe_train_batch():
    """PIPE_TRAIN_B sequences of PIPE_TRAIN_S ids from a seed and their
    next-token labels."""
    rng = np.random.default_rng(SEED + 32)
    ids = rng.integers(3, pipe_train_config().vocab_size,
                       (PIPE_TRAIN_B, PIPE_TRAIN_S)).astype(np.int64)
    labels = np.full_like(ids, -100)
    labels[:, :-1] = ids[:, 1:]
    return ids, labels


@contextlib.contextmanager
def _recording_pp_routes(engine, routes):
    """_recording_routes for a pipe Engine's stage: every routing of this
    stage's layers, keyed as _recording_routes keys them, as
    routes[key][global layer] = (experts, gap)."""
    import torch

    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.ops import moe
    from vita_tpu_torch.parallel.mesh import PIPE, axis
    from vita_tpu_torch.serve import engine as engine_mod

    n_local = engine.cfg.llm.n_layers // engine._pp
    layer0 = axis(engine.mesh, PIPE).rank * n_local
    real = (engine_mod.pp_prefill_chunk, engine_mod.pp_decode_chunk, mixtral.run_layers,
            mixtral.route_topk, moe.route_topk)
    ctx = {}

    def route(logits, k):
        w, idx, probs = real[3](logits, k)
        if ctx.get("keys") is not None:
            layer = layer0 + ctx["calls"]
            ctx["calls"] += 1
            top = torch.topk(probs, k + 1, dim=-1).values
            for key, ids, gap in zip(ctx["keys"], idx.tolist(),
                                     (top[:, k - 1] - top[:, k]).tolist()):
                if key is not None:
                    routes.setdefault(key, {})[layer] = (tuple(sorted(ids)), gap)
        return w, idx, probs

    def run_layers(layers, cfg, x, positions, *a, **kw):
        cache = kw.get("cache", a[1] if len(a) > 1 else None)
        pos = positions[:, 0].tolist() if "prefill" not in ctx else positions[0].tolist()
        if "prefill" in ctx:
            job = ctx["prefill"]
            keys = [(job.req.request_id, "prompt", p) if p < job.true_len else None for p in pos]
        else:
            table, slots, bw = ctx["decode"]
            wave = ((cache["table"].data_ptr() - table.data_ptr())
                    // (table.stride(0) * table.element_size()))
            act = cache["active"].tolist()
            keys = []
            for b, p in enumerate(pos):
                req = slots[wave * bw + b]
                keys.append(None if req is None or not act[b]
                            else (req.request_id, p + 1 - len(req.input_ids)))
        ctx.update(keys=keys, calls=0)
        try:
            return real[2](layers, cfg, x, positions, *a, **kw)
        finally:
            ctx["keys"] = None

    def prefill(llm_params, llm_cfg, job, *a, **kw):
        ctx["prefill"] = job
        try:
            return real[0](llm_params, llm_cfg, job, *a, **kw)
        finally:
            ctx.pop("prefill")

    def decode(llm_params, cache, table, *a, **kw):
        ctx["decode"] = (table, list(engine.slot_req), table.shape[1])
        try:
            return real[1](llm_params, cache, table, *a, **kw)
        finally:
            ctx.pop("decode")

    engine_mod.pp_prefill_chunk, engine_mod.pp_decode_chunk = prefill, decode
    mixtral.run_layers = run_layers
    mixtral.route_topk = moe.route_topk = route
    try:
        yield
    finally:
        (engine_mod.pp_prefill_chunk, engine_mod.pp_decode_chunk, mixtral.run_layers,
         mixtral.route_topk, moe.route_topk) = real


@contextlib.contextmanager
def _recording_pp_top(engine, tops, k: int = 4):
    """While open, each token the decode ring samples records, on the
    ranks that sample it, its row's top ``k`` (token, logit) as
    tops[(request_id, i)], i indexing the request's generated token (as
    _recording_top2 keys it). The ring finishes item jf = w + i*S at its
    jf-th sample: wave jf mod S, token jf // S."""
    import torch

    from vita_tpu_torch.parallel import pp_serving
    from vita_tpu_torch.serve import engine as engine_mod

    real_decode, real_sample = engine_mod.pp_decode_chunk, pp_serving.sample_tokens
    ctx = {}

    def decode(llm_params, cache, table, tok, pos, *a, **kw):
        ctx.update(pos=pos.tolist(), slots=list(engine.slot_req), waves=tok.shape[0],
                   bw=tok.shape[1], item=0)
        try:
            return real_decode(llm_params, cache, table, tok, pos, *a, **kw)
        finally:
            ctx.clear()

    def sample(logits, *a, **kw):
        if ctx:
            w, i = ctx["item"] % ctx["waves"], ctx["item"] // ctx["waves"]
            ctx["item"] += 1
            v, t = torch.topk(logits.float(), k, dim=-1)
            for b, (toks, vals) in enumerate(zip(t.tolist(), v.tolist())):
                req = ctx["slots"][w * ctx["bw"] + b]
                if req is not None:
                    key = (req.request_id, ctx["pos"][w][b] + i + 1 - len(req.input_ids))
                    tops[key] = list(zip(toks, vals))
        return real_sample(logits, *a, **kw)

    engine_mod.pp_decode_chunk, pp_serving.sample_tokens = decode, sample
    try:
        yield
    finally:
        engine_mod.pp_decode_chunk, pp_serving.sample_tokens = real_decode, real_sample


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def _pipe_split(i, got, ref, rid, top2, routes, own_routes, own_top):
    """_mesh_split, and where it finds no near tie, the pipe run's own: a
    split at token j is also accepted where the pipe run's logits put the
    unsharded run's token within PIPE_NEAR_TIE_ULPS bf16 ulps of its own
    choice (the ring's B3/B7 round otherwise than the unsharded batches'
    B4/B8b, and the bf16 logits of two tokens one or two ulps apart, or
    three at a tie, may reorder)."""
    try:
        return _mesh_split(i, got, ref, rid, top2, routes, own_routes)
    except AssertionError:
        j = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        vals = dict(own_top.get((i, j), []))
        if got[j] in vals and ref[j] in vals:
            gap = vals[got[j]] - vals[ref[j]]
            bound = PIPE_NEAR_TIE_ULPS * _bf16_ulp(vals[got[j]])
            if gap <= bound:
                print(f"    request {i} splits at token {j}: {got[j]} vs {ref[j]}, a near tie "
                      f"of the pipe run's logits (gap {gap:.3e} <= {PIPE_NEAR_TIE_ULPS} bf16 "
                      f"ulps, {bound:.3e})", flush=True)
                return j
        raise


@contextlib.contextmanager
def _timing_ring(times):
    """While open, the host seconds of each decode-ring shift (the
    substep's point-to-point step, staged through host memory on gloo)
    are appended to ``times``."""
    from vita_tpu_torch.parallel import pp_serving

    real = pp_serving.ring_shift

    def shift(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            times.append(time.perf_counter() - t0)

    pp_serving.ring_shift = shift
    try:
        yield
    finally:
        pp_serving.ring_shift = real


@contextlib.contextmanager
def _recording_stage_output(store):
    """While open, each prefill chunk's hidden state after this stage's
    layers (mixtral.run_layers over a linear scratch) lands in
    store["hidden"] (float32, host)."""
    from vita_tpu_torch.models import mixtral

    real = mixtral.run_layers

    def run_layers(layers, cfg, x, positions, *a, **kw):
        y, aux = real(layers, cfg, x, positions, *a, **kw)
        cache = kw.get("cache", a[1] if len(a) > 1 else None)
        if cache is not None and "k" in cache:
            store["hidden"] = y[0].float().cpu().numpy()
        return y, aux

    mixtral.run_layers = run_layers
    try:
        yield
    finally:
        mixtral.run_layers = real


@contextlib.contextmanager
def _recording_layer_outputs(store):
    """While open, an unsharded prefill runs its layers one at a time
    (mixtral.run_layers on one-layer views of the stack and the scratch,
    the same kernels at the same shapes) and store["hidden"] lists the
    hidden state after each layer (float32, host)."""
    import inspect

    from vita_tpu_torch.models import mixtral

    real = mixtral.run_layers
    sig = inspect.signature(real)

    def run_layers(*a, **kw):
        args = sig.bind(*a, **kw)
        args.apply_defaults()
        v = args.arguments
        cache = v["cache"]
        if cache is None or "k" not in cache:
            return real(*a, **kw)
        x, aux, out = v["x"], 0.0, []
        for i in range(mixtral.n_layers_of(v["layers"])):
            one = {k: ({n: t[i:i + 1] for n, t in l.items()} if isinstance(l, dict)
                       else l[i:i + 1]) for k, l in v["layers"].items()}
            c1 = {"k": cache["k"][i:i + 1], "v": cache["v"][i:i + 1], "pos": cache["pos"]}
            x, a_i = real(**{**v, "layers": one, "x": x, "cache": c1})
            aux = aux + a_i
            out.append(x[0].float().cpu().numpy())
        store["hidden"] = out
        return x, aux

    mixtral.run_layers = run_layers
    try:
        yield
    finally:
        mixtral.run_layers = real


def pipe_stage_request(cfg):
    """The stage check's request: one 100-token text, one new token (the
    prefill's; no decode step writes a row)."""
    rng = np.random.default_rng(SEED + 33)
    return text_request(cfg, rng, 100, 1)


def _serve_full_pp(engine, cfg, wave_texts, routes, tops, shifts):
    """mesh_full_requests through a pipe ``engine``, its routes, sampled
    top logits and ring shifts recorded: (streams, request ids, TTFT ms,
    decode tok/s)."""
    warm, solo, wave = mesh_full_requests(cfg, wave_texts)
    serve(engine, warm)
    with (_recording_pp_routes(engine, routes), _recording_pp_top(engine, tops),
          _timing_ring(shifts)):
        reqs = serve(engine, solo) + serve(engine, wave)
    return ([r.tokens for r in reqs], [r.request_id for r in reqs],
            [r.ttft_s * 1e3 for r in reqs], [r.decode_tokens_per_s for r in reqs])


def pipe_train_rank(mesh, dev, picks):
    """Phase 13(c) on one rank: the GPipe forward + backward of the
    2-layer slice on this stage's layer (after a warm-up step; launch
    counts zeroed before, read after): loss, aux, step ms, peak memory and
    this rank's gradients at the sampled elements of each leaf it holds
    ({name: (sampled positions it holds, values)})."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.mesh import PIPE, axis

    lcfg = dataclasses.replace(pipe_train_config(), pipe_stages=2, pipe_microbatches=2)
    whole = seq_train_params(pipe_train_config(), dev)
    with torch.no_grad():  # copies: the stage's block alone stays on the card
        params = _to(mixtral.shard_params(whole, lcfg, mesh, dev,
                                          specs=mixtral.param_specs(lcfg)), dev)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    for _, leaf in _leaf_items(params):
        leaf.requires_grad_()
    ids, labels = pipe_train_batch()
    n_labels = int((labels != -100).sum())
    batch = (torch.as_tensor(ids, device=dev), torch.as_tensor(labels, device=dev), n_labels)
    seq_train_step(params, lcfg, *batch, mesh=mesh)  # warm-up: first-use costs
    for _, leaf in _leaf_items(params):
        leaf.grad = None
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    ce, aux = seq_train_step(params, lcfg, *batch, mesh=mesh)
    torch.cuda.synchronize(dev)
    ms = (time.time() - t0) * 1e3
    stage = axis(mesh, PIPE).rank
    samples = {}  # name: (which sampled elements this rank holds, their values)
    for name, leaf in _leaf_items(params):
        idx = np.asarray(picks[name])
        lo = stage * leaf.numel() if name.startswith("layers/") else 0  # the stage's block
        held = (idx >= lo) & (idx < lo + leaf.numel())
        vals = np.zeros(len(idx), np.float32)
        local = torch.as_tensor(idx[held] - lo, device=dev)
        vals[held] = leaf.grad.reshape(-1)[local].float().cpu().numpy()
        samples[name] = (held, vals)
    out = dict(loss=ce + 0.02 * aux, aux=aux, ms=ms, stage=stage,
               launches=dict(kernels.launches), samples=samples,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_rank(rank, world, plan):
    """One rank of phase 13 on cuda:0: (a) the narrow fp32 Engine runs
    under each PIPE_NARROW_MESHES mesh and pp_generate under pipe 4; (b)
    the full-width runs under each PIPE_FULL_MESHES mesh over this rank's
    shards read from phase 11's export, with the stage check first under
    pipe 4; launch counts zeroed before (a) and read after (b); (c) one
    GPipe step under pipe 2 (two replicas)."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.parallel.mesh import make_mesh
    from vita_tpu_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    kernels.lib()  # phase 1's library: loaded, not built
    meshes = {axes: make_mesh((1, 1) + axes)
              for axes in dict.fromkeys(PIPE_NARROW_MESHES + PIPE_FULL_MESHES)}
    pairs = [make_mesh((1, 1, 1, 1, 2), ranks=r) for r in ((0, 1), (2, 3))]
    out = {"narrow": {}, "full": {}, "wall_s": {}}
    t_part = time.time()
    kernels.reset_launches()
    cfg = pipe_narrow_config()
    params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    for axes in PIPE_NARROW_MESHES:
        for label, kw in MESH_NARROW_RUNS:
            engine = Engine(params, cfg, n_slots=4, max_len=512, page_size=64,
                            prefill_chunk=128, device=dev, mesh=meshes[axes], **kw)
            first, wave = mesh_narrow_requests(cfg)
            out["narrow"][axes, label] = [r.tokens for r in serve(engine, first)
                                          + serve(engine, wave)]
            del engine
    gcfg = dataclasses.replace(cfg.llm, pipe_stages=4)
    local = mixtral.shard_params(params["llm"], gcfg, meshes[1, 1, 4], dev)
    prompts = torch.as_tensor(pipe_generate_prompts(cfg), device=dev)
    out["generate"] = mixtral.pp_generate(local, gcfg, meshes[1, 1, 4], prompts, PIPE_GEN_NEW,
                                          PIPE_GEN_LEN).cpu().numpy()
    del params, local
    out["wall_s"]["a"], t_part = time.time() - t_part, time.time()
    cfg = slice_config()
    for axes in PIPE_FULL_MESHES if plan["ckpt_dir"] else ():
        mesh = meshes[axes]
        t0 = time.time()
        _, shards = load_vita_checkpoint(plan["ckpt_dir"], dev, mesh=mesh)
        loaded = time.time() - t0
        if axes == (1, 1, 4):
            stage = {}
            engine = Engine(shards, cfg, max_len=2048, device=dev, mesh=mesh, sharded=True,
                            **MESH_FULL_RUNS[0][1])
            with _recording_stage_output(stage):
                serve(engine, [pipe_stage_request(cfg)])
            out["stage"] = {"hidden": stage["hidden"],  # the pool's bits, as int16
                            "k": engine.cache["k_pages"].view(torch.int16).cpu().numpy(),
                            "v": engine.cache["v_pages"].view(torch.int16).cpu().numpy()}
            del engine
        for label, kw, wave_texts in MESH_FULL_RUNS:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            engine = Engine(shards, cfg, max_len=2048, device=dev, mesh=mesh, sharded=True,
                            **kw)
            built = time.time() - t0
            routes, tops, shifts = {}, {}, []
            tokens, ids, ttft, tps = _serve_full_pp(engine, cfg, wave_texts, routes, tops,
                                                    shifts)

            def own(rec):  # by request index
                return {(ids.index(k[0]),) + k[1:]: v for k, v in rec.items() if k[0] in ids}

            out["full"][axes, label] = dict(
                tokens=tokens, ttft_ms=ttft, tok_s=tps, loaded_s=loaded, built_s=built,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, routes=own(routes),
                tops=own(tops), shift_ms=[t * 1e3 for t in shifts])
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        del shards
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(kernels.launches)
    out["wall_s"]["b"], t_part = time.time() - t_part, time.time()
    out["train"] = pipe_train_rank(pairs[rank // 2], dev, plan["picks"])
    out["wall_s"]["c"] = time.time() - t_part
    return out


def pipe_microbatch_step(params, lcfg, ids, labels, n_labels):
    """The GPipe step's objective without the pipe, and its backward: for
    each of the PIPE_TRAIN_B microbatches (one sequence each) its summed
    cross entropy / n_labels + 0.02 * its aux / PIPE_TRAIN_B, the
    gradients summed over them (the pipeline's aux is the microbatches'
    mean, not the whole batch's). Returns (loss, mean aux)."""
    import torch.nn.functional as F

    from vita_tpu_torch.models import mixtral

    loss, auxes = 0.0, []
    for i in range(PIPE_TRAIN_B):
        logits, _, aux = mixtral.forward(params, lcfg, input_ids=ids[i:i + 1])
        ce = F.cross_entropy(logits.float().flatten(0, 1), labels[i:i + 1].flatten(),
                             ignore_index=-100, reduction="sum") / n_labels
        (ce + 0.02 * aux / PIPE_TRAIN_B).backward()
        loss += float(ce.detach()) + 0.02 * float(aux.detach()) / PIPE_TRAIN_B
        auxes.append(float(aux.detach()))
    return loss, float(np.mean(auxes))


def pipe_train_reference(card, device):
    """Phase 13(c)'s unpiped side: the GPipe step's objective taken one
    microbatch at a time (pipe_microbatch_step, after a warm-up), then
    with attention computed another exact way ('xla') for the spread the
    check allows. Returns (reference, sampled indices)."""
    import torch

    lcfg = pipe_train_config()
    params = seq_train_params(lcfg, device)
    ids, labels = pipe_train_batch()
    rng = np.random.default_rng(SEED + 34)
    picks = {name: rng.integers(0, leaf.numel(), min(leaf.numel(), SEQ_GRAD_SAMPLES))
             for name, leaf in _leaf_items(params)}
    batch = (torch.as_tensor(ids, device=device), torch.as_tensor(labels, device=device),
             int((labels != -100).sum()))
    pipe_microbatch_step(params, lcfg, *batch)  # warm-up: first-use costs
    for _, leaf in _leaf_items(params):
        leaf.grad = None
    _sync(device)
    t0 = time.time()
    loss, aux_mb = pipe_microbatch_step(params, lcfg, *batch)
    _sync(device)
    ref = dict(loss=loss, aux_mb=aux_mb, ms=(time.time() - t0) * 1e3,
               samples=_grad_samples(params, picks))
    for _, leaf in _leaf_items(params):
        leaf.grad = None
    ref["loss_xla"], _ = pipe_microbatch_step(
        params, dataclasses.replace(lcfg, attn_backend="xla"), *batch)
    ref["samples_xla"] = _grad_samples(params, picks)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (c) unpiped {SEQ_TRAIN_LAYERS}-layer slice (dense MoE), {PIPE_TRAIN_B} "
          f"microbatches of {PIPE_TRAIN_S} tokens one after the other: loss {ref['loss']:.6f}, "
          f"forward + backward {ref['ms']:.1f} ms [{card}]", flush=True)
    return ref, picks


def pipe_train_report(card, parts, ref, failed):
    """Phase 13(c)'s checks of the ranks' results against ``ref``, failures
    appended to ``failed``."""
    rel_xla = abs(ref["loss_xla"] - ref["loss"]) / abs(ref["loss"])
    for rep in range(len(parts) // 2):
        pair = parts[2 * rep:2 * rep + 2]
        tag = f"(c) replica {rep}"
        losses = {p["loss"] for p in pair}
        auxes = {p["aux"] for p in pair}
        loss = pair[0]["loss"]
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        aux_rel = abs(pair[0]["aux"] - ref["aux_mb"]) / abs(ref["aux_mb"])
        errs = {}
        for name, want in ref["samples"].items():
            got = np.zeros_like(want)
            seen = np.zeros(len(want), bool)
            for p in pair:
                held, vals = p["samples"][name]
                if not name.startswith("layers/") and p is not pair[0]:
                    # replicated over 'pipe': the whole gradient on every stage
                    if not np.array_equal(vals, pair[0]["samples"][name][1]):
                        failed.append(f"{tag}: the stages' gradients of {name} differ")
                    continue
                got[held], seen[held] = vals[held], True
            if not seen.all():
                failed.append(f"{tag}: no stage holds the gradient of {name} at "
                              f"{int((~seen).sum())} sampled elements")
            norm = max(float(np.linalg.norm(want)), 1e-30)
            errs[name] = (float(np.linalg.norm(got - want)) / norm,
                          float(np.linalg.norm(ref["samples_xla"][name] - want)) / norm)
        over = [f"{tag}: gradient of {n}: relative error {e:.3e}, the xla step's {x:.3e}"
                for n, (e, x) in errs.items() if e > SEQ_GRAD_SPREAD * x + SEQ_GRAD_FLOOR]
        failed += over
        if len(losses) != 1 or len(auxes) != 1:
            failed.append(f"{tag}: the stages' loss or aux differ: {losses}, {auxes}")
        if rel > SEQ_LOSS_RTOL:
            failed.append(f"{tag}: loss {loss} vs unpiped {ref['loss']}")
        if aux_rel > SEQ_LOSS_RTOL:
            failed.append(f"{tag}: aux {pair[0]['aux']} vs the unpiped per-microbatch mean "
                          f"{ref['aux_mb']}")
        for r, p in enumerate(pair):
            missing = [k for k in PIPE_TRAIN_PATH if p["launches"].get(k, 0) == 0]
            if missing:
                failed.append(f"{tag}: stage {r} never launched {missing}")
        print(f"  (c) pipe 2, M 2, {tag[4:]}: loss {loss:.6f} (rel. err {rel:.2e}, bound "
              f"{SEQ_LOSS_RTOL}; the xla step {rel_xla:.2e}), aux {pair[0]['aux']:.6f} against "
              f"the unpiped per-microbatch mean {ref['aux_mb']:.6f} (rel. err {aux_rel:.2e}); "
              f"gradients at {SEQ_GRAD_SAMPLES} sampled elements a leaf, relative error (the "
              f"xla step's; bound {SEQ_GRAD_SPREAD} x xla + {SEQ_GRAD_FLOOR}): "
              + ", ".join(f"{n} {e:.3e} ({x:.3e})" for n, (e, x) in sorted(errs.items()))
              + f"; step {[round(p['ms'], 1) for p in pair]} ms a stage (unpiped "
              f"{ref['ms']:.1f}), peak {[round(p['peak_gib'], 2) for p in pair]} GiB "
              f"({MESH_NOTE}) [{card}]", flush=True)
    return [p["launches"] for p in parts]


def pipe_phase(card: str, device, ckpt_dir=None):
    """Phase 13: pipeline-parallel serving and one GPipe step as
    PIPE_RANKS ranks spawned on cuda:0 over gloo, against unsharded runs
    here (phase 11's full-width references; (a)'s and (c)'s made now).
    (a) Narrow fp32 (MESH_NARROW_RUNS at PIPE_NARROW_LAYERS layers under
    each PIPE_NARROW_MESHES mesh): every rank's streams identical to the
    unsharded Engine's; pp_generate under pipe 4 identical to the greedy
    loop. (b) Full width (MESH_FULL_RUNS under each PIPE_FULL_MESHES mesh,
    shards read per stage by load_vita_checkpoint(..., mesh=)): every
    rank's streams equal, and apart from the unsharded run's only at a
    logit or router near tie (_mesh_split; the ring decodes through B3/B7
    where the unsharded Engine's batches take B4/B8b); under pipe 4 each
    stage's prefill output equals the unsharded prefill's after its layer
    bitwise, and its pool the unsharded pool's layer. (c) one GPipe step
    (pipe_train_report). Without ``ckpt_dir`` (b) is left out
    (chip_probe.py pp-faults). Every check runs, and the phase then fails
    on any that failed. Returns the launch counts summed over the ranks."""
    import torch

    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.parallel.launch import run_ranks
    from vita_tpu_torch.serve.engine import Engine

    failed = []
    # (a) the unsharded narrow runs and greedy loop
    ncfg = pipe_narrow_config()
    nparams = _to(vita.init_params(ncfg, torch.Generator().manual_seed(SEED), "cpu"), device)
    narrow_ref = {}
    for label, kw in MESH_NARROW_RUNS:
        engine = Engine(nparams, ncfg, n_slots=4, max_len=512, page_size=64, prefill_chunk=128,
                        device=device, **kw)
        first, wave = mesh_narrow_requests(ncfg)
        narrow_ref[label] = [r.tokens for r in serve(engine, first) + serve(engine, wave)]
        del engine
    prompts = pipe_generate_prompts(ncfg)
    gen_ref = np.zeros((PIPE_GEN_WAVES, PIPE_GEN_NEW + 1, PIPE_GEN_BATCH), np.int64)
    with torch.no_grad():
        for w in range(PIPE_GEN_WAVES):
            cache = mixtral.init_kv_cache(ncfg.llm, PIPE_GEN_BATCH, PIPE_GEN_LEN, device=device)
            dense = dataclasses.replace(ncfg.llm, moe_mode="dense")
            logits, cache, _ = mixtral.forward(nparams["llm"], dense,
                                               input_ids=torch.as_tensor(prompts[w], device=device),
                                               cache=cache)
            tok = logits[:, -1].float().argmax(-1)
            gen_ref[w, 0] = tok.cpu().numpy()
            for i in range(PIPE_GEN_NEW):
                logits, cache, _ = mixtral.forward(nparams["llm"], ncfg.llm,
                                                   input_ids=tok[:, None], cache=cache)
                tok = logits[:, -1].float().argmax(-1)
                gen_ref[w, i + 1] = tok.cpu().numpy()
    del nparams
    if ckpt_dir:  # (b) the stage check's unsharded prefill, layer by layer
        cfg = slice_config()
        _, params = load_vita_checkpoint(ckpt_dir, device)
        engine = Engine(params, cfg, max_len=2048, device=device, **MESH_FULL_RUNS[0][1])
        layers = {}
        with _recording_layer_outputs(layers):
            serve(engine, [pipe_stage_request(cfg)])
        stage_ref = {"hidden": layers["hidden"],
                     "k": engine.cache["k_pages"].view(torch.int16).cpu().numpy(),
                     "v": engine.cache["v_pages"].view(torch.int16).cpu().numpy()}
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
    # (c)
    train_ref, picks = pipe_train_reference(card, device)
    train_ref["picks"] = picks
    plan = {"ckpt_dir": ckpt_dir, "picks": picks, "device": "cuda:0"}
    t0 = time.time()
    results = run_ranks(pipe_rank, PIPE_RANKS, plan, backend="gloo", timeout=600,
                        store_dir=os.path.join(ROOT, "build"))
    print(f"  {PIPE_RANKS} ranks on cuda:0 over gloo returned in {time.time() - t0:.1f} s "
          f"(rank 0: (a) {results[0]['wall_s']['a']:.1f} s, (b) "
          f"{results[0]['wall_s'].get('b', 0.0):.1f} s, (c) {results[0]['wall_s']['c']:.1f} s; "
          f"{MESH_NOTE})", flush=True)
    # (a)
    for axes in PIPE_NARROW_MESHES:
        for label, _ in MESH_NARROW_RUNS:
            bad = [r for r, res in enumerate(results)
                   if res["narrow"][axes, label] != narrow_ref[label]]
            if bad:
                failed.append(f"(a) --mesh {' '.join(map(str, axes))} {label}: rank {bad[0]}'s "
                              f"streams {results[bad[0]]['narrow'][axes, label]} differ from "
                              f"the unsharded {narrow_ref[label]}")
                continue
            print(f"  (a) narrow fp32 --mesh {' '.join(map(str, axes))}, {label}: "
                  f"{len(narrow_ref[label])} requests, every rank's greedy streams identical to "
                  f"the unsharded Engine's", flush=True)
    bad = [r for r, res in enumerate(results) if not np.array_equal(res["generate"], gen_ref)]
    if bad:
        failed.append(f"(a) pp_generate under pipe 4: rank {bad[0]}'s tokens "
                      f"{results[bad[0]]['generate'].tolist()} are not the greedy loop's "
                      f"{gen_ref.tolist()}")
    else:
        print(f"  (a) pp_generate under pipe 4 ({PIPE_GEN_WAVES} waves of {PIPE_GEN_BATCH}, "
              f"{PIPE_GEN_NEW} new tokens): every rank's tokens identical to the greedy loop's",
              flush=True)
    # (b) the stage check, then the streams
    for r, res in enumerate(results if ckpt_dir else ()):
        got = res["stage"]
        same = (np.array_equal(got["hidden"], stage_ref["hidden"][r])
                and np.array_equal(got["k"][0], stage_ref["k"][r])
                and np.array_equal(got["v"][0], stage_ref["v"][r]))
        diff = float(np.abs(got["hidden"] - stage_ref["hidden"][r]).max())
        print(f"  (b) --mesh 1 1 4 stage {r}: hidden handed on vs the unsharded prefill after "
              f"layer {r}: max |diff| {diff:.3e}; pool rows "
              f"{'equal' if np.array_equal(got['k'][0], stage_ref['k'][r]) else 'DIFFER'} "
              f"(bitwise check: {'passed' if same else 'FAILED'})", flush=True)
        if not same:
            failed.append(f"(b) stage {r}: its hidden state or pool rows differ from the "
                          f"unsharded prefill's layer {r} (max |diff| {diff:.3e})")
    for axes in PIPE_FULL_MESHES if ckpt_dir else ():
        for label, _, _ in MESH_FULL_RUNS:
            name = f"--mesh {' '.join(map(str, axes))}, {label}"
            ref, ids, top2, routes = MESH_FULL_REFS[label]
            got = results[0]["full"][axes, label]["tokens"]
            if any(res["full"][axes, label]["tokens"] != got for res in results):
                failed.append(f"(b) {name}: the ranks' streams differ")
                continue
            own = {}
            for res in results:
                for key, by_layer in res["full"][axes, label]["routes"].items():
                    own.setdefault(key, {}).update(by_layer)
            own = {k: [v[i] for i in sorted(v)] for k, v in own.items()}
            tops = {}
            for res in results:
                tops.update(res["full"][axes, label]["tops"])
            try:
                splits = [_pipe_split(i, g, w, rid, top2, routes, own, tops)
                          for i, (g, w, rid) in enumerate(zip(got, ref, ids))]
            except AssertionError as e:
                failed.append(f"(b) {name}: {e}")
                continue
            print(f"  (b) full width {name}: {len(ref)} requests, every rank's streams equal; "
                  f"against the unsharded Engine: {sum(s is None for s in splits)} identical, "
                  f"splits at near ties {splits}", flush=True)
            for r, res in enumerate(results):
                run = res["full"][axes, label]
                shift = np.asarray(run["shift_ms"])
                print(f"    rank {r}: peak memory {run['peak_gib']:.2f} GiB, shards loaded in "
                      f"{run['loaded_s']:.1f} s, Engine built in {run['built_s']:.1f} s, TTFT "
                      f"{[round(t, 2) for t in run['ttft_ms']]} ms, decode "
                      f"{[round(t, 2) for t in run['tok_s']]} tok/s, ring shift host ms a "
                      f"substep median {np.median(shift):.3f} (p90 "
                      f"{np.percentile(shift, 90):.3f}, {len(shift)} substeps)  ({MESH_NOTE}) "
                      f"[{card}]", flush=True)
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    for r, res in enumerate(results):
        counts = res["launches"]
        print(f"  rank {r} kernel launches in phase 13 (a)-(b): "
              f"{ {k: n for k, n in counts.items() if n} }", flush=True)
        missing = [k for k in PIPE_PATH if counts.get(k, 0) == 0]
        if missing:
            failed.append(f"(a)-(b) rank {r} never launched {missing}")
        add(counts)
    for counts in pipe_train_report(card, [res["train"] for res in results], train_ref, failed):
        add(counts)
    if failed:
        raise AssertionError("phase 13 failed:\n  " + "\n  ".join(failed))
    return total


# --------------------------------------------------------------------------
# phase 14: sharded training over the data and fsdp axes (ZeRO-3)
# --------------------------------------------------------------------------
FSDP_RANKS = 4
AXES_ALL = ("data", "fsdp", "expert", "model", "pipe", "seq")
# (a) narrow fp32: phase 7's configuration (stage 2, gmm, flash); pipe 2
# runs dense MoE (gmm under pipe raises, as the JAX package's) with one
# microbatch, so its objective is the unsharded step's (with 2 the aux is
# the microbatches' mean, the JAX package's GPipe deviation)
FSDP_NARROW_MESHES = ((1, 4, 1, 1), (2, 2, 1, 1), (1, 2, 1, 1, 2), (1, 2, 1, 1, 1, 2))
FSDP_NARROW_STEPS = 3
FSDP_NARROW_B, FSDP_NARROW_S = 4, 256
# per leaf after the last update: |w_mesh - w_ref| <= 2 * (the leaf's
# learning rates summed over the updates) + FSDP_NARROW_ATOL everywhere
# (Adam may move a weight whose gradient is at rounding level by up to
# 2 lr differently, as phase 7's LOSS_RTOL says), and at most
# FSDP_NARROW_SHARE of its elements beyond the CPU tests' float32
# tolerance (atol = rtol = 1e-4)
FSDP_NARROW_ATOL = 1e-6
FSDP_NARROW_SHARE = 1e-3
# (b) full width: phase 6's 2-layer slice, one row of FSDP_FULL_S tokens
# a rank, a warm-up step (lr 0) and one step under each mesh
FSDP_FULL_MESHES = ((1, 4, 1, 1),)
FSDP_FULL_B, FSDP_FULL_S = 4, 2048
FSDP_FULL_FRAMES = 400
# bf16: the losses within FSDP_FULL_LOSS_RTOL of the unsharded step's;
# each optimizer group's global gradient norm (Adam is blind to a
# gradient's scale, the norm is not) within FSDP_FULL_NORM_RTOL of the
# unsharded one; at FSDP_SAMPLES sampled elements of every trainable
# leaf, the step's gradient within FSDP_FULL_GRAD_TOL times the leaf's
# largest sampled unsharded gradient (each rank's bf16 gradient of a
# gathered layer covers its rows and is rounded before the ranks' float32
# sum: a few bf16 ulps; a rank's share lost or counted twice is O(1)),
# and the weight after the step within 2 lr + one bf16 ulp of the
# unsharded one (an update resolved at bf16's precision, such as a zero
# bias's, lands one ulp away wherever its gradient rounded otherwise, so
# how many samples are apart is printed, not held)
FSDP_FULL_LOSS_RTOL = 1e-3
FSDP_FULL_NORM_RTOL = 1e-2
FSDP_FULL_GRAD_TOL = 2e-2
FSDP_SAMPLES = 4096
# the kernels every rank must launch in (b)'s step (and B5a or B5b)
FSDP_PATH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gmm_wgrad")
FSDP_NOTE = f"{FSDP_RANKS} ranks time-sharing one card: not a measure of scaling"


def fsdp_narrow_config(mesh_shape):
    """Phase 7's configuration for a mesh: dense MoE and one microbatch
    under pipe, the flash backend throughout."""
    cfg = narrow_config()
    shape = tuple(mesh_shape) + (1,) * (6 - len(mesh_shape))
    if shape[4] > 1:
        return dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, moe_mode="dense", pipe_stages=shape[4], pipe_microbatches=1))
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, moe_mode="gmm"))


def fsdp_batches(cfg, n, b, s, frames, seed):
    """``n`` global batches of ``b`` rows of ``s`` tokens, each row an
    image tile and an audio clip of ``frames`` fbank frames, rows 1 and 3
    padded."""
    from vita_tpu_torch.tokenization import AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX
    from vita_tpu_torch.tokenization import audio_token_count

    rng = np.random.default_rng(seed)
    sz, n_img, n_aud = cfg.vision.image_size, cfg.image_tokens_per_group, audio_token_count(
        frames)
    out = []
    for _ in range(n):
        ids = rng.integers(3, cfg.llm.vocab_size, (b, s)).astype(np.int32)
        ids[:, 4:4 + n_img] = IMAGE_TOKEN_INDEX
        ids[:, 6 + n_img:6 + n_img + n_aud] = AUDIO_TOKEN_INDEX
        im, am = ids == IMAGE_TOKEN_INDEX, ids == AUDIO_TOKEN_INDEX
        valid = np.ones((b, s), bool)
        valid[1, s - s // 5:] = False
        valid[3, s - s // 9:] = False
        labels = np.where(im | am | ~valid, -100, ids).astype(np.int32)
        labels[:, :8 + n_img + n_aud] = -100  # the prompt
        out.append({
            "input_ids": np.where(im | am, 0, ids).astype(np.int32), "labels": labels,
            "image_mask": im, "audio_mask": am, "attn_valid": valid,
            "images": rng.standard_normal((b, sz, sz, 3)).astype(np.float32),
            "speech": rng.standard_normal((b, frames, 80)).astype(np.float32),
            "speech_lengths": np.full((b,), frames, np.int32)})
    return out


def _fsdp_tc(full: bool):
    from vita_tpu_torch.train.step import TrainConfig

    if full:  # phase 6's
        return dataclasses.replace(TrainConfig.stage2_finetune(), warmup_steps=1)
    return TrainConfig(learning_rate=1e-3, projector_lr=1e-2, warmup_steps=1,
                       total_steps=10)  # phase 7's


def _fsdp_lrs(tc, steps):
    """(base, projector) learning rates summed over ``steps`` updates."""
    from vita_tpu_torch.train.step import warmup_cosine_lr

    total = max(tc.total_steps, tc.warmup_steps + 1)
    base = sum(warmup_cosine_lr(i, tc.learning_rate, tc.warmup_steps, total)
               for i in range(steps))
    proj = sum(warmup_cosine_lr(i, tc.projector_lr or tc.learning_rate, tc.warmup_steps, total)
               for i in range(steps))
    return base, proj


def _block_index(shape, spec, coords, sizes):
    """For a whole leaf of ``shape`` cut by ``spec``: per dim, the first
    index and the extent of the block at ``coords``."""
    lo, ext = [], []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        parts, r = 1, 0
        for a in names:
            parts, r = parts * sizes[a], r * sizes[a] + coords[a]
        lo.append(r * (n // parts))
        ext.append(n // parts)
    return lo, ext


def _cut(x, spec, coords, sizes):
    lo, ext = _block_index(x.shape, spec, coords, sizes)
    return x[tuple(slice(a, a + e) for a, e in zip(lo, ext))]


def _sample_block(block, shape, spec, coords, sizes, picks):
    """The values of the whole leaf (``shape``) at flat ``picks`` that lie
    in this rank's ``block``: (mask of the picks it holds, values)."""
    import torch

    lo, ext = _block_index(shape, spec, coords, sizes)
    idx = np.stack(np.unravel_index(np.asarray(picks), shape), 1) - np.asarray(lo)
    held = np.all((idx >= 0) & (idx < np.asarray(ext)), 1)
    vals = np.zeros(len(picks), np.float32)
    if held.any():
        flat = np.ravel_multi_index(tuple(idx[held].T), tuple(ext))
        vals[held] = block.reshape(-1)[torch.as_tensor(flat, device=block.device)].float().cpu(
        ).numpy()
    return held, vals


def _train_steps(params, cfg, tc, batches, device, mesh=None):
    """make_train_step over ``batches`` (params cut by the mesh under one):
    (losses, leaves after the last update on the host, the router's
    smallest top-k gap per step, its top-k expert ids per step and call)."""
    import torch

    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.ops import moe
    from vita_tpu_torch.parallel import fsdp
    from vita_tpu_torch.train import step

    p = (_to(params, device) if mesh is None
         else fsdp.shard_tree(params, vita.param_specs(cfg), mesh, device))
    opt = step.make_optimizer(tc, p)
    state = opt.init(p)
    fn = step.make_train_step(cfg, tc, opt, mesh)
    gaps, losses, routes = [], [], []
    real_route = moe.route_topk

    def recording_route(logits, k):
        out = real_route(logits, k)
        top = torch.topk(out[2].detach(), k + 1, dim=-1).values
        gaps[-1] = min(gaps[-1], float((top[:, k - 1] - top[:, k]).min()))
        routes[-1].append(np.sort(out[1].detach().cpu().numpy(), -1))
        return out

    # ops.moe routes the unsharded run, mixtral's own import the sharded one
    moe.route_topk = mixtral.route_topk = recording_route
    try:
        for b in batches:
            gaps.append(float("inf"))
            routes.append([])
            losses.append(float(fn(p, state, b)[2]["loss"]))
    finally:
        moe.route_topk = mixtral.route_topk = real_route
    leaves = {n: w.detach().float().cpu().numpy() for n, w in _leaf_items(p)}
    return losses, leaves, gaps, routes


def _first_flip(ref_routes, got_routes, cfg, coords, sizes, b, s):
    """The first step at which a rank's tokens took other experts than
    the same tokens in the unsharded run (its rows over ('data', 'fsdp'),
    its positions over 'seq', its stage's layers under 'pipe'), or None."""
    n_rows = sizes["data"] * sizes["fsdp"]
    r = coords["data"] * sizes["fsdp"] + coords["fsdp"]
    rows = slice(r * b // n_rows, (r + 1) * b // n_rows)
    pos = slice(coords["seq"] * s // sizes["seq"], (coords["seq"] + 1) * s // sizes["seq"])
    per_stage = cfg.llm.n_layers // sizes["pipe"]
    for i, (ref, got) in enumerate(zip(ref_routes, got_routes)):
        for j, ids in enumerate(got):
            want = ref[coords["pipe"] * per_stage + j].reshape(b, s, -1)[rows, pos]
            if not np.array_equal(ids, want.reshape(ids.shape)):
                return i
    return None


def fsdp_full_config(small: bool = False):
    """Phase 6's 2-layer slice (stage 2, gmm, flash, remat, bf16); with
    ``small`` the tiny VITA at those settings, for a run on the CPU."""
    if not small:
        return train_slice_config()
    from vita_tpu_torch.models import vita

    cfg = vita.VITAConfig.tiny()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, moe_mode="gmm", attn_backend="flash", remat=True))


def _fsdp_full_step(cfg, params, batches, device, picks, shapes, mesh=None):
    """A Trainer (cut over ``mesh`` under one) takes a warm-up step and a
    step on ``batches``: (losses, step ms, peak GiB since the warm-up's
    start, launches in the step, the step's global gradient norm of each
    optimizer group, the step's gradients at the sampled flat ``picks``
    of each leaf of whole ``shapes`` (``_sample_block``), the trainer, the
    step's routing: (sorted top-k ids, top-k gap) of each router call in
    order)."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.ops import moe
    from vita_tpu_torch.parallel import fsdp
    from vita_tpu_torch.parallel.mesh import AXES, axis
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    run = RunConfig(output_dir=os.path.join(TRAIN_DIR, "fsdp"), batch_size=FSDP_FULL_B,
                    resume=False)
    kw = {} if mesh is None else dict(mesh=mesh, device=device)
    trainer = Trainer(cfg, _fsdp_tc(True), run, params, **kw)
    del params
    gc.collect()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    p, s = trainer.params, trainer.opt_state
    p, s, m = trainer.step_fn(p, s, batches[0])
    losses.append(float(m["loss"]))
    norms, grads_at, real_sq_norm = [], {}, fsdp.sq_norm
    coords = {a: axis(mesh, a).rank for a in AXES}
    sizes = {a: axis(mesh, a).size for a in AXES}
    specs = dict(_leaf_items(vita.param_specs(cfg)))
    real_update = trainer.optimizer.update
    routes, real_route = [], moe.route_topk

    def recording_route(logits, k):
        out = real_route(logits, k)
        top = torch.topk(out[2].detach(), k + 1, dim=-1).values
        routes.append((out[1].detach().sort(-1).values, top[:, k - 1] - top[:, k]))
        return out

    def recording_sq_norm(*a):
        out = real_sq_norm(*a)
        norms.append(float(out) ** 0.5)
        return out

    def recording_update(params, grads, *a):
        for path, g in grads.items():
            name = "/".join(path)
            grads_at[name] = _sample_block(g, shapes[name], specs[name], coords, sizes,
                                           picks[name])
        return real_update(params, grads, *a)

    kernels.reset_launches()
    _sync(device)
    fsdp.sq_norm, trainer.optimizer.update = recording_sq_norm, recording_update
    # ops.moe routes the unsharded run, mixtral's own import a mesh's gmm
    moe.route_topk = mixtral.route_topk = recording_route
    try:
        t0 = time.time()
        p, s, m = trainer.step_fn(p, s, batches[1])
        losses.append(float(m["loss"]))
        _sync(device)
        ms = (time.time() - t0) * 1e3
    finally:
        fsdp.sq_norm, trainer.optimizer.update = real_sq_norm, real_update
        moe.route_topk = mixtral.route_topk = real_route
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else 0.0
    routes = [(i.cpu().numpy(), g.float().cpu().numpy()) for i, g in routes]
    return losses, ms, peak, dict(kernels.launches), norms, grads_at, trainer, routes


def fsdp_full_reference(cfg, batches, device):
    """(b)'s unsharded Trainer steps here: losses, step ms, peak, the
    groups' gradient norms, and the step's gradients and the trainable
    leaves after it at sampled flat indices (host), with those picks and
    the leaves' shapes; the card is freed after."""
    import torch

    from vita_tpu_torch.train.step import trainable_mask

    params = slice_params(cfg, device)
    rng = np.random.default_rng(SEED + 61)
    mask = dict(_leaf_items(trainable_mask(params, _fsdp_tc(True))))
    shapes = {name: tuple(w.shape) for name, w in _leaf_items(params) if mask[name]}
    picks = {name: np.sort(rng.choice(math.prod(shape), min(FSDP_SAMPLES, math.prod(shape)),
                                      replace=False)) for name, shape in shapes.items()}
    losses, ms, peak, _, norms, grads_at, trainer, routes = _fsdp_full_step(
        cfg, params, batches, device, picks, shapes)
    del params
    values = {name: w.detach().reshape(-1)[torch.as_tensor(picks[name], device=device)]
              .float().cpu().numpy() for name, w in _leaf_items(trainer.params) if name in picks}
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, ms=ms, peak=peak, norms=norms, shapes=shapes, values=values,
                routes=routes,
                grads={k: v for k, (_, v) in grads_at.items()}), picks


def fsdp_rank(rank, world, plan):
    """One rank of phases 14 and 15: (a) FSDP_NARROW_STEPS narrow fp32
    steps under each of ``plan["narrow_meshes"]`` (the losses and this
    rank's blocks after the last update); (b) a warm-up step and a step of
    the full-width slice under each of ``plan["full_meshes"]`` (losses,
    step ms, peak, the step's launches, this rank's values at the sampled
    elements); (c) with ``plan["resume"]`` (phase 15) a Trainer under its
    mesh resumes phase 14(c)'s checkpoint (the step, blocks and Adam
    moments it resumed with); then each argv of ``plan["cli"]`` through
    the train CLI (exit codes and printed lines)."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel.mesh import AXES, axis, make_mesh
    from vita_tpu_torch.train import cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        kernels.lib()  # phase 1's library: loaded, not built
    resume = plan.get("resume")
    meshes = {m: make_mesh(m) for m in dict.fromkeys(
        plan["narrow_meshes"] + plan["full_meshes"] + ((resume["mesh"],) if resume else ()))}
    out = {"narrow": {}, "full": {}, "wall_s": {}}
    t_part = time.time()
    for shape in plan["narrow_meshes"]:
        mesh = meshes[shape]
        cfg = fsdp_narrow_config(shape)
        params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        batches = fsdp_batches(cfg, FSDP_NARROW_STEPS, FSDP_NARROW_B, FSDP_NARROW_S, 60,
                               SEED + 60)
        losses, blocks, _, routes = _train_steps(params, cfg, _fsdp_tc(False), batches, dev,
                                                 mesh)
        out["narrow"][shape] = dict(losses=losses, blocks=blocks, routes=routes,
                                    coords={a: axis(mesh, a).rank for a in AXES})
    out["wall_s"]["a"], t_part = time.time() - t_part, time.time()
    cfg = fsdp_full_config(plan["small"])
    batches = fsdp_batches(cfg, 2, FSDP_FULL_B, plan["full_s"], FSDP_FULL_FRAMES, SEED + 62)
    for shape in plan["full_meshes"]:
        mesh = meshes[shape]
        # the whole weights drawn here are dropped once the Trainer has cut them
        losses, ms, peak, launches, norms, grads_at, trainer, routes = _fsdp_full_step(
            cfg, slice_params(cfg, dev), batches, dev, plan["picks"], plan["shapes"], mesh)
        coords = {a: axis(mesh, a).rank for a in AXES}
        sizes = {a: axis(mesh, a).size for a in AXES}
        specs = dict(_leaf_items(vita.param_specs(cfg)))
        samples = {name: _sample_block(w.detach(), plan["shapes"][name], specs[name], coords,
                                       sizes, plan["picks"][name])
                   for name, w in _leaf_items(trainer.params) if name in plan["picks"]}
        out["full"][shape] = dict(losses=losses, ms=ms, peak=peak, launches=launches,
                                  routes=routes,
                                  norms=norms, samples=samples, grads=grads_at)
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["wall_s"]["b"], t_part = time.time() - t_part, time.time()
    if resume:
        mesh = meshes[resume["mesh"]]
        trainer = _cli_trainer(resume["dir"], dev, mesh)
        out["resume"] = dict(step=trainer.step, coords={a: axis(mesh, a).rank for a in AXES},
                             state=_host_state(trainer))
        del trainer
    out["cli"] = []
    for argv in plan["cli"]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--device", dev.type])
        out["cli"].append((rc, buf.getvalue()))
    out["wall_s"]["c"] = time.time() - t_part
    return out


def _cli_trainer(out_dir, device, mesh=None):
    """A Trainer of the train CLI's tiny-random run (its config with gmm
    MoE, stage 2) on ``out_dir``, resumed from its latest checkpoint: cut
    over ``mesh`` under one, whole on ``device`` without."""
    import torch

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.train.step import TrainConfig
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    cfg = vita.VITAConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, moe_mode="gmm"))
    params = vita.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    kw = {} if mesh is None else dict(mesh=mesh)
    return Trainer(cfg, TrainConfig.stage2_finetune(), RunConfig(output_dir=out_dir, batch_size=4),
                   _to(params, device), **kw)


def _host_state(trainer):
    """The Trainer's params and Adam moments on the host, by leaf name
    ('mu/<leaf>' and 'nu/<leaf>' for the moments)."""
    out = {n: w.detach().float().cpu().numpy() for n, w in _leaf_items(trainer.params)}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v.float().cpu().numpy()
                    for k, v in trainer.opt_state[m].items()})
    return out


def _gather_samples(results, shape, leaf, key, name, failed):
    """A leaf's sampled values from the ranks that hold them (every
    sample held by some rank; ranks holding the same one agree bitwise)."""
    got, seen = None, None
    for res in results:
        held, vals = res["full"][shape][key][leaf]
        if got is None:
            got, seen = np.zeros_like(vals), np.zeros(len(vals), bool)
        both = seen & held
        if both.any() and not np.array_equal(got[both], vals[both]):
            failed.append(f"{name}: {leaf}'s {key}: ranks holding the same block differ")
        got[held], seen = vals[held], seen | held
    if not seen.all():
        failed.append(f"{name}: {leaf}'s {key}: {int((~seen).sum())} samples held by no rank")
    return got


def _narrow_refs(meshes, device, refs=None):
    """The unsharded narrow steps for ``meshes``, by (moe mode, pipe
    stages): those of ``refs`` (an earlier phase's) where present."""
    import torch

    from vita_tpu_torch.models import vita

    refs = dict(refs or {})
    for shape in meshes:
        cfg = fsdp_narrow_config(shape)
        key = (cfg.llm.moe_mode, cfg.llm.pipe_stages)
        if key not in refs:
            ref_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, pipe_stages=1))
            params = vita.init_params(ref_cfg, torch.Generator().manual_seed(SEED), "cpu")
            batches = fsdp_batches(ref_cfg, FSDP_NARROW_STEPS, FSDP_NARROW_B, FSDP_NARROW_S, 60,
                                   SEED + 60)
            refs[key] = _train_steps(params, ref_cfg, _fsdp_tc(False), batches, device)
    return refs


def _narrow_report(results, meshes, narrow_ref, failed):
    """(a): each mesh's losses (phase 7's LOSS_RTOL and router near-tie
    excuse) and every leaf after the last update against the unsharded
    steps' (FSDP_NARROW_*), and bitwise equal on the ranks that hold the
    same block (a leaf replicated over an axis: on every rank of it)."""
    from vita_tpu_torch.models import vita

    base_lr, proj_lr = _fsdp_lrs(_fsdp_tc(False), FSDP_NARROW_STEPS)
    for shape in meshes:
        cfg = fsdp_narrow_config(shape)
        ref_losses, ref_leaves, gaps, ref_routes = narrow_ref[cfg.llm.moe_mode,
                                                              cfg.llm.pipe_stages]
        name = f"(a) --mesh {' '.join(map(str, shape))}"
        sizes = dict(zip(AXES_ALL, tuple(shape) + (1,) * (6 - len(shape))))
        # a rank whose tokens took other experts than the unsharded run's at
        # step i: excused from step i on where the unsharded router had a
        # near tie there (phase 7's excuse), a failure where it had none
        flips = [_first_flip(ref_routes, res["narrow"][shape]["routes"], cfg,
                             res["narrow"][shape]["coords"], sizes, FSDP_NARROW_B,
                             FSDP_NARROW_S) for res in results]
        first_tie = min([f for f in flips if f is not None], default=FSDP_NARROW_STEPS)
        if first_tie < FSDP_NARROW_STEPS and gaps[first_tie] > ROUTE_NEAR_TIE:
            failed.append(f"{name}: routing differs from the unsharded run's at step "
                          f"{first_tie + 1}, whose smallest router gap {gaps[first_tie]:.3e} is "
                          f"no near tie")
        specs = dict(_leaf_items(vita.param_specs(cfg)))
        worst_loss, worst_leaf, worst_share, held = 0.0, (0.0, ""), (0.0, ""), {}
        for r, res in enumerate(results):
            got = res["narrow"][shape]
            errs = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref_losses)]
            worst_loss = max([worst_loss] + errs[:first_tie])
            if any(e > LOSS_RTOL for e in errs[:first_tie]):
                failed.append(f"{name}: rank {r}'s losses {got['losses']} vs the unsharded "
                              f"{ref_losses}")
            for leaf, b in got["blocks"].items():
                split = tuple(a for e in specs[leaf] if e is not None
                              for a in ((e,) if isinstance(e, str) else e) if sizes[a] > 1)
                key = (leaf, tuple(got["coords"][a] for a in split))
                if key in held and not np.array_equal(held[key], b):
                    failed.append(f"{name}: {leaf}'s block {key[1]} differs between ranks")
                held[key] = b
                if first_tie < FSDP_NARROW_STEPS:
                    continue
                want = _cut(ref_leaves[leaf], specs[leaf], got["coords"], sizes)
                diff = np.abs(b - want)
                lr = proj_lr if leaf.endswith("_proj") or "_proj/" in leaf else base_lr
                bound = 2 * lr + FSDP_NARROW_ATOL
                share = float((diff > 1e-4 + 1e-4 * np.abs(want)).mean())
                worst_leaf = max(worst_leaf, (float(diff.max()), leaf))
                worst_share = max(worst_share, (share, leaf))
                if diff.max() > bound or share > FSDP_NARROW_SHARE:
                    failed.append(f"{name}: rank {r}'s {leaf} max |diff| {diff.max():.3e} "
                                  f"(bound {bound:.3e}), {share:.2e} of it beyond 1e-4")
        print(f"  {name} narrow fp32, {FSDP_NARROW_STEPS} steps: losses "
              f"{results[0]['narrow'][shape]['losses']} vs the unsharded {ref_losses} (worst "
              f"rel err {worst_loss:.3e}, tol {LOSS_RTOL}); after the last update worst leaf "
              f"max |diff| {worst_leaf[0]:.3e} ({worst_leaf[1]}), worst share beyond 1e-4 "
              f"{worst_share[0]:.2e} ({worst_share[1]}); the unsharded run's smallest router "
              f"gap per step {[f'{g:.3e}' for g in gaps]}"
              + (f"; routing apart from step {first_tie + 1}: steps {first_tie + 1}-"
                 f"{FSDP_NARROW_STEPS} and the leaves not compared"
                 if first_tie < FSDP_NARROW_STEPS else "; every rank's routing the unsharded "
                 "run's"), flush=True)


def _full_report(card, results, meshes, full_ref, full_s, device, failed, earlier=None,
                 f32=None):
    """(b): each mesh's losses, group gradient norms, sampled gradients
    and weights after the step against the unsharded Trainer's
    (FSDP_FULL_*; with ``f32``, the float32 gradients at the samples, a
    leaf's gradient beyond FSDP_FULL_GRAD_TOL is held to them as
    TP_GRAD_F32_FACTOR says); each rank's step ms and peak (below the
    unsharded peak) beside ``earlier`` (an earlier phase's per-rank (ms,
    peak) by mesh), every rank launching FSDP_PATH and B5a or B5b.
    Returns the launches of the steps summed over the ranks and the
    per-rank (ms, peak) by mesh."""
    total, readings = {}, {}
    tc = _fsdp_tc(True)
    ulp = lambda w: np.abs(w) * 2.0 ** -7  # noqa: E731 - bf16 spacing
    for shape in meshes:
        name = f"(b) --mesh {' '.join(map(str, shape))}"
        losses = [res["full"][shape]["losses"] for res in results]
        if any(l != losses[0] for l in losses):
            failed.append(f"{name}: the ranks' losses differ: {losses}")
        errs = [abs(a - b) / abs(b) for a, b in zip(losses[0], full_ref["losses"])]
        if max(errs) > FSDP_FULL_LOSS_RTOL:
            failed.append(f"{name}: losses {losses[0]} vs the unsharded {full_ref['losses']}")
        norms = [res["full"][shape]["norms"] for res in results]
        if any(x != norms[0] for x in norms):
            failed.append(f"{name}: the ranks' gradient norms differ: {norms}")
        norm_errs = [abs(a - b) / b for a, b in zip(norms[0], full_ref["norms"])]
        if len(norms[0]) != len(full_ref["norms"]) or max(norm_errs) > FSDP_FULL_NORM_RTOL:
            failed.append(f"{name}: gradient norms {norms[0]} vs the unsharded "
                          f"{full_ref['norms']}")
        worst, worst_grad, apart, n, by_leaf = (0.0, ""), (0.0, ""), 0, 0, []
        worst_f32 = (0.0, "")
        for leaf, want in full_ref["values"].items():
            got, g = _gather_samples(results, shape, leaf, "samples", name, failed), \
                _gather_samples(results, shape, leaf, "grads", name, failed)
            g_ref = full_ref["grads"][leaf]
            g_err = float(np.abs(g - g_ref).max() / max(np.abs(g_ref).max(), 1e-30))
            worst_grad = max(worst_grad, (g_err, leaf))
            if f32 is not None and g_err > FSDP_FULL_GRAD_TOL:
                top = max(np.abs(f32[leaf]).max(), 1e-30)
                d_mesh = float(np.abs(g - f32[leaf]).max() / top)
                d_ref = float(np.abs(g_ref - f32[leaf]).max() / top)
                worst_f32 = max(worst_f32, (d_mesh / max(d_ref, 1e-30), leaf))
                if d_mesh > TP_GRAD_F32_FACTOR * d_ref:
                    failed.append(f"{name}: {leaf}'s sampled gradient is {d_mesh:.3e} of its "
                                  f"largest from the float32 one, the unsharded bf16 step's "
                                  f"{d_ref:.3e} (factor {TP_GRAD_F32_FACTOR})")
            elif g_err > FSDP_FULL_GRAD_TOL:
                failed.append(f"{name}: {leaf}'s sampled gradient max |diff| {g_err:.3e} of its "
                              f"largest (tol {FSDP_FULL_GRAD_TOL})")
            lr = tc.projector_lr if leaf.startswith(("vision_proj", "audio_proj")) else \
                tc.learning_rate
            diff = np.abs(got - want)
            over = diff > 2 * lr + ulp(want)
            worst = max(worst, (float((diff / (2 * lr + ulp(want))).max()), leaf))
            apart += int((got != want).sum())
            n += len(want)
            by_leaf.append((float((got != want).mean()), leaf))
            if over.any():
                failed.append(f"{name}: {leaf}: {int(over.sum())} samples beyond 2 lr + 1 ulp "
                              f"(max |diff| {diff.max():.3e})")
        print(f"  {name} full width, {FSDP_FULL_B} rows of {full_s}: losses {losses[0]} vs "
              f"the unsharded {full_ref['losses']} (rel errs "
              f"{[f'{e:.2e}' for e in errs]}, tol {FSDP_FULL_LOSS_RTOL}); group gradient norms "
              f"{norms[0]} (rel errs {[f'{e:.2e}' for e in norm_errs]}, tol "
              f"{FSDP_FULL_NORM_RTOL}); sampled gradients worst max |diff| / largest "
              f"{worst_grad[0]:.3e} ({worst_grad[1]}, tol {FSDP_FULL_GRAD_TOL}"
              + (f"; beyond it, the largest distance from the float32 gradient over the "
                 f"unsharded bf16 step's {worst_f32[0]:.3f} ({worst_f32[1]}), factor "
                 f"{TP_GRAD_F32_FACTOR}" if worst_f32[1] else "") + "); sampled weights "
              f"after the step: worst |diff| / (2 lr + ulp) {worst[0]:.3f} ({worst[1]}), "
              f"{apart} of {n} apart ({apart / n:.4f}; most: "
              f"{', '.join(f'{l} {x:.3f}' for x, l in sorted(by_leaf)[::-1][:4])})", flush=True)
        sizes = dict(zip(AXES_ALL, tuple(shape) + (1,) * (6 - len(shape))))
        if all(sizes[a] == 1 for a in ("data", "fsdp", "pipe", "seq")):
            # every rank routes the whole batch: the forward's router calls
            flips, top_gap, n_routes = 0, 0.0, 0
            got_routes = results[0]["full"][shape]["routes"]
            for (want, gap), (got, _) in zip(full_ref["routes"], got_routes):
                moved = (want != got).any(-1)
                flips, n_routes = flips + int(moved.sum()), n_routes + len(moved)
                top_gap = max([top_gap] + gap[moved].tolist())
            print(f"    routing of the step (every router call, remat's included): {flips} of "
                  f"{n_routes} token routes differ from the unsharded step's, the unsharded "
                  f"router's largest top-k gap among them {top_gap:.3e}", flush=True)
        mesh_total = {}
        readings[shape] = []
        for r, res in enumerate(results):
            run = res["full"][shape]
            readings[shape].append((run["ms"], run["peak"]))
            beside = "".join(f"; phase 14 --mesh {' '.join(map(str, m))}: step {ms:.1f} ms, "
                             f"peak {pk:.2f} GiB" for m, runs in (earlier or {}).items()
                             for ms, pk in runs[r:r + 1])
            print(f"    rank {r}: step {run['ms']:.1f} ms, peak memory {run['peak']:.2f} GiB "
                  f"(unsharded {full_ref['peak']:.2f} GiB, step {full_ref['ms']:.1f} ms{beside})"
                  f"  ({FSDP_NOTE}) [{card}]", flush=True)
            counts = run["launches"]
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
                mesh_total[k] = mesh_total.get(k, 0) + c
            if device.type == "cuda":
                missing = [k for k in FSDP_PATH if counts.get(k, 0) == 0]
                if not counts.get("gmm", 0) and not counts.get("gmm_small", 0):
                    missing.append("gmm or gmm_small")
                if missing:
                    failed.append(f"{name}: rank {r} never launched {missing}")
                if run["peak"] >= full_ref["peak"]:
                    failed.append(f"{name}: rank {r}'s peak {run['peak']:.2f} GiB is not below "
                                  f"the unsharded {full_ref['peak']:.2f} GiB")
        print(f"    launches in the step, summed over the ranks: "
              f"{ {k: c for k, c in mesh_total.items() if c} }", flush=True)
    return total, readings


def _train_cli_files(cli_dir):
    """phase 14(c)'s data for the train CLI under ``cli_dir`` (made anew):
    the chat file's path."""
    import shutil

    shutil.rmtree(cli_dir, ignore_errors=True)
    os.makedirs(cli_dir)
    wav = write_wav(os.path.join(cli_dir, "q.wav"), 1.0, SEED + 63)
    chat = os.path.join(cli_dir, "chat.json")
    with open(chat, "w") as f:
        json.dump([{"conversations": [{"from": "human", "value": "<audio>\n"},
                                      {"from": "gpt", "value": "a sound"}], "audio": wav},
                   {"conversations": _turns(np.random.default_rng(SEED), 40)}] * 4, f)
    return chat


# what phase 14 leaves phase 15: its unsharded references and readings
TRAIN_REFS = {}


def _cli_argv(chat, out_dir, mesh, epochs=1):
    return ["--model", "tiny-random", "--data", chat, "--output-dir", out_dir, "--batch-size",
            "4", "--epochs", str(epochs), "--mesh", *map(str, mesh), "--moe-mode", "gmm",
            "--dist-backend", "gloo"]


def fsdp_phase(card: str, device, small: bool = False):
    """Phase 14: sharded training (ZeRO-3 over 'fsdp', the batch over
    ('data', 'fsdp')) as FSDP_RANKS ranks spawned on cuda:0 over gloo,
    against unsharded steps here, made first and kept on the host. (a)
    narrow fp32 under each FSDP_NARROW_MESHES mesh (``_narrow_report``);
    (b) the full-width slice under each FSDP_FULL_MESHES mesh
    (``_full_report``); (c) the train CLI: every rank exits 0,
    metrics.jsonl is written once, a second run resumes. ``small`` (with
    a CPU ``device``) runs (b) on the tiny config, to try the phase
    without a card. Every check runs, and the phase then fails on any
    that failed. Keeps its references in TRAIN_REFS for phase 15 and
    returns the launch counts of (b)'s steps summed over the ranks."""
    from vita_tpu_torch.parallel.launch import run_ranks

    failed = []
    narrow_ref = _narrow_refs(FSDP_NARROW_MESHES, device)
    # (b) the unsharded full-width step
    full_cfg = fsdp_full_config(small)
    full_s = FSDP_FULL_S if not small else 64
    batches = fsdp_batches(full_cfg, 2, FSDP_FULL_B, full_s, FSDP_FULL_FRAMES, SEED + 62)
    t0 = time.time()
    full_ref, picks = fsdp_full_reference(full_cfg, batches, device)
    print(f"  (b) unsharded Trainer: warm-up + step in {time.time() - t0:.1f} s, step "
          f"{full_ref['ms']:.1f} ms, losses {full_ref['losses']}, peak "
          f"{full_ref['peak']:.2f} GiB  [{card}]", flush=True)
    cli_dir = os.path.join(TRAIN_DIR, "fsdp_cli")
    chat = _train_cli_files(cli_dir)
    run_dir = os.path.join(cli_dir, "run")
    plan = {"device": "cuda:0" if device.type == "cuda" else "cpu", "small": small,
            "full_s": full_s, "picks": picks, "shapes": full_ref["shapes"],
            "narrow_meshes": FSDP_NARROW_MESHES, "full_meshes": FSDP_FULL_MESHES,
            "cli": [_cli_argv(chat, run_dir, (1, 4, 1, 1))] * 2}
    t0 = time.time()
    results = run_ranks(fsdp_rank, FSDP_RANKS, plan, backend="gloo", timeout=900,
                        store_dir=os.path.join(ROOT, "build"))
    walls = results[0]["wall_s"]
    print(f"  {FSDP_RANKS} ranks on {plan['device']} over gloo returned in "
          f"{time.time() - t0:.1f} s (rank 0: (a) {walls['a']:.1f} s, (b) {walls['b']:.1f} s, "
          f"(c) {walls['c']:.1f} s; {FSDP_NOTE})", flush=True)
    _narrow_report(results, FSDP_NARROW_MESHES, narrow_ref, failed)
    total, readings = _full_report(card, results, FSDP_FULL_MESHES, full_ref, full_s, device,
                                   failed)
    # (c)
    metrics = os.path.join(run_dir, "metrics.jsonl")
    lines = open(metrics).read().splitlines() if os.path.exists(metrics) else []
    for r, res in enumerate(results):
        (rc1, out1), (rc2, out2) = res["cli"]
        if rc1 or rc2:
            failed.append(f"(c) rank {r}: exit codes {rc1}, {rc2}")
        if r == 0 and "resumed from step" not in out2:
            failed.append(f"(c) rank 0's second run printed no resume: {out2!r}")
    if len(lines) != 2:
        failed.append(f"(c) metrics.jsonl holds {len(lines)} lines, not one a step (2)")
    resumed = [x for x in results[0]["cli"][1][1].splitlines() if "resumed" in x]
    print(f"  (c) train CLI --mesh 1 4 1 1 --moe-mode gmm: exit codes "
          f"{[[rc for rc, _ in res['cli']] for res in results]}, metrics.jsonl {len(lines)} "
          f"lines, second run: {resumed}", flush=True)
    TRAIN_REFS.update(narrow=narrow_ref, full=full_ref, picks=picks, full_s=full_s,
                      readings=readings, chat=chat, run_dir=run_dir, small=small)
    if failed:
        raise AssertionError("phase 14 failed:\n  " + "\n  ".join(failed))
    return total


# --------------------------------------------------------------------------
# phase 15: tensor- and expert-parallel training
# --------------------------------------------------------------------------
# (a) narrow fp32 as phase 14's (a): gmm MoE, dense with one microbatch
# under pipe; every mesh splits 'model' or 'expert'
TP_NARROW_MESHES = ((1, 1, 2, 2), (1, 2, 1, 2), (2, 1, 2, 1), (1, 1, 1, 2, 2),
                    (1, 1, 1, 2, 1, 2))
# (b) the full-width slice: its 32 / 8 heads of 128 split 16 / 4 a rank,
# each expert's 14336 ffn columns 7168 a rank, 4 experts a rank
TP_FULL_MESHES = ((1, 1, 2, 2),)
# (c) phase 14(c)'s checkpoint (saved under --mesh 1 4 1 1) resumed here
TP_RESUME_MESH = (1, 1, 2, 2)
# (b)'s gradients: over 'model' the forward's sums are taken in another
# order than the unsharded step's (the experts' ffn-column partials and
# the output projection's, each a bf16 GEMM's float32 output summed over
# the ranks), so bf16 rounding and routing near ties move the sampled
# gradients by more than FSDP_FULL_GRAD_TOL of each leaf's largest, where
# phase 14's forward is the unsharded one bitwise: the unsharded bf16
# step's gradient is itself 8e-3 to 4e-1 of each leaf's largest from the
# float32 gradient, and another order of the same sums lands as far from
# it elsewhere. A leaf whose sampled gradient is farther than
# FSDP_FULL_GRAD_TOL from the unsharded step's is held to the float32
# gradient of the same weights and rows: no farther from it than
# TP_GRAD_F32_FACTOR times the unsharded bf16 step's gradient is (at most
# 1.38 on the H100 as committed; with the "f" over 'model' on the
# attention's input dropped, 2.6 to 31 on 19 leaves: `chip_probe.py
# tp-faults`).
TP_GRAD_F32_FACTOR = 2.0


def tp_phase(card: str, device):
    """Phase 15: tensor- and expert-parallel training as FSDP_RANKS ranks
    spawned on cuda:0 over gloo, after phase 14 (whose unsharded
    references it takes from TRAIN_REFS, or makes them when run alone):
    (a) narrow fp32 under each TP_NARROW_MESHES mesh and (b) the
    full-width slice under TP_FULL_MESHES, held as phase 14's (a) and (b)
    are; (c) phase 14(c)'s checkpoint (4 ranks of fsdp) resumed by a
    Trainer without a mesh here and under TP_RESUME_MESH on the ranks: the
    saved blocks are the whole leaves the unsharded Trainer resumed with,
    cut by the saved mesh's specs, and each rank's are the same leaves cut
    by its own, bitwise (params and Adam moments); then the train CLI
    under that mesh trains two more steps from it, every rank exiting 0.
    Returns the launch counts of (b)'s step summed over the ranks."""
    import torch

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel.launch import run_ranks
    from vita_tpu_torch.train.trainer import load_state

    failed = []
    small = TRAIN_REFS.get("small", False)
    narrow_ref = _narrow_refs(TP_NARROW_MESHES, device, TRAIN_REFS.get("narrow"))
    if "full" in TRAIN_REFS:
        full_ref, picks, full_s = TRAIN_REFS["full"], TRAIN_REFS["picks"], TRAIN_REFS["full_s"]
    else:
        full_s = FSDP_FULL_S if not small else 64
        full_cfg = fsdp_full_config(small)
        full_ref, picks = fsdp_full_reference(
            full_cfg, fsdp_batches(full_cfg, 2, FSDP_FULL_B, full_s, FSDP_FULL_FRAMES, SEED + 62),
            device)
    if "run_dir" not in TRAIN_REFS:  # phase 14(c)'s checkpoint, made here
        chat = _train_cli_files(os.path.join(TRAIN_DIR, "fsdp_cli"))
        run_dir = os.path.join(TRAIN_DIR, "fsdp_cli", "run")
        run_ranks(_cli_rank, FSDP_RANKS, _cli_argv(chat, run_dir, (1, 4, 1, 1))
                  + ["--device", device.type], backend="gloo", timeout=300,
                  store_dir=os.path.join(ROOT, "build"))
        TRAIN_REFS.update(chat=chat, run_dir=run_dir)
    run_dir, chat = TRAIN_REFS["run_dir"], TRAIN_REFS["chat"]
    # (b) the float32 gradients of the measured step at the samples
    t0 = time.time()
    full_cfg = fsdp_full_config(small)
    f32 = full_f32_gradients(full_cfg, fsdp_batches(
        full_cfg, 2, FSDP_FULL_B, full_s, FSDP_FULL_FRAMES, SEED + 62)[1], device, picks)
    print(f"  (b) float32 gradients of the unsharded step at the samples in "
          f"{time.time() - t0:.1f} s  [{card}]", flush=True)
    # (c) the unsharded resume, before the ranks train on from the checkpoint
    where = os.path.join(run_dir, "ckpt", "step_2")
    with open(os.path.join(where, "mesh.json")) as f:
        saved_mesh = tuple(json.load(f)["mesh"])
    trainer = _cli_trainer(run_dir, device)
    whole, whole_step = _host_state(trainer), trainer.step
    del trainer
    plan = {"device": "cuda:0" if device.type == "cuda" else "cpu", "small": small,
            "full_s": full_s, "picks": picks, "shapes": full_ref["shapes"],
            "narrow_meshes": TP_NARROW_MESHES, "full_meshes": TP_FULL_MESHES,
            "resume": {"mesh": TP_RESUME_MESH, "dir": run_dir},
            "cli": [_cli_argv(chat, run_dir, TP_RESUME_MESH, epochs=2)]}
    t0 = time.time()
    results = run_ranks(fsdp_rank, FSDP_RANKS, plan, backend="gloo", timeout=900,
                        store_dir=os.path.join(ROOT, "build"))
    walls = results[0]["wall_s"]
    print(f"  {FSDP_RANKS} ranks on {plan['device']} over gloo returned in "
          f"{time.time() - t0:.1f} s (rank 0: (a) {walls['a']:.1f} s, (b) {walls['b']:.1f} s, "
          f"(c) {walls['c']:.1f} s; {FSDP_NOTE})", flush=True)
    _narrow_report(results, TP_NARROW_MESHES, narrow_ref, failed)
    total, _ = _full_report(card, results, TP_FULL_MESHES, full_ref, full_s, device, failed,
                            TRAIN_REFS.get("readings"), f32)
    # (c)
    cfg = vita.VITAConfig.tiny()
    specs = dict(_leaf_items(vita.param_specs(cfg)))
    spec_of = lambda n: specs[n.split("/", 1)[1] if n[:3] in ("mu/", "nu/") else n]  # noqa
    old = dict(zip(AXES_ALL, saved_mesh))
    n_saved, checked = math.prod(saved_mesh), 0
    for r in range(n_saved):
        state = load_state(os.path.join(run_dir, "ckpt"), 2, "cpu", name=f"rank_{r}.pt")
        host = {n: w.detach().float().numpy() for n, w in _leaf_items(state["params"])}
        for m in ("mu", "nu"):
            host.update({f"{m}/{k}": v.float().numpy() for k, v in state["opt_state"][m].items()})
        coords = dict(zip(AXES_ALL, (int(c) for c in np.unravel_index(r, saved_mesh))))
        if set(host) != set(whole):
            failed.append(f"(c) saved rank {r}'s leaves {sorted(set(host) ^ set(whole))} differ")
        for n, b in host.items():
            if n in whole and not np.array_equal(b, _cut(whole[n], spec_of(n), coords, old)):
                failed.append(f"(c) saved rank {r}'s {n} is not the unsharded resume's block")
            checked += 1
    new = dict(zip(AXES_ALL, tuple(TP_RESUME_MESH) + (1,) * (6 - len(TP_RESUME_MESH))))
    for r, res in enumerate(results):
        got = res["resume"]
        if got["step"] != whole_step:
            failed.append(f"(c) rank {r} resumed at step {got['step']}, not {whole_step}")
        for n, b in got["state"].items():
            if not np.array_equal(b, _cut(whole[n], spec_of(n), got["coords"], new)):
                failed.append(f"(c) rank {r}'s resumed {n} is not the saved leaf's block")
            checked += 1
        (rc, printed), = res["cli"]
        if rc:
            failed.append(f"(c) rank {r}: the train CLI exited {rc}")
        if r == 0 and ("resumed from step 2" not in printed or "[step 4]" not in printed):
            failed.append(f"(c) rank 0's train CLI did not resume and train on: {printed!r}")
    resumed = [x for x in results[0]["cli"][0][1].splitlines() if "resumed" in x or "[step" in x]
    print(f"  (c) phase 14(c)'s checkpoint (--mesh {' '.join(map(str, saved_mesh))}, step "
          f"{whole_step}) resumed unsharded on {device.type} and under --mesh "
          f"{' '.join(map(str, TP_RESUME_MESH))}: {checked} saved and resumed blocks of "
          f"{len(whole)} leaves (params and Adam moments) checked bitwise; the train CLI "
          f"under that mesh: exit codes {[res['cli'][0][0] for res in results]}, rank 0 "
          f"{resumed}", flush=True)
    if failed:
        raise AssertionError("phase 15 failed:\n  " + "\n  ".join(failed))
    return total


def full_f32_gradients(cfg, batch, device, picks):
    """The float32 gradient of (b)'s measured step at the sampled flat
    ``picks`` of each trainable leaf: the slice's bf16 weights
    (``slice_params``, which the warm-up's update at lr 0 leaves as they
    are) widened to float32, every component run in float32, one forward
    and backward of ``loss_fn`` over the unsharded whole batch."""
    import torch

    from vita_tpu_torch.train import step

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        return tree.float() if tree.is_floating_point() else tree

    params = widen(slice_params(cfg, device))
    gc.collect()
    f = torch.float32
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, dtype=f),
                              vision=dataclasses.replace(cfg.vision, dtype=f),
                              audio=dataclasses.replace(cfg.audio, dtype=f))
    tc = _fsdp_tc(True)
    step.make_optimizer(tc, params)  # marks the trainable leaves
    loss, _ = step.loss_fn(params, cfg, step.batch_to(batch, device), tc.aux_loss_coef)
    leaves = dict(_leaf_items(params))
    names = list(picks)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    out = {n: g.reshape(-1)[torch.as_tensor(picks[n], device=device)].cpu().numpy()
           for n, g in zip(names, grads)}
    del params, grads, loss, leaves
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _cli_rank(rank, world, argv):
    """The train CLI on one rank of a spawned group (phase 14(c)'s run,
    when phase 15 runs alone)."""
    from vita_tpu_torch.train import cli

    return cli.main(argv)


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

    import shutil

    print("phase 11: the serving mesh on one card (expert 2 x model 2, 4 gloo ranks)",
          flush=True)
    try:
        t0 = time.time()
        parts.append(mesh_phase(card, dev))
        print(f"  phase 11 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
        print("phase 12: sequence parallelism and the duplex replicas (4 gloo ranks on one "
              "card)", flush=True)
        t0 = time.time()
        parts.append(seq_duplex_phase(card, dev, os.path.join(MESH_DIR, "ckpt")))
        print(f"  phase 12 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
        print("phase 13: pipeline-parallel serving and one GPipe step (4 gloo ranks on one "
              "card)", flush=True)
        t0 = time.time()
        parts.append(pipe_phase(card, dev, os.path.join(MESH_DIR, "ckpt")))
        print(f"  phase 13 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    print("phase 14: sharded training over the data and fsdp axes (4 gloo ranks on one card)",
          flush=True)
    t0 = time.time()
    parts.append(fsdp_phase(card, dev))
    print(f"  phase 14 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
    print("phase 15: tensor- and expert-parallel training (4 gloo ranks on one card)",
          flush=True)
    t0 = time.time()
    parts.append(tp_phase(card, dev))
    print(f"  phase 15 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
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
