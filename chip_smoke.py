#!/usr/bin/env python3
"""Drive the PyTorch port (vita_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build the hand-written CUDA kernels from vita_tpu_torch/csrc with nvcc
     (sm_90a, one nvcc per source, all at once) into build/kernels/;
  2. hold every kernel against its plain PyTorch version at the serving
     path's shapes in bf16 and at a small shape in fp32, and time both with
     CUDA events (median of 25 runs after warm-up): B1-B4, the quantized
     expert FFNs B6/B7 (int8/int4, per-channel and grouped) and B8a/B8b,
     and B9 over int8 pages;
  3. serve the full-width VITA-8x7B slice (Mixtral cut to 4 of 32 layers,
     InternViT-300M at 448px, Whale 24x1024; random weights from a seed)
     through Engine, three times on the same weights: bf16 experts (one
     text request alone, then one image+audio request with three text
     requests); int4 experts with int8 KV pages on 8 slots (alone, then
     image+audio with seven text requests); int8 experts with int8 KV
     pages (alone, then a wave of four). Launch counts are zeroed before
     each run and read after it; every kernel of a run's path must have
     launched in it;
  4. the same Engine on the card and on the CPU, narrow fp32 config, same
     weights and prompts, float experts and then int4 experts with int8 KV
     pages: greedy streams must be identical (for the quantized run, a
     request may split only at a step where the CPU's own top two logits
     were the two tokens, within NEAR_TIE below).

Prints the card's name and power limit first, a JSON line of per-kernel
results before the last, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def compare(name, got, want, atol, rtol):
    """Max abs error of got vs want; raises past atol + rtol * |want|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past atol {atol} + rtol {rtol}; "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def _flash_case(rng, b, sq, skv, hq, hkv, kv_len, q_off, dtype, dev):
    import torch

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)

    q, k, v = t(b, sq, hq, 128), t(b, skv, hkv, 128), t(b, skv, hkv, 128)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q_off = torch.tensor(q_off, dtype=torch.int32, device=dev)
    return (q, k, v, kv_len, q_off, True, 128 ** -0.5)


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


def _expert_weights(rng, rows, d, f, dtype, dev):
    import torch

    def t(shape, scale):
        w = torch.empty(shape, dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        return w.normal_(generator=gen).mul_(scale)

    return (t((rows, d, f), d ** -0.5), t((rows, d, f), d ** -0.5),
            t((rows, f, d), f ** -0.5))


def _routing(rng, t, k, n_experts, layer, dtype, dev):
    import torch

    idx = np.stack([rng.choice(n_experts, k, replace=False) for _ in range(t)])
    w = rng.random((t, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return (torch.from_numpy(w).to(dev),
            torch.from_numpy((idx + layer * n_experts).astype(np.int32)).to(dev))


def kernel_phase(card: str):
    """Every kernel against its plain version; returns per-kernel rows for
    the result line (times at the serving path's main shape)."""
    import torch

    from vita_tpu_torch.ops import flash_attention as fa
    from vita_tpu_torch.ops import moe_decode as md
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

    def check(kernel, case, run_kernel, run_plain, dtype, timed, tols=tol):
        want = run_plain()
        got = run_kernel()
        torch.cuda.synchronize()
        err = compare(f"{kernel} {case}", got, want, *tols[dtype])
        line = f"  {kernel:20s} {case:44s} max_abs_err {err:.3e} (tol {tols[dtype]})"
        if timed:
            ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
            line += f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]"
            if kernel not in rows:
                rows[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(line, flush=True)

    # B1: prefill chunk 256 over bucket 512 (both chunks), 384 as one chunk
    for case, sq, skv, kv_len, q_off, dt, timed in (
        ("bf16 chunk 256/512, offset 256", 256, 512, [512], [256], bf16, True),
        ("bf16 chunk 256/512, offset 0", 256, 512, [256], [0], bf16, False),
        ("bf16 whole bucket 384", 384, 384, [384], [0], bf16, False),
        ("fp32 B=2 ragged, kv_len pad, q_offset", 100, 150, [150, 77], [50, 0], f32, False),
    ):
        b = len(kv_len)
        hq, hkv = (32, 8) if dt == bf16 else (4, 2)
        args = _flash_case(rng, b, sq, skv, hq, hkv, kv_len, q_off, dt, dev)
        check("flash_fwd", case, lambda a=args: fa.flash_mha_cuda(*a),
              lambda a=args: fa.flash_mha_plain(*a), dt, timed)

    # B2: decode over the serving pool (4 layers, 128 pages of 64)
    for case, lengths, dt, timed in (
        ("bf16 B=4 ragged, one inactive", [1000, 37, 0, 2048], bf16, True),
        ("bf16 B=1", [300], bf16, False),
        ("fp32 B=3 page 16", [5, 0, 70], f32, False),
    ):
        if dt == bf16:
            args = _paged_case(rng, lengths, 32, 8, 4, 128, 64, 32, dt, dev)
        else:
            args = _paged_case(rng, lengths, 4, 2, 2, 16, 16, 6, dt, dev)
        check("paged_attention", case, lambda a=args: pa.paged_attention_cuda(*a),
              lambda a=args: pa.paged_attention_plain(*a), dt, timed)

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
        check("paged_attention_q", case, lambda a=args: pa.paged_attention_cuda(*a),
              lambda a=args: pa.paged_attention_plain(*a), dt, timed)

    # B3/B4: the selected experts of layer 3 of 4 (flat ids into [L*E, ...])
    for dt, d, f, n_layers in ((bf16, 4096, 14336, 4), (f32, 256, 512, 2)):
        layer = n_layers - 1
        wg, wu, wd = _expert_weights(rng, n_layers * 8, d, f, dt, dev)
        for t in (1, 3):
            x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
            _, idx = _routing(rng, t, 2, 8, layer, dt, dev)
            check("gather_expert_ffn", f"{dt} T={t}",
                  lambda x=x, i=idx: md.gather_expert_ffn_cuda(x, i, wg, wu, wd),
                  lambda x=x, i=idx: md.gather_expert_ffn_plain(x, i, wg, wu, wd),
                  dt, t == 1 and dt == bf16)
        for t in (4, 16):
            x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
            w, idx = _routing(rng, t, 2, 8, layer, dt, dev)
            act, m = md._active_expert_plan(w, idx, 8)
            check("masked_expert_ffn", f"{dt} T={t}",
                  lambda x=x, a=act, m=m: md.masked_expert_ffn_cuda(x, a, m, wg, wu, wd),
                  lambda x=x, a=act, m=m: md.masked_expert_ffn_plain(x, a, m, wg, wu, wd),
                  dt, t == 4 and dt == bf16)

        # B6/B7 (gather) and B8a/B8b (masked) over the same experts,
        # quantized layer by layer; grouped int4 only has the gather schedule
        # on the main path (group 128 at the serving width)
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
            for t in (1, 3):
                x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
                _, idx = _routing(rng, t, 2, 8, layer, dt, dev)
                check("gather_expert_ffn" + sfx, f"{kind} {dt} T={t}",
                      lambda x=x, i=idx, q=qp, b=bits: md.gather_expert_ffn_q_cuda(x, i, q, b),
                      lambda x=x, i=idx, q=qp, b=bits: md.gather_expert_ffn_q_plain(x, i, q, b),
                      dt, t == 1 and dt == bf16, tol_q)
            for t in ((4, 16) if bits == 8 else (8, 16)) if main else ():
                x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, dt)
                w, idx = _routing(rng, t, 2, 8, layer, dt, dev)
                act, m = md._active_expert_plan(w, idx, 8)
                check("masked_expert_ffn" + sfx, f"{kind} {dt} T={t}",
                      lambda x=x, a=act, m=m, q=qp, b=bits:
                          md.masked_expert_ffn_q_cuda(x, a, m, q, b),
                      lambda x=x, a=act, m=m, q=qp, b=bits:
                          md.masked_expert_ffn_q_plain(x, a, m, q, b),
                      dt, t < 16 and dt == bf16, tol_q)
            del qp
        del wg, wu, wd, stack
        torch.cuda.empty_cache()
    return rows


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


def slice_phase(card: str, cfg, device, max_new_tokens: int = 32):
    """Serve the slice through the Engine once per SERVED_RUNS entry, on
    the same weights; returns the launch counts summed over the runs."""
    import torch

    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.serve.engine import Engine

    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = vita.init_params(cfg, gen, device)
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    _sync(device)
    print(f"  init {n_bytes / 2**30:.2f} GiB of weights on {device}: "
          f"{time.time() - t0:.1f} s", flush=True)
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
        logits, _, _ = mixtral.forward(params["llm"], cfg.llm, input_ids=ids)
        last = logits[0, -1].float()
        if logits.shape != (1, ids.shape[1], cfg.llm.vocab_size) or not bool(
                last.isfinite().all()):
            raise AssertionError(f"cacheless logits {tuple(logits.shape)} not finite")
        gap = float(last.max() - last[solo.tokens[0]])
        print(f"  cacheless forward: logits {tuple(logits.shape)} finite; engine's first "
              f"token is {gap:.4f} below the top logit", flush=True)
        if gap > 0.1:
            raise AssertionError(f"first token {gap:.4f} below the reference's top logit")
        del engine, logits
        gc.collect()
        torch.cuda.empty_cache()
    return total


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


def equivalence_phase(devices, near_tie: float = 0.0, **engine_kw):
    """Greedy streams of the Engine on each device, same weights, prompts
    and options; the last device is the reference. Raises on any
    difference, except (with ``near_tie`` > 0) where the reference's own
    top two logits at that request's step were the two tokens and lay
    within ``near_tie``: that request is compared up to the step."""
    import torch

    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.serve.engine import Engine

    cfg = narrow_config()
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
    print(f"  greedy streams identical on {devices} ({engine_kw}): {len(ref)} requests, "
          f"{compared} of {sum(map(len, ref))} tokens compared", flush=True)


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
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    counts = slice_phase(card, slice_config(), torch.device("cuda"))
    print(f"  phase 3 wall {time.time() - t0:.1f} s  [{card}]", flush=True)
    torch.cuda.empty_cache()

    print("phase 4: Engine on cuda vs cpu, narrow fp32 config", flush=True)
    t0 = time.time()
    pair = [torch.device("cuda"), torch.device("cpu")]
    equivalence_phase(pair, decode_moe_mode="gather")
    equivalence_phase(pair, NEAR_TIE, decode_moe_mode="gather_q4", kv_int8=True)
    print(f"  phase 4 wall {time.time() - t0:.1f} s", flush=True)

    meta = {
        "flash_fwd": ("csrc/flash_fwd.cu", "vita_tpu/ops/flash_attention.py:54"),
        "paged_attention": ("csrc/paged_attn.cu", "vita_tpu/ops/paged_attention.py:95"),
        "gather_expert_ffn": ("csrc/expert_ffn.cu", "vita_tpu/ops/moe_decode.py:30"),
        "masked_expert_ffn": ("csrc/expert_ffn.cu", "vita_tpu/ops/moe_decode.py:539"),
        "gather_expert_ffn_q": ("csrc/expert_ffn.cu", "vita_tpu/ops/moe_decode.py:162"),
        "gather_expert_ffn_q4": ("csrc/expert_ffn.cu", "vita_tpu/ops/moe_decode.py:326"),
        "masked_expert_ffn_q": ("csrc/expert_ffn.cu", "vita_tpu/ops/moe_decode.py:627"),
        "masked_expert_ffn_q4": ("csrc/expert_ffn.cu", "vita_tpu/ops/moe_decode.py:720"),
        "paged_attention_q": ("csrc/paged_attn.cu", "vita_tpu/ops/paged_attention.py:335"),
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
