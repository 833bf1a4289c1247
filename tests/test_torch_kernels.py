"""PyTorch port: every hand-written CUDA kernel against its plain PyTorch
version, on a card. Skips without one (a CUDA kernel has no CPU mode).

This module imports no jax, so it also runs on a machine without it:
    python -m pytest --noconftest -q tests/test_torch_kernels.py
(--noconftest: the suite's conftest configures jax).
"""

import numpy as np
import pytest
import torch

from torch_port_util import close, cuda_or_skip, normal, t
from vita_tpu_torch import kernels
from vita_tpu_torch.ops import flash_attention as fa
from vita_tpu_torch.ops import moe_decode as md
from vita_tpu_torch.ops import paged_attention as pa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# quantized experts round h to bf16 on both sides; float32 sums taken in
# another order can move an h value across a bf16 rounding boundary, which
# moves an output by up to 2^-8 |h| |w|; a kernel that left the rounding
# out would be off by a few 1e-3 on hundreds of elements
TOL_Q = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


def _launched(name, fn):
    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    return out


# (B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal)
FLASH_CASES = {
    "causal_gqa_per_row_offset": (2, 24, 40, 8, 2, [40, 33], [16, 9], True),
    "ragged_tiles_kv_len_padding": (2, 70, 130, 4, 4, [130, 37], [60, 5], True),
    "bidirectional_padding": (2, 20, 30, 4, 2, [30, 11], [0, 0], False),
    "rows_without_keys": (1, 8, 16, 4, 2, [16], [-3], True),
    "serving_chunk_256_over_512": (1, 256, 512, 32, 8, [512], [256], True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(case, dtype):
    dev = cuda_or_skip()
    b, sq, skv, hq, hkv, kv_len, q_off, causal = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (t(normal(rng, b, s, h, 128)).to(dev, dtype)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    args = (q, k, v, t(kv_len, torch.int32).to(dev), t(q_off, torch.int32).to(dev),
            causal, 128 ** -0.5)
    got = _launched("flash_fwd", lambda: fa.flash_mha_cuda(*args))
    want = fa.flash_mha_plain(*args)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths,page", [([5, 1], 8), ([17, 0, 64], 16), ([300, 2, 129], 64)])
def test_paged_kernel_matches_plain(lengths, page, dtype):
    dev = cuda_or_skip()
    rng = np.random.default_rng(1)
    n_pool, max_pages, hkv, hq = 24, 6, 2, 8
    kp, vp = (t(normal(rng, 2, hkv, n_pool, page, 128)).to(dev, dtype) for _ in range(2))
    tables = np.full((len(lengths), max_pages), n_pool, np.int32)  # sentinel
    perm = rng.permutation(n_pool)
    for i, n in enumerate(lengths):
        k = min(-(-n // page), max_pages)
        tables[i, :k] = perm[i * max_pages:i * max_pages + k]
    args = (t(normal(rng, len(lengths), hq, 128)).to(dev, dtype), kp, vp,
            t(tables).to(dev), t(lengths, torch.int32).to(dev), 1, 128 ** -0.5)
    got = _launched("paged_attention", lambda: pa.paged_attention_cuda(*args))
    want = pa.paged_attention_plain(*args)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tok", [1, 3, 4, 16])
def test_expert_kernels_match_plain(n_tok, dtype):
    dev = cuda_or_skip()
    rng = np.random.default_rng(2)
    e, n_layers, d, f = 4, 2, 256, 640
    wg, wu = (t(normal(rng, n_layers * e, d, f, scale=d ** -0.5)).to(dev, dtype)
              for _ in range(2))
    wd = t(normal(rng, n_layers * e, f, d, scale=f ** -0.5)).to(dev, dtype)
    x = t(normal(rng, n_tok, d)).to(dev, dtype)
    idx = np.stack([rng.choice(e, 2, replace=False) for _ in range(n_tok)]) + e
    w = rng.random((n_tok, 2)).astype(np.float32)
    idx, w = t(idx, torch.int32).to(dev), t(w / w.sum(1, keepdims=True)).to(dev)
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    got = _launched("gather_expert_ffn", lambda: md.gather_expert_ffn_cuda(x, idx, wg, wu, wd))
    close(got.float().cpu(), md.gather_expert_ffn_plain(x, idx, wg, wu, wd).float().cpu(), **tol)
    act, m = md._active_expert_plan(w, idx, e)
    got = _launched("masked_expert_ffn",
                    lambda: md.masked_expert_ffn_cuda(x, act, m, wg, wu, wd))
    want = md.masked_expert_ffn_plain(x, act, m, wg, wu, wd)
    close(got.float().cpu(), want.float().cpu(), **tol)


@pytest.mark.gpu
def test_public_functions_launch_on_cuda_tensors():
    """The public entry points take the kernel for CUDA tensors: one launch
    each, no plain fallback."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(3)
    q = t(normal(rng, 1, 4, 2, 128)).to(dev)
    _launched("flash_fwd", lambda: fa.flash_mha(q, q, q, causal=True))
    pool = t(normal(rng, 1, 2, 3, 8, 128)).to(dev)
    _launched("paged_attention", lambda: pa.paged_attention(
        t(normal(rng, 1, 4, 128)).to(dev), pool, pool,
        torch.zeros(1, 2, dtype=torch.int32, device=dev),
        torch.full((1,), 5, dtype=torch.int32, device=dev), 0))
    w = t(normal(rng, 4, 8, 16)).to(dev)
    wd = t(normal(rng, 4, 16, 8)).to(dev)
    idx = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    _launched("gather_expert_ffn", lambda: md.masked_expert_ffn(
        t(normal(rng, 1, 8)).to(dev), torch.full((1, 2), 0.5, device=dev), idx, w, w, wd, 4))
    idx4 = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=torch.int32, device=dev)
    _launched("masked_expert_ffn", lambda: md.masked_expert_ffn(
        t(normal(rng, 4, 8)).to(dev), torch.full((4, 2), 0.5, device=dev), idx4, w, w, wd, 4))


# (dtype, layers, D, F): fp32 at a small shape, bf16 at the serving width
Q_SHAPES = {"fp32_small": (torch.float32, 2, 256, 640),
            "bf16_serving": (torch.bfloat16, 1, 4096, 14336)}
# kind: (bits, int4 group)
Q_KINDS = {"int8": (8, 0), "int4": (4, 0), "int4_group64": (4, 64)}


def _quantized_experts(rng, bits, group, dtype, n_layers, d, f, dev):
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    rows = n_layers * 8

    def w(shape, scale):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype).mul_(scale)

    p = {"router": w((d, 8), d ** -0.5), "w_gate": w((rows, d, f), d ** -0.5),
         "w_up": w((rows, d, f), d ** -0.5), "w_down": w((rows, f, d), f ** -0.5)}
    if bits == 8:
        return md.quantize_expert_weights(p)
    return md.quantize_expert_weights_int4(p, group)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(Q_SHAPES))
@pytest.mark.parametrize("kind", sorted(Q_KINDS))
def test_quantized_expert_kernels_match_plain(kind, shape):
    """B6/B7 (gather, T 1 and 3) and B8a/B8b (masked, T 4, 8, 16)."""
    dev = cuda_or_skip()
    bits, group = Q_KINDS[kind]
    dtype, n_layers, d, f = Q_SHAPES[shape]
    rng = np.random.default_rng(4)
    qp = _quantized_experts(rng, bits, group, dtype, n_layers, d, f, dev)
    suffix = "_q4" if bits == 4 else "_q"
    tol = dict(atol=TOL_Q[dtype], rtol=TOL_Q[dtype])
    for n_tok in (1, 3, 4, 8, 16):
        x = t(normal(rng, n_tok, d)).to(dev, dtype)
        idx = np.stack([rng.choice(8, 2, replace=False) for _ in range(n_tok)])
        idx = t(idx + 8 * (n_layers - 1), torch.int32).to(dev)
        w = rng.random((n_tok, 2)).astype(np.float32)
        w = t(w / w.sum(1, keepdims=True)).to(dev)
        if n_tok < 4:
            got = _launched("gather_expert_ffn" + suffix,
                            lambda: md.gather_expert_ffn_q_cuda(x, idx, qp, bits))
            want = md.gather_expert_ffn_q_plain(x, idx, qp, bits)
        else:
            act, m = md._active_expert_plan(w, idx, 8)
            got = _launched("masked_expert_ffn" + suffix,
                            lambda: md.masked_expert_ffn_q_cuda(x, act, m, qp, bits))
            want = md.masked_expert_ffn_q_plain(x, act, m, qp, bits)
        assert got.dtype == dtype
        close(got.float().cpu(), want.float().cpu(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths,page", [([5, 1, 0], 64), ([300, 2, 129], 64),
                                          ([1000, 37, 0, 2048], 128), ([384], 128)])
def test_paged_q_kernel_matches_plain(lengths, page, dtype):
    """B9 over int8 pages with row scales; q and o in dtype."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(5)
    hkv, hq = 8, 32
    max_pages = max(-(-n // page) for n in lengths)
    n_pool = max_pages * len(lengths) + 2
    shape, sshape = (2, hkv, n_pool, page, 128), (2, hkv, n_pool, 1, page)
    kp, vp = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev) for _ in range(2))
    ks, vs = (torch.rand(sshape, device=dev) * 0.02 for _ in range(2))
    tables = np.full((len(lengths), max_pages), n_pool, np.int32)  # sentinel
    perm = rng.permutation(n_pool)
    for i, n in enumerate(lengths):
        k = -(-n // page)
        tables[i, :k] = perm[i * max_pages:i * max_pages + k]
    args = (t(normal(rng, len(lengths), hq, 128)).to(dev, dtype), kp, vp, t(tables).to(dev),
            t(lengths, torch.int32).to(dev), 1, 128 ** -0.5, ks, vs)
    got = _launched("paged_attention_q", lambda: pa.paged_attention_cuda(*args))
    want = pa.paged_attention_plain(*args)
    assert got.dtype == dtype
    close(got.float().cpu(), want.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_quantized_public_functions_launch_on_cuda_tensors():
    """The quantized entry points take their kernels for CUDA tensors."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(6)
    p = {"router": t(normal(rng, 8, 4)).to(dev), "w_gate": t(normal(rng, 4, 8, 16)).to(dev),
         "w_up": t(normal(rng, 4, 8, 16)).to(dev), "w_down": t(normal(rng, 4, 16, 8)).to(dev)}
    q8, q4 = md.quantize_expert_weights(p), md.quantize_expert_weights_int4(p)
    for n_tok, q, fn, name in ((1, q8, md.masked_expert_ffn_q, "gather_expert_ffn_q"),
                               (4, q8, md.masked_expert_ffn_q, "masked_expert_ffn_q"),
                               (4, q4, md.masked_expert_ffn_q4, "gather_expert_ffn_q4"),
                               (8, q4, md.masked_expert_ffn_q4, "masked_expert_ffn_q4")):
        idx = t(np.stack([[i % 4, (i + 1) % 4] for i in range(n_tok)]), torch.int32).to(dev)
        _launched(name, lambda: fn(t(normal(rng, n_tok, 8)).to(dev),
                                   torch.full((n_tok, 2), 0.5, device=dev), idx, q, 4))
    pool = torch.zeros(1, 2, 3, 8, 128, dtype=torch.int8, device=dev)
    scales = torch.ones(1, 2, 3, 1, 8, device=dev)
    _launched("paged_attention_q", lambda: pa.paged_attention(
        t(normal(rng, 1, 4, 128)).to(dev), pool, pool,
        torch.zeros(1, 2, dtype=torch.int32, device=dev),
        torch.full((1,), 5, dtype=torch.int32, device=dev), 0, k_scale=scales, v_scale=scales))
