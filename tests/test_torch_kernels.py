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
