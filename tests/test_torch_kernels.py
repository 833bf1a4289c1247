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
from vita_tpu_torch.ops import moe
from vita_tpu_torch.ops import moe_decode as md
from vita_tpu_torch.ops import moe_gmm as mg
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


def _flash_fwd_args(case, dtype, dev):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (t(normal(rng, b, s, h, 128)).to(dev, dtype)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    return (q, k, v, t(kv_len, torch.int32).to(dev), t(q_off, torch.int32).to(dev),
            causal, 128 ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(case, dtype):
    args = _flash_fwd_args(case, dtype, cuda_or_skip())
    got, _ = _launched("flash_fwd", lambda: fa.flash_fwd_cuda(*args))
    want, _ = fa.flash_fwd_plain(*args)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_lse_matches_plain(case, dtype):
    """B1's log-sum-exp, which the backward reads: float32 whatever q's
    dtype, -inf exactly on rows without keys."""
    args = _flash_fwd_args(case, dtype, cuda_or_skip())
    _, lse = _launched("flash_fwd", lambda: fa.flash_fwd_cuda(*args))
    _, want_lse = fa.flash_fwd_plain(*args)
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    assert torch.equal(torch.isinf(lse).cpu(), torch.isinf(want_lse).cpu())
    fin = torch.isfinite(want_lse)
    close(lse[fin].cpu(), want_lse[fin].cpu(), atol=1e-4, rtol=1e-4)


# bf16 B1 (wgmma + TMA) where its design has edges: a causal sequence
# whose walk wraps the K/V ring many times and crosses kv_len inside a tile
# (a pair of q heads a block); the Generator's decode call (one q row over
# 1000+ keys at a q_offset, one q head a block); batch rows whose kv_len and
# q_offset differ, so masks cross tiles at other columns in each row and a
# p scattered to the wrong columns cannot pass
FLASH_BF16_CASES = {
    "long_causal_2048_kv_len_1500": (1, 2048, 2048, 32, 8, [1500], [0], True),
    "decode_one_row_over_1200_keys": (2, 1, 1536, 32, 8, [1200, 1037], [1199, 1036], True),
    "per_row_kv_len_and_offset": (3, 300, 700, 32, 8, [700, 333, 517], [400, 33, -20], True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FLASH_BF16_CASES))
def test_flash_bf16_kernel_matches_plain(case):
    dev = cuda_or_skip()
    b, sq, skv, hq, hkv, kv_len, q_off, causal = FLASH_BF16_CASES[case]
    rng = np.random.default_rng(15)
    q, k, v = (t(normal(rng, b, s, h, 128)).to(dev, torch.bfloat16)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    args = (q, k, v, t(kv_len, torch.int32).to(dev), t(q_off, torch.int32).to(dev), causal,
            128 ** -0.5)
    got, lse = _launched("flash_fwd", lambda: fa.flash_fwd_cuda(*args))
    want, want_lse = fa.flash_fwd_plain(*args)
    tol = TOL[torch.bfloat16]
    close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)
    assert torch.equal(torch.isinf(lse).cpu(), torch.isinf(want_lse).cpu())
    fin = torch.isfinite(want_lse)
    close(lse[fin].cpu(), want_lse[fin].cpu(), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [9, 65])
def test_flash_mha_below_head_dim_128_launches_b1(d, dtype):
    """flash_mha on CUDA tensors at head dim 65 (Whale's flash path: 64
    and the key-bias column) and 9 (the tiny Whale's): B1 launches once,
    zero-padded to 128 (counted as flash_fwd:d65 / d9), never the plain
    version; o, lse and the backward's dq, dk, dv (B10/B11 on the padded
    head, sliced back) agree with the plain versions at d."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(d)
    q, k, v, do = (t(normal(rng, 2, 150, 16, d)).to(dev, dtype) for _ in range(4))
    kv_len = torch.tensor([150, 97], dtype=torch.int32, device=dev)
    q_off = torch.zeros(2, dtype=torch.int32, device=dev)
    scale = 64 ** -0.5
    kernels.reset_launches()
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = fa.flash_mha(qg, kg, vg, kv_len=kv_len, causal=False, scale=scale)
    o.backward(do)
    torch.cuda.synchronize()
    assert kernels.launch_keys == {f"flash_fwd:d{d}": 1, f"flash_bwd_dq:d{d}": 1,
                                   f"flash_bwd_dkv:d{d}": 1}
    want, lse = fa.flash_fwd_plain(q, k, v, kv_len, q_off, False, scale)
    tol = TOL[dtype]
    close(o.detach().float().cpu(), want.float().cpu(), atol=tol, rtol=tol)
    _, got_lse = fa.flash_fwd_cuda(q, k, v, kv_len, q_off, False, scale)
    close(got_lse.cpu(), lse.cpu(), atol=1e-4, rtol=1e-4)
    args = (q, k, v, do, lse, fa.flash_delta(do, want), kv_len, q_off, False, scale)
    close(qg.grad.float().cpu(), fa.flash_bwd_dq_plain(*args).float().cpu(), atol=tol, rtol=tol)
    for g, w in zip((kg.grad, vg.grad), fa.flash_bwd_dkv_plain(*args)):
        close(g.float().cpu(), w.float().cpu(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_bf16_kernel_is_deterministic():
    """One write per output and no atomics: two launches of bf16 B1 (both
    block shapes) give the same bits."""
    dev = cuda_or_skip()
    for case in ("long_causal_2048_kv_len_1500", "decode_one_row_over_1200_keys"):
        b, sq, skv, hq, hkv, kv_len, q_off, causal = FLASH_BF16_CASES[case]
        gen = torch.Generator(device=dev).manual_seed(16)
        q, k, v = (torch.randn(b, s, h, 128, generator=gen, device=dev).to(torch.bfloat16)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
        args = (q, k, v, torch.tensor(kv_len, dtype=torch.int32, device=dev),
                torch.tensor(q_off, dtype=torch.int32, device=dev), causal, 128 ** -0.5)
        (o1, l1), (o2, l2) = fa.flash_fwd_cuda(*args), fa.flash_fwd_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2) and torch.equal(l1, l2)


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


def _confined_routing(rng, n_tok, experts, dev):
    """Top-2 routing of n_tok tokens over only ``experts`` (flat ids), so
    the masked plan pads its rows by repeating the last distinct id."""
    idx = np.stack([rng.choice(experts, 2, replace=False) for _ in range(n_tok)])
    w = rng.random((n_tok, 2)).astype(np.float32)
    return t(w / w.sum(1, keepdims=True)).to(dev), t(idx, torch.int32).to(dev)


def _q_rows_plain(x, eids, toks, qp, bits):
    """The plain quantized SwiGLU of each row's token slots: y [R, nt, D]
    in x's dtype, zero for an empty slot (-1)."""
    xs = torch.where(toks[..., None] >= 0, x[toks.clamp(min=0).long()], 0)
    return md._swiglu_rows_q(xs, qp, eids, bits).to(x.dtype)


def _close_q(got, want):
    close(got.float().cpu(), want.float().cpu(), atol=TOL_Q[torch.bfloat16],
          rtol=TOL_Q[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("n_tok", [8, 16])
def test_q4_mma_kernel_padding_rows(n_tok):
    """bf16 B8b at the serving width with routing confined to 3 of 8
    experts: 5 of the plan's 8 rows are padding; they read no weights and
    give zeros, and the weighted output matches the plain version."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(7)
    qp = _quantized_experts(rng, 4, 0, torch.bfloat16, 1, 4096, 14336, dev)
    x = t(normal(rng, n_tok, 4096)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, n_tok, [1, 4, 6], dev)
    act, m = md._active_expert_plan(w, idx, 8)
    assert act.tolist() == [1, 4, 6, 6, 6, 6, 6, 6]
    y = md._expert_ffn_q_mma(x, *md._active_rows(x, act), qp, 4, True)
    assert y.shape == (8, 8 if n_tok <= 8 else 16, 4096)
    assert torch.isfinite(y).all() and not y[3:].any()
    got = _launched("masked_expert_ffn_q4", lambda: md.masked_expert_ffn_q_cuda(x, act, m, qp, 4))
    assert not torch.isnan(got).any()
    _close_q(got, md.masked_expert_ffn_q_plain(x, act, m, qp, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tok", [4, 8, 16])
def test_q8_mma_kernel_padding_rows(n_tok):
    """bf16 B8a at the serving width with routing confined to 3 of 8
    experts: 5 of the plan's 8 rows are padding; they read no weights and
    give zeros, the other rows the plain version's outputs, and the
    weighted output matches the plain version."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(15)
    qp = _quantized_experts(rng, 8, 0, torch.bfloat16, 1, 4096, 14336, dev)
    x = t(normal(rng, n_tok, 4096)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, n_tok, [0, 2, 5], dev)
    act, m = md._active_expert_plan(w, idx, 8)
    assert act.tolist() == [0, 2, 5, 5, 5, 5, 5, 5]
    eids, toks = md._active_rows(x, act)
    y = md._expert_ffn_q_mma(x, eids, toks, qp, 8, True)
    assert y.shape == (8, toks.shape[1], 4096)
    assert not y[3:].any() and y[:3, :n_tok].abs().amax(-1).min() > 0
    _close_q(y[:3], _q_rows_plain(x, eids[:3], toks[:3], qp, 8))
    got = _launched("masked_expert_ffn_q", lambda: md.masked_expert_ffn_q_cuda(x, act, m, qp, 8))
    _close_q(got, md.masked_expert_ffn_q_plain(x, act, m, qp, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
def test_q_mma_kernel_empty_token_slots(bits):
    """Rows whose slots hold -1 between tokens (and a row of only empty
    slots), in int4 and int8: those slots give zeros, the others the plain
    version's outputs; two pieces of F for down, the last ragged."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(16)
    qp = _quantized_experts(rng, bits, 0, torch.bfloat16, 1, 512, 2304, dev)
    x = t(normal(rng, 5, 512)).to(dev, torch.bfloat16)
    eids = torch.tensor([2, 5, 7], dtype=torch.int32, device=dev)
    toks = torch.tensor([[0, -1, 2, -1, 1, 3, -1, -1], [-1] * 8, [3, 2, 1, 0, -1, -1, -1, 4]],
                        dtype=torch.int32, device=dev)
    y = md._expert_ffn_q_mma(x, eids, toks, qp, bits, False)
    torch.cuda.synchronize()
    assert not y[toks < 0].any() and y[toks >= 0].abs().amax(-1).min() > 0
    _close_q(y, _q_rows_plain(x, eids, toks, qp, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tok", [1, 2, 3])
def test_q4_mma_kernel_gather_rows_repeat_experts(n_tok):
    """bf16 B7 at the serving width: pair rows that name the same expert
    on adjacent rows (pairs sorted by expert) are all computed, unlike the
    masked plan's padding; then the public function at T 1-3 (pairs sorted
    from T 2) launches the kernel and matches the CPU."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(17)
    qp = _quantized_experts(rng, 4, 0, torch.bfloat16, 1, 4096, 14336, dev)
    x = t(normal(rng, n_tok, 4096)).to(dev, torch.bfloat16)
    eids = torch.tensor([3, 3, 5, 5, 5, 0][:2 * n_tok], dtype=torch.int32, device=dev)
    toks = torch.tensor([[0], [1], [2], [0], [1], [2]][:2 * n_tok], dtype=torch.int32,
                        device=dev).clamp(max=n_tok - 1)
    y = md._expert_ffn_q_mma(x, eids, toks, qp, 4, False)
    torch.cuda.synchronize()
    assert y.abs().amax(-1).min() > 0
    _close_q(y, _q_rows_plain(x, eids, toks, qp, 4))
    w, idx = _confined_routing(rng, n_tok, [1, 4], dev)
    got = _launched("gather_expert_ffn_q4", lambda: md.masked_expert_ffn_q4(x, w, idx, qp, 8))
    cpu = {k: v.cpu() for k, v in qp.items()}
    _close_q(got, md.masked_expert_ffn_q4(x.cpu(), w.cpu(), idx.cpu(), cpu, 8))


# (D, F): ragged k16-steps and column tiles with 16-byte rows; rows that
# are no multiple of 16 bytes (staged without cp.async); several pieces of
# F for down, the last ragged
NARROW_Q = {"ragged_tiles": (200, 648), "unaligned_rows": (100, 332),
            "three_f_pieces": (64, 4400)}


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", sorted(NARROW_Q))
def test_q_mma_kernel_narrow_ragged_widths(case, bits):
    """bf16 B7 (T 1-3) and B8a/B8b (T 4-16; int4 masks from T 8) at narrow
    widths against the plain versions."""
    dev = cuda_or_skip()
    d, f = NARROW_Q[case]
    rng = np.random.default_rng(18)
    qp = _quantized_experts(rng, bits, 0, torch.bfloat16, 1, d, f, dev)
    for n_tok in (1, 3, 4, 8, 16):
        x = t(normal(rng, n_tok, d)).to(dev, torch.bfloat16)
        w, idx = _confined_routing(rng, n_tok, list(range(8)), dev)
        if bits == 4:
            got = md.gather_expert_ffn_q_cuda(x, idx, qp, 4)
            _close_q(got, md.gather_expert_ffn_q_plain(x, idx, qp, 4))
        act, m = md._active_expert_plan(w, idx, 8)
        got = md.masked_expert_ffn_q_cuda(x, act, m, qp, bits)
        _close_q(got, md.masked_expert_ffn_q_plain(x, act, m, qp, bits))


@pytest.mark.gpu
def test_q4_mma_kernel_narrow_ragged_widths():
    """bf16 B8b at D 200, F 648: D/2 = 100 k rows and 648 columns leave
    ragged k16-steps and column tiles, and rows that are no multiple of 16
    bytes (staged without cp.async)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(8)
    qp = _quantized_experts(rng, 4, 0, torch.bfloat16, 1, 200, 648, dev)
    x = t(normal(rng, 8, 200)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, 8, list(range(8)), dev)
    act, m = md._active_expert_plan(w, idx, 8)
    got = _launched("masked_expert_ffn_q4", lambda: md.masked_expert_ffn_q_cuda(x, act, m, qp, 4))
    _close_q(got, md.masked_expert_ffn_q_plain(x, act, m, qp, 4))


@pytest.mark.gpu
def test_q4_mma_kernel_is_deterministic():
    """Down's split sums meet in a fixed order (no atomics): two launches
    give the same bits."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(9)
    qp = _quantized_experts(rng, 4, 0, torch.bfloat16, 1, 4096, 14336, dev)
    x = t(normal(rng, 16, 4096)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, 16, list(range(8)), dev)
    rows = md._active_rows(x, md._active_expert_plan(w, idx, 8)[0])
    a, b = (md._expert_ffn_q_mma(x, *rows, qp, 4, True) for _ in range(2))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("bits,n_tok", [(4, 1), (4, 3), (8, 4), (8, 16)])
def test_q_mma_kernel_is_deterministic(bits, n_tok):
    """Two launches give the same bits for B7's pair rows (T 1, and T 3's
    sorted pairs) and B8a's plan (T 4, 16)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(19)
    qp = _quantized_experts(rng, bits, 0, torch.bfloat16, 1, 4096, 14336, dev)
    x = t(normal(rng, n_tok, 4096)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, n_tok, list(range(8)), dev)
    if bits == 4:
        idx = idx.reshape(-1).sort().values.reshape(n_tok, 2)
        rows, padded = md._pair_rows(x, idx), False
    else:
        rows, padded = md._active_rows(x, md._active_expert_plan(w, idx, 8)[0]), True
    a, b = (md._expert_ffn_q_mma(x, *rows, qp, bits, padded) for _ in range(2))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# (D, F): multiples of 4 and not of 16, so k16-steps, column tiles and the
# rows' 16-byte alignment are all ragged; the second has three F pieces
NARROW_B6 = {"d100_f332": (100, 332), "d36_f4404": (36, 4404)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(NARROW_B6))
def test_b6_gather_q8_runs_tensor_core_kernel(case, monkeypatch):
    """bf16 B6 (int8 experts, gather schedule) through the public
    gather_expert_ffn_q and masked_expert_ffn_q at T 1-3 (pairs sorted by
    expert from T 2, so adjacent rows repeat an expert): the tensor-core
    kernel of csrc/expert_ffn_q.cu runs and the SIMT kernel does not, the
    outputs match the plain version and the CPU, and two launches give
    equal bits. float32 x still takes the SIMT kernel."""
    dev = cuda_or_skip()
    d, f = NARROW_B6[case]
    simt = []
    simt_launch = md._expert_ffn_cuda
    monkeypatch.setattr(md, "_expert_ffn_cuda",
                        lambda *a, **k: simt.append(1) or simt_launch(*a, **k))
    rng = np.random.default_rng(21)
    qp = _quantized_experts(rng, 8, 0, torch.bfloat16, 1, d, f, dev)
    cpu = {k: v.cpu() for k, v in qp.items()}
    for n_tok in (1, 2, 3):
        x = t(normal(rng, n_tok, d)).to(dev, torch.bfloat16)
        w, idx = _confined_routing(rng, n_tok, [1, 4, 6], dev)
        got = _launched("gather_expert_ffn_q", lambda: md.gather_expert_ffn_q(x, idx, qp))
        _close_q(got, md.gather_expert_ffn_q_plain(x, idx, qp, 8))
        again = md.gather_expert_ffn_q(x, idx, qp)
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))
        out = _launched("gather_expert_ffn_q",
                        lambda: md.masked_expert_ffn_q(x, w, idx, qp, 8))
        _close_q(out, md.masked_expert_ffn_q(x.cpu(), w.cpu(), idx.cpu(), cpu, 8))
    assert not simt
    xf = t(normal(rng, 1, d)).to(dev)
    got = _launched("gather_expert_ffn_q", lambda: md.gather_expert_ffn_q(xf, idx[:1], qp))
    close(got.cpu(), md.gather_expert_ffn_q_plain(xf, idx[:1], qp, 8).cpu(),
          atol=TOL_Q[torch.float32], rtol=TOL_Q[torch.float32])
    assert simt


def _bf16_experts(rng, rows, d, f, dev):
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def w(shape, scale):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).mul_(scale)

    return w((rows, d, f), d ** -0.5), w((rows, d, f), d ** -0.5), w((rows, f, d), f ** -0.5)


def _rows_plain(x, eids, toks, wg, wu, wd):
    """The plain SwiGLU of each row's token slots: y [R, nt, D], zero for
    an empty slot (-1)."""
    xs = torch.where(toks[..., None] >= 0, x[toks.clamp(min=0).long()], 0)
    e = eids.long()
    return md._swiglu_rows(xs, wg[e], wu[e], wd[e]).to(x.dtype)


def _close_bf16(got, want):
    close(got.float().cpu(), want.float().cpu(), atol=TOL[torch.bfloat16],
          rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("n_tok", [4, 8, 16])
def test_bf16_mma_kernel_padding_rows(n_tok):
    """bf16 B4 at the serving width with routing confined to 3 of 8
    experts: 5 of the plan's 8 rows are padding; they read no weights and
    give zeros, and the weighted output matches the plain version."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(10)
    wg, wu, wd = _bf16_experts(rng, 8, 4096, 14336, dev)
    x = t(normal(rng, n_tok, 4096)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, n_tok, [1, 4, 6], dev)
    act, m = md._active_expert_plan(w, idx, 8)
    assert act.tolist() == [1, 4, 6, 6, 6, 6, 6, 6]
    eids, toks = md._active_rows(x, act)
    y = md._expert_ffn_mma(x, eids, toks, wg, wu, wd, True)
    assert y.shape == (8, toks.shape[1], 4096)
    assert not y[3:].any() and y[:3, :n_tok].abs().amax(-1).min() > 0
    _close_bf16(y[:3], _rows_plain(x, eids[:3], toks[:3], wg, wu, wd))
    got = _launched("masked_expert_ffn", lambda: md.masked_expert_ffn_cuda(x, act, m, wg, wu, wd))
    _close_bf16(got, md.masked_expert_ffn_plain(x, act, m, wg, wu, wd))


@pytest.mark.gpu
def test_bf16_mma_kernel_empty_token_slots():
    """Rows whose slots hold -1 between tokens (and a row of only empty
    slots): those slots give zeros, the others the plain version's
    outputs; two pieces of F for down, the last ragged."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(11)
    wg, wu, wd = _bf16_experts(rng, 8, 512, 2304, dev)
    x = t(normal(rng, 5, 512)).to(dev, torch.bfloat16)
    eids = torch.tensor([2, 5, 7], dtype=torch.int32, device=dev)
    toks = torch.tensor([[0, -1, 2, -1, 1, 3, -1, -1], [-1] * 8, [3, 2, 1, 0, -1, -1, -1, 4]],
                        dtype=torch.int32, device=dev)
    y = md._expert_ffn_mma(x, eids, toks, wg, wu, wd, False)
    torch.cuda.synchronize()
    assert not y[toks < 0].any() and y[toks >= 0].abs().amax(-1).min() > 0
    _close_bf16(y, _rows_plain(x, eids, toks, wg, wu, wd))


@pytest.mark.gpu
def test_bf16_mma_kernel_gather_rows_repeat_experts():
    """Gather rows may name the same expert on adjacent rows (pairs sorted
    by expert): unlike the masked plan's padding, every one is computed.
    Also through the public function at T 3, whose pairs are sorted."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(12)
    wg, wu, wd = _bf16_experts(rng, 8, 1024, 2048, dev)
    x = t(normal(rng, 3, 1024)).to(dev, torch.bfloat16)
    eids = torch.tensor([3, 3, 5, 5, 5, 0], dtype=torch.int32, device=dev)
    toks = torch.tensor([[0], [1], [2], [0], [1], [2]], dtype=torch.int32, device=dev)
    y = md._expert_ffn_mma(x, eids, toks, wg, wu, wd, False)
    torch.cuda.synchronize()
    assert y.abs().amax(-1).min() > 0
    _close_bf16(y, _rows_plain(x, eids, toks, wg, wu, wd))
    w, idx = _confined_routing(rng, 3, [1, 4], dev)
    got = _launched("gather_expert_ffn", lambda: md.masked_expert_ffn(x, w, idx, wg, wu, wd, 8))
    _close_bf16(got, md.masked_expert_ffn(x.cpu(), w.cpu(), idx.cpu(), wg.cpu(), wu.cpu(),
                                          wd.cpu(), 8))


# (D, F): ragged k16-steps and column tiles with 16-byte rows; rows that
# are no multiple of 16 bytes (staged without cp.async); several pieces of
# F for down, the last ragged
NARROW_BF16 = {"ragged_tiles": (200, 648), "odd_widths": (99, 333), "three_f_pieces": (64, 4400)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(NARROW_BF16))
def test_bf16_mma_kernel_narrow_ragged_widths(case):
    dev = cuda_or_skip()
    d, f = NARROW_BF16[case]
    rng = np.random.default_rng(13)
    wg, wu, wd = _bf16_experts(rng, 8, d, f, dev)
    for n_tok in (1, 3, 8, 16):
        x = t(normal(rng, n_tok, d)).to(dev, torch.bfloat16)
        w, idx = _confined_routing(rng, n_tok, list(range(8)), dev)
        got = md.gather_expert_ffn_cuda(x, idx, wg, wu, wd)
        _close_bf16(got, md.gather_expert_ffn_plain(x, idx, wg, wu, wd))
        act, m = md._active_expert_plan(w, idx, 8)
        got = md.masked_expert_ffn_cuda(x, act, m, wg, wu, wd)
        _close_bf16(got, md.masked_expert_ffn_plain(x, act, m, wg, wu, wd))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tok", [1, 16])
def test_bf16_mma_kernel_is_deterministic(n_tok):
    """Down's pieces of F meet in a fixed order (no atomics): two launches
    give the same bits, for B3's pair rows and B4's plan."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(14)
    wg, wu, wd = _bf16_experts(rng, 8, 4096, 14336, dev)
    x = t(normal(rng, n_tok, 4096)).to(dev, torch.bfloat16)
    w, idx = _confined_routing(rng, n_tok, list(range(8)), dev)
    rows = md._pair_rows(x, idx) if n_tok == 1 else md._active_rows(
        x, md._active_expert_plan(w, idx, 8)[0])
    a, b = (md._expert_ffn_mma(x, *rows, wg, wu, wd, n_tok > 1) for _ in range(2))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


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


def _split_case(rng, lengths, page, max_pages, dtype, quant, dev):
    """Paged attention arguments at the served model's 32 / 8 heads: every
    slot's pages distinct, the table clamped to max_pages (a length past
    it is the speculative overshoot), unused entries the sentinel."""
    hkv, hq = 8, 32
    n_pool = sum(min(-(-n // page), max_pages) for n in lengths) + 3
    shape, sshape = (2, hkv, n_pool, page, 128), (2, hkv, n_pool, 1, page)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev) for _ in range(2))
        scales = tuple(torch.rand(sshape, device=dev) * 0.02 for _ in range(2))
    else:
        kp, vp = (t(normal(rng, *shape)).to(dev, dtype) for _ in range(2))
        scales = ()
    tables = np.full((len(lengths), max_pages), n_pool, np.int32)  # sentinel
    perm, used = rng.permutation(n_pool), 0
    for i, n in enumerate(lengths):
        k = min(-(-n // page), max_pages)
        tables[i, :k] = perm[used:used + k]
        used += k
    return (t(normal(rng, len(lengths), hq, 128)).to(dev, dtype), kp, vp, t(tables).to(dev),
            t(lengths, torch.int32).to(dev), 1, 128 ** -0.5, *scales)


# (lengths, page, max_pages): long slots over every split, a ragged last
# page inside the last split; lengths past the table width (max_pages *
# page) beside short and empty slots
SPLIT_CASES = {
    "long_page_64": ([4096, 1, 0, 2047], 64, 64),
    "long_page_128": ([4096, 1, 0, 2047], 128, 32),
    "past_table_page_64": ([600, 5, 0, 300], 64, 8),
    "past_table_page_16": ([40, 0, 33], 16, 2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8_bf16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_paged_split_kernel_matches_plain(case, kind):
    """B2 (bf16, f32 pages) and B9 (int8 pages, bf16 q) with the keys split
    over a cluster of blocks."""
    dev = cuda_or_skip()
    lengths, page, max_pages = SPLIT_CASES[case]
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    args = _split_case(np.random.default_rng(12), lengths, page, max_pages, dtype,
                       kind.startswith("int8"), dev)
    name = "paged_attention_q" if kind.startswith("int8") else "paged_attention"
    got = _launched(name, lambda: pa.paged_attention_cuda(*args))
    want = pa.paged_attention_plain(*args)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.count_nonzero(got[i]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_paged_split_kernel_is_deterministic(quant):
    """The splits meet in rank order (no atomics): two launches of B2 and
    of B9 give the same bits."""
    dev = cuda_or_skip()
    args = _split_case(np.random.default_rng(13), [4096, 37, 0, 2047], 64, 64,
                       torch.bfloat16, quant, dev)
    a, b = pa.paged_attention_cuda(*args), pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


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


# (R, K, N, tile_m, gids, large): K and N ragged against the blocks (float32
# 128 x 128, bf16 128 x 256) and their K tiles; group 1 is padding only
# (zero rows) where R has a second tile; "one_tile" has fewer rows than a
# tile (TMA zero-fills past R); "unaligned" rows take the element-by-element
# loads (bf16: rows whose stride is no multiple of 16 bytes cannot be TMA
# tensors, so the producer fills the ring with plain loads; with N 75 only,
# transpose_rhs keeps TMA for w [E, N, K])
GMM_CASES = {
    "small_ragged": (384, 200, 72, 128, [0, 1, 2], False),
    "small_unaligned": (384, 201, 75, 128, [0, 1, 2], False),
    "small_one_tile": (40, 64, 128, 128, [2], False),
    "large_ragged": (1536, 200, 136, 512, [0, 1, 2], True),
    "large_unaligned": (1536, 201, 75, 512, [0, 1, 2], True),
    "large_unaligned_n": (1536, 200, 75, 512, [0, 1, 2], True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_kernels_match_plain(case, dtype, transpose_rhs, monkeypatch):
    """B5b (gmm_small) and B5a (gmm; SMALL_R_MAX lowered so that it runs
    at a small R) against gmm_plain."""
    dev = cuda_or_skip()
    r, k, n, tile_m, gids, large = GMM_CASES[case]
    if large:
        monkeypatch.setattr(mg, "SMALL_R_MAX", 0)
    rng = np.random.default_rng(7)
    x = normal(rng, r, k)
    if r >= 2 * tile_m:
        x[tile_m:2 * tile_m] = 0.0
    w = normal(rng, 3, *((n, k) if transpose_rhs else (k, n)), scale=k ** -0.5)
    x, w = t(x).to(dev, dtype), t(w).to(dev, dtype)
    g = t(gids, torch.int32).to(dev)
    got = _launched("gmm" if large else "gmm_small",
                    lambda: mg.gmm_cuda(x, w, g, transpose_rhs, tile_m))
    want = mg.gmm_plain(x, w, g, transpose_rhs, tile_m)
    assert got.dtype == dtype and got.shape == (r, n)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])
    if r >= 2 * tile_m:
        assert not got[tile_m:2 * tile_m].any()


# B5a at the model's widths (D 4096, F 14336): (K, N, transpose_rhs) of
# the gate/up and down projections and of the gate/up dx (dy [R, F] times
# w_gate [E, D, F] transposed); R 1024 in two groups with SMALL_R_MAX
# lowered, so full 128 x 256 tiles and walks of 64-224 stages through the
# 4-stage ring run
GMM_WIDTH_CASES = {
    "gate_up": (4096, 14336, False),
    "down": (14336, 4096, False),
    "dx": (14336, 4096, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GMM_WIDTH_CASES))
def test_gmm_large_kernel_at_model_widths(case, monkeypatch):
    dev = cuda_or_skip()
    k, n, trans = GMM_WIDTH_CASES[case]
    monkeypatch.setattr(mg, "SMALL_R_MAX", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(1024, k, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(2, *((n, k) if trans else (k, n)), generator=gen, device=dev)
    w = (w * k ** -0.5).to(torch.bfloat16)
    g = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    got = _launched("gmm", lambda: mg.gmm_cuda(x, w, g, trans, 512))
    want = mg.gmm_plain(x, w, g, trans, 512)
    assert got.dtype == torch.bfloat16 and got.shape == (1024, n)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[torch.bfloat16],
          rtol=TOL[torch.bfloat16])


# B5b at the model's widths: an Engine prefill chunk of 256 tokens routed
# top-2 over 8 experts (R 1536, tile 128: 12 row tiles, 5 experts with one
# tile, 7 with padding), gate/up, down and the gate/up dx
GMM_SMALL_GIDS = [0, 0, 1, 2, 3, 3, 4, 5, 6, 7, 7, 7]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GMM_WIDTH_CASES))
def test_gmm_small_kernel_at_model_widths(case):
    dev = cuda_or_skip()
    k, n, trans = GMM_WIDTH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(1536, k, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(8, *((n, k) if trans else (k, n)), generator=gen, device=dev)
    w = (w * k ** -0.5).to(torch.bfloat16)
    g = torch.tensor(GMM_SMALL_GIDS, dtype=torch.int32, device=dev)
    got = _launched("gmm_small", lambda: mg.gmm_cuda(x, w, g, trans, 128))
    want = mg.gmm_plain(x, w, g, trans, 128)
    assert got.dtype == torch.bfloat16 and got.shape == (1536, n)
    close(got.float().cpu(), want.float().cpu(), atol=TOL[torch.bfloat16],
          rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
def test_gmm_small_kernel_is_deterministic():
    """Two launches of bf16 B5b (w N-major and, with transpose_rhs,
    K-major) give the same bits."""
    dev = cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(1536, 520, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.tensor(GMM_SMALL_GIDS, dtype=torch.int32, device=dev)
    for trans in (False, True):
        w = torch.randn(8, *((264, 520) if trans else (520, 264)), generator=gen,
                        device=dev).to(torch.bfloat16)
        first, second = (mg.gmm_cuda(x, w, g, trans, 128) for _ in range(2))
        torch.cuda.synchronize()
        assert kernels.launches["gmm_small"] > 0 and torch.equal(first, second)


@pytest.mark.gpu
def test_gmm_wgmma_kernels_are_deterministic(monkeypatch):
    """One write per output and no atomics: two launches of bf16 B5a (w
    N-major and, with transpose_rhs, K-major) and of bf16 B12 give the same
    bits."""
    dev = cuda_or_skip()
    monkeypatch.setattr(mg, "SMALL_R_MAX", 0)
    gen = torch.Generator(device=dev).manual_seed(13)

    def bf(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    x, b = bf(1536, 520), bf(1536, 264)
    g = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    for trans, w in ((False, bf(3, 520, 264)), (True, bf(3, 264, 520))):
        first, second = (mg.gmm_cuda(x, w, g, trans, 512) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first, second)
    first, second = (mg.gmm_wgrad_cuda(x, b, g, 3, 512) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_gmm_moe_ffn_launches_on_cuda_tensors():
    """moe_ffn in gmm mode runs its three matmuls through B5b on the card
    and matches the same call on the CPU."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(8)
    p = {"router": normal(rng, 64, 4), "w_gate": normal(rng, 4, 64, 128, scale=0.125),
         "w_up": normal(rng, 4, 64, 128, scale=0.125),
         "w_down": normal(rng, 4, 128, 64, scale=128 ** -0.5)}
    x = normal(rng, 37, 64)
    before = kernels.launches["gmm_small"]
    got, _ = moe.moe_ffn({k: t(v).to(dev) for k, v in p.items()}, t(x).to(dev), 2, "gmm")
    torch.cuda.synchronize()
    assert kernels.launches["gmm_small"] == before + 3
    want, _ = moe.moe_ffn({k: t(v) for k, v in p.items()}, t(x), 2, "gmm")
    close(got.cpu(), want, atol=TOL[torch.float32], rtol=TOL[torch.float32])


# the backward's cases: the forward's, plus ragged edges at the bf16
# kernels' tiles (64/32 q rows, 32/64 keys) with GQA rep 4, and a batch row
# with kv_len 0 beside a negative q_offset
BWD_CASES = {
    **FLASH_CASES,
    "ragged_200_over_333_gqa4": (1, 200, 333, 16, 4, [333], [133], True),
    "kv_len_0_row": (3, 70, 96, 8, 2, [96, 0, 50], [26, 0, -9], True),
}


def _flash_grad_args(case, dtype, dev, seed=9):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, do = (t(normal(rng, b, s, h, 128)).to(dev, dtype)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv), (sq, hq)))
    lens, offs = t(kv_len, torch.int32).to(dev), t(q_off, torch.int32).to(dev)
    return q, k, v, do, lens, offs, causal


def _flash_bwd_args(case, dtype, dev):
    q, k, v, do, lens, offs, causal = _flash_grad_args(case, dtype, dev)
    scale = 128 ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, lens, offs, causal, scale)
    return q, k, v, do, lse, fa.flash_delta(do, o), lens, offs, causal, scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernels_match_plain(case, dtype):
    """B10 (dq) and B11 (dk, dv) against the plain backward on the same
    lse and delta; GQA, kv_len padding (0 included), per-row offsets,
    ragged tiles and rows without keys (zero gradient)."""
    args = _flash_bwd_args(case, dtype, cuda_or_skip())
    dq = _launched("flash_bwd_dq", lambda: fa.flash_bwd_dq_cuda(*args))
    dk, dv = _launched("flash_bwd_dkv", lambda: fa.flash_bwd_dkv_cuda(*args))
    want = (fa.flash_bwd_dq_plain(*args),) + fa.flash_bwd_dkv_plain(*args)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        close(got.float().cpu(), ref.float().cpu(), atol=TOL[dtype], rtol=TOL[dtype])
    lens = args[6].cpu()
    for i in torch.nonzero(lens == 0).flatten().tolist():  # a row without keys
        assert not dq[i].any() and not dk[i].any() and not dv[i].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["serving_chunk_256_over_512", "kv_len_0_row"])
def test_flash_bwd_kernels_are_deterministic(case, dtype):
    """One write per output and no atomics: two launches of B10 and of B11
    give the same bits."""
    args = _flash_bwd_args(case, dtype, cuda_or_skip())
    for fn in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_autograd_runs_the_kernels():
    """flash_mha's backward on CUDA tensors launches B10 and B11 and gives
    the CPU Function's gradients."""
    dev = cuda_or_skip()
    q, k, v, do, lens, offs, _ = _flash_grad_args("causal_gqa_per_row_offset", torch.float32,
                                                  "cpu")
    grads = []
    for d in (dev, torch.device("cpu")):
        leaves = [x.to(d).requires_grad_() for x in (q, k, v)]
        before = dict(kernels.launches)
        o = fa.flash_mha(*leaves, kv_len=lens.to(d), q_offset=offs.to(d), causal=True)
        (o * do.to(d)).sum().backward()
        on_card = d.type == "cuda"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert kernels.launches[name] == before[name] + on_card
        grads.append([x.grad.cpu() for x in leaves])
    for got, want in zip(*grads):
        close(got, want, atol=TOL[torch.float32], rtol=TOL[torch.float32])


# (R, K, N, E, tile_m, gids): expert 1 owns no row tile in "empty_expert";
# "unaligned" rows (K, N no multiple of 8) cannot be TMA tensors, so bf16
# B12's producer fills its ring with plain loads; with tile_m 32, experts'
# runs start and end inside the 64-row stages (96, 128 and 96 rows)
WGRAD_CASES = {
    "tile_128": (512, 200, 136, 3, 128, [0, 0, 1, 2]),
    "tile_512": (1536, 136, 200, 3, 512, [0, 1, 2]),
    "empty_expert": (384, 128, 64, 3, 128, [0, 2, 2]),
    "one_tile": (40, 64, 72, 2, 128, [1]),
    "unaligned": (1536, 201, 75, 3, 512, [0, 1, 2]),
    "tile_32": (320, 136, 200, 3, 32, [0, 0, 0, 1, 1, 1, 1, 2, 2, 2]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_gmm_wgrad_kernel_matches_plain(case, dtype):
    """B12: per-expert a^T b, exactly 0 for an expert without rows."""
    dev = cuda_or_skip()
    r, k, n, e, tile_m, gids = WGRAD_CASES[case]
    rng = np.random.default_rng(10)
    a, b = t(normal(rng, r, k)).to(dev, dtype), t(normal(rng, r, n)).to(dev, dtype)
    g = t(gids, torch.int32).to(dev)
    got = _launched("gmm_wgrad", lambda: mg.gmm_wgrad_cuda(a, b, g, e, tile_m))
    want = mg.gmm_wgrad_plain(a, b, g, e, tile_m)
    assert got.dtype == dtype and got.shape == (e, k, n)
    tol = TOL[dtype] * (1 if dtype == torch.bfloat16 else 10)  # sums of up to 1024 rows
    close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=TOL[dtype])
    for x in set(range(e)) - set(gids):
        assert not got[x].any()


@pytest.mark.gpu
def test_gmm_wgrad_bf16_written_by_the_kernel():
    """bf16 B12 writes dw in a's dtype itself: the call allocates its bf16
    output and no float32 [E, K, N] temporary."""
    dev = cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(14)
    a, b = (torch.randn(1024, n, generator=gen, device=dev).to(torch.bfloat16)
            for n in (1024, 2048))
    g = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dw = _launched("gmm_wgrad", lambda: mg.gmm_wgrad_cuda(a, b, g, 2, 512))
    assert dw.dtype == torch.bfloat16 and dw.shape == (2, 1024, 2048)
    assert torch.cuda.max_memory_allocated() - base <= dw.numel() * dw.element_size() + (1 << 20)


@pytest.mark.gpu
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_autograd_runs_the_kernels(transpose_rhs):
    """gmm's backward on CUDA tensors: dx through B5b with transpose_rhs
    flipped, dw through B12; equal to the CPU Function's gradients."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(11)
    x = normal(rng, 384, 64)
    w = normal(rng, 3, 64, 96, scale=0.125)
    if transpose_rhs:
        w = np.ascontiguousarray(w.transpose(0, 2, 1))
    dy = normal(rng, 384, 96)
    gids = t([0, 1, 1], torch.int32)
    grads = []
    for d in (dev, torch.device("cpu")):
        xs, ws = t(x).to(d).requires_grad_(), t(w).to(d).requires_grad_()
        before = dict(kernels.launches)
        (mg.gmm(xs, ws, gids.to(d), transpose_rhs, 128) * t(dy).to(d)).sum().backward()
        on_card = d.type == "cuda"
        assert kernels.launches["gmm_small"] == before["gmm_small"] + 2 * on_card
        assert kernels.launches["gmm_wgrad"] == before["gmm_wgrad"] + on_card
        grads.append((xs.grad.cpu(), ws.grad.cpu()))
    for got, want in zip(*grads):
        close(got, want, atol=1e-3, rtol=1e-4)
    assert not grads[0][1][2].any()  # expert 2 owns no tile
