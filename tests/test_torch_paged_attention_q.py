"""PyTorch port: the int8 page pool. Page writes and prefill installs are
held bit for bit to JAX's (jitted, as the JAX engine runs them) on pages
and scales, dropped writes included; int8 paged attention (plain version
on the CPU) to the JAX Pallas kernel in interpret mode at head dim 128 and
page 128 (the TPU kernel's alignment rule), and at page 64 to JAX's int8
twin, both at float32 tolerance 1e-4. The CUDA kernel against the plain
version is in test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import paged_attention as j_pa
from vita_tpu_torch.ops import paged_attention as pa

L, HKV, HQ, D, POOL = 2, 2, 8, 128, 10


def _int8_pool(rng, page, d=D):
    shape, sshape = (L, HKV, POOL, page, d), (L, HKV, POOL, 1, page)
    kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random(sshape) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
    return kp, vp, ks, vs


def _tables(rng, lengths, page, max_pages):
    tables = np.full((len(lengths), max_pages), POOL, np.int32)  # OOB sentinel
    perm = rng.permutation(POOL)
    used = 0
    for i, n in enumerate(lengths):
        k = min(-(-n // page), max_pages)
        tables[i, :k] = perm[used:used + k]
        used += k
    return tables


def _attend(q, pool, tables, lengths, layer, interpret):
    kp, vp, ks, vs = pool
    got = pa.paged_attention(t(q), t(kp), t(vp), t(tables), t(lengths, torch.int32), layer,
                             k_scale=t(ks), v_scale=t(vs))
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
            jnp.asarray(lengths, jnp.int32), jnp.int32(layer))
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            want = j_pa.paged_attention(*args, **kw)
    else:
        want = j_pa.paged_attention(*args, **kw)
    return got, want


@pytest.mark.parametrize("lengths", [[130, 0, 384, 5], [1, 256], [400, 0]])
def test_paged_q_plain_matches_jax_kernel(lengths):
    """Page 128: JAX runs _paged_attn_kernel_q in interpret mode; a length
    of 384 fills the 3-page table, 400 runs past it (both clamp the pages
    to the table), 0 gives zeros."""
    rng = np.random.default_rng(0)
    pool = _int8_pool(rng, 128)
    tables = _tables(rng, lengths, 128, 3)
    q = normal(rng, len(lengths), HQ, D)
    for layer in range(L):
        got, want = _attend(q, pool, tables, lengths, layer, interpret=True)
        close(got, want)
        for i, n in enumerate(lengths):
            if n == 0:
                assert torch.count_nonzero(got[i]) == 0


@pytest.mark.parametrize("lengths", [[70, 3, 0], [256, 64, 65]])
def test_paged_q_plain_page_64_matches_jax_twin(lengths):
    rng = np.random.default_rng(1)
    pool = _int8_pool(rng, 64)
    tables = _tables(rng, lengths, 64, 4)
    q = normal(rng, len(lengths), HQ, D)
    got, want = _attend(q, pool, tables, lengths, 1, interpret=False)
    close(got, want)


def test_paged_q_keeps_q_dtype():
    rng = np.random.default_rng(2)
    kp, vp, ks, vs = _int8_pool(rng, 64)
    q = t(normal(rng, 1, HQ, D)).to(torch.bfloat16)
    out = pa.paged_attention(q, t(kp), t(vp), torch.zeros(1, 2, dtype=torch.int32),
                             torch.tensor([9], dtype=torch.int32), 0,
                             k_scale=t(ks), v_scale=t(vs))
    assert out.dtype == torch.bfloat16 and out.shape == (1, HQ, D)
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention(q, t(kp), t(vp), torch.zeros(1, 2, dtype=torch.int32),
                           torch.tensor([9], dtype=torch.int32), 0, k_scale=t(ks))


def test_write_kv_rows_q_bit_identical_to_jax():
    """Slot 0 writes normally, 1 is inactive, 2 lands on an unallocated
    (sentinel) page, 3 overshoots past its table, 4 writes the same row as
    inactive slot 1: only slot 0's row and scale change."""
    rng = np.random.default_rng(3)
    page = 8
    kp, vp, ks, vs = _int8_pool(rng, page, d=16)
    tables = np.array([[3, 4, POOL, POOL], [3, 4, POOL, POOL], [5, POOL, POOL, POOL],
                       [6, 7, 8, 9], [3, 4, POOL, POOL]], np.int32)
    pos = np.array([9, 9, 12, 4 * page + 2, 9], np.int32)
    active = np.array([True, False, True, True, False])
    kn, vn = normal(rng, 5, HKV, 16), normal(rng, 5, HKV, 16)
    tk, tv, tks, tvs = map(t, (kp, vp, ks, vs))
    got = pa.write_kv_rows(tk, tv, 1, t(tables), t(pos), t(kn), t(vn), t(active),
                           k_scale=tks, v_scale=tvs)
    assert got[0] is tk and got[2] is tks  # in place
    want = jax.jit(j_pa.write_kv_rows)(
        jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(active),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    changed = np.argwhere(tks.numpy() != ks)
    assert changed.tolist() == [[1, h, 4, 0, 1] for h in range(HKV)]


def test_quantize_rows_bit_identical_to_jax():
    rng = np.random.default_rng(4)
    x = normal(rng, 6, HKV, 32) * 3
    x[1, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    q, s = pa._quantize_rows(t(x))
    jq, js = jax.jit(j_pa._quantize_rows)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_install_prefill_pages_q_bit_identical_to_jax():
    rng = np.random.default_rng(5)
    page = 8
    kp, vp, ks, vs = _int8_pool(rng, page, d=16)
    s = 3 * page
    k_lin, v_lin = normal(rng, L, 1, s, HKV, 16), normal(rng, L, 1, s, HKV, 16)
    ids = np.array([6, 2, POOL], np.int32)  # last page padded out of range
    got = pa.install_prefill_pages(*map(t, (kp, vp, k_lin, v_lin, ids)),
                                   k_scale=t(ks), v_scale=t(vs))
    want = jax.jit(j_pa.install_prefill_pages)(
        *map(jnp.asarray, (kp, vp, k_lin, v_lin, ids)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_page_pool_quantized():
    pool = pa.init_page_pool(2, 3, 5, 8, 16, dtype=torch.bfloat16, quantized=True)
    want = j_pa.init_page_pool(2, 3, 5, 8, 16, dtype=jnp.bfloat16, quantized=True)
    assert set(pool) == set(want)
    for name, w in want.items():
        assert tuple(pool[name].shape) == w.shape
        assert str(pool[name].dtype).split(".")[-1] == str(w.dtype)
        assert not pool[name].any()
