"""PyTorch port: paged decode attention (plain version on the CPU) against
the JAX Pallas kernel in interpret mode, and the page writes' drop
semantics against JAX's scatters. The CUDA kernel against the plain
version is in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import paged_attention as j_pa
from vita_tpu_torch.ops import paged_attention as pa

L, HKV, HQ, D, PAGE, POOL, MAXP = 2, 2, 4, 128, 8, 10, 4


def _pool_and_tables(rng, lengths, d=D):
    kp, vp = normal(rng, L, HKV, POOL, PAGE, d), normal(rng, L, HKV, POOL, PAGE, d)
    tables = np.full((len(lengths), MAXP), POOL, np.int32)  # OOB sentinel
    perm = rng.permutation(POOL)
    used = 0
    for i, n in enumerate(lengths):
        k = min(-(-n // PAGE), MAXP)
        tables[i, :k] = perm[used:used + k]
        used += k
    return kp, vp, tables


@pytest.mark.parametrize("lengths", [[5, 1], [8, 13], [17, 0], [32, 3], [40, 0]])
def test_paged_plain_matches_jax_kernel(lengths):
    """[40, 0]: a length past the table's MAXP * PAGE = 32 rows (a
    speculative overshoot; both clamp the pages to the table) beside an
    empty slot."""
    rng = np.random.default_rng(0)
    kp, vp, tables = _pool_and_tables(rng, lengths)
    q = normal(rng, len(lengths), HQ, D)
    for layer in range(L):
        got = pa.paged_attention(t(q), t(kp), t(vp), t(tables), t(lengths, torch.int32), layer)
        with pltpu.force_tpu_interpret_mode():
            want = j_pa.paged_attention(
                jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
                jnp.asarray(lengths, jnp.int32), jnp.int32(layer))
        close(got, want)
        for i, n in enumerate(lengths):
            if n == 0:
                assert torch.count_nonzero(got[i]) == 0


def test_write_kv_rows_drops_like_jax():
    """Slot 0 writes normally, 1 is inactive, 2 lands on an unallocated
    (sentinel) page, 3 overshoots past its table, 4 writes the same row as
    inactive slot 1."""
    rng = np.random.default_rng(1)
    kp, vp, _ = _pool_and_tables(rng, [])
    tables = np.array([[3, 4, POOL, POOL], [3, 4, POOL, POOL], [5, POOL, POOL, POOL],
                       [6, 7, 8, 9], [3, 4, POOL, POOL]], np.int32)
    pos = np.array([9, 9, 12, 4 * PAGE + 2, 9], np.int32)
    active = np.array([True, False, True, True, False])
    kn, vn = normal(rng, 5, HKV, D), normal(rng, 5, HKV, D)
    gk, gv = pa.write_kv_rows(t(kp), t(vp), 1, t(tables), t(pos), t(kn), t(vn), t(active))
    wk, wv = j_pa.write_kv_rows(jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1),
                                jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(kn),
                                jnp.asarray(vn), jnp.asarray(active))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    changed = np.argwhere((gk.numpy() != kp).any(-1))
    assert changed.tolist() == [[1, h, 4, 1] for h in range(HKV)]  # only slot 0's row


def test_write_kv_rows_in_place_and_default_active():
    rng = np.random.default_rng(2)
    kp, vp, tables = _pool_and_tables(rng, [20, 3])
    k, v = t(kp), t(vp)
    pos = np.array([19, 2], np.int32)
    kn, vn = normal(rng, 2, HKV, D), normal(rng, 2, HKV, D)
    gk, _ = pa.write_kv_rows(k, v, 0, t(tables), t(pos), t(kn), t(vn))
    assert gk is k
    wk, _ = j_pa.write_kv_rows(jnp.asarray(kp), jnp.asarray(vp), jnp.int32(0),
                               jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(kn),
                               jnp.asarray(vn))
    np.testing.assert_array_equal(k.numpy(), np.asarray(wk))


def test_install_prefill_pages_drops_padded_ids():
    rng = np.random.default_rng(3)
    kp, vp, _ = _pool_and_tables(rng, [])
    s = 3 * PAGE
    k_lin, v_lin = normal(rng, L, 1, s, HKV, D), normal(rng, L, 1, s, HKV, D)
    ids = np.array([6, 2, POOL], np.int32)  # last page padded out of range
    gk, gv = pa.install_prefill_pages(t(kp), t(vp), t(k_lin), t(v_lin), t(ids))
    wk, wv = j_pa.install_prefill_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_lin),
                                        jnp.asarray(v_lin), jnp.asarray(ids))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_page_pool_allocator_and_init():
    p = pa.PagePool(6)
    a = p.alloc(4)
    assert len(a) == 4 and p.free_count == 2 and p.alloc(3) is None and p.free_count == 2
    p.release(a)
    assert p.free_count == 6
    assert [pa.pages_needed(n, 8) for n in (1, 8, 9)] == [1, 1, 2]
    pool = pa.init_page_pool(2, 3, 5, 8, 16, dtype=torch.bfloat16)
    want = j_pa.init_page_pool(2, 3, 5, 8, 16, dtype=jnp.bfloat16)
    for name in ("k_pages", "v_pages"):
        assert tuple(pool[name].shape) == want[name].shape
        assert pool[name].dtype == torch.bfloat16 and not pool[name].any()
