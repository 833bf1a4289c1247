"""PyTorch port: the grouped-matmul prefill MoE (ops/moe_gmm.py) and the
capacity-dropping modes of ops/moe.py against the JAX package.

The gmm cases run the JAX kernels themselves in Pallas interpret mode, both
schedules: the k-blocked one (B5a) is forced by a fixture that lowers the
JAX module's SMALL_R_MAX and its K/N tiles, so that several k steps run;
moe_ffn runs as the JAX suite runs it on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import moe as j_moe
from vita_tpu.ops import moe_gmm as j_gmm
from vita_tpu_torch.ops import moe, moe_gmm

GMM_TOL = dict(atol=1e-5, rtol=1e-5)  # the JAX gmm test's tolerance


def _routing(rng, t_, k, e, unused=()):
    """[T, k] distinct experts per token, never any of ``unused``."""
    pool = [x for x in range(e) if x not in unused]
    return np.stack([rng.choice(pool, k, replace=False) for _ in range(t_)]).astype(np.int32)


# (T, k, E, tile_m, experts left without tokens)
LAYOUTS = {
    "small": (37, 2, 4, 128, ()),
    "empty_experts": (5, 2, 8, 128, (2, 3, 5, 6, 7)),
    "tk_16384": (8192, 2, 8, 128, ()),
    "tk_16400_tile_512": (8200, 2, 8, 512, (4,)),
    "tile_512_small": (40, 2, 4, 512, (1,)),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_sorted_layout_matches_jax_exactly(case):
    t_, k, e, tile_m, unused = LAYOUTS[case]
    idx = _routing(np.random.default_rng(0), t_, k, e, unused)
    got = moe_gmm.sorted_layout(t(idx), e, tile_m)
    want = j_gmm.sorted_layout(jnp.asarray(idx), e, tile_m)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture
def big_schedule(monkeypatch):
    """The JAX module takes its k-blocked schedule at any R, in tiles of
    K 32 and N 64."""
    monkeypatch.setattr(j_gmm, "SMALL_R_MAX", 0)
    monkeypatch.setattr(j_gmm, "TILE_K", 32)
    monkeypatch.setattr(j_gmm, "TILE_N", 64)


# (schedule, tile_m, R, gids): every expert has a tile; group 1 is
# padding only (zero rows) in the first two
GMM_CASES = {
    "small": ("small", 128, 384, [0, 1, 2]),
    "big": ("big", 256, 768, [0, 1, 2]),
    "small_one_tile": ("small", 128, 40, [2]),
}


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_plain_matches_jax_kernels(case, transpose_rhs, request):
    schedule, tile_m, r, gids = GMM_CASES[case]
    if schedule == "big":
        request.getfixturevalue("big_schedule")
    rng = np.random.default_rng(1)
    e, k_dim, n_dim = 3, 128, 128
    x = normal(rng, r, k_dim)
    if r >= 2 * tile_m:
        x[tile_m:2 * tile_m] = 0.0
    w = normal(rng, e, *((n_dim, k_dim) if transpose_rhs else (k_dim, n_dim)), scale=0.1)
    gids = np.asarray(gids, np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = j_gmm.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gids), transpose_rhs,
                         tile_m)
    got = moe_gmm.gmm(t(x), t(w), t(gids), transpose_rhs, tile_m)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, **GMM_TOL)
    if r >= 2 * tile_m:
        assert not got[tile_m:2 * tile_m].any()


def test_gmm_shape_checks():
    x, w, g = torch.zeros(256, 8), torch.zeros(2, 8, 4), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="contraction"):
        moe_gmm.gmm(x, torch.zeros(2, 6, 4), g, tile_m=128)
    with pytest.raises(ValueError, match="divisible"):
        moe_gmm.gmm(torch.zeros(200, 8), w, g, tile_m=128)
    with pytest.raises(ValueError, match="group ids"):
        moe_gmm.gmm(x, w, g[:1], tile_m=128)
    assert moe_gmm.gmm(x, w, g, tile_m=128).shape == (256, 4)


def _params(seed, e=4, d=32, f=64):
    return jax.device_get(j_moe.init_moe_params(jax.random.PRNGKey(seed), e, d, f))


@pytest.mark.parametrize("mode,capacity_factor", [
    ("gmm", 1.25), ("sort", 1.25), ("sort", 0.5), ("capacity", 1.25), ("capacity", 0.5),
    ("dense", 1.25),
])
def test_moe_ffn_modes_match_jax(mode, capacity_factor):
    """Capacity factor 0.5 drops pairs: the same ones on both sides."""
    params = _params(0)
    rng = np.random.default_rng(2)
    x = normal(rng, 23, 32)
    mask = np.ones(23, np.float32)
    mask[19:] = 0
    out, aux = moe.moe_ffn({k: t(v) for k, v in params.items()}, t(x), 2, mode,
                           capacity_factor, token_mask=t(mask))
    jout, jaux = j_moe.moe_ffn(params, jnp.asarray(x), 2, mode, capacity_factor,
                               token_mask=jnp.asarray(mask))
    close(out, jout, **GMM_TOL)
    close(aux, jaux, atol=1e-6, rtol=0)
    if mode in ("sort", "capacity") and capacity_factor < 1:
        dense, _ = j_moe.moe_ffn(params, jnp.asarray(x), 2, "dense")
        assert np.abs(np.asarray(jout) - np.asarray(dense)).max() > 1e-3  # pairs dropped


def test_moe_ffn_gmm_large_tiles(monkeypatch):
    """T*k above SMALL_R_MAX (lowered on both sides) takes TILE_M rows per
    tile, R = ceil(T*k / 512) * 512 + E * 512."""
    monkeypatch.setattr(moe_gmm, "SMALL_R_MAX", 32)
    monkeypatch.setattr(j_gmm, "SMALL_R_MAX", 32)
    params = _params(1)
    x = normal(np.random.default_rng(3), 37, 32)
    sizes = []
    real = moe_gmm.gmm_plain

    def spy(x, w, gids, transpose_rhs=False, tile_m=moe_gmm.TILE_M):
        sizes.append((x.shape[0], tile_m))
        return real(x, w, gids, transpose_rhs, tile_m)

    monkeypatch.setattr(moe_gmm, "gmm_plain", spy)
    out, _ = moe.moe_ffn({k: t(v) for k, v in params.items()}, t(x), 2, "gmm")
    jout, _ = j_moe.moe_ffn(params, jnp.asarray(x), 2, "gmm")
    close(out, jout, **GMM_TOL)
    assert sizes == [(512 + 4 * 512, 512)] * 3


def test_moe_ffn_unknown_mode_raises():
    p = {"router": torch.zeros(4, 2), "w_gate": torch.zeros(2, 4, 4)}
    with pytest.raises(ValueError, match="unknown moe mode"):
        moe.moe_ffn(p, torch.zeros(4, 4), 2, "nope")
    assert moe.np_ceil(2.01) == j_moe.np_ceil(2.01) == 3 and moe.np_ceil(2.0) == 2
