"""PyTorch port: the training half of the MoE. gmm's gradients (the
autograd Function: dx through gmm with transpose_rhs flipped, dw through
gmm_wgrad) against the JAX custom VJP running its Pallas kernels in
interpret mode, both schedules (the k-blocked one forced by a fixture that
lowers the JAX module's SMALL_R_MAX and tiles); and moe_ffn's ``chunk``
(checkpointed token chunks, chunk-local aux) against the JAX package.

Tolerance: float32, 1e-5 for gmm (the JAX gmm test's), 1e-4 for moe_ffn's
gradients (longer chains of sums)."""

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

GMM_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def big_schedule(monkeypatch):
    """The JAX module takes its k-blocked schedule at any R, in tiles of
    K 32 and N 64."""
    monkeypatch.setattr(j_gmm, "SMALL_R_MAX", 0)
    monkeypatch.setattr(j_gmm, "TILE_K", 32)
    monkeypatch.setattr(j_gmm, "TILE_N", 64)


# (schedule, tile_m, R, gids): group 1's rows are zero (an expert whose
# tile is padding only: its dw must be exactly 0)
CASES = {
    "small": ("small", 128, 384, [0, 1, 2]),
    "big": ("big", 256, 768, [0, 1, 2]),
    "small_one_tile": ("small", 128, 40, [2]),
}


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_grads_match_jax_kernels(case, transpose_rhs, request):
    schedule, tile_m, r, gids = CASES[case]
    if schedule == "big":
        request.getfixturevalue("big_schedule")
    rng = np.random.default_rng(1)
    e, k_dim, n_dim = 3, 128, 128
    x = normal(rng, r, k_dim)
    if r >= 2 * tile_m:
        x[tile_m:2 * tile_m] = 0.0
    w = normal(rng, e, *((n_dim, k_dim) if transpose_rhs else (k_dim, n_dim)), scale=0.1)
    dy = normal(rng, r, n_dim)
    g = np.asarray(gids, np.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, w: j_gmm.gmm(x, w, jnp.asarray(g), transpose_rhs, tile_m),
                         jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(dy))
    xs, ws = t(x).requires_grad_(), t(w).requires_grad_()
    (moe_gmm.gmm(xs, ws, t(g), transpose_rhs, tile_m) * t(dy)).sum().backward()
    close(xs.grad, jdx, **GMM_TOL)
    # an expert with no row tile is an output block the JAX kernel never
    # visits (undefined there; sorted_layout never makes one): compare the
    # visited experts, and hold the port's others to exact zeros
    owned = sorted(set(gids))
    close(ws.grad[owned], np.asarray(jdw)[owned], **GMM_TOL)
    assert not ws.grad[[x for x in range(e) if x not in owned]].any()
    if r >= 2 * tile_m:
        assert not ws.grad[1].any()


def test_gmm_wgrad_plain_zero_for_expert_without_rows():
    rng = np.random.default_rng(2)
    a, b = t(normal(rng, 256, 8)), t(normal(rng, 256, 4))
    dw = moe_gmm.gmm_wgrad(a, b, t([0, 2], torch.int32), 3, 128)
    assert dw.shape == (3, 8, 4) and not dw[1].any()
    close(dw[0], a[:128].T @ b[:128], atol=1e-5, rtol=1e-5)


def _params(seed, e=4, d=32, f=64):
    return jax.device_get(j_moe.init_moe_params(jax.random.PRNGKey(seed), e, d, f))


@pytest.mark.parametrize("chunk", [8, 0])
@pytest.mark.parametrize("mode", ["dense", "gmm"])
def test_moe_ffn_chunk_matches_jax(mode, chunk):
    """Output, chunk-local aux and the gradients of sum(out * g) + aux
    against the JAX package; chunk 0 is the unchunked reference."""
    params = _params(0)
    rng = np.random.default_rng(3)
    x, g = normal(rng, 24, 32), normal(rng, 24, 32)
    mask = np.ones(24, np.float32)
    mask[19:] = 0

    def j_loss(p, x):
        out, aux = j_moe.moe_ffn(p, x, 2, mode, token_mask=jnp.asarray(mask), chunk=chunk)
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tp = {k: t(v).requires_grad_() for k, v in params.items()}
    tx = t(x).requires_grad_()
    out, aux = moe.moe_ffn(tp, tx, 2, mode, token_mask=t(mask), chunk=chunk)
    ((out * t(g)).sum() + aux).backward()
    close(out.detach(), jout, atol=1e-5, rtol=1e-5)
    close(aux.detach(), jaux, atol=1e-6, rtol=0)
    close(tx.grad, jgx)
    for k in params:
        close(tp[k].grad, jgp[k])


def test_moe_ffn_chunk_ignored_where_jax_ignores_it():
    """T <= chunk, a chunk that does not divide T, and gather modes run
    unchunked: the same output and aux as chunk 0."""
    params = {k: t(v) for k, v in _params(1).items()}
    x = t(normal(np.random.default_rng(4), 12, 32))
    for mode, chunk in (("dense", 12), ("dense", 5), ("gather", 4)):
        got = moe.moe_ffn(params, x, 2, mode, chunk=chunk)
        want = moe.moe_ffn(params, x, 2, mode)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    chunked = moe.moe_ffn(params, x, 2, "dense", chunk=4)
    assert not torch.equal(chunked[1], moe.moe_ffn(params, x, 2, "dense")[1])
