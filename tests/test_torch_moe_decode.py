"""PyTorch port: selected-expert decode FFN (plain versions on the CPU)
against the JAX Pallas gather/masked kernels in interpret mode, over flat
layer*E+e ids into stacked weights. The CUDA kernels against the plain
versions are in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import moe_decode as j_md
from vita_tpu_torch.ops import moe_decode as md

E, LAYERS, D, F = 4, 2, 64, 256


def _weights(rng):
    return (normal(rng, LAYERS * E, D, F, scale=D ** -0.5),
            normal(rng, LAYERS * E, D, F, scale=D ** -0.5),
            normal(rng, LAYERS * E, F, D, scale=F ** -0.5))


def _routing(rng, n_tok, layer=1):
    idx = np.stack([rng.choice(E, 2, replace=False) for _ in range(n_tok)]) + layer * E
    w = rng.random((n_tok, 2)).astype(np.float32)
    return w / w.sum(1, keepdims=True), idx.astype(np.int32)


@pytest.mark.parametrize("n_tok", [1, 3])
def test_gather_expert_ffn_matches_jax_kernel(n_tok):
    rng = np.random.default_rng(0)
    ws = _weights(rng)
    x = normal(rng, n_tok, D)
    _, idx = _routing(rng, n_tok)
    got = md.gather_expert_ffn(t(x), t(idx), *map(t, ws))
    assert got.shape == (n_tok, 2, D)
    with pltpu.force_tpu_interpret_mode():
        want = j_md.gather_expert_ffn(jnp.asarray(x), jnp.asarray(idx),
                                      *map(jnp.asarray, ws), block_f=128)
    close(got, want)


@pytest.mark.parametrize("n_tok", [1, 2, 4, 16])
def test_masked_expert_ffn_matches_jax_kernel(n_tok):
    rng = np.random.default_rng(1)
    ws = _weights(rng)
    x = normal(rng, n_tok, D)
    w, idx = _routing(rng, n_tok)
    got = md.masked_expert_ffn(t(x), t(w), t(idx), *map(t, ws), n_experts=E)
    with pltpu.force_tpu_interpret_mode():
        want = j_md.masked_expert_ffn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                      *map(jnp.asarray, ws), n_experts=E)
    close(got, want)


def test_active_expert_plan_matches_jax():
    rng = np.random.default_rng(2)
    for n_tok in (1, 3, 4, 16):
        w, idx = _routing(rng, n_tok)
        act, m = md._active_expert_plan(t(w), t(idx), E)
        jact, jm = j_md._active_expert_plan(jnp.asarray(w), jnp.asarray(idx), E)
        assert act.dtype == torch.int32
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
        close(m, jm)


def test_sorted_pair_gather_inverts_its_permutation():
    rng = np.random.default_rng(3)
    ws = [t(a) for a in _weights(rng)]
    x = t(normal(rng, 3, D))
    _, idx = _routing(rng, 3)
    run = lambda xr, ir: md.gather_expert_ffn(xr, ir, *ws)
    close(md._sorted_pair_gather(x, t(idx), run), run(x, t(idx)), atol=1e-6, rtol=1e-6)
