"""PyTorch port: the optional Whale components (models/whale_extras.py)
against the JAX package in float32 (tolerance 1e-4, the SSM 1e-5: the
port's sequential loop against JAX's associative scan), on the same
weights and inputs, plus init structure and the odd-kernel error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from torch_port_util import close, normal, t
from vita_tpu.models import whale_extras as j_ex
from vita_tpu_torch.models import whale_extras as ex


def _port(jp):
    return jax.tree.map(lambda a: t(np.asarray(a)), jp)


def _with_bn(jp, rng):
    """Folded BatchNorm scale/shift drawn away from 1/0, so that they count."""
    return {k: (jnp.asarray(1 + 0.2 * normal(rng, *v.shape)) if "scale" in k else
                jnp.asarray(0.1 * normal(rng, *v.shape)) if "shift" in k else v)
            for k, v in jp.items()}


@pytest.mark.parametrize("left,right,ld,rd,hidden", [(1, 1, 1, 1, False), (2, 1, 1, 1, True),
                                                     (3, 2, 2, 3, False), (1, 0, 1, 1, True)])
def test_fsmn_matches_jax(left, right, ld, rd, hidden):
    rng = np.random.default_rng(left + 10 * right)
    jp = j_ex.init_fsmn(jax.random.PRNGKey(0), 16, 24, 32, left=left, right=right)
    x = normal(rng, 2, 11, 16)
    h = normal(rng, 2, 11, 32) if hidden else None
    got = ex.fsmn_layer(_port(jp), t(x), None if h is None else t(h), ld, rd)
    want = j_ex.fsmn_layer(jp, jnp.asarray(x), None if h is None else jnp.asarray(h), ld, rd)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("stride,causal,dilation,din,dout", [
    (1, True, 1, 8, 8), (2, True, 1, 8, 8), (1, False, 1, 8, 8), (1, False, 2, 8, 8),
    (1, True, 2, 8, 12), (2, False, 1, 8, 12)])
def test_conv1d_layer_matches_jax(stride, causal, dilation, din, dout):
    rng = np.random.default_rng(stride + 3 * dilation)
    jp = _with_bn(j_ex.init_conv1d_layer(jax.random.PRNGKey(1), din, dout, 3), rng)
    x = normal(rng, 2, 13, din)
    got = ex.conv1d_layer(_port(jp), t(x), stride, causal, dilation)
    want = j_ex.conv1d_layer(jp, jnp.asarray(x), stride, causal, dilation)
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("stride,causal,dilation", [(1, True, 1), (2, True, 1), (1, False, 1),
                                                    (2, False, 2), (1, True, 3)])
def test_dtc_block_matches_jax(stride, causal, dilation):
    rng = np.random.default_rng(7 * stride + dilation)
    jp = _with_bn(j_ex.init_dtc(jax.random.PRNGKey(2), 8, kernel=3), rng)
    x = normal(rng, 2, 12, 8)
    got = ex.dtc_block(_port(jp), t(x), stride, causal, dilation)
    want = j_ex.dtc_block(jp, jnp.asarray(x), stride, causal, dilation)
    assert got.shape == want.shape
    close(got, want)


def test_even_centred_kernel_raises_as_jax():
    for init, fn in ((lambda g: ex.init_conv1d_layer(8, 8, 4, g), ex.conv1d_layer),
                     (lambda g: ex.init_dtc(8, 4, g), ex.dtc_block)):
        with pytest.raises(ValueError, match="odd effective kernel"):
            fn(init(torch.Generator().manual_seed(0)), torch.zeros(1, 6, 8), causal=False)


@pytest.mark.parametrize("masked", [False, True])
def test_soft_attention_matches_jax(masked):
    rng = np.random.default_rng(3)
    jp = j_ex.init_soft_attention(jax.random.PRNGKey(3), 8, 16)
    x = normal(rng, 2, 5, 8)
    m = np.array([[False] * 3 + [True] * 2, [False] * 5]) if masked else None
    got = ex.soft_attention(_port(jp), t(x), None if m is None else t(m))
    want = j_ex.soft_attention(jp, jnp.asarray(x), None if m is None else jnp.asarray(m))
    close(got, want)


@pytest.mark.parametrize("dim,state,steps", [(16, 4, 9), (32, 16, 33)])
def test_ssm_scan_matches_jax(dim, state, steps):
    rng = np.random.default_rng(dim)
    jp = j_ex.init_ssm(jax.random.PRNGKey(4), dim, state_dim=state)
    jp = {**jp, "dt_bias": jnp.asarray(normal(rng, dim) * 0.5)}
    x = normal(rng, 2, steps, dim)
    got = ex.ssm_scan(_port(jp), t(x))
    close(got, j_ex.ssm_scan(jp, jnp.asarray(x)), atol=1e-5, rtol=1e-5)


def test_init_structure_matches_jax():
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = ((ex.init_fsmn(16, 24, 32, g, left=2, right=1),
              j_ex.init_fsmn(key, 16, 24, 32, left=2, right=1)),
             (ex.init_conv1d_layer(8, 12, 5, g), j_ex.init_conv1d_layer(key, 8, 12, 5)),
             (ex.init_dtc(8, 3, g), j_ex.init_dtc(key, 8, 3)),
             (ex.init_soft_attention(8, 16, g), j_ex.init_soft_attention(key, 8, 16)),
             (ex.init_ssm(32, g), j_ex.init_ssm(key, 32)))
    for got, want in pairs:
        assert jax.tree.map(lambda a: tuple(a.shape), got) == \
            jax.tree.map(lambda a: tuple(a.shape), want)
    close(pairs[-1][0]["a_log"], pairs[-1][1]["a_log"])
