"""PyTorch port: norms, rope, plain attention, dense MoE and sampling
against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import close, normal, t
from vita_tpu.ops import attention as j_attn
from vita_tpu.ops import moe as j_moe
from vita_tpu.ops import norms as j_norms
from vita_tpu.ops import rope as j_rope
from vita_tpu_torch.ops import attention, moe, norms, rope


def test_rms_and_layer_norm():
    rng = np.random.default_rng(0)
    x, w, b = normal(rng, 3, 5, 32), normal(rng, 32), normal(rng, 32)
    close(norms.rms_norm(t(x), t(w)), j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    close(norms.layer_norm(t(x), t(w), t(b)),
          j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # bf16 in, bf16 out, computed in f32: exact up to the final rounding
    xb = t(x).bfloat16()
    got = norms.rms_norm(xb, t(w))
    assert got.dtype == torch.bfloat16
    want = j_norms.rms_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(w))
    close(got.float(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)


def test_rope_tables_and_apply():
    rng = np.random.default_rng(1)
    q, k = normal(rng, 2, 7, 4, 16), normal(rng, 2, 7, 2, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    cos, sin = rope.rope_tables(t(pos), 16, 1e6)
    jcos, jsin = j_rope.rope_tables(jnp.asarray(pos), 16, 1e6)
    close(cos, jcos)
    close(sin, jsin)
    qo, ko = rope.apply_rope(t(q), t(k), t(pos), 1e6)
    jq, jk = j_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 1e6)
    close(qo, jq)
    close(ko, jk)


def test_repeat_kv_and_mask_builders():
    rng = np.random.default_rng(2)
    x = normal(rng, 2, 5, 3, 4)
    np.testing.assert_array_equal(attention.repeat_kv(t(x), 2).numpy(),
                                  np.asarray(j_attn.repeat_kv(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(attention.causal_mask_bias(4, 9, 5).numpy(),
                                  np.asarray(j_attn.causal_mask_bias(4, 9, 5)))
    valid = rng.random((3, 6)) < 0.5
    np.testing.assert_array_equal(attention.padding_mask_bias(t(valid)).numpy(),
                                  np.asarray(j_attn.padding_mask_bias(jnp.asarray(valid))))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_mha_xla_with_bias(hq, hkv):
    rng = np.random.default_rng(3)
    q, k, v = normal(rng, 2, 6, hq, 16), normal(rng, 2, 9, hkv, 16), normal(rng, 2, 9, hkv, 16)
    bias = np.asarray(j_attn.causal_mask_bias(6, 9, 3)) + np.asarray(
        j_attn.padding_mask_bias(jnp.asarray(rng.random((2, 9)) < 0.8)))
    got = attention.mha_xla(t(q), t(k), t(v), bias=t(bias))
    want = j_attn.mha_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias))
    close(got, want)


def test_route_topk_and_aux_loss():
    rng = np.random.default_rng(4)
    logits = normal(rng, 10, 8)
    w, i, p = moe.route_topk(t(logits), 2)
    jw, ji, jp = j_moe.route_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.dtype == torch.int32
    close(w, jw)
    close(p, jp)
    mask = (rng.random(10) < 0.7).astype(np.float32)
    for tm in (None, mask):
        got = moe.load_balancing_loss(p, i, 8, None if tm is None else t(tm))
        want = j_moe.load_balancing_loss(jp, ji, 8, None if tm is None else jnp.asarray(tm))
        close(got, want)


def test_moe_ffn_dense_matches_jax():
    import jax

    params = jax.device_get(j_moe.init_moe_params(jax.random.PRNGKey(0), 4, 32, 64))
    x = normal(np.random.default_rng(5), 12, 32)
    mask = np.ones(12, np.float32)
    mask[9:] = 0
    out, aux = moe.moe_ffn({k: t(v) for k, v in params.items()}, t(x), 2, "dense",
                           token_mask=t(mask))
    jout, jaux = j_moe.moe_ffn(params, jnp.asarray(x), 2, "dense", token_mask=jnp.asarray(mask))
    close(out, jout)
    close(aux, jaux)


def test_moe_ffn_other_modes_not_ported():
    """Every mode of the JAX package runs; a mode it does not have raises."""
    p = {"router": torch.zeros(4, 2), "w_gate": torch.zeros(2, 4, 4)}
    with pytest.raises(ValueError, match="unknown moe mode"):
        moe.moe_ffn(p, torch.zeros(4, 4), 2, "chunked")


def test_sampling_modes_and_greedy_tokens():
    import jax

    from vita_tpu import sampling as j_sampling
    from vita_tpu_torch import sampling

    for knobs in (([0.0, 0.0], [0, 0], [1.0, 1.0]), ([0.7, 0.0], [0, 0], [1.0, 1.0]),
                  ([0.7, 0.0], [5, 0], [1.0, 1.0]), ([0.0], [0], [0.9])):
        assert sampling.choose_sampling_mode(*knobs) == j_sampling.choose_sampling_mode(*knobs)
    rng = np.random.default_rng(6)
    logits = normal(rng, 3, 50)
    temp, tk, tp = np.zeros(3, np.float32), np.zeros(3, np.int32), np.ones(3, np.float32)
    gen = torch.Generator().manual_seed(0)
    want = j_sampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp),
                                    jnp.asarray(tk), jnp.asarray(tp), mode="greedy")
    for mode in ("greedy", "categorical", "filtered"):
        got = sampling.sample_tokens(t(logits), gen, t(temp), t(tk), t(tp), mode=mode)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # sampled rows: top_k=1 and a vanishing top_p both leave only the argmax
    hot = np.full(3, 0.9, np.float32)
    got = sampling.sample_tokens(t(logits), gen, t(hot), t(np.array([1, 0, 1], np.int32)),
                                 t(np.array([1.0, 1e-9, 0.5], np.float32)), mode="filtered")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    draws = sampling.sample_tokens(t(logits).repeat(200, 1), gen, t(hot).repeat(200),
                                   t(tk).repeat(200), t(tp).repeat(200), mode="categorical")
    assert 0 <= int(draws.min()) and int(draws.max()) < 50 and len(set(draws.tolist())) > 1
