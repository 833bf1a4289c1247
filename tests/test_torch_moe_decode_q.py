"""PyTorch port: weight-only quantized experts. The quantizers are held bit
for bit to the JAX package's; the int8/int4 expert FFNs (plain versions on
the CPU) to the JAX Pallas kernels in interpret mode, over flat layer*E+e
ids into stacked weights, with JAX's own quantized weights on both sides.
Both sides round h to bf16 before the down projection, so float32
tolerance 1e-4 holds. The CUDA kernels against the plain versions are in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import moe as j_moe
from vita_tpu.ops import moe_decode as j_md
from vita_tpu_torch.ops import moe as moe
from vita_tpu_torch.ops import moe_decode as md

E, LAYERS, D, F = 4, 2, 64, 256
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _x(x, dtype):
    """The same float32 numpy activations in ``dtype`` for torch and for
    jax (both round to nearest even)."""
    tdt, jdt = DTYPES[dtype]
    return t(x).to(tdt), jnp.asarray(x).astype(jdt)


def _tol(want, dtype):
    """float32: the shared 1e-4. bfloat16: one bf16 ulp at the output's
    scale, the least power of two at or above max |want|, over 2^7. Both
    sides take exact products of bf16 x and the integer weights in float32
    and round h and y to bf16; their float32 sums run in other orders, which
    can move h across a bf16 rounding boundary and the rounded output by up
    to one such ulp."""
    if dtype == "float32":
        return {}
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return dict(atol=2.0 ** (np.ceil(np.log2(top)) - 7), rtol=0)


def _weights(rng, layers=LAYERS):
    return {"router": normal(rng, D, E, scale=D ** -0.5),
            "w_gate": normal(rng, layers * E, D, F, scale=D ** -0.5),
            "w_up": normal(rng, layers * E, D, F, scale=D ** -0.5),
            "w_down": normal(rng, layers * E, F, D, scale=F ** -0.5)}


def _routing(rng, n_tok, layer=1):
    idx = np.stack([rng.choice(E, 2, replace=False) for _ in range(n_tok)]) + layer * E
    w = rng.random((n_tok, 2)).astype(np.float32)
    return w / w.sum(1, keepdims=True), idx.astype(np.int32)


def _jax_q(w, bits, group=0):
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    q = j_md.quantize_expert_weights(jw) if bits == 8 else j_md.quantize_expert_weights_int4(jw, group)
    return q, {k: t(v) for k, v in q.items()}


QUANTIZERS = {
    "int8": (md.quantize_expert_weights, j_md.quantize_expert_weights),
    "int4": (md.quantize_expert_weights_int4, j_md.quantize_expert_weights_int4),
    "int4_group16": (lambda p: md.quantize_expert_weights_int4(p, 16),
                     lambda p: j_md.quantize_expert_weights_int4(p, 16)),
}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind", sorted(QUANTIZERS))
def test_quantizers_bit_identical_to_jax(kind, stacked):
    rng = np.random.default_rng(0)
    w = _weights(rng)
    if stacked:  # [L, E, A, B], quantized layer by layer
        w = {k: v.reshape(LAYERS, E, *v.shape[1:]) if k != "router" else v
             for k, v in w.items()}
    fn, jfn = QUANTIZERS[kind]
    got = fn({k: t(v) for k, v in w.items()})
    want = jfn({k: jnp.asarray(v) for k, v in w.items()})
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype), name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_int4_pack_unpack_round_trip():
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, (3, 8, 6)).astype(np.int8)
    for axis in (-2, -1):
        packed = md._pack_int4(t(q), axis)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(j_md._pack_int4(jnp.asarray(q), axis)))
        back = md._unpack_int4(packed, axis)
        assert back.dtype == torch.bfloat16
        np.testing.assert_array_equal(back.float().numpy(), q.astype(np.float32))


def test_apply_group_scale_rounds_like_jax():
    rng = np.random.default_rng(2)
    w = rng.integers(-7, 8, (32, 24)).astype(np.float32)
    s = rng.random((4, 24)).astype(np.float32) * 0.1
    got = md._apply_group_scale(t(w), t(s))
    want = j_md._apply_group_scale(jnp.asarray(w, jnp.bfloat16), jnp.asarray(s))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


GATHER_CASES = {  # name: (bits, group)
    "int8": (8, 0), "int4": (4, 0), "int4_group16": (4, 16),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_tok", [1, 3])
@pytest.mark.parametrize("kind", sorted(GATHER_CASES))
def test_gather_expert_ffn_q_matches_jax_kernel(kind, n_tok, dtype):
    """B6 (int8) and B7 (int4, per-channel fold and grouped pre-multiply),
    over float32 and bf16 activations (the serving path's)."""
    bits, group = GATHER_CASES[kind]
    rng = np.random.default_rng(3)
    jq, tq = _jax_q(_weights(rng), bits, group)
    x, jx = _x(normal(rng, n_tok, D), dtype)
    _, idx = _routing(rng, n_tok)
    fn, jfn = ((md.gather_expert_ffn_q, j_md.gather_expert_ffn_q) if bits == 8
               else (md.gather_expert_ffn_q4, j_md.gather_expert_ffn_q4))
    got = fn(x, t(idx), tq)
    assert got.shape == (n_tok, 2, D) and got.dtype == x.dtype
    with pltpu.force_tpu_interpret_mode():
        want = jfn(jx, jnp.asarray(idx), jq)
    close(got.float(), want.astype(jnp.float32), **_tol(want, dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_tok", [4, 8, 16])
@pytest.mark.parametrize("kind", sorted(GATHER_CASES))
def test_masked_expert_ffn_q_matches_jax_kernel(kind, n_tok, dtype):
    """B8a (int8, T >= 4) and B8b (int4 per-channel, T >= 8); int4 at T 4
    and grouped int4 take the per-pair schedule (B7) in both packages;
    over float32 and bf16 activations (the serving path's)."""
    bits, group = GATHER_CASES[kind]
    rng = np.random.default_rng(4)
    jq, tq = _jax_q(_weights(rng), bits, group)
    x, jx = _x(normal(rng, n_tok, D), dtype)
    w, idx = _routing(rng, n_tok)
    fn, jfn = ((md.masked_expert_ffn_q, j_md.masked_expert_ffn_q) if bits == 8
               else (md.masked_expert_ffn_q4, j_md.masked_expert_ffn_q4))
    got = fn(x, t(w), t(idx), tq, n_experts=E)
    assert got.dtype == x.dtype
    with pltpu.force_tpu_interpret_mode():
        want = jfn(jx, jnp.asarray(w), jnp.asarray(idx), jq, n_experts=E)
    close(got.float(), want.astype(jnp.float32), **_tol(want, dtype))


def test_masked_expert_ffn_q4_padding_rows_match_jax_kernel():
    """B8b at T 8 with routing confined to 2 of the 4 experts: the plan's
    act has 2 padding rows (the last id repeated, routing weight 0), which
    the CUDA kernel skips; the output must stay what the TPU kernel gives."""
    rng = np.random.default_rng(8)
    jq, tq = _jax_q(_weights(rng), 4)
    x = normal(rng, 8, D)
    idx = np.tile(np.array([[1, 3], [3, 1]], np.int32) + E, (4, 1))
    w = rng.random((8, 2)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    act, m = md._active_expert_plan(t(w), t(idx), E)
    assert act.tolist() == [E + 1, E + 3, E + 3, E + 3] and not m[2:].any()
    got = md.masked_expert_ffn_q4(t(x), t(w), t(idx), tq, n_experts=E)
    with pltpu.force_tpu_interpret_mode():
        want = j_md.masked_expert_ffn_q4(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx), jq,
                                         n_experts=E)
    close(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_masked_expert_ffn_q_padding_rows_match_jax_kernel(dtype):
    """B8a at T 4 with routing confined to 2 of the 4 experts: the plan's
    act has 2 padding rows (the last id repeated, routing weight 0), which
    the CUDA kernel skips; the output must stay what the TPU kernel gives."""
    rng = np.random.default_rng(9)
    jq, tq = _jax_q(_weights(rng), 8)
    x, jx = _x(normal(rng, 4, D), dtype)
    idx = np.tile(np.array([[0, 2], [2, 0]], np.int32) + E, (2, 1))
    w = rng.random((4, 2)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    act, m = md._active_expert_plan(t(w), t(idx), E)
    assert act.tolist() == [E, E + 2, E + 2, E + 2] and not m[2:].any()
    got = md.masked_expert_ffn_q(x, t(w), t(idx), tq, n_experts=E)
    with pltpu.force_tpu_interpret_mode():
        want = j_md.masked_expert_ffn_q(jx, jnp.asarray(w), jnp.asarray(idx), jq, n_experts=E)
    close(got.float(), want.astype(jnp.float32), **_tol(want, dtype))


def test_masked_q_schedule_windows(monkeypatch):
    """Which schedule each batch size takes: int8 masks from T 4, int4
    per-channel from T 8, grouped int4 never."""
    calls = []
    monkeypatch.setattr(md, "masked_expert_ffn_q_plain",
                        lambda *a: calls.append(("masked", a[4])) or torch.zeros(a[0].shape))
    monkeypatch.setattr(md, "gather_expert_ffn_q_plain",
                        lambda x, idx, q, bits: calls.append(("gather", bits))
                        or torch.zeros(x.shape[0], idx.shape[1], x.shape[1]))
    rng = np.random.default_rng(5)
    w = _weights(rng, layers=1)
    qs = {8: md.quantize_expert_weights({k: t(v) for k, v in w.items()}),
          4: md.quantize_expert_weights_int4({k: t(v) for k, v in w.items()}),
          "g": md.quantize_expert_weights_int4({k: t(v) for k, v in w.items()}, 16)}
    for key, n_tok, want in ((8, 3, "gather"), (8, 4, "masked"), (4, 4, "gather"),
                             (4, 8, "masked"), ("g", 8, "gather"), (8, 17, "gather")):
        calls.clear()
        tw, idx = _routing(rng, n_tok, layer=0)
        fn = md.masked_expert_ffn_q if key == 8 else md.masked_expert_ffn_q4
        fn(t(normal(rng, n_tok, D)), t(tw), t(idx), qs[key], n_experts=E)
        assert calls and calls[0][0] == want, (key, n_tok, calls)


@pytest.mark.parametrize("mode", ["gather", "gather_q", "gather_q4"])
def test_moe_ffn_gather_modes_match_jax(mode):
    rng = np.random.default_rng(6)
    w = _weights(rng, layers=1)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if mode == "gather_q":
        jw = j_md.quantize_expert_weights(jw)
    elif mode == "gather_q4":
        jw = j_md.quantize_expert_weights_int4(jw)
    x = normal(rng, 8, D)
    got, aux = moe.moe_ffn({k: t(v) for k, v in jw.items()}, t(x), 2, mode=mode)
    with pltpu.force_tpu_interpret_mode():
        want, jaux = j_moe.moe_ffn(jw, jnp.asarray(x), 2, mode=mode)
    close(got, want)
    close(aux, jaux)


def test_moe_ffn_decode_q_matches_jax():
    rng = np.random.default_rng(7)
    jq, tq = _jax_q(_weights(rng, layers=1), 8)
    x = normal(rng, 2, D)
    got, aux = md.moe_ffn_decode_q(tq, t(x))
    with pltpu.force_tpu_interpret_mode():
        want, _ = j_md.moe_ffn_decode_q(jq, jnp.asarray(x))
    close(got, want)
    assert float(aux) == 0.0
