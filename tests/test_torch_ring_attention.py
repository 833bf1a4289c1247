"""PyTorch port: sequence parallelism (vita_tpu_torch.parallel.ring_attention
and the seq-parallel Mixtral forward) on gloo ranks, mirroring
tests/test_ring_attention.py at its shapes (B 2, S 32, 4 q / 2 kv heads of
8, inputs from a numpy seed).

- The ring under (seq, model) = (4, 1) and (2, 2), causal and not, at
  lengths [S, S-7]: every rank's block of the output, put together, held
  to JAX's ``ring_flash_mha`` on its 8-device CPU mesh and to the port's
  unsharded ``flash_mha`` at 2e-5; the gradients of sum(o * g) at 5e-5;
  the merged lse to the unsharded one. A batch row with no valid key
  (length 0) against the port's flash_mha only: JAX masks with a finite
  -1e30 and gives such a row the mean of v (ROADMAP section C).
- The two bad-shape ValueErrors, with JAX's messages.
- ``flash_mha_with_lse`` against JAX's (Pallas in interpret mode): both
  outputs, and the gradients of a loss on both, at 1e-4 (float32; the
  sums run in another order).
- A block wholly in the future (a negative q_offset) and a row with no
  key through the kernels' plain versions: o = 0, lse = -inf, gradients 0.
- The tiny Mixtral under seq 4, as JAX's
  test_mixtral_forward_seq_parallel_matches_unsharded: the loss (the ranks'
  shares plus 0.02 aux) at rtol 1e-5 and the gradients summed over the
  ranks at 1e-4, against JAX's seq-parallel run (dense) and its unsharded
  run (dense, and gmm in interpret mode); the capacity and sort modes
  (their drops decided over the whole sequence's token order, which each
  rank gathers for the MoE) against JAX's unsharded run.

One group of 4 ranks runs every case, in a thread while this process
computes JAX's side."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_mesh_util as u
from torch_port_util import close, normal, t
from vita_tpu.models import mixtral as j_mix
from vita_tpu.ops import flash_attention as j_flash
from vita_tpu.parallel.mesh import make_mesh as j_make_mesh
from vita_tpu.parallel.ring_attention import ring_flash_mha as j_ring
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import mixtral
from vita_tpu_torch.ops import flash_attention as flash
from vita_tpu_torch.parallel.launch import run_ranks

B, S, HQ, HKV, D = 2, 32, 4, 2, 8
WORLD = 4
MESHES = {"seq4": (4, 1), "seq2_model2": (2, 2)}
RING = [(m, c) for m in MESHES for c in (True, False)]
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
MIX_S = 32


def _shape(seq, model):
    return (1, 1, 1, model, 1, seq)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = {"q": normal(rng, B, S, HQ, D), "k": normal(rng, B, S, HKV, D),
         "v": normal(rng, B, S, HKV, D), "g": normal(rng, B, S, HQ, D)}
    cfg = j_mix.MixtralConfig.tiny()
    x["jcfg"] = cfg
    x["jparams"] = jax.device_get(j_mix.init_params(jax.random.PRNGKey(0), cfg))
    x["ids"] = rng.integers(0, cfg.vocab_size, (2, MIX_S)).astype(np.int32)
    x["valid"] = np.arange(MIX_S)[None, :] < np.array([[MIX_S], [25]])
    return x


def _cases(x):
    tq, tk, tv, tg = (t(x[n]) for n in "qkvg")
    cases = []
    for name, causal in RING:
        cases.append((f"{name}_{causal}", "ring_case",
                      dict(mesh=_shape(*MESHES[name]), q=tq, k=tk, v=tv, g=tg,
                           lengths=torch.tensor([S, S - 7]), causal=causal)))
    cases.append(("no_key_row", "ring_case",
                  dict(mesh=_shape(4, 1), q=tq, k=tk, v=tv, g=tg,
                       lengths=torch.tensor([S - 7, 0]), causal=True)))
    cases.append(("bad", "ring_bad_shapes", dict(mesh=_shape(4, 1), q=tq, k=tk, v=tv)))
    tcfg = mixtral.MixtralConfig.tiny()
    params = from_jax_params(x["jparams"], tcfg)
    for mode in ("dense", "gmm"):
        cases.append((f"mix_{mode}", "seq_mixtral_case",
                      dict(mesh=_shape(4, 1), params=params, cfg=tcfg, ids=t(x["ids"]),
                           valid=t(x["valid"]), mode=mode)))
    for mode in ("capacity", "sort"):
        cases.append((f"refuse_{mode}", "seq_mixtral_case",
                      dict(mesh=_shape(4, 1), params=params, cfg=tcfg, ids=t(x["ids"]),
                           valid=t(x["valid"]), mode=mode)))
    return cases


def _j_ring(x, seq, model, causal, lengths):
    mesh = j_make_mesh((1, 8 // (seq * model), 1, model, 1, seq))
    lengths = jnp.asarray(lengths)

    def f(q, k, v):
        o = j_ring(q, k, v, lengths, causal=causal, mesh=mesh)
        return jnp.sum(o * jnp.asarray(x["g"])), o

    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x[n]) for n in "qkv"))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _j_mixtral_loss(jp, cfg, ids, valid, mesh):
    def loss(p):
        logits, _, aux = j_mix.forward(p, cfg, input_ids=jnp.asarray(ids),
                                       attn_valid=jnp.asarray(valid), mesh=mesh)
        m = jnp.asarray(valid, jnp.float32)[:, :, None]
        return jnp.mean((logits.astype(jnp.float32) * m) ** 2) + 0.02 * aux

    return jax.value_and_grad(loss)(jp)


def _jax_side(x):
    out = {}
    for name, causal in RING:
        seq, model = MESHES[name]
        out[f"{name}_{causal}"] = _j_ring(x, seq, model, causal, [S, S - 7])
    cfg, jp = x["jcfg"], x["jparams"]
    out["mix_dense_sp"] = _j_mixtral_loss(
        jp, dataclasses.replace(cfg, attn_backend="flash"), x["ids"], x["valid"],
        j_make_mesh((1, 2, 1, 1, 1, 4)))
    out["mix_dense"] = _j_mixtral_loss(jp, cfg, x["ids"], x["valid"], None)
    for mode in ("capacity", "sort"):
        out[f"mix_{mode}"] = _j_mixtral_loss(jp, dataclasses.replace(cfg, moe_mode=mode),
                                             x["ids"], x["valid"], None)
    with pltpu.force_tpu_interpret_mode():
        out["mix_gmm"] = _j_mixtral_loss(jp, dataclasses.replace(cfg, moe_mode="gmm"),
                                         x["ids"], x["valid"], None)
    return out


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("ring_ranks"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, WORLD, _cases(inputs), {}, threads=1,
                            timeout=300, store_dir=store)
        jax_out = _jax_side(inputs)
        return ranks.result(), jax_out


def _assemble(ranks, case, key, heads):
    """The whole [B, S, H, d] (or lse [B, H, S]) from the ranks' blocks."""
    blocks = [r[case] for r in ranks]
    seq = max(b["coords"]["seq"] for b in blocks) + 1
    model = max(b["coords"]["model"] for b in blocks) + 1
    s_loc, h_loc = S // seq, heads // model
    lse = key == "lse"
    full = np.zeros((B, heads, S) if lse else (B, S, heads, D), np.float32)
    for b in blocks:
        c = b["coords"]
        rows = slice(c["seq"] * s_loc, (c["seq"] + 1) * s_loc)
        hs = slice(c["model"] * h_loc, (c["model"] + 1) * h_loc)
        if lse:
            full[:, hs, rows] = b[key]
        else:
            full[:, rows, hs] = b[key]
    return full


def _port_unsharded(x, lengths, causal):
    leaves = [t(x[n]).requires_grad_() for n in "qkv"]
    o, lse = flash.flash_mha_with_lse(*leaves, kv_len=torch.tensor(lengths, dtype=torch.int32),
                                      causal=causal)
    (o * t(x["g"])).sum().backward()
    return o.detach(), lse.detach(), [p.grad for p in leaves]


@pytest.mark.parametrize("mesh,causal", RING)
def test_ring_matches_jax_and_unsharded(results, inputs, mesh, causal):
    ranks, jx = results
    case = f"{mesh}_{causal}"
    got = _assemble(ranks, case, "out", HQ)
    want_o, want_g = jx[case]
    ref_o, ref_lse, ref_g = _port_unsharded(inputs, [S, S - 7], causal)
    close(got, want_o, **FWD_TOL)
    close(got, ref_o, **FWD_TOL)
    close(_assemble(ranks, case, "lse", HQ), ref_lse, **FWD_TOL)
    for key, heads, w, r in zip(("dq", "dk", "dv"), (HQ, HKV, HKV), want_g, ref_g):
        g = _assemble(ranks, case, key, heads)
        close(g, w, **GRAD_TOL)
        close(g, r, **GRAD_TOL)


def test_ring_row_with_no_key_is_zero(results, inputs):
    ranks, _ = results
    got = _assemble(ranks, "no_key_row", "out", HQ)
    ref_o, _, ref_g = _port_unsharded(inputs, [S - 7, 0], True)
    assert np.all(got[1] == 0) and np.all(np.isfinite(got))
    close(got, ref_o, **FWD_TOL)
    for key, heads, r in zip(("dq", "dk", "dv"), (HQ, HKV, HKV), ref_g):
        g = _assemble(ranks, "no_key_row", key, heads)
        assert np.all(g[1] == 0)
        close(g, r, **GRAD_TOL)
    lse = _assemble(ranks, "no_key_row", "lse", HQ)
    assert np.all(lse[1] == np.float32(-1e30)) and np.all(np.isfinite(lse))


def test_ring_rejects_bad_shapes(results):
    ranks, _ = results
    for r in ranks:
        divisible, cache = r["bad"]
        assert divisible == f"sequence length {S - 2} not divisible by seq axis 4"
        assert cache == "ring attention requires Sq == Skv (no KV cache)"


LSE_CASES = {  # (B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal): every row sees a key
    "causal_gqa_offset": (2, 20, 30, 4, 2, [30, 25], [10, 5], True),
    "bidirectional_padding": (2, 20, 30, 4, 1, [30, 11], [0, 0], False),
}


@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_flash_mha_with_lse_matches_jax(case):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = LSE_CASES[case]
    rng = np.random.default_rng(1)
    q, g = normal(rng, b, sq, hq, 128), normal(rng, b, sq, hq, 128)
    k, v = normal(rng, b, skv, hkv, 128), normal(rng, b, skv, hkv, 128)
    h = normal(rng, b, hq, sq)

    def j_loss(q, k, v):
        o, lse = j_flash.flash_mha_with_lse(
            q, k, v, kv_len=jnp.asarray(kv_len, jnp.int32),
            q_offset=jnp.asarray(q_off, jnp.int32), causal=causal, block_q=16, block_k=16)
        return jnp.sum(o * g) + jnp.sum(lse * h), (o, lse)

    with pltpu.force_tpu_interpret_mode():
        (_, (jo, jlse)), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    o, lse = flash.flash_mha_with_lse(*leaves, kv_len=t(kv_len, torch.int32),
                                      q_offset=t(q_off, torch.int32), causal=causal)
    ((o * t(g)).sum() + (lse * t(h)).sum()).backward()
    close(o.detach(), jo)
    close(lse.detach(), jlse)
    for p, w in zip(leaves, jg):
        close(p.grad, w)


def test_fully_masked_blocks_give_zero_through_the_plain_versions():
    """A causal block wholly in the future of its queries (q_offset = -Sq,
    as the ring's later blocks) and a batch row with kv_len 0: o = 0 and
    lse = -inf from the forward, zero dq/dk/dv from the backward, nothing
    NaN. The finite rows match the unmasked computation."""
    rng = np.random.default_rng(2)
    q, do = t(normal(rng, 2, 8, 4, 16)), t(normal(rng, 2, 8, 4, 16))
    k, v = t(normal(rng, 2, 8, 2, 16)), t(normal(rng, 2, 8, 2, 16))
    kv_len = torch.tensor([8, 0], dtype=torch.int32)
    future = torch.tensor([-8, 0], dtype=torch.int32)  # row 0 wholly in the future, row 1 no key
    o, lse = flash.flash_fwd_plain(q, k, v, kv_len, future, True, 0.25)
    assert torch.all(o == 0) and torch.all(lse == float("-inf"))
    delta = flash.flash_delta(do, o)
    args = (q, k, v, do, lse, delta, kv_len, future, True, 0.25)
    dq = flash.flash_bwd_dq_plain(*args)
    dk, dv = flash.flash_bwd_dkv_plain(*args)
    for x in (dq, dk, dv):
        assert torch.all(x == 0)
    # the same block at offset 0 sees keys: finite and not zero
    o0, lse0 = flash.flash_fwd_plain(q, k, v, kv_len, torch.zeros(2, dtype=torch.int32), True,
                                     0.25)
    assert torch.isfinite(lse0[0]).all() and o0[0].abs().sum() > 0


@pytest.mark.parametrize("mode", ["dense", "gmm"])
def test_seq_parallel_mixtral_matches_jax(results, mode):
    ranks, jx = results
    parts = [r[f"mix_{mode}"] for r in ranks]
    aux = {float(p["aux"]) for p in parts}
    assert len(aux) == 1  # the whole sequence's aux on every rank
    loss = sum(float(p["share"]) for p in parts) + 0.02 * aux.pop()
    refs = [jx[f"mix_{mode}"]] + ([jx["mix_dense_sp"]] if mode == "dense" else [])
    for want_loss, want_g in refs:
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        flat = dict(u._tree_leaves(jax.tree.map(np.asarray, want_g)))
        for name in parts[0]["grads"]:
            summed = sum(p["grads"][name] for p in parts)
            close(summed, flat[name], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["capacity", "sort"])
def test_seq_parallel_capacity_modes_name_their_item(results, mode):
    """The capacity and sort modes under seq 4 (refused until their drops
    were decided over the whole sequence's token order): the loss and the
    gradients summed over the ranks are JAX's unsharded ones, whose
    capacity counts every position of the sequence."""
    ranks, jx = results
    parts = [r[f"refuse_{mode}"] for r in ranks]
    aux = {float(p["aux"]) for p in parts}
    assert len(aux) == 1
    loss = sum(float(p["share"]) for p in parts) + 0.02 * aux.pop()
    want_loss, want_g = jx[f"mix_{mode}"]
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    flat = dict(u._tree_leaves(jax.tree.map(np.asarray, want_g)))
    for name in parts[0]["grads"]:
        close(sum(p["grads"][name] for p in parts), flat[name], atol=1e-4, rtol=1e-4)
