"""PyTorch port: pipeline parallelism (vita_tpu_torch.parallel.pipeline and
Mixtral's GPipe path and pipelined greedy generation) on gloo ranks,
mirroring tests/test_pipeline.py.

- ``pipeline_layer_stack`` on a smooth body (L 8, D 16, B 8, S 6, pipe 4,
  M 4): the output within 1e-6 of JAX's pipelined run on its 8-device CPU
  mesh and of the port's unpipelined loop, aux the unpipelined sum / M,
  the gradients of sum(out^2) (each stage's block of the weights, and
  the input on every rank) within 1e-5 and those of aux within 1e-5
  relative.
- ``mixtral.forward`` (4 layers, dense MoE, 2 experts top-2) under pipe 4
  with M 2: logits within 2e-4 of JAX's pipe run and its unpipelined run,
  aux within 1e-4 (and equal to the mean of the per-microbatch aux).
- The gradients of NLL + 0.02 aux under pipe 2 with M 4: every leaf each
  rank holds within rtol 2e-3 / atol 2e-4 of JAX's (pipe 2 x fsdp 2) and
  of the port's unpipelined ones, the embedding whole on every rank; the
  same loss with remat against without (1e-4 / 1e-6) under pipe 4.
- Pipe 2 x seq 2 (flash, the ring inside each stage): the logits within
  2e-5 of JAX's unsharded forward, and the gradients of the ranks'
  shares summed over 'seq' within 1e-4 of the port's unsharded ones.
- A multimodal train step with the LLM as a 2-stage GPipe: the loss
  against the unpipelined step's (rtol 5e-3, as JAX's test), and the
  towers', projectors' and embedding's gradients whole and equal on every
  rank (1e-5 of the unpipelined step's).
- Every ValueError of JAX's pipe path, with the port's messages.
- ``pp_decode_greedy`` (dense under pipe 4, chained twice; gather under
  pipe 2) and ``pp_generate`` (pipe 2): tokens exact against JAX's
  pipelined runs and the port's unpipelined greedy loop.

One group of 4 ranks runs every case (the pipe-2 cases as two replicas
of two ranks), in a thread while this process computes JAX's side."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_pipe_util as u
from torch_port_util import close, normal, t
from vita_tpu.models import mixtral as j_mix
from vita_tpu.parallel.mesh import make_mesh as j_make_mesh
from vita_tpu.parallel.pipeline import pipeline_layer_stack as j_pls
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import mixtral
from vita_tpu_torch.parallel.launch import run_ranks

WORLD = 4
PIPE4, PIPE2 = (1, 1, 1, 1, 4), (1, 1, 1, 1, 2)
PIPE2_SEQ2 = (1, 1, 1, 1, 2, 2)
L_T, D_T, B_T, S_T = 8, 16, 8, 6
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _j_cfg(**kw):
    # top_k == n_experts: the routing weights are a whole softmax, so the
    # comparisons see the schedule, not top-k flips (as JAX's test)
    return j_mix.MixtralConfig.tiny(n_layers=4, moe_mode="dense", n_experts=2, top_k=2, **kw)


def _t_cfg(**kw):
    return mixtral.MixtralConfig.tiny(n_layers=4, moe_mode="dense", n_experts=2, top_k=2, **kw)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = {"w": normal(rng, L_T, D_T, D_T, scale=0.1), "x": normal(rng, B_T, S_T, D_T),
         "scale": normal(rng, B_T, S_T, 1)}
    jcfg = _j_cfg()
    x["jparams"] = jax.device_get(j_mix.init_params(jax.random.PRNGKey(0), jcfg))
    x["ids"] = rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
    tiny = j_mix.MixtralConfig.tiny()
    x["jparams_tiny"] = jax.device_get(j_mix.init_params(jax.random.PRNGKey(0), tiny))
    x["ids_seq"] = rng.integers(0, tiny.vocab_size, (2, 32)).astype(np.int32)
    x["decode4"] = rng.integers(1, jcfg.vocab_size, (4, 2, 7)).astype(np.int32)
    x["decode2"] = rng.integers(1, jcfg.vocab_size, (2, 2, 5)).astype(np.int32)
    x["generate2"] = rng.integers(1, jcfg.vocab_size, (2, 2, 6)).astype(np.int32)
    return x


def _train_batch():
    from vita_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.tokenization import media_masks

    cfg = vita.VITAConfig.tiny()
    ids = [1, 7] + [IMAGE_TOKEN_INDEX] * cfg.image_tokens_per_group + [9, 5, 2]
    safe, im, am = media_masks(np.array(ids))
    b, sz = 2, cfg.vision.image_size
    return cfg, {
        "input_ids": torch.as_tensor(np.tile(safe, (b, 1))).long(),
        "labels": torch.as_tensor(np.tile(safe, (b, 1))).long(),
        "image_mask": torch.as_tensor(np.tile(im, (b, 1))),
        "audio_mask": torch.as_tensor(np.tile(am, (b, 1))),
        "images": torch.zeros(b, sz, sz, 3), "speech": torch.zeros(b, 50, 80),
        "speech_lengths": torch.full((b,), 50), "attn_valid": torch.ones(b, len(ids),
                                                                          dtype=torch.bool),
    }


def _cases(x):
    tcfg = _t_cfg()
    params = from_jax_params(x["jparams"], tcfg)
    tiny = mixtral.MixtralConfig.tiny()
    params_tiny = from_jax_params(x["jparams_tiny"], tiny)
    ids = t(x["ids"]).long()
    from vita_tpu_torch.models import vita

    vcfg, batch = _train_batch()
    vparams = vita.init_params(vcfg, torch.Generator().manual_seed(0))
    shared = {"p": params, "cfg": tcfg, "pt": params_tiny, "tiny": tiny, "vp": vparams,
              "vcfg": vcfg, "batch": batch}
    gather = dataclasses.replace(tcfg, moe_mode="gather")
    shared["gather"] = gather
    cases = [
        ("transform", "transform_case", dict(mesh=PIPE4, w=t(x["w"]), x=t(x["x"]),
                                              scale=t(x["scale"]), n_micro=4)),
        ("fwd4", "pp_forward_case", dict(mesh=PIPE4, params="@p", cfg="@cfg", ids=ids,
                                         stages=4, micro=2)),
        ("grads2", "pp_forward_case", dict(mesh=PIPE2, params="@p", cfg="@cfg", ids=ids,
                                           stages=2, micro=4, objective="nll")),
        ("sq4", "pp_forward_case", dict(mesh=PIPE4, params="@p", cfg="@cfg", ids=ids,
                                        stages=4, micro=2, objective="sq")),
        ("sq4_remat", "pp_forward_case", dict(mesh=PIPE4, params="@p", cfg="@cfg", ids=ids,
                                              stages=4, micro=2, remat=True, objective="sq")),
        ("seq", "pp_seq_case", dict(mesh=PIPE2_SEQ2, params="@pt", cfg="@tiny",
                                    ids=t(x["ids_seq"]).long())),
        ("train", "pp_train_step_case", dict(mesh=PIPE2, params="@vp", cfg="@vcfg",
                                             batch="@batch")),
        ("errors", "pp_errors", dict(mesh=PIPE4, params="@p", cfg="@cfg", ids=ids)),
        ("decode4", "pp_decode_case", dict(mesh=PIPE4, params="@p", cfg="@cfg",
                                           prompts=t(x["decode4"]).long(), max_len=32,
                                           n_new=5)),
        ("decode2_gather", "pp_decode_case", dict(mesh=PIPE2, params="@p", cfg="@gather",
                                                  prompts=t(x["decode2"]).long(), max_len=16,
                                                  n_new=4)),
        ("generate2", "pp_generate_case", dict(mesh=PIPE2, params="@p", cfg="@cfg",
                                               prompts=t(x["generate2"]).long(), max_len=16,
                                               n_new=5)),
    ]
    return cases, shared


def _j_put(mesh, params, cfg):
    specs = j_mix.param_specs(cfg)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)


def _jax_side(x):
    out = {}
    # the raw transform on pipe 4 (x fsdp 2, as JAX's test)
    mesh = j_make_mesh(shape=(1, 2, 1, 1, 4), devices=jax.devices()[:8])
    w, xx, sc = (jnp.asarray(x[k]) for k in ("w", "x", "scale"))

    def body(lp, xm, c):
        return jnp.tanh(xm @ lp) * c, jnp.sum(xm ** 2)

    def pp(w, xx):
        return j_pls(mesh, body, w, xx, sc, 4, 4)

    o, a = jax.jit(pp)(w, xx)
    out["transform"] = dict(out=np.asarray(o), aux=float(a))
    for key, obj in (("", lambda w, xx: jnp.sum(pp(w, xx)[0] ** 2)),
                     ("aux_", lambda w, xx: pp(w, xx)[1])):
        gw, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(w, xx)
        out["transform"].update({key + "gw": np.asarray(gw), key + "gx": np.asarray(gx)})
    # Mixtral under pipe 4 (M 2) and its unpipelined run
    jcfg, jp, ids = _j_cfg(), x["jparams"], jnp.asarray(x["ids"])
    ref, _, aux_ref = j_mix.forward(jp, jcfg, input_ids=ids)
    mesh4 = j_make_mesh(shape=(1, 1, 1, 1, 4), devices=jax.devices()[:4])
    c4 = dataclasses.replace(jcfg, pipe_stages=4, pipe_microbatches=2)
    got, _, aux_pp = jax.jit(lambda p, i: j_mix.forward(p, c4, input_ids=i, mesh=mesh4))(
        _j_put(mesh4, jp, c4), ids)
    out["fwd"] = dict(ref=np.asarray(ref), aux_ref=float(aux_ref), pp=np.asarray(got),
                      aux_pp=float(aux_pp))
    out["aux_mb"] = float(np.mean([float(j_mix.forward(jp, jcfg, input_ids=ids[i:i + 2])[2])
                                   for i in (0, 2)]))
    # gradients of NLL + 0.02 aux: unpipelined and pipe 2 x fsdp 2 (M 4)
    labels = jnp.roll(ids, -1, axis=1)

    def loss(p, c, m=None):
        logits, _, aux = j_mix.forward(p, c, input_ids=ids, mesh=m)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, labels[..., None], -1).mean() + 0.02 * aux

    out["g_ref"] = jax.device_get(jax.grad(loss)(jp, jcfg))
    mesh2 = j_make_mesh(shape=(1, 2, 1, 1, 2), devices=jax.devices()[:4])
    c2 = dataclasses.replace(jcfg, pipe_stages=2, pipe_microbatches=4)
    out["g_pp"] = jax.device_get(jax.jit(jax.grad(lambda p: loss(p, c2, mesh2)))(
        _j_put(mesh2, jp, c2)))
    out["g_sq"] = jax.device_get(jax.grad(
        lambda p: jnp.mean(j_mix.forward(p, jcfg, input_ids=ids)[0].astype(jnp.float32) ** 2))(
        jp))
    # the tiny config unsharded (xla), for pipe x seq
    tiny = j_mix.MixtralConfig.tiny()
    ids_seq = jnp.asarray(x["ids_seq"])

    def share(p):
        lg = j_mix.forward(p, tiny, input_ids=ids_seq)[0].astype(jnp.float32)
        return jnp.sum(lg ** 2) / lg.size, lg

    (_, lg), g = jax.value_and_grad(share, has_aux=True)(x["jparams_tiny"])
    out["seq"] = dict(logits=np.asarray(lg), grads=jax.device_get(g))
    # the pipelined greedy decodes and generation on JAX's mesh
    for name, prompts, s, max_len, n_new, mode in (
            ("decode4", x["decode4"], 4, 32, 5, "dense"),
            ("decode2_gather", x["decode2"], 2, 16, 4, "gather")):
        c = dataclasses.replace(jcfg, moe_mode=mode)
        out[name] = _j_pp_decode(jp, c, prompts, s, max_len, n_new)
    mesh_g = j_make_mesh(shape=(1, 1, 1, 1, 2), devices=jax.devices()[:2])
    cg = dataclasses.replace(jcfg, pipe_stages=2)
    out["generate2"] = np.asarray(jax.jit(
        lambda p, pr: j_mix.pp_generate(p, cg, mesh_g, pr, 5, 16))(
        jp, jnp.asarray(x["generate2"])))
    return out


def _j_pp_decode(jp, cfg, prompts, s, max_len, n_new):
    mesh = j_make_mesh(shape=(1, 1, 1, 1, s), devices=jax.devices()[:s])
    ks, vs, first = [], [], []
    for w in range(s):
        cache = j_mix.init_kv_cache(cfg, batch=prompts.shape[1], max_len=max_len)
        logits, cache, _ = j_mix.forward(jp, cfg, input_ids=jnp.asarray(prompts[w]),
                                         cache=cache)
        ks.append(cache["k"])
        vs.append(cache["v"])
        first.append(jnp.argmax(logits[:, -1].astype(jnp.float32), -1))
    cache = {"k": jnp.stack(ks, 1), "v": jnp.stack(vs, 1),
             "pos": jnp.full((s, prompts.shape[1]), prompts.shape[2], jnp.int32)}
    run = jax.jit(lambda p, c, f: j_mix.pp_decode_greedy(p, cfg, mesh, c, f, n_new))
    toks1, cache = run(jp, cache, jnp.stack(first).astype(jnp.int32))
    toks2, _ = run(jp, cache, toks1[:, -1])
    return np.asarray(toks1), np.asarray(toks2)


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("pipe_ranks"))
    cases, shared = _cases(inputs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, WORLD, cases, shared, threads=1,
                            timeout=600, store_dir=store)
        jax_out = _jax_side(inputs)
        return ranks.result(), jax_out


def _port_sequential(params, cfg, prompts, max_len, n_new):
    """The port's unpipelined greedy loop: per wave prefill, then one token
    a step; tokens [W, 1 + n_new, B] (the first from the prefill)."""
    out = []
    with torch.no_grad():
        for w in range(prompts.shape[0]):
            cache = mixtral.init_kv_cache(cfg, batch=prompts.shape[1], max_len=max_len)
            logits, cache, _ = mixtral.forward(params, cfg, input_ids=t(prompts[w]).long(),
                                               cache=cache)
            tok = logits[:, -1].argmax(-1)
            seq = [tok]
            for _ in range(n_new):
                logits, cache, _ = mixtral.forward(params, cfg, input_ids=tok[:, None],
                                                   cache=cache)
                tok = logits[:, -1].argmax(-1)
                seq.append(tok)
            out.append(torch.stack(seq).numpy())
    return np.stack(out).astype(np.int32)


def _stage_block(x, stage, n):
    return np.asarray(x)[stage * (x.shape[0] // n):(stage + 1) * (x.shape[0] // n)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/" if prefix or k else k))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _want_leaf(flat_ref, name, stage, n):
    ref = flat_ref[name]
    return _stage_block(ref, stage, n) if name.startswith("layers/") else ref


def test_pipeline_transform_exact(results, inputs):
    """Forward within 1e-6, aux = the unpipelined sum / M, the gradients of
    sum(out^2) within 1e-5 (JAX's test; + 1e-6 relative) and those of aux
    alone within 1e-5 (+ 1e-5 relative)."""
    ranks, jx = results
    w, x, sc = (torch.as_tensor(inputs[k]) for k in ("w", "x", "scale"))
    ref = {}
    for key in ("", "aux_"):
        wg, xg = w.clone().requires_grad_(), x.clone().requires_grad_()
        out, aux = xg, 0.0
        for i in range(L_T):
            out, aux = torch.tanh(out @ wg[i]) * sc, aux + (out ** 2).sum()
        (aux / 4 if key else (out ** 2).sum()).backward()
        ref.update({key + "gw": wg.grad.numpy(), key + "gx": xg.grad})
    want = jx["transform"]
    for r in ranks:
        got = r["transform"]
        close(got["out"], want["out"], atol=1e-6, rtol=0)
        close(got["out"], out.detach(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["aux"], float(aux) / 4, rtol=1e-6)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
        # elements up to 30 (sum(out^2)) and 70 (aux): a few float32 ulps of
        # sums taken in another order than JAX's or the unpipelined loop's
        for key, tol in (("", dict(atol=1e-5, rtol=1e-6)), ("aux_", dict(atol=1e-5, rtol=1e-5))):
            close(got[key + "gw"], _stage_block(want[key + "gw"], got["stage"], 4), **tol)
            close(got[key + "gw"], _stage_block(ref[key + "gw"], got["stage"], 4), **tol)
            close(got[key + "gx"], want[key + "gx"], **tol)
            close(got[key + "gx"], ref[key + "gx"], **tol)


def test_pp_forward_matches_scan(results):
    ranks, jx = results
    want = jx["fwd"]
    for r in ranks:
        got = r["fwd4"]
        close(got["logits"], want["pp"], rtol=2e-4, atol=2e-4)
        close(got["logits"], want["ref"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(got["aux"]), want["aux_pp"], rtol=1e-4)
        np.testing.assert_allclose(float(got["aux"]), want["aux_ref"], rtol=1e-4)
        np.testing.assert_allclose(float(got["aux"]), jx["aux_mb"], rtol=1e-4)


def test_pp_grads_match(results):
    """Every rank's gradient of every leaf it holds: the stage's block of
    the layer leaves, the embedding, the final norm and the head whole
    (the embedding's from the stage-0 input's gradient, sent to every
    rank)."""
    ranks, jx = results
    ref, pp = _flat(jx["g_ref"]), _flat(jx["g_pp"])
    for r in ranks:
        got = r["grads2"]
        assert set(got["grads"]) == set(ref)
        for name, g in got["grads"].items():
            close(g, _want_leaf(ref, name, got["stage"], 2), **GRAD_TOL)
            close(g, _want_leaf(pp, name, got["stage"], 2), **GRAD_TOL)
        assert np.abs(got["grads"]["embed"]).max() > 0
    for name in ("embed", "ln_final", "lm_head"):
        np.testing.assert_array_equal(ranks[0]["grads2"]["grads"][name],
                                      ranks[1]["grads2"]["grads"][name])


def test_pp_remat_matches(results):
    ranks, jx = results
    ref = _flat(jx["g_sq"])
    for r in ranks:
        a, b = r["sq4"], r["sq4_remat"]
        for name, g in a["grads"].items():
            close(b["grads"][name], g, rtol=1e-4, atol=1e-6)
            close(g, _want_leaf(ref, name, a["stage"], 4), **GRAD_TOL)


def test_pipeline_composes_with_ring_attention(results):
    """Pipe 2 x seq 2: each rank's block of the logits equals JAX's
    unsharded forward's (every stage holds them); the gradients of the
    blocks' shares, summed over 'seq', equal the unsharded ones: each
    stage's block of the layer leaves, the rest whole."""
    ranks, jx = results
    want = jx["seq"]
    s_loc = want["logits"].shape[1] // 2
    ref = _flat(want["grads"])
    summed = {}
    for r in ranks:
        got, c = r["seq"], r["seq"]["coords"]
        rows = slice(c["seq"] * s_loc, (c["seq"] + 1) * s_loc)
        close(got["logits"], want["logits"][:, rows], rtol=2e-5, atol=2e-5)
        assert np.isfinite(float(got["aux"]))
        for name, g in got["grads"].items():
            key = (c["pipe"], name)
            summed[key] = summed.get(key, 0) + g
    for (stage, name), g in summed.items():
        close(g, _want_leaf(ref, name, stage, 2), rtol=1e-4, atol=1e-4)


def test_pp_full_train_step(results):
    """A multimodal train step's loss with the LLM as a 2-stage GPipe,
    against the unpipelined step; the towers', projectors' and embedding's
    gradients (replicated over 'pipe') whole and equal on every rank."""
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.train.step import TrainConfig, loss_fn
    from torch_mesh_util import _fresh, _tree_leaves

    ranks, _ = results
    cfg, batch = _train_batch()
    params = _fresh(vita.init_params(cfg, torch.Generator().manual_seed(0)))
    loss, _ = loss_fn(params, cfg, batch, TrainConfig().aux_loss_coef)
    loss.backward()
    ref = {k: leaf.grad for k, leaf in _tree_leaves(params) if leaf.grad is not None}
    for r in ranks:
        got = r["train"]
        assert np.isfinite(float(got["loss"]))
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=5e-3)
        assert any(k.startswith("vision/") for k in got["grads"])
        assert any(k.startswith("audio_proj/") for k in got["grads"])
        for name, g in got["grads"].items():
            close(g, ref[name], atol=1e-5, rtol=1e-4)
            np.testing.assert_array_equal(g, ranks[0]["train"]["grads"][name])


def test_pp_errors(results):
    """The pipe path's ValueErrors (JAX's, whose messages the port keeps)."""
    ranks, _ = results
    got = ranks[0]["errors"]
    assert "mesh" in got["no_mesh"]
    assert "pipe axis size 4 != pipe_stages 3" in got["stages"]
    for name in ("cache", "gather", "unstacked"):
        assert "cacheless" in got[name]
    assert "gmm" in got["gmm"]
    assert "no 'pipe' axis" in got["no_pipe_axis"]
    assert "batch 3 not divisible by microbatches 2" in got["batch"]
    assert "not divisible by pipe_stages=4" in got["reshape"]
    assert "wave count" in got["waves"]
    assert "pipe axis size 4 != pipe_stages 1" in got["engine_mesh"]
    assert all(r["errors"] == got for r in ranks)
    # JAX raises for the same inputs
    jcfg = _j_cfg()
    jp = j_mix.init_params(jax.random.PRNGKey(0), jcfg)
    ids = jnp.zeros((4, 24), jnp.int32)
    with pytest.raises(ValueError, match="mesh"):
        j_mix.forward(jp, dataclasses.replace(jcfg, pipe_stages=4), input_ids=ids)
    mesh = j_make_mesh(shape=(1, 1, 1, 1, 4), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="cacheless"):
        j_mix.forward(jp, dataclasses.replace(jcfg, pipe_stages=4), input_ids=ids, mesh=mesh,
                      cache=j_mix.init_kv_cache(jcfg, batch=4, max_len=32))


@pytest.mark.parametrize("name,s,max_len,n_new,mode", [
    ("decode4", 4, 32, 5, "dense"), ("decode2_gather", 2, 16, 4, "gather")])
def test_pp_decode_greedy_matches_sequential(results, inputs, name, s, max_len, n_new, mode):
    """The ring decode from the unpipelined prefill's caches, chained
    twice: tokens equal JAX's pipelined decode and the port's greedy
    loop; the vocabulary split over 'pipe' (V/S rows a rank)."""
    ranks, jx = results
    cfg = dataclasses.replace(_t_cfg(), moe_mode=mode)
    params = from_jax_params(inputs["jparams"], cfg)
    prompts = inputs["decode4" if s == 4 else "decode2"]
    seq = _port_sequential(params, cfg, prompts, max_len, 2 * n_new)
    j1, j2 = jx[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_array_equal(got["first"], seq[:, 0])
        np.testing.assert_array_equal(got["toks1"], j1)
        np.testing.assert_array_equal(got["toks2"], j2)
        np.testing.assert_array_equal(got["toks1"], seq[:, 1:n_new + 1])
        np.testing.assert_array_equal(got["toks2"], seq[:, n_new + 1:])
        assert got["pos"].min() == prompts.shape[2] + 2 * n_new
        assert got["vocab_rows"] == cfg.vocab_size // s


def test_pp_generate_end_to_end_matches_sequential(results, inputs):
    ranks, jx = results
    cfg = _t_cfg()
    params = from_jax_params(inputs["jparams"], cfg)
    seq = _port_sequential(params, cfg, inputs["generate2"], 16, 5)
    for r in ranks:
        np.testing.assert_array_equal(r["generate2"], jx["generate2"])
        np.testing.assert_array_equal(r["generate2"], seq)


def test_unstack_layers_forward_matches(inputs):
    """unstack_layers gives per-layer trees (views) that forward takes in
    place of the stacked layers: the same logits as the stacked forward
    and as JAX's forward over its own unstacked layers."""
    cfg = _t_cfg()
    params = from_jax_params(inputs["jparams"], cfg)
    ids = t(inputs["ids"]).long()
    un = mixtral.unstack_layers(params)
    assert len(un["layers"]) == cfg.n_layers
    assert un["layers"][1]["attn"]["wq"].data_ptr() == params["layers"]["attn"]["wq"][1].data_ptr()
    with torch.no_grad():
        want, _, aux = mixtral.forward(params, cfg, input_ids=ids)
        got, _, aux_un = mixtral.forward(un, cfg, input_ids=ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert float(aux_un) == float(aux)
    jp = j_mix.unstack_layers(inputs["jparams"])
    j_logits, _, _ = j_mix.forward(jp, _j_cfg(), input_ids=jnp.asarray(inputs["ids"]))
    close(got, np.asarray(j_logits), rtol=2e-4, atol=2e-4)
