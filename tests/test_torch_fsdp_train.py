"""PyTorch port: sharded training over the mesh's data, fsdp, pipe and seq
axes (parallel/fsdp.py, the train step under a training mesh,
Trainer(mesh=), the train CLI's --mesh) on gloo ranks, against the JAX
package's sharded step on its 8-device CPU mesh and the port's unsharded
step, on ``VITAConfig.tiny()`` with the same weights and global batches.

- The specs (``vita.param_specs`` with the towers' and projectors') equal
  the JAX package's PartitionSpecs, for the tiny and the 8x7B configs,
  with and without a pipe lead.
- The stage-local gradient clip under a pipe mesh (C4): pipe 2 with one
  microbatch, grad_clip 1e-3 (every step clips) and the default, two
  updates: every leaf replicated over 'pipe' bitwise equal on both
  stages, every leaf within tolerance of JAX's pipe-2 step and of the
  port's unsharded step.
- The sharded step at (1,4,1,1), (2,2,1,1), (1,2,1,1,2) (2 microbatches)
  and (1,2,1,1,1,2) (flash, the ring), two updates (the first at lr 0,
  as warmup 1 gives it): the metrics within 1e-5 relative (tokens exact)
  and each rank's blocks within tolerance of JAX's sharded step's
  leaves; the same blocks against the port's unsharded step, except under
  pipe with 2 microbatches, whose aux loss is the microbatches' mean (the
  JAX package's GPipe deviation): pipe there runs with one microbatch
  too. gmm MoE at (1,4,1,1) against the port's unsharded gmm step. The
  blocks of every leaf are bitwise equal on the ranks that hold the same
  block.
- ``test_pp_full_train_step``'s multimodal batch at (1,2,1,1,2) (one
  microbatch a rank's row): the loss against the unsharded step's and
  JAX's, the blocks against the unsharded step's.
- Trainer(mesh=) at (2,2,1,1): four steps straight against two steps, a
  save and two resumed steps, bitwise; rank 0 alone prints and writes
  metrics.jsonl. The train CLI under 4 ranks (--mesh 1 4 1 1 --device cpu
  --dist-backend gloo): its losses against the unsharded CLI's, and a
  second run resumes.
- What a training mesh refuses: a batch that does not divide. The
  capacity, sort and moe_chunk modes under fsdp 2 and a Trainer over
  model 2 or expert 2 (refused until they were ported) give the
  unsharded step's loss and metrics; tests/test_torch_tp_train.py holds
  them in full.
- ``load_vita_checkpoint(dir, mesh=, training=True)``: each rank's
  blocks of a native and an HF-layout directory, bitwise.

Tolerances, float32: the loss 1e-5 relative; parameters rtol = atol =
1e-4 against JAX and against the unsharded step, the port's float32
Adam tolerance (tests/test_torch_train.py: Adam's update m / (sqrt(nu) +
1e-8) is ill-conditioned where a gradient is at the level of float32
rounding, and sums taken in another order move such an update by a few
1e-3 of the rate: here one element in 10^4 moves by 1e-6 to 2e-5).

One group of 4 ranks runs every case (the 2-rank meshes as two
replicas), in a thread while this process computes JAX's side."""

import concurrent.futures
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_fsdp_util as u
from test_torch_pipeline import _train_batch
from test_torch_train import _chat
from torch_mesh_util import _fresh
from vita_tpu.models import vita as j_vita
from vita_tpu.parallel.mesh import make_mesh as j_make_mesh
from vita_tpu.train import step as j_step
from vita_tpu_torch import checkpoint
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.parallel.mesh import AXES
from vita_tpu_torch.train import step

WORLD = 4
TOL = dict(atol=1e-4, rtol=1e-4)
# name: (mesh, microbatches, JAX's step to hold it to)
MESHES = {
    "fsdp4": ((1, 4, 1, 1), 1, True),
    "dp2_fsdp2": ((2, 2, 1, 1), 1, True),
    "pipe2_fsdp2": ((1, 2, 1, 1, 2), 2, True),
    "pipe2_fsdp2_m1": ((1, 2, 1, 1, 2), 1, False),
    "seq2_fsdp2": ((1, 2, 1, 1, 1, 2), 1, True),
}
C4 = (1, 1, 1, 1, 2)
# the capacity modes and moe_chunk over split tokens (refused until their
# drops and chunks were taken over the whole batch's token order)
REFUSE_MESH = (1, 2, 1, 1)
WHOLE_BATCH_MODES = (("capacity", 0), ("sort", 0), ("dense", 4))


def _tc(**kw):
    """Stage 2 with a short warmup and large rates, so that the second
    update moves every trainable weight."""
    return dataclasses.replace(step.TrainConfig.stage2_finetune(), warmup_steps=1,
                               total_steps=10, learning_rate=1e-2, projector_lr=3e-2,
                               weight_decay=0.01, **kw)


def _media_batch(cfg, seed, b=4, s=40, frames=60):
    """Four rows, each one image tile and one audio clip; rows 1 and 3
    padded."""
    from vita_tpu_torch.tokenization import AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX
    from vita_tpu_torch.tokenization import audio_token_count

    rng = np.random.default_rng(seed)
    n_img, n_aud = cfg.image_tokens_per_group, audio_token_count(frames)
    ids = rng.integers(3, cfg.llm.vocab_size, (b, s)).astype(np.int32)
    ids[:, 2:2 + n_img] = IMAGE_TOKEN_INDEX
    ids[:, 3 + n_img:3 + n_img + n_aud] = AUDIO_TOKEN_INDEX
    im, am = ids == IMAGE_TOKEN_INDEX, ids == AUDIO_TOKEN_INDEX
    valid = np.ones((b, s), bool)
    valid[1, s - 7:] = False
    valid[3, s - 12:] = False
    labels = np.where(im | am | ~valid, -100, ids).astype(np.int32)
    labels[:, :4] = -100
    sz = cfg.vision.image_size
    return {
        "input_ids": np.where(im | am, 0, ids).astype(np.int32), "labels": labels,
        "image_mask": im, "audio_mask": am, "attn_valid": valid,
        "images": rng.standard_normal((b, sz, sz, 3)).astype(np.float32),
        "speech": rng.standard_normal((b, frames, 80)).astype(np.float32),
        "speech_lengths": np.array([frames, frames - 9, frames, frames - 4], np.int32)[:b],
    }


def _pp_batch(cfg):
    """test_pp_full_train_step's batch (tests/torch_pipe_util's), as numpy."""
    return {k: v.numpy() for k, v in _train_batch()[1].items()}


def _with_llm(cfg, **kw):
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **kw))


def _mesh_cfg(cfg, mesh, micro):
    shape = tuple(mesh) + (1,) * (6 - len(mesh))
    if shape[4] > 1:
        cfg = _with_llm(cfg, pipe_stages=shape[4], pipe_microbatches=micro)
    if shape[5] > 1:
        cfg = _with_llm(cfg, attn_backend="flash")
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_vita.VITAConfig.tiny()
    jp = jax.device_get(jax.jit(j_vita.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tcfg = vita.VITAConfig.tiny()
    tmp = tmp_path_factory.mktemp("fsdp_train")
    tp = from_jax_params(jp, tcfg)
    checkpoint.save_vita_checkpoint(str(tmp / "native"), tcfg, tp)
    checkpoint.export_hf_vita_checkpoint(str(tmp / "hf"), tcfg, tp)
    return {"jcfg": jcfg, "jp": jp, "tcfg": tcfg, "tp": tp,
            "batches": [_media_batch(tcfg, seed) for seed in range(2)],
            "pp_batch": _pp_batch(tcfg), "chat": str(_chat(tmp, n=4)), "tmp": tmp,
            "native": str(tmp / "native"), "hf": str(tmp / "hf")}


def _cases(x):
    tcfg, tmp = x["tcfg"], x["tmp"]
    shared = {"p": x["tp"], "cfg": tcfg, "gmm": _with_llm(tcfg, moe_mode="gmm"), "tc": _tc(),
              "tc_clip": _tc(grad_clip=1e-3), "b": x["batches"], "ppb": [x["pp_batch"]] * 2}
    cases = [(name, "train_steps_case", dict(mesh=mesh, params="@p", cfg="@cfg", tc="@tc",
                                             batches="@b", micro=micro))
             for name, (mesh, micro, _) in MESHES.items()]
    cases += [
        ("fsdp4_gmm", "train_steps_case", dict(mesh=(1, 4, 1, 1), params="@p", cfg="@gmm",
                                                tc="@tc", batches="@b", micro=1)),
        ("c4_clip", "train_steps_case", dict(mesh=C4, params="@p", cfg="@cfg", tc="@tc_clip",
                                             batches="@b", micro=1)),
        ("c4_default", "train_steps_case", dict(mesh=C4, params="@p", cfg="@cfg", tc="@tc",
                                                batches="@b", micro=1)),
        ("pp_batch", "train_steps_case", dict(mesh=(1, 2, 1, 1, 2), params="@p", cfg="@cfg",
                                              tc="@tc", batches="@ppb", micro=1)),
        ("refuse", "refusals_case", dict(mesh=REFUSE_MESH, params="@p", cfg="@cfg",
                                         batch=x["batches"][0])),
        ("refuse_model", "tp_trainer_case", dict(mesh=(1, 1, 1, 2), params="@p", cfg="@cfg",
                                                  tc="@tc", batch=x["batches"][0])),
        ("refuse_expert", "tp_trainer_case", dict(mesh=(1, 1, 2, 1), params="@p", cfg="@cfg",
                                                   tc="@tc", batch=x["batches"][0])),
        ("trainer_straight", "trainer_case",
         dict(mesh=(2, 2, 1, 1), params="@p", cfg="@cfg", tc="@tc", data=x["chat"],
              out=str(tmp / "straight"), runs=[(2, True)])),
        ("trainer_resumed", "trainer_case",
         dict(mesh=(2, 2, 1, 1), params="@p", cfg="@cfg", tc="@tc", data=x["chat"],
              out=str(tmp / "resumed"), runs=[(1, True), (2, True)])),
    ]
    cli = ["--model", "tiny-random", "--data", x["chat"], "--output-dir", str(tmp / "cli"),
           "--batch-size", "4", "--device", "cpu", "--mesh", "1", "4", "1", "1",
           "--dist-backend", "gloo"]
    cases += [("cli1", "cli_case", dict(argv=cli)), ("cli2", "cli_case", dict(argv=cli)),
              ("ckpt", "checkpoint_case", dict(mesh=(1, 2, 1, 1, 2), native=x["native"],
                                               hf=x["hf"]))]
    return cases, shared


def _j_steps(x, mesh_shape, cfg, tc, batches):
    """JAX's jitted make_train_step on params placed by vita.param_specs
    and batches under P(('data', 'fsdp')): (metrics, params) after each
    update."""
    mesh, params = _j_placed(x, mesh_shape, cfg)
    jtc = j_step.TrainConfig(**dataclasses.asdict(tc))
    opt = j_step.make_optimizer(jtc, params)
    state = opt.init(params)
    fn = jax.jit(j_step.make_train_step(cfg, jtc, opt, mesh=mesh))
    out = []
    for b in batches:
        params, state, m = fn(params, state, _j_batch(mesh, b))
        out.append(({k: float(v) for k, v in m.items()}, _flat_np(jax.device_get(params))))
    return out


def _j_placed(x, mesh_shape, cfg):
    """JAX's mesh of ``mesh_shape`` and the params placed on it by
    vita.param_specs."""
    mesh = j_make_mesh(shape=mesh_shape, devices=jax.devices()[:math.prod(mesh_shape)])
    specs = j_vita.param_specs(cfg)
    return mesh, jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), x["jp"],
                              specs)


def _j_batch(mesh, b):
    bsz = b["input_ids"].shape[0]
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P(("data", "fsdp")) if v.shape[0] == bsz else P())) for k, v in b.items()}


def _j_loss(x, mesh_shape, cfg, batch):
    """JAX's jitted loss_fn (aux coefficient 0.02) over the mesh, as
    _j_steps places params and batch: the loss."""
    mesh, params = _j_placed(x, mesh_shape, cfg)
    fn = jax.jit(lambda p, b: j_step.loss_fn(p, cfg, b, 0.02, mesh=mesh)[0])
    return float(fn(params, _j_batch(mesh, batch)))


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _port_steps(params, cfg, tc, batches):
    """The port's unsharded step: (metrics, params) after each update."""
    params = _fresh(params)
    opt = step.make_optimizer(tc, params)
    state = opt.init(params)
    fn = step.make_train_step(cfg, tc, opt)
    out = []
    for b in batches:
        params, state, m = fn(params, state, b)
        out.append(({k: float(v) for k, v in m.items()}, u._flat(params)))
    return out


def _jax_side(x):
    jcfg, tc = x["jcfg"], _tc()
    out = {}
    for name, (mesh, micro, with_jax) in MESHES.items():
        if with_jax:
            out[name] = _j_steps(x, mesh, _mesh_cfg(jcfg, mesh, micro), tc, x["batches"])
    out["c4_clip"] = _j_steps(x, C4, _mesh_cfg(jcfg, C4, 1), _tc(grad_clip=1e-3), x["batches"])
    mesh = (1, 2, 1, 1, 2)
    out["pp_batch"] = _j_steps(x, mesh, _mesh_cfg(jcfg, mesh, 1), tc, [x["pp_batch"]] * 2)
    for mode, chunk in WHOLE_BATCH_MODES:
        out[f"loss_{mode}_{chunk}"] = _j_loss(
            x, REFUSE_MESH, _with_llm(jcfg, moe_mode=mode, moe_chunk=chunk), x["batches"][0])
    return out


@pytest.fixture(scope="module")
def results(setup, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("fsdp_ranks"))
    cases, shared = _cases(setup)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, WORLD, cases, shared, threads=1,
                            timeout=900, store_dir=store)
        jax_out = _jax_side(setup)
        tcfg, tp = setup["tcfg"], setup["tp"]
        port = {"dense": _port_steps(tp, tcfg, _tc(), setup["batches"]),
                "gmm": _port_steps(tp, _with_llm(tcfg, moe_mode="gmm"), _tc(), setup["batches"]),
                "clip": _port_steps(tp, tcfg, _tc(grad_clip=1e-3), setup["batches"]),
                "pp_batch": _port_steps(tp, tcfg, _tc(), [setup["pp_batch"]] * 2)}
        return ranks.result(), jax_out, port


def _leaf_specs(cfg):
    return {"/".join(p): s for p, s in step.tree_leaves(vita.param_specs(cfg))}


def _block(x, spec, coords, sizes):
    """The block of the whole leaf ``x`` at ``coords`` by ``spec``."""
    for dim, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n, r = 1, 0
        for a in names:
            n, r = n * sizes[a], r * sizes[a] + coords[a]
        if n > 1:
            size = x.shape[dim] // n
            x = np.take(x, np.arange(r * size, (r + 1) * size), axis=dim)
    return x


def _sizes(mesh):
    return dict(zip(AXES, tuple(mesh) + (1,) * (6 - len(mesh))))


def _check_blocks(ranks, name, mesh, cfg, want, tol=TOL):
    """Every rank's blocks after each update against the whole leaves of
    ``want`` [(metrics, leaves)], and bitwise equal on the ranks that hold
    the same block."""
    sizes, specs = _sizes(mesh), _leaf_specs(cfg)
    held = {}
    for r in ranks:
        got = r[name]
        for i, blocks in enumerate(got["blocks"]):
            for leaf, b in blocks.items():
                np.testing.assert_allclose(
                    b, _block(want[i][1][leaf], specs[leaf], got["coords"], sizes),
                    err_msg=f"{name} {leaf} update {i + 1} at {got['coords']}", **tol)
                split = [a for e in specs[leaf] if e is not None
                         for a in ((e,) if isinstance(e, str) else e) if sizes[a] > 1]
                key = (i, leaf, tuple(got["coords"][a] for a in split))
                if key in held:
                    np.testing.assert_array_equal(b, held[key], err_msg=f"{name} {key}")
                held[key] = b


def _check_metrics(ranks, name, want, rtol=1e-5):
    for r in ranks:
        for got, (w, _) in zip(r[name]["metrics"], want):
            for k in ("loss", "ce", "aux"):
                np.testing.assert_allclose(got[k], w[k], rtol=rtol, err_msg=f"{name} {k}")
            assert got["tokens"] == w["tokens"]


def _t_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, P))


@pytest.mark.parametrize("size", ["tiny", "vita_8x7b"])
@pytest.mark.parametrize("pipe", [1, 2])
def test_param_specs_equal_jax(size, pipe):
    jcfg, tcfg = getattr(j_vita.VITAConfig, size)(), getattr(vita.VITAConfig, size)()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, pipe_stages=pipe))
    tcfg = _with_llm(tcfg, pipe_stages=pipe)
    assert vita.param_specs(tcfg) == _t_tuples(j_vita.param_specs(jcfg))


def test_param_specs_replicate_alternative_towers_and_projectors():
    """A tower without specs of its own (CLIP) and a variant projector
    replicate every leaf, as the JAX package's eval_shape does."""
    kw = dict(vision_tower="clip", vision_projector="mlp3x_gelu")
    from vita_tpu.models import clip as j_clip
    from vita_tpu_torch.models import clip

    jcfg = dataclasses.replace(j_vita.VITAConfig.tiny(), vision=j_clip.CLIPConfig.tiny(), **kw)
    tcfg = dataclasses.replace(vita.VITAConfig.tiny(), vision=clip.CLIPConfig.tiny(), **kw)
    got, want = vita.param_specs(tcfg), _t_tuples(j_vita.param_specs(jcfg))
    assert got == want
    assert all(s == () for _, s in step.tree_leaves({k: got[k] for k in ("vision",
                                                                          "vision_proj")}))


@pytest.mark.parametrize("name", ["c4_clip", "c4_default"])
def test_pipe_clip_is_global(results, setup, name):
    """C4: under pipe 2 every rank clips by the norm of the whole
    gradient, so the leaves replicated over 'pipe' stay bitwise equal on
    both stages and every leaf is JAX's pipe step's and the unsharded
    step's."""
    ranks, jx, port = results
    cfg = _mesh_cfg(setup["tcfg"], C4, 1)
    if name in jx:
        _check_metrics(ranks, name, jx[name])
        _check_blocks(ranks, name, C4, cfg, jx[name])
    ref = port["clip" if name == "c4_clip" else "dense"]
    _check_metrics(ranks, name, ref)
    _check_blocks(ranks, name, C4, cfg, ref)
    specs = _leaf_specs(cfg)
    for i in range(2):
        for leaf, spec in specs.items():
            if "pipe" not in spec:
                stage = {r[name]["coords"]["pipe"]: r[name]["blocks"][i][leaf] for r in ranks[:2]}
                np.testing.assert_array_equal(stage[0], stage[1], err_msg=leaf)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_jax(results, setup, name):
    """Two updates over the mesh: the metrics and each rank's blocks
    against JAX's sharded step and the port's unsharded step."""
    ranks, jx, port = results
    mesh, micro, with_jax = MESHES[name]
    cfg = _mesh_cfg(setup["tcfg"], mesh, micro)
    if with_jax:
        _check_metrics(ranks, name, jx[name])
        _check_blocks(ranks, name, mesh, cfg, jx[name])
    if micro == 1:
        _check_metrics(ranks, name, port["dense"])
        _check_blocks(ranks, name, mesh, cfg, port["dense"])
    moved = [leaf for leaf, b in ranks[0][name]["blocks"][1].items()
             if not np.array_equal(b, ranks[0][name]["blocks"][0][leaf])]
    assert len(moved) == 23  # the LLM's 13 leaves, the projectors' 4 + 6


def test_sharded_gmm_step_matches_unsharded(results, setup):
    ranks, _, port = results
    cfg = _with_llm(setup["tcfg"], moe_mode="gmm")
    _check_metrics(ranks, "fsdp4_gmm", port["gmm"])
    _check_blocks(ranks, "fsdp4_gmm", (1, 4, 1, 1), cfg, port["gmm"])


def test_pp_full_train_step_batch(results, setup):
    """test_pp_full_train_step's multimodal batch at (1,2,1,1,2): the loss
    against JAX's sharded step and the port's unsharded one (its model
    axis of 2 waits for tensor-parallel training)."""
    ranks, jx, port = results
    cfg = _mesh_cfg(setup["tcfg"], (1, 2, 1, 1, 2), 1)
    _check_metrics(ranks, "pp_batch", jx["pp_batch"])
    _check_metrics(ranks, "pp_batch", port["pp_batch"])
    _check_blocks(ranks, "pp_batch", (1, 2, 1, 1, 2), cfg, port["pp_batch"])


def test_training_refusals(results, setup):
    """What a training mesh refuses: a batch that does not divide. The
    capacity and sort modes and moe_chunk under fsdp 2 (refused until
    their drops and chunks were taken over the whole batch's token order)
    give the loss of JAX's sharded loss_fn on the same mesh and the
    unsharded loss, and a Trainer over model 2 or expert 2 steps as the
    unsharded step does."""
    ranks, jx, port = results
    batch = step.batch_to(setup["batches"][0], "cpu")
    for mode, chunk in WHOLE_BATCH_MODES:
        c = _with_llm(setup["tcfg"], moe_mode=mode, moe_chunk=chunk)
        want = float(step.loss_fn(setup["tp"], c, batch, 0.02)[1]["loss"])
        np.testing.assert_allclose(jx[f"loss_{mode}_{chunk}"], want, rtol=1e-5,
                                   err_msg=f"JAX {mode}_{chunk}")
        for r in ranks:
            np.testing.assert_allclose(float(r["refuse"][f"{mode}_{chunk}"]), want, rtol=1e-5,
                                       err_msg=f"{mode}_{chunk}")
    for r in ranks:
        got = r["refuse"]
        assert got["odd_batch"].startswith("ValueError") and "does not divide" in got["odd_batch"]
        for key in ("refuse_model", "refuse_expert"):
            for k in ("loss", "ce", "aux"):
                np.testing.assert_allclose(r[key][k], port["dense"][0][0][k], rtol=1e-5,
                                           err_msg=f"{key} {k}")
            assert r[key]["tokens"] == port["dense"][0][0]["tokens"]


def test_trainer_resumes_bitwise_on_its_mesh(results):
    """Four steps straight against two, a save and two resumed: every
    rank's blocks and Adam moments bitwise; rank 0 alone prints; each
    step_N holds every rank's blocks."""
    ranks, _, _ = results
    for i, r in enumerate(ranks):
        straight = r["trainer_straight"]["runs"][0]
        first, resumed = r["trainer_resumed"]["runs"]
        assert straight["step"] == resumed["step"] == 4 and first["step"] == 2
        assert [m["step"] for m in resumed["log"]] == [3, 4]
        for a, b in zip(straight["log"][2:], resumed["log"]):
            assert a["loss"] == b["loss"]
        for leaf, b in straight["blocks"].items():
            np.testing.assert_array_equal(resumed["blocks"][leaf], b, err_msg=leaf)
        for k, v in straight["mu"].items():
            np.testing.assert_array_equal(resumed["mu"][k], v, err_msg=k)
        assert ("resumed from step 2" in resumed["printed"]) == (i == 0)
        assert ("[step 4]" in straight["printed"]) == (i == 0)
        assert r["trainer_resumed"]["files"] == ["step_2", "step_4"]


def test_trainer_checkpoint_layout(results, setup):
    """One metrics.jsonl line a step (rank 0's); a rank file a rank and
    the mesh's shape in every step_N."""
    out = setup["tmp"] / "resumed"
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4]
    step4 = out / "ckpt" / "step_4"
    assert sorted(os.listdir(step4)) == ["mesh.json"] + [f"rank_{i}.pt" for i in range(4)]
    assert json.loads((step4 / "mesh.json").read_text())["mesh"] == [2, 2, 1, 1, 1, 1]


def test_train_cli_over_four_ranks(results, setup, tmp_path, capsys):
    """--mesh 1 4 1 1 on 4 gloo ranks: every rank exits 0, rank 0 prints
    the steps, their losses are the unsharded CLI's, and a second run
    resumes."""
    from vita_tpu_torch.train import cli

    ranks, _, _ = results
    argv = ["--model", "tiny-random", "--data", setup["chat"], "--output-dir",
            str(tmp_path / "one"), "--batch-size", "4", "--device", "cpu"]
    assert cli.main(argv) == 0
    want = [float(line.split("loss=")[1].split()[0]) for line in
            capsys.readouterr().out.splitlines() if line.startswith("[step")]
    assert len(want) == 2
    for i, r in enumerate(ranks):
        assert r["cli1"]["rc"] == r["cli2"]["rc"] == 0
        got = [float(line.split("loss=")[1].split()[0]) for line in
               r["cli1"]["out"].splitlines() if line.startswith("[step")]
        if i == 0:  # printed to 4 decimals
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        else:
            assert got == []
        assert ("resumed from step 2" in r["cli2"]["out"]) == (i == 0)
    lines = (setup["tmp"] / "cli" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]


def test_checkpoint_loads_training_blocks(results, setup):
    """``--model <dir>`` under a training mesh: load_vita_checkpoint(dir,
    mesh=, training=True) gives each rank its blocks of every component
    by vita.param_specs (the layers led by 'pipe'), bitwise those of the
    same directory loaded whole, for the native and the HF layout."""
    ranks, _, _ = results
    mesh = (1, 2, 1, 1, 2)
    sizes = _sizes(mesh)
    for layout in ("native", "hf"):
        cfg, params = checkpoint.load_vita_checkpoint(setup[layout], "cpu")
        specs = _leaf_specs(_mesh_cfg(cfg, mesh, 1))
        whole = {n: w.float().numpy() for n, w in u._flat(params).items()}
        for r in ranks:
            got = r["ckpt"]
            assert set(got[layout]) == set(whole)
            for leaf, b in got[layout].items():
                np.testing.assert_array_equal(
                    b, _block(whole[leaf], specs[leaf], got["coords"], sizes),
                    err_msg=f"{layout} {leaf}")
