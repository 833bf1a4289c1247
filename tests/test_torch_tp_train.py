"""PyTorch port: tensor- and expert-parallel training (the mesh's 'model'
and 'expert' axes in the train step, Trainer(mesh=), resume on another
mesh and the train CLI's --mesh) on gloo ranks, against the JAX
package's sharded step on its 8-device CPU mesh and the port's unsharded
step, on ``VITAConfig.tiny()`` (4 q / 2 kv heads, 4 experts) with the
same weights and global batches (tests/test_torch_fsdp_train.py's).

- Three updates (the first at lr 0, as warmup 1 gives it) under (1,1,2,2),
  (1,2,1,2), (2,1,2,1) and (1,1,4,1) with dense MoE and the xla
  attention, (1,1,1,2,2) (pipe x model, one microbatch) and
  (1,1,1,2,1,2) (model x seq, the ring on each rank's heads): each
  step's metrics within 1e-5 relative (tokens exact) and each rank's
  blocks after every update within tolerance of JAX's sharded step's
  leaves and of the port's unsharded step's. gmm MoE with flash attention
  under (1,1,2,2) against the port's unsharded gmm step. Every leaf's
  blocks are bitwise equal on the ranks that hold the same block, so a
  leaf replicated over 'model' or 'expert' is bitwise equal across each
  model x expert group.
- gmm MoE with flash attention under (1,1,2,2) is also held to JAX's
  unsharded gmm step (xla attention, as the port's unsharded gmm step) in
  Pallas interpret mode (what the TPU kernels compute): GSPMD cannot
  partition an interpret-mode Pallas call and shard_map refuses one, and
  JAX's sharded step is its unsharded step's function.
- The capacity mode with moe_chunk under (1,2,1,1) and the sort mode
  under (1,1,2,1,1,2): drops and chunks over the whole batch's token
  order, two updates (one at a rate above 0, where
  tests/test_torch_fsdp_train.py's 1e-4 holds) against JAX's sharded step
  on the same mesh (GSPMD takes the capacity and the chunks over the
  global token order) and the port's unsharded step.
- The clip: grad_clip 1e-3 (every step clips) under (1,1,2,2) against
  JAX's step and the unsharded one; with the global norm's old axis set
  ('fsdp', 'pipe') planted back the same check fails.
- Resume on another mesh: a Trainer saves under (1,2,1,1) after two
  steps; a Trainer under (1,1,2,2) and one without a mesh resume from it.
  The params and Adam moments they resume with are the saved blocks put
  together, bitwise; the next two steps are those of an uninterrupted run
  under (1,2,1,1).
- The train CLI with --mesh 1 1 2 2 --device cpu --dist-backend gloo on
  4 ranks: every rank exits 0 and rank 0's losses are the unsharded
  CLI's.

Tolerances, float32, as tests/test_torch_fsdp_train.py states them: the
loss 1e-5 relative, parameters rtol = atol = 1e-4 against the port's
unsharded step (Adam's update moves a weight whose gradient is at
rounding level by a few 1e-3 of the rate when sums are taken in another
order). Against JAX's step 2e-4: that file's 1e-4 holds one update at a
learning rate above 0, and three updates here make two; the port's
unsharded step itself is up to 1.2e-4 from JAX's sharded one after them
(on a few elements of (1,1,4,1)'s vision_proj/fc1_w, at rate 3e-2),
while each mesh stays within 1.2e-5 of the port's unsharded step.

One group of 4 ranks runs every case (the 2-rank meshes as two
replicas), in a thread while this process computes JAX's side."""

import concurrent.futures
import functools
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_fsdp_util as u
from test_torch_fsdp_train import (
    TOL,
    _block,
    _check_blocks,
    _check_metrics,
    _j_steps,
    _leaf_specs,
    _media_batch,
    _mesh_cfg,
    _port_steps,
    _sizes,
    _tc,
    _with_llm,
)
from test_torch_train import _chat
from torch_mesh_util import _fresh
from vita_tpu.models import vita as j_vita
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.parallel.mesh import AXES

WORLD = 4
JAX_TOL = dict(atol=2e-4, rtol=2e-4)
# name: (mesh, the LLM's overrides, the port's unsharded step to hold it to)
MESHES = {
    "ep2_tp2": ((1, 1, 2, 2), {}, "dense"),
    "fsdp2_tp2": ((1, 2, 1, 2), {}, "dense"),
    "dp2_ep2": ((2, 1, 2, 1), {}, "dense"),
    "ep4": ((1, 1, 4, 1), {}, "dense"),
    "pipe2_tp2": ((1, 1, 1, 2, 2), {}, "dense"),
    "tp2_seq2": ((1, 1, 1, 2, 1, 2), {}, "dense"),
}
GMM = ((1, 1, 2, 2), dict(moe_mode="gmm", attn_backend="flash"))
# the capacity modes and moe_chunk over tokens split between ranks: name:
# (mesh, the LLM's overrides), against the port's unsharded step with the
# same overrides (tests/test_torch_moe_backward.py holds the unsharded
# modes and chunks to JAX's, tests/test_torch_ring_attention.py the
# seq-parallel capacity and sort modes)
WHOLE_BATCH = {
    "fsdp2_capacity_chunk": ((1, 2, 1, 1), dict(moe_mode="capacity", moe_chunk=40)),
    "ep2_seq2_sort": ((1, 1, 2, 1, 1, 2), dict(moe_mode="sort")),
}
CLIP = (1, 1, 2, 2)
SAVE_MESH, RESUME_MESH = (1, 2, 1, 1), (1, 1, 2, 2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_vita.VITAConfig.tiny()
    jp = jax.device_get(jax.jit(j_vita.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tcfg = vita.VITAConfig.tiny()
    tmp = tmp_path_factory.mktemp("tp_train")
    return {"jcfg": jcfg, "jp": jp, "tcfg": tcfg, "tp": from_jax_params(jp, tcfg),
            "batches": [_media_batch(tcfg, seed) for seed in range(3)],
            "chat": str(_chat(tmp, n=4)), "tmp": tmp}


def _cases(x):
    tcfg, tmp = x["tcfg"], x["tmp"]
    shared = {"p": x["tp"], "cfg": tcfg, "gmm": _with_llm(tcfg, **GMM[1]), "tc": _tc(),
              "tc_clip": _tc(grad_clip=1e-3), "b": x["batches"]}
    steps = lambda mesh, cfg="@cfg", tc="@tc": dict(  # noqa: E731
        mesh=mesh, params="@p", cfg=cfg, tc=tc, batches="@b", micro=1)
    cases = [(name, "train_steps_case", steps(mesh)) for name, (mesh, _, _) in MESHES.items()]
    shared.update({name: _with_llm(tcfg, **llm) for name, (_, llm) in WHOLE_BATCH.items()})
    shared["b2"] = x["batches"][:2]
    cases += [(name, "train_steps_case", dict(steps(mesh, cfg=f"@{name}"), batches="@b2"))
              for name, (mesh, _) in WHOLE_BATCH.items()]
    cases += [
        ("gmm_flash", "train_steps_case", steps(GMM[0], cfg="@gmm")),
        ("clip", "train_steps_case", steps(CLIP, tc="@tc_clip")),
        ("clip_old_norm", "old_norm_steps_case", steps(CLIP, tc="@tc_clip")),
    ]
    run = dict(params="@p", cfg="@cfg", tc="@tc", data=x["chat"])
    cases += [
        ("saved", "resume_case", dict(mesh=SAVE_MESH, out=str(tmp / "saved"), epochs=1,
                                      save=True, **run)),
        ("straight", "resume_case", dict(mesh=SAVE_MESH, out=str(tmp / "straight"), epochs=2,
                                         save=False, **run)),
        ("resumed", "resume_case", dict(mesh=RESUME_MESH, out=str(tmp / "saved" / "rep0"),
                                        epochs=2, save=False, per_replica=False, **run)),
    ]
    cli = ["--model", "tiny-random", "--data", x["chat"], "--output-dir", str(tmp / "cli"),
           "--batch-size", "4", "--device", "cpu", "--mesh", "1", "1", "2", "2",
           "--dist-backend", "gloo"]
    cases.append(("cli", "cli_case", dict(argv=cli)))
    return cases, shared


def _j_gmm_steps(x, cfg):
    """JAX's unsharded gmm step, its kernels in Pallas interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return _j_steps(x, (1, 1, 1, 1), _with_llm(cfg, moe_mode="gmm"), _tc(), x["batches"])


def _jax_side(x):
    """JAX's steps, two at a time (XLA compiles and runs them without the
    GIL; the interpret-mode switch is thread-local)."""
    jcfg, b = x["jcfg"], x["batches"]
    jobs = {name: functools.partial(_j_steps, x, mesh, _mesh_cfg(jcfg, mesh, 1), _tc(), b)
            for name, (mesh, _, _) in MESHES.items()}
    jobs["clip"] = functools.partial(_j_steps, x, CLIP, jcfg, _tc(grad_clip=1e-3), b)
    for name, (mesh, llm) in WHOLE_BATCH.items():
        jobs[name] = functools.partial(_j_steps, x, mesh, _mesh_cfg(_with_llm(jcfg, **llm), mesh, 1),
                                       _tc(), b[:2])
    jobs["gmm"] = functools.partial(_j_gmm_steps, x, jcfg)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        running = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in running.items()}


@pytest.fixture(scope="module")
def results(setup, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("tp_ranks"))
    cases, shared = _cases(setup)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, WORLD, cases, shared, threads=1,
                            timeout=900, store_dir=store)
        jax_out = _jax_side(setup)
        tcfg, tp, b = setup["tcfg"], setup["tp"], setup["batches"]
        port = {"dense": _port_steps(tp, tcfg, _tc(), b),
                "gmm": _port_steps(tp, _with_llm(tcfg, moe_mode="gmm"), _tc(), b),
                "clip": _port_steps(tp, tcfg, _tc(grad_clip=1e-3), b)}
        port.update({name: _port_steps(tp, _with_llm(tcfg, **llm), _tc(), b[:2])
                     for name, (_, llm) in WHOLE_BATCH.items()})
        return ranks.result(), jax_out, port


def _cfg(setup, mesh, **llm):
    return _mesh_cfg(_with_llm(setup["tcfg"], **llm), mesh, 1)


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_ep_step_matches_jax_and_unsharded(results, setup, name):
    """Three updates over the mesh: the metrics and each rank's blocks
    against JAX's sharded step and the port's unsharded step; blocks
    bitwise equal where ranks hold the same one (replicated leaves across
    each model x expert group)."""
    ranks, jx, port = results
    mesh, llm, ref = MESHES[name]
    cfg = _cfg(setup, mesh, **llm)
    _check_metrics(ranks, name, jx[name])
    _check_blocks(ranks, name, mesh, cfg, jx[name], JAX_TOL)
    _check_metrics(ranks, name, port[ref])
    _check_blocks(ranks, name, mesh, cfg, port[ref])
    moved = [leaf for leaf, b in ranks[0][name]["blocks"][2].items()
             if not np.array_equal(b, ranks[0][name]["blocks"][0][leaf])]
    assert len(moved) == 23  # the LLM's 13 leaves, the projectors' 4 + 6


@pytest.mark.parametrize("name", list(WHOLE_BATCH))
def test_capacity_modes_over_split_tokens(results, setup, name):
    """The capacity mode with moe_chunk under fsdp 2 and the sort mode
    under seq 2 beside expert 2: their drops and chunks are taken over the
    whole batch's token order (each layer's MoE gathers every rank's
    tokens), as JAX's sharded step on the same mesh and the unsharded step
    take them."""
    ranks, jx, port = results
    mesh, llm = WHOLE_BATCH[name]
    cfg = _cfg(setup, mesh, **llm)
    for want in (jx[name], port[name]):
        _check_metrics(ranks, name, want)
        _check_blocks(ranks, name, mesh, cfg, want)


def test_gmm_flash_step_matches_unsharded(results, setup):
    """gmm MoE (every rank's local experts and ffn columns) with flash
    attention on the local heads, under expert 2 x model 2: against the
    port's unsharded gmm step and JAX's (its kernels in interpret mode,
    unsharded; both with the xla attention, the same function as flash)."""
    ranks, jx, port = results
    mesh, llm = GMM
    cfg = _cfg(setup, mesh, **llm)
    _check_metrics(ranks, "gmm_flash", port["gmm"])
    _check_blocks(ranks, "gmm_flash", mesh, cfg, port["gmm"])
    _check_metrics(ranks, "gmm_flash", jx["gmm"])
    _check_blocks(ranks, "gmm_flash", mesh, cfg, jx["gmm"], JAX_TOL)


def test_clip_is_global_over_model_and_expert(results, setup):
    """grad_clip 1e-3 binds at every step: every rank clips by the norm of
    the whole gradient (each leaf's blocks summed over 'model' and
    'expert' too), as JAX's step and the unsharded step do."""
    ranks, jx, port = results
    cfg = _cfg(setup, CLIP)
    for want, tol in ((jx["clip"], JAX_TOL), (port["clip"], TOL)):
        _check_metrics(ranks, "clip", want)
        _check_blocks(ranks, "clip", CLIP, cfg, want, tol)


def test_clip_check_fails_with_the_old_norm_axes(results, setup):
    """The same check on a run whose global norm sums each leaf's blocks
    over ('fsdp', 'pipe') only, as before 'model' and 'expert' were
    trained: each rank clips by its own blocks' norm, and the check
    fails."""
    ranks, _, port = results
    with pytest.raises(AssertionError):
        _check_blocks(ranks, "clip_old_norm", CLIP, _cfg(setup, CLIP), port["clip"])


def _saved_blocks(where):
    """Every saved rank's state in a step_N directory of a mesh checkpoint."""
    files = sorted((f for f in os.listdir(where) if f.startswith("rank_")),
                   key=lambda f: int(f[5:-3]))
    return [torch.load(os.path.join(where, f), map_location="cpu", weights_only=True)
            for f in files]


def _coords(rank, mesh):
    shape = tuple(mesh) + (1,) * (6 - len(mesh))
    return dict(zip(AXES, (int(c) for c in np.unravel_index(rank, shape))))


def _flat_state(state):
    """params by leaf name, then 'mu/<leaf>' and 'nu/<leaf>'."""
    out = {n: w.float().numpy() for n, w in u._flat(state["params"]).items()}
    for m in ("mu", "nu"):  # copies: the Trainer updates its moments in place
        out.update({f"{m}/{k}": v.float().numpy().copy()
                    for k, v in state["opt_state"][m].items()})
    return out


def _unsharded_resume(setup):
    """A Trainer without a mesh on the saved directory: (the state it
    resumed with, whole; its log and params after two epochs)."""
    from vita_tpu_torch.data.dataset import Collator, ConversationDataset, DataArgs, DatasetSpec
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    cfg = setup["tcfg"]
    ds = ConversationDataset([DatasetSpec(setup["chat"])], u.encode, 1, 2, pad_id=0,
                             args=DataArgs(image_size=cfg.vision.image_size, max_patches=1,
                                           use_thumbnail=False))
    run = RunConfig(output_dir=str(setup["tmp"] / "saved" / "rep0"), batch_size=4,
                    num_epochs=2, save_every_steps=10 ** 6, loader_workers=1)
    tr = Trainer(cfg, _tc(), run, _fresh(setup["tp"]))
    loaded = _flat_state({"params": tr.params, "opt_state": tr.opt_state})
    step0 = tr.step
    log = tr.train(ds, Collator(pad_id=0))
    return loaded, step0, log, {n: w.numpy() for n, w in u._flat(tr.params).items()}


def test_resume_on_another_mesh(results, setup):
    """Saved under (1,2,1,1) at step 2; resumed under (1,1,2,2) and without
    a mesh: the state each resumes with is the saved blocks put together
    (every saved rank's block is the unsharded resume's whole leaf cut at
    its coordinates, every (1,1,2,2) rank's block the same whole leaf cut
    at its own), bitwise; the next two steps are the uninterrupted run's."""
    ranks, _, _ = results
    cfg = setup["tcfg"]
    specs = _leaf_specs(cfg)
    spec_of = lambda name: specs[name.split("/", 1)[1] if name[:3] in ("mu/", "nu/")  # noqa
                                 else name]
    whole, step0, log, final = _unsharded_resume(setup)
    assert step0 == 2
    saved = _saved_blocks(setup["tmp"] / "saved" / "rep0" / "ckpt" / "step_2")
    assert len(saved) == 2
    for r, state in enumerate(saved):
        c = _coords(r, SAVE_MESH)
        assert state["step"] == 2
        for name, b in _flat_state(state).items():
            np.testing.assert_array_equal(
                b, _block(whole[name], spec_of(name), c, _sizes(SAVE_MESH)), err_msg=name)
    for r in ranks:
        got = r["resumed"]
        assert got["loaded"]["step"] == 2
        blocks = {**got["loaded"]["blocks"],
                  **{f"{m}/{k}": v for m in ("mu", "nu") for k, v in got["loaded"][m].items()}}
        assert set(blocks) == set(whole)
        for name, b in blocks.items():
            np.testing.assert_array_equal(
                b, _block(whole[name], spec_of(name), got["coords"], _sizes(RESUME_MESH)),
                err_msg=f"resumed {name} at {got['coords']}")
    straight = ranks[0]["straight"]
    assert [m["step"] for m in straight["log"]] == [1, 2, 3, 4]
    want = straight["log"][2:]
    for got_log in [log] + [r["resumed"]["log"] for r in ranks]:
        assert [m["step"] for m in got_log] == [3, 4]
        for a, b in zip(got_log, want):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    sizes = _sizes(SAVE_MESH)
    for r in ranks[:2]:  # replica 0 of the uninterrupted run
        for name, b in r["straight"]["blocks"].items():
            np.testing.assert_allclose(
                b, _block(final[name], specs[name], r["straight"]["coords"], sizes),
                err_msg=name, **TOL)
    for r in ranks:
        for name, b in r["resumed"]["blocks"].items():
            np.testing.assert_allclose(
                b, _block(final[name], specs[name], r["resumed"]["coords"],
                          _sizes(RESUME_MESH)), err_msg=name, **TOL)
    assert "resumed from step 2" in ranks[0]["resumed"]["printed"]
    assert all("resumed" not in r["resumed"]["printed"] for r in ranks[1:])


def test_train_cli_over_expert_and_model(results, setup, tmp_path, capsys):
    """--mesh 1 1 2 2 on 4 gloo ranks: every rank exits 0, rank 0 alone
    prints the steps, and their losses are the unsharded CLI's."""
    from vita_tpu_torch.train import cli

    ranks, _, _ = results
    argv = ["--model", "tiny-random", "--data", setup["chat"], "--output-dir",
            str(tmp_path / "one"), "--batch-size", "4", "--device", "cpu"]
    assert cli.main(argv) == 0
    want = [float(line.split("loss=")[1].split()[0]) for line in
            capsys.readouterr().out.splitlines() if line.startswith("[step")]
    assert len(want) == 2
    for i, r in enumerate(ranks):
        assert r["cli"]["rc"] == 0
        got = [float(line.split("loss=")[1].split()[0]) for line in
               r["cli"]["out"].splitlines() if line.startswith("[step")]
        if i == 0:  # printed to 4 decimals
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        else:
            assert got == []
