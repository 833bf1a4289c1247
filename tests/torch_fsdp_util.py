"""Rank functions for the sharded-training tests of the PyTorch port
(tests/test_torch_fsdp_train.py, tests/test_torch_tp_train.py).

As tests/torch_pipe_util.py: the test starts a group of gloo ranks with
``vita_tpu_torch.parallel.launch.run_ranks``; each rank imports this
module afresh (it imports neither jax nor the JAX package) and runs a
list of cases. A case's ``mesh`` is a mesh shape; one smaller than the
group is built once for each run of consecutive ranks it covers (every
rank builds them all, in order), so each such replica runs the case on
its own ranks and every rank returns its replica's result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from torch_mesh_util import _fresh, as_numpy, coords, engine_tokens  # noqa: F401 - a case


def run_cases(rank: int, world: int, cases: Sequence[Tuple[str, str, Dict[str, Any]]],
              shared: Dict[str, Any]) -> Dict[str, Any]:
    """Each case (name, function of this module, kwargs) on this rank, in
    order. A kwarg value ``"@key"`` is ``shared[key]``; ``mesh`` is a
    mesh shape, built here over this rank's replica."""
    from vita_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    meshes = {}
    out = {}
    for name, fn, kw in cases:
        kw = {k: shared[v[1:]] if isinstance(v, str) and v.startswith("@") else v
              for k, v in kw.items()}
        if kw.get("mesh") is not None:
            shape = tuple(kw["mesh"])
            if shape not in meshes:
                per = math.prod(shape)
                built = [make_mesh(shape, ranks=range(i, i + per)) for i in range(0, world, per)]
                meshes[shape] = built[rank // per]
            kw["mesh"] = meshes[shape]
        out[name] = as_numpy(globals()[fn](**kw))
    return out


def encode(s: str) -> List[int]:
    """Word ids inside the tiny model's 512 vocabulary (as
    tests/test_torch_train.py encodes)."""
    return [1] + [3 if w == "</s>" else 100 + (sum(map(ord, w)) % 400)
                  for w in s.replace("</s>", " </s> ").split()]


def mesh_config(cfg, mesh, micro: int = 2):
    """``cfg`` for a training mesh: the LLM's GPipe stages from its 'pipe'
    axis (``micro`` microbatches) and the flash backend under 'seq'."""
    from vita_tpu_torch.parallel.mesh import PIPE, SEQ, axis

    llm = cfg.llm
    if axis(mesh, PIPE).size > 1:
        llm = dataclasses.replace(llm, pipe_stages=axis(mesh, PIPE).size,
                                  pipe_microbatches=micro)
    if axis(mesh, SEQ).size > 1:
        llm = dataclasses.replace(llm, attn_backend="flash")
    return dataclasses.replace(cfg, llm=llm)


def _flat(tree) -> Dict[str, torch.Tensor]:
    from vita_tpu_torch.train.step import tree_leaves

    return {"/".join(p): w.detach().clone() for p, w in tree_leaves(tree)}


def train_steps_case(mesh, params, cfg, tc, batches, micro: int = 2) -> Dict[str, Any]:
    """``make_train_step`` over the mesh on this rank's blocks of
    ``params`` (cut by ``vita.param_specs``), one update a global batch:
    the metrics of each step and this rank's blocks after each update."""
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel import fsdp
    from vita_tpu_torch.train import step

    cfg = mesh_config(cfg, mesh, micro)
    local = fsdp.shard_tree(_fresh(params), vita.param_specs(cfg), mesh, "cpu")
    opt = step.make_optimizer(tc, local)
    state = opt.init(local)
    fn = step.make_train_step(cfg, tc, opt, mesh)
    metrics, blocks = [], []
    for b in batches:
        local, state, m = fn(local, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        blocks.append(_flat(local))
    return {"coords": coords(mesh), "metrics": metrics, "blocks": blocks}


def refusals_case(mesh, params, cfg, batch) -> Dict[str, str]:
    """Over a training mesh: the loss (as its repr) of the capacity and
    sort modes and of moe_chunk over tokens split between ranks (refused
    until their drops and chunks were taken over the whole batch's token
    order), and the message a batch that does not divide over data x fsdp
    raises with."""
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.parallel import fsdp
    from vita_tpu_torch.train import step

    local = fsdp.shard_tree(params, vita.param_specs(cfg), mesh, "cpu")
    batch = step.batch_to(batch, "cpu")
    out = {}

    def grab(name, fn):
        try:
            out[name] = repr(float(fn()[1]["loss"]))
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"

    for mode, chunk in (("capacity", 0), ("sort", 0), ("dense", 4)):
        c = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, moe_mode=mode,
                                                             moe_chunk=chunk))
        grab(f"{mode}_{chunk}", lambda c=c: step.loss_fn(local, c, batch, 0.02, mesh))
    odd = {k: v[:3] if v.shape[0] == 4 else v for k, v in batch.items()}
    grab("odd_batch", lambda: step.loss_fn(local, cfg, odd, 0.02, mesh))
    return out


def tp_trainer_case(mesh, params, cfg, tc, batch) -> Dict[str, float]:
    """A Trainer over a mesh with a 'model' or 'expert' axis > 1 (cutting
    the whole params itself) takes one step on ``batch``: its metrics."""
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    tr = Trainer(cfg, tc, RunConfig(output_dir="unused", resume=False, batch_size=4),
                 _fresh(params), mesh=mesh)
    _, _, m = tr.step_fn(tr.params, tr.opt_state, batch)
    return {k: float(v) for k, v in m.items()}


def old_norm_steps_case(mesh, params, cfg, tc, batches, micro: int = 1) -> Dict[str, Any]:
    """``train_steps_case`` with the global norm's axis set that counted
    a leaf's blocks over ('fsdp', 'pipe') only, planted back: each rank of
    a 'model' or 'expert' group clips by its own blocks' norm there."""
    from vita_tpu_torch.parallel import fsdp
    from vita_tpu_torch.parallel.mesh import FSDP, PIPE

    def old_sq_norm(grads, specs, mesh):
        parts = {}
        for g, spec in zip(grads, specs):
            over = tuple(a for a in (FSDP, PIPE) if a in fsdp.split_axes(spec, mesh))
            s = (g.float() ** 2).sum()
            parts[over] = parts[over] + s if over in parts else s
        return sum(fsdp.all_reduce_sum(parts[o], mesh, o) for o in sorted(parts))

    real = fsdp.sq_norm
    fsdp.sq_norm = old_sq_norm
    try:
        return train_steps_case(mesh, params, cfg, tc, batches, micro)
    finally:
        fsdp.sq_norm = real


def resume_case(mesh, params, cfg, tc, data: str, out: str, epochs: int, save: bool,
                per_replica: bool = True) -> Dict[str, Any]:
    """A Trainer over ``mesh`` on ``out`` (a directory of its own for each
    replica of a mesh smaller than the group, with ``per_replica``): this
    rank's blocks, Adam moments and step as it stands after building
    (resumed from ``out``'s latest checkpoint, if any), then ``epochs``
    epochs of training and, with ``save``, a checkpoint: the log, the
    blocks after it and the printed lines."""
    import os

    import torch.distributed as dist

    from vita_tpu_torch.data.dataset import Collator, ConversationDataset, DataArgs, DatasetSpec
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    from vita_tpu_torch.parallel.mesh import AXES, all_reduce_sum

    # every rank of the mesh has finished the cases before this one (a
    # checkpoint this run reads was written by another mesh's ranks)
    all_reduce_sum(torch.zeros(1), mesh, AXES)
    if per_replica:
        out = os.path.join(out, f"rep{dist.get_rank() // math.prod(mesh.mesh.shape)}")
    cfg = mesh_config(cfg, mesh)
    ds = ConversationDataset([DatasetSpec(data)], encode, 1, 2, pad_id=0,
                             args=DataArgs(image_size=cfg.vision.image_size, max_patches=1,
                                           use_thumbnail=False))
    run = RunConfig(output_dir=out, batch_size=4, num_epochs=epochs, save_every_steps=10 ** 6,
                    loader_workers=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr = Trainer(cfg, tc, run, _fresh(params), mesh=mesh)
        loaded = {"step": tr.step, "blocks": _flat(tr.params),
                  "mu": {k: v.clone() for k, v in tr.opt_state["mu"].items()},
                  "nu": {k: v.clone() for k, v in tr.opt_state["nu"].items()}}
        log = tr.train(ds, Collator(pad_id=0))
        if save:
            tr.save()
    return {"coords": coords(mesh), "loaded": loaded, "log": log, "step": tr.step,
            "blocks": _flat(tr.params), "printed": buf.getvalue()}


def trainer_case(mesh, params, cfg, tc, data: str, out: str, runs: List[Tuple[int, bool]],
                 batch_size: int = 4) -> Dict[str, Any]:
    """Trainer(mesh=) runs over one output directory: each run (epochs,
    save at its end) builds a fresh Trainer, which resumes from the
    latest checkpoint. Returns each run's metrics, this rank's blocks and
    Adam moments after it, its printed lines (rank 0's alone print) and
    the files of the output directory."""
    import os

    from vita_tpu_torch.data.dataset import Collator, ConversationDataset, DataArgs, DatasetSpec
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    cfg = mesh_config(cfg, mesh)
    ds = ConversationDataset([DatasetSpec(data)], encode, 1, 2, pad_id=0,
                             args=DataArgs(image_size=cfg.vision.image_size, max_patches=1,
                                           use_thumbnail=False))
    res = []
    for epochs, save in runs:
        run = RunConfig(output_dir=out, batch_size=batch_size, num_epochs=epochs,
                        save_every_steps=10 ** 6, loader_workers=1)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tr = Trainer(cfg, tc, run, _fresh(params), mesh=mesh)
            log = tr.train(ds, Collator(pad_id=0))
            if save:
                tr.save()
        res.append({"log": log, "step": tr.step, "blocks": _flat(tr.params),
                    "mu": {k: v.clone() for k, v in tr.opt_state["mu"].items()},
                    "printed": buf.getvalue()})
    return {"coords": coords(mesh), "runs": res,
            "files": sorted(os.listdir(os.path.join(out, "ckpt")))}


def checkpoint_case(mesh, native: str, hf: str) -> Dict[str, Any]:
    """``load_vita_checkpoint(dir, mesh=, training=True)`` of a native and
    an HF-layout directory: this rank's blocks of every leaf, and the
    coordinates."""
    from vita_tpu_torch.checkpoint import load_vita_checkpoint

    out = {"coords": coords(mesh)}
    for name, path in (("native", native), ("hf", hf)):
        _, params = load_vita_checkpoint(path, "cpu", mesh=mesh, training=True)
        out[name] = _flat(params)
    return out


def cli_case(argv: List[str]) -> Dict[str, Any]:
    """``python -m vita_tpu_torch.train.cli`` in this rank (the process
    group is the group's own): its exit code and printed lines."""
    from vita_tpu_torch.train import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return {"rc": rc, "out": buf.getvalue()}
