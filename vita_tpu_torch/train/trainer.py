"""Training loop: batching, steps, checkpointing, resume, logging
(vita_tpu.train.trainer).

One train step per batch (``train.step.make_train_step``), batches in
modality-grouped order, auto-resume from the latest checkpoint that skips
the batches already trained, ``metrics.jsonl``, and pruning to
``keep_checkpoints``. A checkpoint is ``{params, opt_state, step}``
written with ``torch.save`` to ``output_dir/ckpt/step_N/state.pt``: the
directory is written under a temporary name and renamed into place when
complete, so a ``step_N`` directory is always whole. Parameters update in
place.

``Trainer(..., mesh=)`` trains over a training mesh of any of the six
axes (one process a rank, as
``parallel.distributed.training_mesh`` starts them). It
cuts this rank's blocks of the whole params by ``vita.param_specs`` onto
its device, as the JAX package's ``device_put`` does (or takes blocks
already cut: ``sharded=True``, from ``checkpoint.load_vita_checkpoint(...,
mesh=, training=True)``). Every rank builds the same global batch from
the same seeded order and the step takes its rows. Metrics are the whole
batch's on every rank; the mesh's first rank prints them and writes
``metrics.jsonl``. A checkpoint on a mesh holds each rank's blocks
(``step_N/rank_R.pt`` for rank R of the mesh, with the mesh's shape in
``mesh.json``). A run resumes on any mesh or on none, as the JAX
package's orbax restores onto the target's sharding: on the mesh it was
saved from each rank reads its own file; elsewhere each rank reads every
saved rank's blocks (mapped, not copied), puts each leaf of the params
and the Adam moments together by the saved mesh's specs and keeps its
own block of it, one leaf at a time.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import re
import shutil
import time
from typing import Dict, Iterable, List, Optional

import torch

from vita_tpu_torch.data.dataset import Collator, modality_grouped_indices
from vita_tpu_torch.data.loader import PrefetchLoader
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel import fsdp
from vita_tpu_torch.parallel.mesh import (
    AXES,
    DATA,
    FSDP,
    PIPE,
    all_reduce_sum,
    axis,
    local_shard,
)
from vita_tpu_torch.train.step import (
    TrainConfig,
    batch_logits,
    batch_to,
    make_optimizer,
    make_train_step,
    token_nll,
    trainable_mask,
    tree_leaves,
)

STATE_FILE = "state.pt"
MESH_FILE = "mesh.json"


@dataclasses.dataclass
class RunConfig:
    output_dir: str
    batch_size: int = 8
    num_epochs: int = 1
    save_every_steps: int = 500
    keep_checkpoints: int = 2  # save_total_limit 2
    log_every: int = 1
    seed: int = 42
    resume: bool = True
    loader_workers: int = 4


def committed_steps(directory: str) -> List[int]:
    """The steps with a complete ``step_N`` checkpoint under ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(re.compile(r"step_(\d+)$").match,
                                               os.listdir(directory)) if m)


def save_state(directory: str, step: int, state) -> str:
    """``state`` to ``directory/step_N/state.pt``, renamed into place."""
    final = os.path.join(directory, f"step_{step}")
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final


def load_state(directory: str, step: Optional[int] = None, device=None, mmap: bool = False,
               name: str = STATE_FILE):
    """The state saved at ``step`` (default: the latest) under ``directory``
    (with ``mmap``, CPU views of the mapped file); ``name`` is the file in
    ``step_N`` (a rank's ``rank_R.pt`` on a mesh)."""
    if step is None:
        steps = committed_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no step_N checkpoint under {directory}")
        step = steps[-1]
    return torch.load(os.path.join(directory, f"step_{step}", name),
                      map_location=device, weights_only=True, mmap=mmap)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _mesh_rank(mesh) -> int:
    """This rank's index in the mesh, row-major over its axes."""
    r = 0
    for a in AXES:
        r = r * axis(mesh, a).size + axis(mesh, a).rank
    return r


def _barrier(mesh, device) -> None:
    """Every rank of the mesh has reached this point."""
    all_reduce_sum(torch.zeros(1, device=device), mesh, AXES)


@torch.no_grad()
def copy_into(params, loaded) -> None:
    """Copy every leaf of ``loaded`` into the same leaf of ``params``."""
    leaves = dict(tree_leaves(params))
    for path, value in tree_leaves(loaded):
        if path not in leaves or leaves[path].shape != value.shape:
            raise ValueError(f"checkpoint leaf {'/'.join(path)} does not match the model")
        leaves[path].copy_(value)


def load_adapter_into(params, path: str):
    """Overlay the components of a ``save_trainable_only`` checkpoint (the
    latest step under ``path``) onto ``params``, in place."""
    copy_into(params, load_state(path))
    return params


class Trainer:
    def __init__(self, cfg: vita.VITAConfig, tc: TrainConfig, run: RunConfig, params,
                 mesh=None, sharded: bool = False, device=None):
        """``params`` whole (cut here under a ``mesh``, onto ``device``,
        default the params' own) or, with ``sharded``, this rank's blocks
        already."""
        self.cfg, self.tc, self.run, self.mesh = cfg, tc, run, mesh
        self.lead = True
        if mesh is not None:
            data, fsdp_n = axis(mesh, DATA).size, axis(mesh, FSDP).size
            if run.batch_size % (data * fsdp_n):
                raise ValueError(f"batch size {run.batch_size} does not divide over data x fsdp "
                                 f"= {data * fsdp_n} ranks")
            self.lead = _mesh_rank(mesh) == 0
            if not sharded:
                dev = device or next(iter(tree_leaves(params)))[1].device
                params = fsdp.shard_tree(params, vita.param_specs(cfg), mesh, dev)
        self.optimizer = make_optimizer(tc, params)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self.step_fn = make_train_step(cfg, tc, self.optimizer, mesh)
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        if run.resume:
            self._maybe_resume()

    # -- checkpointing ----------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(self.run.output_dir, "ckpt")

    def _device(self):
        return next(iter(tree_leaves(self.params)))[1].device

    def _state_file(self) -> str:
        return STATE_FILE if self.mesh is None else f"rank_{_mesh_rank(self.mesh)}.pt"

    def _mesh_shape(self) -> List[int]:
        return [axis(self.mesh, a).size for a in AXES]

    def _maybe_resume(self) -> None:
        steps = committed_steps(self._ckpt_dir())
        if not steps:
            return
        where = os.path.join(self._ckpt_dir(), f"step_{steps[-1]}")
        saved = None
        if os.path.exists(os.path.join(where, MESH_FILE)):
            with open(os.path.join(where, MESH_FILE)) as f:
                saved = json.load(f)["mesh"]
        mine = None if self.mesh is None else self._mesh_shape()
        if saved == mine:
            state = load_state(self._ckpt_dir(), steps[-1], self._device(),
                               name=self._state_file())
        else:
            state = self._restore(where, saved)
        copy_into(self.params, state["params"])
        self.opt_state = state["opt_state"]
        self.step = state["step"]
        if self.lead:
            print(f"[trainer] resumed from step {self.step}"
                  + ("" if saved == mine else f" (saved on mesh {saved}, restored onto {mine})"))

    @torch.no_grad()
    def _restore(self, where: str, saved: Optional[List[int]]):
        """The state saved in ``where`` on a mesh of shape ``saved`` (None:
        unsharded) for this run: each leaf of the params and of the Adam
        moments put together whole from every saved rank's blocks by the
        saved mesh's specs (``fsdp.assemble``), then cut to this rank's
        block by this run's (whole without a mesh), one leaf at a time."""
        files = [STATE_FILE] if saved is None else [
            f"rank_{r}.pt" for r in range(math.prod(saved))]
        states = [torch.load(os.path.join(where, f), map_location="cpu", weights_only=True,
                             mmap=True) for f in files]
        pipe = 1 if saved is None else saved[AXES.index(PIPE)]
        old = dict(tree_leaves(vita.param_specs(dataclasses.replace(
            self.cfg, llm=dataclasses.replace(self.cfg.llm, pipe_stages=pipe)))))
        new = dict(tree_leaves(vita.param_specs(self.cfg)))
        dev = self._device()

        def leaf(path, blocks):
            x = blocks[0] if saved is None else fsdp.assemble(blocks, old[path], saved)
            if self.mesh is not None:
                x = local_shard(x, new[path], self.mesh)
            return x.to(dev, copy=True)

        def params(tree, path=()):
            if isinstance(tree, dict):
                return {k: params(v, path + (k,)) for k, v in tree.items()}
            return leaf(path, [_at(st["params"], path) for st in states])

        opt = states[0]["opt_state"]
        moments = {m: {key: leaf(tuple(key.split("/")), [st["opt_state"][m][key] for st in states])
                       for key in opt[m]} for m in ("mu", "nu")}
        return {"params": params(states[0]["params"]), "step": states[0]["step"],
                "opt_state": {**opt, **moments}}

    def save(self) -> None:
        """``{params, opt_state, step}`` to ``ckpt/step_N``; on a mesh every
        rank writes its blocks into one directory, renamed into place by
        the mesh's first rank once all have written (collective)."""
        state = {"params": self.params, "opt_state": self.opt_state, "step": self.step}
        if self.mesh is None:
            save_state(self._ckpt_dir(), self.step, state)
        else:
            final = os.path.join(self._ckpt_dir(), f"step_{self.step}")
            tmp, dev = f"{final}.tmp", self._device()
            if self.lead:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                with open(os.path.join(tmp, MESH_FILE), "w") as f:
                    json.dump({"mesh": self._mesh_shape()}, f)
            _barrier(self.mesh, dev)
            torch.save(state, os.path.join(tmp, self._state_file()))
            _barrier(self.mesh, dev)
            if self.lead:
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
        if self.lead:
            for s in committed_steps(self._ckpt_dir())[: -self.run.keep_checkpoints]:
                shutil.rmtree(os.path.join(self._ckpt_dir(), f"step_{s}"), ignore_errors=True)
        if self.mesh is not None:
            _barrier(self.mesh, self._device())

    def save_trainable_only(self, name: str = "adapters") -> None:
        """Adapter-only checkpoint: just the trainable top-level components
        (e.g. the mm projector), for ``--pretrain-mm-adapter``; whole
        leaves (gathered on a mesh, written by its first rank)."""
        mask = trainable_mask(self.params, self.tc)
        subset = {k: v for k, v in self.params.items()
                  if next(tree_leaves(mask[k]))[1]}
        if self.mesh is not None:
            specs = vita.param_specs(self.cfg)
            with torch.no_grad():
                subset = {k: fsdp.gather_tree(v, specs[k], self.mesh, whole=True)
                          for k, v in subset.items()}
        if self.lead:
            save_state(os.path.join(self.run.output_dir, name), self.step, subset)

    # -- data -------------------------------------------------------------
    def batches(self, dataset, collator: Collator) -> Iterable[Dict]:
        rng = random.Random(self.run.seed + self.step)
        order = modality_grouped_indices(dataset.modality_lengths(), self.run.batch_size, rng)
        # background sample building and collation overlap the device step
        return PrefetchLoader(dataset, order, self.run.batch_size, collator,
                              num_workers=self.run.loader_workers, prefetch=2)

    # -- loop -------------------------------------------------------------
    def train(self, dataset, collator: Optional[Collator] = None) -> List[Dict[str, float]]:
        collator = collator or Collator(pad_id=0)
        # a resumed run continues the same schedule: the batches already
        # trained are built and skipped, never stepped again
        resume_skip = self.step
        g = 0
        for epoch in range(self.run.num_epochs):
            for batch in self.batches(dataset, collator):
                if g < resume_skip:
                    g += 1
                    continue
                g += 1
                t0 = time.time()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                self.step += 1
                if self.step % self.run.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=self.step, epoch=epoch, step_time=time.time() - t0)
                    self.metrics_log.append(m)
                    if self.lead:
                        print(f"[step {self.step}] loss={m['loss']:.4f} ce={m['ce']:.4f} "
                              f"aux={m['aux']:.4f} ({m['step_time']:.2f}s)")
                if self.step % self.run.save_every_steps == 0:
                    self.save()
        if self.lead:
            os.makedirs(self.run.output_dir, exist_ok=True)
            with open(os.path.join(self.run.output_dir, "metrics.jsonl"), "a") as f:
                for m in self.metrics_log:
                    f.write(json.dumps(m) + "\n")
        return self.metrics_log


def make_eval_step(cfg: vita.VITAConfig):
    """Eval step: (masked next-token NLL sum, labelled token count)."""

    @torch.no_grad()
    def step(params, batch):
        dev = next(iter(tree_leaves(params)))[1].device
        batch = batch_to(batch, dev)
        logits, _, _ = batch_logits(params, cfg, batch, token_mask=False)
        return token_nll(logits, batch["labels"])

    return step


def evaluate(params, cfg: vita.VITAConfig, dataset, collator: Collator,
             batch_size: int = 8, max_batches: Optional[int] = None) -> Dict[str, float]:
    """Perplexity over a held-out conversation dataset; the tail batch
    evaluates too."""
    step = make_eval_step(cfg)
    total_nll, total_tok = 0.0, 0
    n = len(dataset)
    for bi, i in enumerate(range(0, n, batch_size)):
        if max_batches is not None and bi >= max_batches:
            break
        nll, tok = step(params, collator([dataset[j] for j in range(i, min(i + batch_size, n))]))
        total_nll += float(nll)
        total_tok += int(tok)
    if total_tok == 0:
        # no evaluated tokens must not read as a perfect score
        return {"eval_nll": float("nan"), "eval_ppl": float("nan"), "eval_tokens": 0}
    return {"eval_nll": total_nll / total_tok, "eval_ppl": math.exp(total_nll / total_tok),
            "eval_tokens": total_tok}
