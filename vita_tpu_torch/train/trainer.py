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


def load_state(directory: str, step: Optional[int] = None, device=None, mmap: bool = False):
    """The state saved at ``step`` (default: the latest) under ``directory``
    (with ``mmap``, CPU views of the mapped file)."""
    if step is None:
        steps = committed_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no step_N checkpoint under {directory}")
        step = steps[-1]
    return torch.load(os.path.join(directory, f"step_{step}", STATE_FILE),
                      map_location=device, weights_only=True, mmap=mmap)


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
    def __init__(self, cfg: vita.VITAConfig, tc: TrainConfig, run: RunConfig, params):
        self.cfg, self.tc, self.run = cfg, tc, run
        self.optimizer = make_optimizer(tc, params)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self.step_fn = make_train_step(cfg, tc, self.optimizer)
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        if run.resume:
            self._maybe_resume()

    # -- checkpointing ----------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(self.run.output_dir, "ckpt")

    def _maybe_resume(self) -> None:
        steps = committed_steps(self._ckpt_dir())
        if not steps:
            return
        dev = next(iter(tree_leaves(self.params)))[1].device
        state = load_state(self._ckpt_dir(), steps[-1], dev)
        copy_into(self.params, state["params"])
        self.opt_state = state["opt_state"]
        self.step = state["step"]
        print(f"[trainer] resumed from step {self.step}")

    def save(self) -> None:
        save_state(self._ckpt_dir(),
                   self.step, {"params": self.params, "opt_state": self.opt_state,
                               "step": self.step})
        for s in committed_steps(self._ckpt_dir())[: -self.run.keep_checkpoints]:
            shutil.rmtree(os.path.join(self._ckpt_dir(), f"step_{s}"), ignore_errors=True)

    def save_trainable_only(self, name: str = "adapters") -> None:
        """Adapter-only checkpoint: just the trainable top-level components
        (e.g. the mm projector), for ``--pretrain-mm-adapter``."""
        mask = trainable_mask(self.params, self.tc)
        subset = {k: v for k, v in self.params.items()
                  if next(tree_leaves(mask[k]))[1]}
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
                    print(f"[step {self.step}] loss={m['loss']:.4f} ce={m['ce']:.4f} "
                          f"aux={m['aux']:.4f} ({m['step_time']:.2f}s)")
                if self.step % self.run.save_every_steps == 0:
                    self.save()
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
