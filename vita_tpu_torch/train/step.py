"""Training step: loss, freeze masks, grouped learning rates
(vita_tpu.train.step).

Parameters are the port's nested dicts of tensors. ``make_optimizer``
marks the trainable leaves (``requires_grad``) and returns an AdamW that
updates exactly what the JAX package's optax chain updates:

  - frozen leaves take part in nothing: no gradient, no norm, no update;
  - with ``projector_lr`` (stage 2) the two adapters and the rest form two
    groups (``optax.multi_transform``), each clipped by its OWN global norm;
  - per group: clip_by_global_norm(grad_clip), Adam moments kept in the
    parameter's dtype, weight decay on leaves with ndim > 1, then the
    learning rate of update i (from 0)
    ``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))(i)``,
    so the first update has lr 0.

The update happens in place, where the JAX package donates its buffers.

Under a training mesh (any of the six axes) each rank holds
its blocks of the leaves (``vita.param_specs``, as the Trainer cuts
them) and the global batch; the forward takes its rows and positions
(``vita.batch_block``) and the CE's denominator is the labelled count of
the whole batch, so each rank's objective is its share (the ranks of one
'model' x 'expert' group hold the same rows and compute the same share,
whose gradient the model's collectives give each of them: its block of a
split leaf's, the whole of a replicated one's). ``make_train_step`` then
sums the gradients over the ranks of 'data', 'fsdp' and 'seq'
(``parallel.fsdp.reduce_grads``), clips each group by its global norm
(``parallel.fsdp.sq_norm``: each leaf once, its blocks summed over every
axis that splits it, so every rank clips alike) and keeps the Adam
moments on the rank's blocks. This is the JAX package's step over
the same global batch, which GSPMD shards.

A batch whose loss reaches no trainable leaf (stage 1 on a text or a
speech batch) gives every trainable leaf a zero gradient and still takes
the update (the count advances, the moments decay, weight decay applies),
as optax does on the JAX package's gradients, which are zero there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vita_tpu_torch.constants import IGNORE_INDEX
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel import fsdp
from vita_tpu_torch.parallel.mesh import DATA, FSDP, SEQ, all_reduce_sum, axis

Path = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    projector_lr: Optional[float] = None  # mm_projector_lr; None = same
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    aux_loss_coef: float = 0.02
    warmup_steps: int = 100
    total_steps: int = 10000
    # stage presets (which top-level components train)
    train_llm: bool = True
    train_vision: bool = False
    train_audio: bool = False
    train_vision_proj: bool = True
    train_audio_proj: bool = True

    @staticmethod
    def stage1_pretrain_mlp() -> "TrainConfig":
        # projector alignment only, lr 5e-4
        return TrainConfig(learning_rate=5e-4, train_llm=False, train_audio_proj=False)

    @staticmethod
    def stage2_finetune() -> "TrainConfig":
        # + audio adapter, lr 2e-5, projectors 5e-4
        return TrainConfig(learning_rate=2e-5, projector_lr=5e-4)

    @staticmethod
    def stage3_task() -> "TrainConfig":
        return TrainConfig(learning_rate=2e-5)


def tree_leaves(tree, prefix: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, tensor) of every leaf of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _component_map(params, fn) -> Dict[str, Any]:
    """The same nested structure with fn(component name) at every leaf."""
    def sub(tree, value):
        return {k: sub(v, value) for k, v in tree.items()} if isinstance(tree, dict) else value
    return {k: sub(v, fn(k)) for k, v in params.items()}


def trainable_mask(params, tc: TrainConfig):
    """Nested bools: which top-level component trains (freeze flags)."""
    flags = {
        "llm": tc.train_llm,
        "vision": tc.train_vision,
        "audio": tc.train_audio,
        "vision_proj": tc.train_vision_proj,
        "audio_proj": tc.train_audio_proj,
    }
    return _component_map(params, flags.__getitem__)


def lr_group_labels(params):
    """'projector' for the two adapters, 'base' elsewhere (grouped LRs)."""
    return _component_map(params, lambda k: "projector" if k.endswith("_proj") else "base")


def warmup_cosine_lr(step: int, peak: float, warmup: int, total: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total)(step) with
    end value 0."""
    if step < warmup:
        return peak * step / warmup
    decay = total - warmup
    t = min(step - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


class AdamW:
    """Per-group clip + AdamW over the trainable leaves, in place."""

    def __init__(self, tc: TrainConfig, params):
        self.tc = tc
        mask = dict(tree_leaves(trainable_mask(params, tc)))
        labels = dict(tree_leaves(lr_group_labels(params)))
        paths = [p for p, _ in tree_leaves(params) if mask[p]]
        if tc.projector_lr is None:
            self.groups = [(tc.learning_rate, paths)]
        else:
            self.groups = [(lr, [p for p in paths if labels[p] == name])
                           for name, lr in (("base", tc.learning_rate),
                                            ("projector", tc.projector_lr))]
        self.paths = paths

    def init(self, params) -> Dict[str, Any]:
        leaves = dict(tree_leaves(params))
        return {"count": 0,
                "mu": {"/".join(p): torch.zeros_like(leaves[p]) for p in self.paths},
                "nu": {"/".join(p): torch.zeros_like(leaves[p]) for p in self.paths}}

    def lr(self, base_lr: float, count: int) -> float:
        tc = self.tc
        return warmup_cosine_lr(count, base_lr, tc.warmup_steps,
                                max(tc.total_steps, tc.warmup_steps + 1))

    @torch.no_grad()
    def update(self, params, grads: Dict[Path, torch.Tensor], state: Dict[str, Any],
               mesh=None, specs: Optional[Dict[Path, Any]] = None):
        """Apply one update to ``params`` in place; advances ``state``.
        Under a ``mesh`` the leaves and gradients are this rank's blocks
        by ``specs`` (path -> spec) and each group clips by its global
        norm (``parallel.fsdp.sq_norm``)."""
        tc = self.tc
        leaves = dict(tree_leaves(params))
        count = state["count"]
        c1 = 1.0 - tc.b1 ** (count + 1)
        c2 = 1.0 - tc.b2 ** (count + 1)
        for base_lr, paths in self.groups:
            if not paths:
                continue
            gs = [grads[p] for p in paths]
            norm = torch.sqrt(fsdp.sq_norm(gs, [specs[p] if specs else () for p in paths],
                                           mesh))
            lr = self.lr(base_lr, count)
            for p, g in zip(paths, gs):
                w, key = leaves[p], "/".join(p)
                g = torch.where(norm < tc.grad_clip, g, g / norm.to(g.dtype) * tc.grad_clip)
                mu = state["mu"][key].mul_(tc.b1).add_((1 - tc.b1) * g)
                nu = state["nu"][key].mul_(tc.b2).add_((1 - tc.b2) * (g * g))
                u = (mu / c1) / (torch.sqrt(nu / c2) + 1e-8)
                if w.ndim > 1 and tc.weight_decay:
                    u = u + tc.weight_decay * w
                w.add_((-lr * u).to(w.dtype))
        state["count"] = count + 1
        return state


def make_optimizer(tc: TrainConfig, params) -> AdamW:
    """Mark each leaf of ``params`` trainable or frozen (requires_grad) as
    ``tc`` says and return the optimizer over the trainable ones."""
    mask = dict(tree_leaves(trainable_mask(params, tc)))
    for path, w in tree_leaves(params):
        w.requires_grad_(bool(mask[path]) and w.is_floating_point())
    return AdamW(tc, params)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
            for k, v in batch.items() if k != "tiles_per_sample"}


def batch_logits(params, cfg: vita.VITAConfig, batch, token_mask: bool, mesh=None):
    audio_select = None
    if "audio_select_clip" in batch:
        audio_select = (batch["audio_select_clip"], batch["audio_select_row"])
    return vita.forward(
        params, cfg, batch["input_ids"],
        image_mask=batch.get("image_mask"), audio_mask=batch.get("audio_mask"),
        images=batch.get("images"), speech=batch.get("speech"),
        speech_lengths=batch.get("speech_lengths"), audio_select=audio_select,
        attn_valid=batch.get("attn_valid"),
        token_mask=batch.get("attn_valid") if token_mask else None, mesh=mesh,
    )


def next_labels(labels: torch.Tensor) -> torch.Tensor:
    """The label row t predicts (label t + 1), IGNORE_INDEX at the last
    position."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], 1)


def _nll(logits: torch.Tensor, targets: torch.Tensor):
    targets = targets.long()
    mask = targets != IGNORE_INDEX
    nll = F.cross_entropy(logits.float().flatten(0, 1), torch.where(mask, targets, 0).flatten(),
                          reduction="none")
    return (nll * mask.flatten()).sum(), mask.sum()


def token_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the next-token NLL over labelled positions, their count):
    row t predicts label t + 1."""
    return _nll(logits, next_labels(labels))


def loss_fn(params, cfg: vita.VITAConfig, batch: Dict[str, torch.Tensor],
            aux_coef: float, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: input_ids [B,S], labels [B,S], image_mask/audio_mask [B,S],
    attn_valid [B,S], images [N,H,W,3]?, speech [B,T,80]?, speech_lengths.
    ``mesh`` is a training mesh (``params`` then hold this rank's blocks)
    or a pipe mesh (cfg.llm.pipe_stages > 1; ``params`` hold this rank's
    stage of the LLM). Under a mesh the batch is the global one and the
    returned objective this rank's share: its tokens' NLL over the
    labelled count summed over ('data', 'fsdp', 'seq') (without
    gradient), plus the whole batch's aux term; the metrics are the whole
    batch's, on every rank."""
    logits, _, aux = batch_logits(params, cfg, batch, token_mask=True, mesh=mesh)
    nll, count = _nll(logits, vita.batch_block(next_labels(batch["labels"]), cfg, mesh))
    split = tuple(a for a in (DATA, FSDP, SEQ) if axis(mesh, a).size > 1)
    denom = all_reduce_sum(count, mesh, split).clamp_min(1)
    ce = nll / denom
    total = ce + aux_coef * aux
    if split:
        ce = all_reduce_sum(nll.detach(), mesh, split) / denom
    return total, {"loss": ce + aux_coef * aux, "ce": ce, "aux": aux, "tokens": denom}


def make_train_step(cfg: vita.VITAConfig, tc: TrainConfig, optimizer: AdamW,
                    mesh=None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics): one
    forward and backward over the trainable leaves, then the optimizer's
    in-place update. ``mesh`` as for ``loss_fn``: every rank updates its
    own blocks (under a pipe axis the replicated leaves alike everywhere),
    from the gradients summed over the ranks and clipped by the global
    norm."""
    specs = dict(tree_leaves(vita.param_specs(cfg))) if mesh is not None else None

    def step(params, opt_state, batch):
        leaves = dict(tree_leaves(params))
        dev = leaves[optimizer.paths[0]].device if optimizer.paths else None
        batch = batch_to(batch, dev)
        loss, metrics = loss_fn(params, cfg, batch, tc.aux_loss_coef, mesh)
        ws = [leaves[p] for p in optimizer.paths]
        # No graph: the loss reaches no trainable leaf (the module's
        # docstring). Every rank of a mesh decides alike: the towers and the
        # fusion run over the whole global batch on every rank, so a rank's
        # block of the embeddings carries a graph whenever any row's media
        # does.
        grads = (torch.autograd.grad(loss, ws, allow_unused=True) if loss.requires_grad
                 else [None] * len(ws))
        grads = {p: torch.zeros_like(w) if g is None else g
                 for p, w, g in zip(optimizer.paths, ws, grads)}
        if mesh is not None:
            grads = fsdp.reduce_grads(grads, specs, mesh)
        opt_state = optimizer.update(params, grads, opt_state, mesh, specs)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step
