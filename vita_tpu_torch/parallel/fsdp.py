"""ZeRO-3 parameter sharding over the mesh's 'fsdp' axis, with the batch
split over ('data', 'fsdp').

The JAX package gets this from GSPMD: ``vita.param_specs`` places every
leaf and the compiler inserts the gathers and reductions. Here every rank
holds its block of each leaf (``shard_tree``: the leaf cut by its spec,
as ``parallel.mesh.local_shard`` cuts it) and the forward gathers a
leaf's whole over 'fsdp' where it is used (``gather``: the model's layer
at the top of the layer, inside what remat recomputes, so the gathered
weights die after the layer's forward and are gathered again in its
backward). The gather is ``parallel.mesh.all_gather_cat``, whose
backward reduce-scatters over 'fsdp': the block's gradient is summed
over the fsdp ranks right after the layer's backward.

The rest of the step's reduction is ``reduce_grads``: every rank's
objective is its rows' share of the loss (and positions' share under
'seq'), so a gradient is summed over 'data' and 'seq', and a leaf that
'fsdp' does not split is summed over 'fsdp' too. The ranks of one
'model' x 'expert' group hold the same rows and compute the same
objective, and the model's collectives (parallel.mesh's "f" and "g")
give each of them its block of that one objective's gradient of a leaf
split over 'model' or 'expert', and the whole gradient of a leaf
replicated over them: nothing is summed over 'model' or 'expert'. A leaf
split over 'pipe' is the stage's own and summed over nothing more. Every
stage computes the whole gradient of a leaf replicated over 'pipe', and
every rank of a model x expert group that of a leaf replicated over
'model' or 'expert'; the copies agree up to the order of accumulations
that need not be deterministic (a scatter-add on a card), so the copy
of coordinate 0 of those axes is taken everywhere and such leaves stay
bitwise equal on every rank. ``sq_norm`` is the squared global norm of a
set of gradients: each leaf counted once, its blocks summed over every
axis that splits it ('fsdp', 'model', 'expert', 'pipe'), so every rank
clips by the same norm.

Where a leaf is used whole by every rank of a model group (a tower or a
projector, which the port runs whole on every rank; ``gather(...,
whole=True)``) its 'model' block is gathered with
``parallel.mesh.all_gather_slice``, whose backward takes the rank's slice
of the gradient: every rank of the group computes the same objective.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from vita_tpu_torch.parallel.mesh import (
    AXES,
    DATA,
    EXPERT,
    FSDP,
    MODEL,
    PIPE,
    SEQ,
    all_gather_cat,
    all_gather_slice,
    all_reduce_sum,
    axis,
    broadcast_from,
    local_shard,
)

BATCH_AXES = (DATA, FSDP)
BUCKET = 1 << 26  # elements of one gradient all-reduce (256 MiB of float32)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_axes(spec: Sequence, mesh) -> Tuple[str, ...]:
    """The axes of size > 1 that ``spec`` splits its leaf over."""
    return tuple(n for e in spec for n in _names(e) if axis(mesh, n).size > 1)


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, device=None):
    """This rank's block of every leaf of ``tree`` (whole leaves, on any
    device) by its spec, contiguous on ``device``: a copy of the block, so
    the whole leaf is not kept alive by it (a leaf the mesh does not split
    is the leaf itself, moved to ``device``)."""
    def block(x, spec):
        b = local_shard(x.detach(), spec, mesh)
        if b.numel() == x.numel():
            return b.to(device).contiguous()
        return b.to(device=device, copy=True, memory_format=torch.contiguous_format)

    return _map(block, tree, specs)


def gather(x: torch.Tensor, spec: Sequence, mesh, whole: bool = False) -> torch.Tensor:
    """The leaf whole over 'fsdp' from this rank's block ``x`` (the dims
    that ``spec`` splits over other axes stay this rank's). Differentiable:
    the backward reduce-scatters the gradient over 'fsdp'. With ``whole``
    the dims split over the other axes are gathered too, with
    ``all_gather_slice`` (for a leaf every rank of those axes uses whole
    towards the same objective: a tower's, a projector's; without
    autograd, any leaf whole)."""
    for dim, entry in enumerate(spec):
        for n in reversed(_names(entry)):  # the innermost block first
            if axis(mesh, n).size == 1:
                continue
            if n == FSDP:
                x = all_gather_cat(x, mesh, FSDP, dim)
            elif whole:
                x = all_gather_slice(x, mesh, n, dim)
    return x


def gather_tree(tree, specs, mesh, whole: bool = False):
    """``gather`` on every leaf of ``tree`` (one component's params)."""
    return _map(lambda x, s: gather(x, s, mesh, whole), tree, specs)


def assemble(blocks: Sequence[torch.Tensor], spec: Sequence, shape: Sequence[int]) -> torch.Tensor:
    """The whole leaf from ``blocks``, rank r's block of it on a mesh of
    ``shape`` (sizes in ``AXES`` order, rank r at r's row-major
    coordinate), cut by ``spec``: the inverse of ``local_shard``. Ranks
    that hold the same block give it once."""
    sizes = dict(zip(AXES, shape))
    entries = [_names(e) for e in spec] + [()] * (blocks[0].dim() - len(spec))
    parts = [math.prod(sizes[n] for n in names) for names in entries]
    out = torch.empty([n * p for n, p in zip(blocks[0].shape, parts)], dtype=blocks[0].dtype)
    done = set()
    for r, b in enumerate(blocks):
        coords = dict(zip(AXES, np.unravel_index(r, tuple(shape))))
        at = []
        for names in entries:
            i = 0
            for n in names:
                i = i * sizes[n] + int(coords[n])
            at.append(i)
        if tuple(at) in done:
            continue
        done.add(tuple(at))
        out[tuple(slice(i * n, (i + 1) * n) for i, n in zip(at, b.shape))] = b
    return out


def reduce_grads(grads: Dict, specs: Dict, mesh) -> Dict:
    """Each gradient summed over the ranks whose objectives it collects:
    'data' and 'seq', and 'fsdp' unless its spec splits the leaf over
    'fsdp' (then the gather's backward has summed it there); never over
    'model' or 'expert'. A leaf replicated over 'pipe', 'model' or
    'expert' takes the gradient of coordinate 0 of each such axis on every
    rank. ``grads`` and ``specs`` map the same keys. The gradients of one
    set of axes travel as float32 buffers of up to ``BUCKET`` elements (a
    large one in several) and are written back into ``grads``' tensors."""
    out = dict(grads)
    for name in (PIPE, MODEL, EXPERT):
        if axis(mesh, name).size > 1:
            keys = [k for k in grads if name not in split_axes(specs[k], mesh)]
            if keys:
                out.update(zip(keys, broadcast_from([out[k] for k in keys], mesh, name, 0)))
    buckets: Dict[Tuple[str, ...], list] = {}
    for key, g in out.items():
        over = (DATA, SEQ) if FSDP in split_axes(specs[key], mesh) else (DATA, FSDP, SEQ)
        over = tuple(a for a in over if axis(mesh, a).size > 1)
        if not over:
            continue
        out[key] = g = g.contiguous()
        runs = buckets.setdefault(over, [[]])
        for at in range(0, g.numel(), BUCKET):
            seg = g.view(-1)[at:at + BUCKET]
            if sum(x.numel() for x in runs[-1]) + seg.numel() > BUCKET:
                runs.append([])
            runs[-1].append(seg)
    for over, runs in buckets.items():
        for segs in runs:
            flat = all_reduce_sum(torch.cat([x.float() for x in segs]), mesh, over)
            for x, y in zip(segs, flat.split([x.numel() for x in segs])):
                x.copy_(y)
    return out


def sq_norm(grads: Iterable[torch.Tensor], specs: Iterable[Sequence], mesh) -> torch.Tensor:
    """The squared global norm of the leaves whose blocks ``grads`` are
    (float32): each block's sum of squares, summed over every axis that
    splits its leaf, each leaf once. The same value on every rank."""
    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(grads, specs):
        split = split_axes(spec, mesh)
        over = tuple(a for a in AXES if a in split)
        s = (g.float() ** 2).sum()
        parts[over] = parts[over] + s if over in parts else s
    total = None
    for over in sorted(parts):
        s = all_reduce_sum(parts[over], mesh, over)
        total = s if total is None else total + s
    return total


def batch_rows(x: torch.Tensor, mesh, micro: int = 1) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (dim 0) over ('data',
    'fsdp'). With ``micro`` > 1 (the GPipe microbatches) the batch is
    ``micro`` consecutive microbatches and the rank takes its block of
    each, so its own microbatch j holds its rows of the global microbatch
    j, the rows over which the JAX package's pipeline takes microbatch
    j's MoE statistics. A batch that does not divide raises ValueError."""
    n = axis(mesh, DATA).size * axis(mesh, FSDP).size
    if n == 1:
        return x
    b = x.shape[0]
    if b % (n * micro):
        raise ValueError(f"batch of {b} rows does not divide over data x fsdp = {n} ranks"
                         + (f" in {micro} microbatches" if micro > 1 else ""))
    rows = x.reshape((micro, b // micro) + tuple(x.shape[1:]))
    rows = local_shard(rows, (None, BATCH_AXES), mesh)
    return rows.reshape((b // n,) + tuple(x.shape[1:]))
