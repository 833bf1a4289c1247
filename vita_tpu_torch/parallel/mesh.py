"""The 6-axis device mesh and its collectives (vita_tpu.parallel.mesh).

Axes, in order: ``data`` (batch data parallelism), ``fsdp`` (parameter
sharding), ``expert`` (MoE expert parallelism), ``model`` (tensor
parallelism of heads and vocabulary), ``pipe`` (pipeline stages) and
``seq`` (sequence parallelism). A mesh is a ``DeviceMesh`` over the ranks
of the process group (or over a list of them: a serving replica) with
these dim names; rank r sits at r's row-major coordinate, as the JAX
package reshapes its device list.

In place of ``NamedSharding``: ``local_shard`` cuts a full tensor into this
rank's block by a spec tuple (``None``, an axis name or a tuple of names
per dim, as a PartitionSpec), and ``axis`` gives the size, rank and
process group of one axis. The collectives run over one axis's group
or over several axes in turn (a tuple of names, blocks ordered as
``local_shard`` cuts them), each differentiable where autograd records
its input, in the pairs of Megatron's tensor parallelism:

- ``all_reduce_sum`` ("g"): the sum forward, the identity backward, for
  a sum of partials that every rank then uses whole (a row-parallel
  product's output, the aux loss's statistics);
- ``all_reduce_grad`` ("f"): the identity forward, the sum backward, for
  a tensor every rank uses whole that feeds this rank's part of a
  column-parallel product (its gradient there is a partial);
- ``all_gather_cat``: the join forward, a reduce-scatter backward, where
  each rank adds its own function of the whole tensor to an objective of
  its own (the fsdp gather);
- ``all_gather_slice``: the join forward, this rank's slice of the
  gradient backward, where every rank of the axis computes the same
  objective from the whole tensor (the logits over 'model', a tower's
  leaves gathered over 'model').

``serving_axes`` says which axes a serving mesh may use (a training
mesh takes all six, as ``vita.param_specs`` places the leaves);
``broadcast_from`` sends one coordinate's tensors to the rest of an
axis; ``shift_down`` (the seq ring's step) and ``shift_up`` (the pipeline's
stage-to-stage step, as a chain or a cycle) move tensors point to point
along one axis. A gloo group stages CUDA tensors through host memory
(ranks that share one card talk over gloo).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA, FSDP, EXPERT, MODEL, PIPE, SEQ = (
    "data", "fsdp", "expert", "model", "pipe", "seq"
)
AXES: Tuple[str, ...] = (DATA, FSDP, EXPERT, MODEL, PIPE, SEQ)
REDUCE_SLICE = 1 << 26  # elements a gather's backward reduce-scatters at once


def make_mesh(shape: Optional[Sequence[int]] = None, ranks: Optional[Sequence[int]] = None):
    """The 6-axis mesh over every rank of the process group, or over
    ``ranks`` (global ranks, row-major).

    ``shape`` is (data, fsdp, expert, model[, pipe[, seq]]) sizes whose
    product is the number of ranks (pipe and seq default to 1). Default:
    all ranks on the fsdp axis. A one-process run with no process group
    gets a one-rank gloo group. The mesh's device type is 'cuda' under nccl
    and 'cpu' otherwise (its groups carry CUDA tensors either way).

    Building a mesh creates its axis groups, which is collective over the
    whole process group: every rank builds every mesh over ``ranks``, its
    own and the others', in the same order (a rank outside a mesh gets a
    mesh it takes no part in)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if any(not 0 <= r < world for r in ranks) or len(set(ranks)) != len(ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a group of {world}")
    n = len(ranks)
    if shape is None:
        shape = (1, n, 1, 1)
    shape = tuple(int(s) for s in shape)
    while 4 <= len(shape) < 6:
        shape = shape + (1,)
    if len(shape) != 6:
        raise ValueError(f"mesh shape must have 4-6 axes {AXES}, got {shape}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=AXES)


@dataclasses.dataclass(frozen=True)
class Axis:
    size: int
    rank: int  # this rank's coordinate on the axis
    group: Any  # the axis's process group (None for a missing mesh)

    @property
    def staged(self) -> bool:
        """A gloo group: CUDA tensors go through host memory."""
        return dist.get_backend(self.group) == "gloo"


_NO_AXIS = Axis(1, 0, None)


def axis(mesh, name: str) -> Axis:
    """Size, coordinate and group of axis ``name`` (size 1 without a mesh)."""
    if mesh is None:
        return _NO_AXIS
    cache = getattr(mesh, "_vita_axes", None)
    if cache is None:
        cache = {}
        for i, n in enumerate(mesh.mesh_dim_names):
            cache[n] = Axis(mesh.size(i), mesh.get_local_rank(n), mesh.get_group(n))
        mesh._vita_axes = cache
    return cache[name]


def serving_axes(mesh) -> Tuple[int, int]:
    """(expert, model) sizes of a serving mesh (which may also have a
    'pipe' axis, and 'data' or 'fsdp' axes, as the JAX package's Engine
    places its params by ``param_specs`` and gives its pool no batch axis:
    a rank holds its 'fsdp' blocks, every layer gathers its weights whole
    at its top, and every rank of 'data' x 'fsdp' serves the whole batch).
    A 'seq' axis > 1 raises ValueError (a KV cache holds whole
    sequences)."""
    if axis(mesh, SEQ).size > 1:
        raise ValueError(
            "seq-parallel attention supports the cacheless path only (Sq == Skv); "
            "KV-cache decode/prefill needs seq axis 1")
    return axis(mesh, EXPERT).size, axis(mesh, MODEL).size


def local_shard(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (a view):
    each dim named by axes is cut into equal blocks, the block index
    row-major over the named axes, as a PartitionSpec shards."""
    for dim, names in enumerate(spec):
        if names is None:
            continue
        names = (names,) if isinstance(names, str) else tuple(names)
        size, rank = 1, 0
        for n in names:
            a = axis(mesh, n)
            size, rank = size * a.size, rank * a.size + a.rank
        if size == 1:
            continue
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {names} "
                             f"({size} ranks)")
        step = x.shape[dim] // size
        x = x.narrow(dim, rank * step, step)
    return x


def _names(name) -> Tuple[str, ...]:
    return (name,) if isinstance(name, str) else tuple(name)


def all_reduce_sum(x: torch.Tensor, mesh, name) -> torch.Tensor:
    """The sum of ``x`` over the ranks of axis ``name`` (or of several
    axes, a tuple of names), added in float32 and rounded once to x's
    dtype; ``x`` itself when the axes have size 1.

    Differentiable where autograd records ``x`` (Megatron's "g"): the
    backward hands this rank's ``x`` the incoming gradient as it is and
    sums nothing. So when every rank of the axes adds the same function of
    the sum to its objective (a row-parallel product's output, the aux
    loss's statistics), each summand's gradient is that of one such term,
    not ``size`` times it."""
    names = [n for n in _names(name) if axis(mesh, n).size > 1]
    if not names:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _SumIdentity.apply(x, mesh, tuple(names))
    return _reduce(x, mesh, names)


def _reduce(x: torch.Tensor, mesh, names) -> torch.Tensor:
    buf = x.float()
    for n in names:
        a = axis(mesh, n)
        staged = buf.cpu() if buf.is_cuda and a.staged else buf.clone() if buf is x else buf
        dist.all_reduce(staged, group=a.group)
        buf = staged
    return buf.to(device=x.device, dtype=x.dtype)


class _SumIdentity(torch.autograd.Function):
    """all_reduce_sum forward; the backward hands each rank the gradient
    of its own summand only (the identity)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        return _reduce(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_grad(x: torch.Tensor, mesh, name) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the ranks of axis
    ``name`` (or of several axes) in the backward (Megatron's "f"; float32,
    rounded once): for a tensor that every rank of the axes holds whole
    and feeds to its own part of a product split over them (this rank's
    heads, ffn columns or experts), so that the gradient each rank passes
    on is the whole one, the same on every rank."""
    names = tuple(n for n in _names(name) if axis(mesh, n).size > 1)
    if not names or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _GradSum.apply(x, mesh, names)


class _GradSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.mesh, ctx.names), None, None


def all_gather_cat(x: torch.Tensor, mesh, name, dim: int = -1) -> torch.Tensor:
    """The blocks of the ranks of axis ``name`` joined along ``dim`` in
    rank order; ``x`` itself when the axis has size 1. A tuple of names
    joins the blocks row-major over them, as ``local_shard`` cuts a dim
    over that tuple (the last name's blocks innermost).

    Differentiable where autograd records ``x``: the backward
    reduce-scatters, each rank adding the blocks of the incoming gradient
    that the ranks of the axes send it (float32, in rank order, rounded
    once). So when every rank adds its own function of the whole tensor
    to its objective, each block's gradient is that of the ranks'
    objectives summed (the fsdp gather)."""
    names = tuple(n for n in _names(name) if axis(mesh, n).size > 1)
    if not names:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherCat.apply(x, mesh, names, dim)
    for n in reversed(names):
        x = _gather_one(x, mesh, n, dim)
    return x


class _GatherCat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        for n in reversed(names):
            x = _gather_one(x, mesh, n, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        # in slices along another dim, so one slice's buffers at a time are
        # staged (a gathered layer's gradient is GBs)
        dim = ctx.dim % g.dim()
        cdim = 0 if dim else g.dim() - 1
        per = max(1, REDUCE_SLICE // max(1, g.numel() // max(1, g.shape[cdim])))
        parts = g.split(per, cdim) if g.dim() > 1 else [g]
        out = []
        for part in parts:
            for n in ctx.names:
                part = _reduce_scatter_one(part, ctx.mesh, n, dim)
            out.append(part.to(g.dtype))
        return torch.cat(out, cdim) if len(out) > 1 else out[0], None, None, None


def all_gather_slice(x: torch.Tensor, mesh, name, dim: int = -1) -> torch.Tensor:
    """The blocks of the ranks of axis ``name`` (or of several axes)
    joined along ``dim``, as ``all_gather_cat`` joins them; its backward
    takes this rank's block of the incoming gradient and sums nothing. For
    a tensor from which every rank of the axes computes the same objective
    (the logits split over 'model', a tower's leaves gathered whole over
    'model'): each rank's own gradient of the whole is already the whole
    gradient."""
    names = tuple(n for n in _names(name) if axis(mesh, n).size > 1)
    if not names:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherSlice.apply(x, mesh, names, dim)
    for n in reversed(names):
        x = _gather_one(x, mesh, n, dim)
    return x


class _GatherSlice(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        for n in reversed(names):
            x = _gather_one(x, mesh, n, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        spec = [None] * g.dim()
        spec[ctx.dim % g.dim()] = ctx.names
        return local_shard(g, spec, ctx.mesh).contiguous(), None, None, None


def _reduce_scatter_one(g: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``g`` over the ranks
    of axis ``name``, in float32: each rank sends every other rank that
    rank's block (one all_to_all of raw bytes, staged through host memory
    on gloo), then adds the blocks it received in rank order."""
    a = axis(mesh, name)
    blocks = g.chunk(a.size, dim)
    send = torch.cat([b.contiguous().reshape(-1) for b in blocks]).view(torch.uint8)
    if send.is_cuda and a.staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=a.group)
    got = recv.to(g.device).view(g.dtype).reshape((a.size,) + tuple(blocks[0].shape))
    total = got[0].float()
    for i in range(1, a.size):
        total = total + got[i].float()
    return total


def _gather_one(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    a = axis(mesh, name)
    if a.size == 1:
        return x
    src = x.contiguous()
    if src.is_cuda and a.staged:
        src = src.cpu()
    if src.dtype == torch.bfloat16:  # gathered as raw bytes (gloo has no bf16 gather)
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(a.size)]
    dist.all_gather(parts, src, group=a.group)
    out = torch.cat(parts, dim)
    if x.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    return out.to(x.device)


def _pack(tensors: Sequence[torch.Tensor], staged: bool) -> torch.Tensor:
    """The tensors' bytes in one flat uint8 buffer (on the host when
    ``staged``)."""
    buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    return buf.cpu() if buf.is_cuda and staged else buf


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]):
    """New tensors of ``like``'s shapes, dtypes and device from the bytes
    of ``buf``."""
    buf = buf.to(like[0].device)
    out, at = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        out.append(buf[at:at + nbytes].clone().view(t.dtype).reshape(t.shape))
        at += nbytes
    return out


def broadcast_from(tensors: Sequence[torch.Tensor], mesh, name: str, src: int):
    """The tensors of the rank at coordinate ``src`` of axis ``name`` on
    every rank of the axis, as new tensors (this rank's ``tensors`` give
    the shapes, dtypes and device; the source's own come back as they
    are). One buffer of raw bytes travels; a gloo group stages it through
    host memory."""
    a = axis(mesh, name)
    if a.size == 1:
        return list(tensors)
    buf = _pack(tensors, a.staged)
    dist.broadcast(buf, dist.get_global_rank(a.group, src), group=a.group)
    return list(tensors) if a.rank == src else _unpack(buf, tensors)


def shift_down(tensors: Sequence[torch.Tensor], mesh, name: str, cycle: bool = True,
               send: bool = True, recv: bool = True):
    """Each rank of axis ``name`` sends ``tensors`` to the rank before it
    (cyclically) and returns those of the rank after it, as new tensors of
    the same shapes, dtypes and device. One buffer of raw bytes travels
    each way (``batch_isend_irecv``); a gloo group stages CUDA tensors
    through host memory. ``cycle``, ``send`` and ``recv`` as for
    ``shift_up``, whose step this reverses."""
    return _shift(tensors, mesh, name, -1, cycle, send, recv)


def shift_up(tensors: Sequence[torch.Tensor], mesh, name: str, cycle: bool = False,
             send: bool = True, recv: bool = True):
    """The pipeline's stage-to-stage step: each rank of axis ``name`` sends
    ``tensors`` to the rank after it and receives from the rank before
    it, as ``shift_down`` packs and stages them. ``cycle`` False is a
    chain (the last rank sends nothing, the first receives nothing);
    True wraps the last rank to the first. ``send`` / ``recv`` False
    leave out this rank's send / receive of the step (a pipeline bubble);
    the peer must leave out the matching receive / send. Returns the
    received tensors (``tensors`` give their shapes), or None when this
    rank received nothing."""
    return _shift(tensors, mesh, name, 1, cycle, send, recv)


def _shift(tensors, mesh, name: str, step: int, cycle: bool, send: bool, recv: bool):
    a = axis(mesh, name)
    if a.size == 1:
        return list(tensors) if cycle and send and recv else None
    to, frm = a.rank + step, a.rank - step
    if cycle:
        to, frm = to % a.size, frm % a.size
    send = send and 0 <= to < a.size
    recv = recv and 0 <= frm < a.size
    ops = []
    peer = lambda r: dist.get_global_rank(a.group, r)  # noqa: E731
    if send:
        ops.append(dist.P2POp(dist.isend, _pack(tensors, a.staged), peer(to), a.group))
    if recv:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        dev = "cpu" if a.staged else tensors[0].device
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        ops.append(dist.P2POp(dist.irecv, buf, peer(frm), a.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _unpack(buf, tensors) if recv else None
