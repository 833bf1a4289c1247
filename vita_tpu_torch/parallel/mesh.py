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
process group of one axis. The collectives ``all_reduce_sum`` (and
``sum_stat``, its form for a statistic every rank uses whole),
``all_gather_cat`` and ``shift_down`` (the ring's point-to-point step) run
over one axis's group; a gloo group stages CUDA tensors through host
memory (ranks that share one card talk over gloo).
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
    """(expert, model) sizes of a serving mesh. A 'seq' axis > 1 raises
    ValueError (a KV cache holds whole sequences); the axes the serving
    path does not shard over yet raise, naming their ROADMAP item."""
    if axis(mesh, PIPE).size > 1:
        raise NotImplementedError(
            "pipeline-parallel serving (a 'pipe' axis > 1) is not ported yet (ROADMAP A11c)")
    if axis(mesh, SEQ).size > 1:
        raise ValueError(
            "seq-parallel attention supports the cacheless path only (Sq == Skv); "
            "KV-cache decode/prefill needs seq axis 1")
    if axis(mesh, DATA).size > 1 or axis(mesh, FSDP).size > 1:
        raise NotImplementedError(
            "data/fsdp axes > 1 (sharded training) are not ported yet (ROADMAP A11d)")
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


def all_reduce_sum(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of axis ``name``, added in float32
    and rounded once to x's dtype; ``x`` itself when the axis has size 1."""
    a = axis(mesh, name)
    if a.size == 1:
        return x
    buf = x.float()
    buf = buf.cpu() if buf.is_cuda and a.staged else buf.clone() if buf is x else buf
    dist.all_reduce(buf, group=a.group)
    return buf.to(device=x.device, dtype=x.dtype)


def all_gather_cat(x: torch.Tensor, mesh, name: str, dim: int = -1) -> torch.Tensor:
    """The blocks of the ranks of axis ``name`` joined along ``dim`` in
    rank order; ``x`` itself when the axis has size 1."""
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


class _SumStat(torch.autograd.Function):
    """all_reduce_sum forward; the backward hands each rank the gradient
    of its own summand only (the identity)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        return all_reduce_sum(x, mesh, name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_stat(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of axis ``name`` (as
    ``all_reduce_sum``) for a statistic that every rank then uses whole:
    its backward passes the incoming gradient to this rank's ``x`` and
    does not sum it over the axis. So when every rank adds the same
    function of the sum to its objective, the gradients summed over the
    axis are those of one such term, not ``size`` times them."""
    if axis(mesh, name).size == 1:
        return x
    return _SumStat.apply(x, mesh, name)


def shift_down(tensors: Sequence[torch.Tensor], mesh, name: str):
    """Each rank of axis ``name`` sends ``tensors`` to the rank before it
    (cyclically) and returns those of the rank after it, as new tensors of
    the same shapes, dtypes and device. One buffer of raw bytes travels
    each way (``batch_isend_irecv``); a gloo group stages CUDA tensors
    through host memory."""
    a = axis(mesh, name)
    if a.size == 1:
        return list(tensors)
    dev = tensors[0].device
    send = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    if send.is_cuda and a.staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    peer = lambda r: dist.get_global_rank(a.group, r % a.size)  # noqa: E731
    ops = [dist.P2POp(dist.isend, send, peer(a.rank - 1), a.group),
           dist.P2POp(dist.irecv, recv, peer(a.rank + 1), a.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    recv = recv.to(dev)
    out, at = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(recv[at:at + nbytes].clone().view(t.dtype).reshape(t.shape))
        at += nbytes
    return out
