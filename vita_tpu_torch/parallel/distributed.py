"""Process-group setup and the global mesh (vita_tpu.parallel.distributed).

Under torchrun each process calls ``initialize(backend)`` once: the rank,
world size and rendezvous address come from ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, then
``global_mesh(shape)`` builds the 6-axis mesh over every rank,
``serving_mesh`` the ``--mesh EXPERT MODEL [PIPE]`` mesh of the serving
surfaces, ``training_mesh`` the ``--mesh DATA FSDP EXPERT MODEL [PIPE
[SEQ]]`` mesh of the train CLI, or ``serving_replicas`` splits the ranks
into two replicas of one expert x model mesh each (the duplex surfaces'
two Engines).

The backend is always the caller's choice, never found by trying one:
``nccl`` when each rank has a card of its own, ``gloo`` on the CPU or when
several ranks share one card (nccl refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from vita_tpu_torch.parallel.mesh import make_mesh

BACKENDS = ("nccl", "gloo")


def initialize(backend: str) -> None:
    """Idempotent process-group init from torchrun's variables; a no-op
    for one process. WORLD_SIZE > 1 without RANK raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    if "RANK" not in os.environ:
        raise RuntimeError(
            f"WORLD_SIZE={world} is set but RANK is not: every process "
            "would claim rank 0 and the rendezvous would hang; set RANK per "
            "process (torchrun semantics)"
        )
    address = (os.environ.get("MASTER_ADDR", "127.0.0.1") + ":"
               + os.environ.get("MASTER_PORT", "29500"))
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=int(os.environ["RANK"]))


def global_mesh(shape: Optional[Sequence[int]] = None):
    """The mesh over every rank (call after initialize())."""
    return make_mesh(shape=shape)


def _serving_axes(axes: Sequence[int], pipe: bool = True) -> List[int]:
    axes = [int(a) for a in axes]
    if len(axes) == 3 and not pipe:
        raise ValueError(f"the duplex replicas take --mesh EXPERT MODEL, got {axes}")
    if len(axes) not in (2, 3):
        raise ValueError(f"--mesh takes EXPERT MODEL [PIPE], got {axes}")
    if any(a < 1 for a in axes):
        raise ValueError(f"--mesh sizes must be positive, got {axes}")
    return axes


def serving_mesh(axes: Sequence[int], backend: str):
    """The mesh of ``--mesh EXPERT MODEL [PIPE]`` over the ranks of a
    torchrun launch (or one process), (1, 1, EXPERT, MODEL, PIPE), the
    process group started with ``backend``."""
    axes = _serving_axes(axes)
    initialize(backend)
    return global_mesh((1, 1) + tuple(axes))


def training_mesh(axes: Sequence[int], backend: str):
    """The mesh of ``--mesh DATA FSDP EXPERT MODEL [PIPE [SEQ]]`` over the
    ranks of a torchrun launch (or one process), the process group started
    with ``backend``: the 4-6 axis form of ``make_mesh``, with the JAX
    package's ValueErrors (an axis count outside 4-6, a shape that does
    not cover the ranks)."""
    axes = [int(a) for a in axes]
    if not 4 <= len(axes) <= 6:
        raise ValueError(f"mesh shape must have 4-6 axes (data, fsdp, expert, model, pipe, "
                         f"seq), got {tuple(axes)}")
    if any(a < 1 for a in axes):
        raise ValueError(f"--mesh sizes must be positive, got {axes}")
    initialize(backend)
    return global_mesh(axes)


@dataclasses.dataclass
class Replicas:
    """This rank's place among the two duplex replicas of one serving mesh
    each: replica i holds ranks [i*per, (i+1)*per) and its leader is rank
    i*per."""
    index: int  # this rank's replica, 0 or 1
    per: int  # ranks a replica
    mesh: Any  # this rank's replica's mesh (expert x model over its ranks)
    control: Any  # gloo group of this replica's ranks: its step loop's broadcasts
    link: Any  # gloo group {0, per}: rank 0 and replica 1's leader (None elsewhere)

    @property
    def leader(self) -> int:
        return self.index * self.per


def serving_replicas(axes: Sequence[int], backend: str) -> Replicas:
    """The two duplex replicas of the ``--mesh EXPERT MODEL`` serving mesh
    over the ranks of a torchrun launch of 2*EXPERT*MODEL ranks, the
    process group started with ``backend``. Every rank builds both
    replicas' meshes and groups in the same order (creating a group is
    collective over the whole process group) and keeps its own. The
    duplex surfaces take two axes, as the JAX package's do."""
    expert, model = _serving_axes(axes, pipe=False)
    per = expert * model
    initialize(backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != 2 * per:
        raise ValueError(f"--mesh {expert} {model} serves 2 replicas of {per} rank(s): "
                         f"launch {2 * per} ranks, not {world}")
    spans = [list(range(0, per)), list(range(per, 2 * per))]
    meshes = [make_mesh((1, 1, expert, model), ranks=r) for r in spans]
    controls = [dist.new_group(r, backend="gloo") for r in spans]
    link = dist.new_group([0, per], backend="gloo")
    rank = dist.get_rank()
    index = rank // per
    return Replicas(index, per, meshes[index], controls[index],
                    link if rank in (0, per) else None)


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: for 'cuda', card LOCAL_RANK modulo the cards
    visible (ranks beyond the card count share cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def default_backend(device: torch.device) -> str:
    """nccl for cards (one rank each), gloo for the CPU; ranks that share
    a card pass gloo themselves."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"
