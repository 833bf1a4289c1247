"""Process-group setup and the global mesh (vita_tpu.parallel.distributed).

Under torchrun each process calls ``initialize(backend)`` once: the rank,
world size and rendezvous address come from ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, then
``global_mesh(shape)`` builds the 6-axis mesh over every rank.

The backend is always the caller's choice, never found by trying one:
``nccl`` when each rank has a card of its own, ``gloo`` on the CPU or when
several ranks share one card (nccl refuses two ranks on one device).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

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


def serving_mesh(axes: Sequence[int], backend: str):
    """The mesh of ``--mesh EXPERT MODEL`` over the ranks of a torchrun
    launch (or one process), the process group started with ``backend``."""
    axes = [int(a) for a in axes]
    if len(axes) == 3:
        raise NotImplementedError(
            "--mesh EXPERT MODEL PIPE: pipeline-parallel serving is not ported yet "
            "(ROADMAP A11c); pass EXPERT MODEL")
    if len(axes) != 2:
        raise ValueError(f"--mesh takes EXPERT MODEL, got {axes}")
    initialize(backend)
    return global_mesh((1, 1, axes[0], axes[1]))


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
