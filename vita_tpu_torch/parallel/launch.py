"""Start a group of ranks on one host and collect what each returns.

``run_ranks(fn, world_size, *args)`` spawns ``world_size`` processes, each
of which joins a process group through a FileStore (no TCP port to pick),
calls ``fn(rank, world_size, *args)`` and sends back its result. A rank
that raises or a group that outlives ``timeout`` stops every rank and
raises here. ``fn`` must be importable by name from a module (spawned
processes import it afresh), and so must its arguments' types. It should
return plain values (numpy arrays, not tensors: a tensor travels as a
handle to the rank's shared memory, which is gone once the rank exits).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


def _rank_main(fn, rank, world_size, store_path, backend, threads, out, args):
    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: loopback only
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size)
        result = fn(rank, world_size, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
              timeout: float = 600.0, store_dir: Optional[str] = None,
              threads: int = 0) -> List[Any]:
    """[fn(0, world_size, *args), ..., fn(world_size - 1, ...)], each run
    in its own spawned process; ``threads`` > 0 sets each rank's torch
    CPU threads. Raises RuntimeError with the first failing rank's
    traceback, or when the ranks have not all returned within ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="vita_ranks_", dir=store_dir), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, store, backend, threads, out, args),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * world_size
    deadline = time.time() + timeout
    try:
        for _ in range(world_size):
            while True:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    if time.time() > deadline:
                        raise RuntimeError(f"ranks did not finish within {timeout:.0f} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return results
