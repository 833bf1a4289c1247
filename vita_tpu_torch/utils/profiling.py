"""Tracing and profiling utilities (vita_tpu.utils.profiling on PyTorch).

- ``sync(x)`` waits for the device work behind a tensor (or a dict, list
  or tuple of them): ``torch.cuda.synchronize`` on the tensor's card, and
  nothing for CPU tensors, whose work is done when the call returns.
- ``PhaseTimer`` accumulates per-phase times: on a card, CUDA events
  around each phase; on the CPU, the host clock.
- ``trace(logdir)`` captures a ``torch.profiler`` trace of the CPU and,
  when a card is present, CUDA activity, written as a Chrome trace to
  ``logdir/trace.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait until the device work producing ``x`` has finished."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class PhaseTimer:
    """Accumulates per-phase times; phases like encode/prefill/decode.

    ``with timer.phase("prefill", result=out) as box:`` times the block;
    the block may instead put what it computed under ``box["sync"]``. With
    a card, each phase is timed by CUDA events recorded on the current
    stream before and after it; without one, by the host clock."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        events = None
        if torch.cuda.is_available():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        out: dict = {}
        try:
            yield out
        finally:
            if events is not None:
                events[1].record()
                events[1].synchronize()
                dt = events[0].elapsed_time(events[1]) / 1e3
            else:
                sync(out["sync"] if "sync" in out else result)
                dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(v / self.counts[k] * 1000, 3)}
            for k, v in self.totals.items()
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler capture of the block (CPU, and CUDA when a card is
    present), exported as a Chrome trace to ``logdir/trace.json``; yields
    the profiler, whose ``key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
