"""Duplex replicas over disjoint ranks (vita_tpu.serve.duplex_http's and
duplex_demo's ``--mesh EXPERT MODEL``).

A launch of 2*E*M ranks splits into two replicas of an expert x model
serving mesh each (``parallel.distributed.serving_replicas``): ranks
[0, per) serve replica 0, ranks [per, 2*per) replica 1. Each replica runs
its own step loop, a ``MeshEngineThread`` over a gloo group of its ranks,
led by its lowest rank; no collective spans both replicas. They are not
wholly apart: replica 1's leader waits, once a step, on a round trip to a
thread of rank 0, which shares its interpreter with replica 0's loop and
the server (``ReplicaLink.wait_s`` sums that wait).

Global rank 0 leads replica 0 and hosts the duplex controller (and the
HTTP server, VAD, TTS and camera). For replica 1 it holds a
``RemoteReplica``, which the controller drives as it drives an Engine
(``submit``, ``cancel_all``, ``stats``). Its thread and replica 1's leader
(its loop's ``ReplicaLink``) exchange one message each way per replica-1
step over a two-rank gloo group {0, per}: the leader sends the tokens and
finishes its requests streamed since the last exchange, in order (and now
and then its Engine's stats); rank 0 answers with the new submissions,
the ids of cancelled requests and a stop flag, and hands the tokens and
finishes to the submitted requests' ``on_token``/``on_finish``, where the
controller's state-token gate reads them.

An error on any rank of either replica ends both: the failing rank closes
its process group, every collective or exchange that waits on it raises,
and each loop that raises closes its own (``engine.end_process_group``),
finishes its requests with the reason 'error' and calls its
``on_error`` (rank 0: the server's shutdown).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from vita_tpu_torch.serve.engine import (
    _REQUEST_FIELDS,
    Engine,
    MeshEngineThread,
    Request,
    end_process_group,
)

STATS_EVERY_S = 1.0  # how often a replica leader sends its Engine's stats


class ReplicaLink:
    """The link of replica 1's leader to rank 0: called by
    its MeshEngineThread before each step, it sends the streamed events and
    takes rank 0's submissions, cancellations and stop flag."""

    def __init__(self, group):
        self.group = group
        self._outbox: List[tuple] = []
        self._shadows: Dict[int, Request] = {}
        self._stats_t = 0.0
        self.exchanges = 0
        self.wait_s = 0.0  # time in the exchanges' round trips to rank 0

    def _finish(self, rid: int, reason: str) -> None:
        self._shadows.pop(rid, None)
        self._outbox.append(("finish", rid, reason))

    def exchange(self, loop: MeshEngineThread) -> None:
        import torch.distributed as dist

        events, self._outbox = self._outbox, []
        stats = None
        if time.time() - self._stats_t > STATS_EVERY_S:
            stats, self._stats_t = loop.engine.stats(), time.time()
        t0 = time.perf_counter()
        dist.send_object_list([events, stats], dst=0, group=self.group)
        box = [None]
        dist.recv_object_list(box, src=0, group=self.group)
        self.wait_s += time.perf_counter() - t0
        self.exchanges += 1
        cmd = box[0]
        for fields in cmd["new"]:
            req = Request(**fields)
            rid = req.request_id
            req.on_token = lambda tok, rid=rid: self._outbox.append(("token", rid, tok))
            req.on_finish = lambda toks, reason, rid=rid: self._finish(rid, reason)
            self._shadows[rid] = req
            loop.submit(req)
        for rid in cmd["cancel"]:
            if rid in self._shadows:
                self._shadows[rid].cancel()
        if cmd["stop"]:
            loop.stop()


class RemoteReplica(threading.Thread):
    """Rank 0's stand-in for the Engine of a replica led by rank
    ``leader``: ``submit`` (checked with ``check``, the local Engine's
    limits), ``cancel_all`` and ``stats`` as on an Engine; its thread runs
    the exchange with the leader's ``ReplicaLink``. Submitted requests get
    their tokens, times and callbacks here, in the order the leader's
    Engine produced them."""

    def __init__(self, group, leader: int, check: Optional[Callable[[Request], None]] = None,
                 on_error: Optional[Callable[[], None]] = None):
        super().__init__(daemon=True)
        self.group, self.leader = group, leader
        self.check = check
        self.on_error = on_error
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._new: List[Request] = []
        self._live: Dict[int, Request] = {}
        self._stats: Dict[str, float] = {}
        self._stop_evt = threading.Event()

    def submit(self, req: Request) -> Request:
        if self.check is not None:
            self.check(req)
        req.submit_time = time.time()
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"the serving replica has stopped: {self.error!r}")
            self._new.append(req)
            self._live[req.request_id] = req
        return req

    def cancel_all(self) -> None:
        with self._lock:
            reqs = list(self._live.values())
        for r in reqs:
            r.cancel()

    def stats(self) -> Dict[str, float]:
        return dict(self._stats)

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 - ends both replicas, loudly
            traceback.print_exc()
            with self._lock:
                self.error = e
                live, self._live, self._new = list(self._live.values()), {}, []
            for req in live:
                if req.on_finish is not None:
                    req.on_finish(req.tokens, "error")
            end_process_group()
            if self.on_error is not None:
                self.on_error()

    def _deliver(self, events) -> None:
        for kind, rid, value in events:
            req = self._live.get(rid)
            if req is None:
                continue
            if kind == "token":
                if not req.tokens:
                    req.first_token_time = time.time()
                req.tokens.append(value)
                if req.on_token is not None:
                    req.on_token(value)
            else:
                with self._lock:
                    self._live.pop(rid, None)
                req.finish_time = time.time()
                if req.on_finish is not None:
                    req.on_finish(list(req.tokens), value)

    def _loop(self) -> None:
        import torch.distributed as dist

        while True:
            box = [None, None]
            dist.recv_object_list(box, src=self.leader, group=self.group)
            events, stats = box
            if stats is not None:
                self._stats = stats
            self._deliver(events)
            with self._lock:
                new, self._new = self._new, []
                cancel = [rid for rid, r in self._live.items() if r.cancelled]
            stop = self._stop_evt.is_set()
            cmd = {"new": [{f: getattr(r, f) for f in _REQUEST_FIELDS} for r in new],
                   "cancel": cancel, "stop": stop}
            dist.send_object_list([cmd], dst=self.leader, group=self.group)
            if stop:
                return


def serve_one(engine, req: Request, timeout: float = 600.0) -> None:
    """Submit ``req`` and return once it has finished: an Engine not yet
    driven by a thread is stepped here, a running replica loop
    (MeshEngineThread, RemoteReplica) is waited on (the duplex surfaces'
    warm-up requests)."""
    if isinstance(engine, Engine):
        engine.submit(req)
        engine.run_until_idle()
        return
    done = threading.Event()
    req.on_finish = lambda tokens, reason: done.set()
    engine.submit(req)
    if not done.wait(timeout):
        raise RuntimeError(f"a serving replica did not finish a request in {timeout:.0f} s")


def replica_loop(replicas, engine: Engine,
                 on_error: Optional[Callable[[], None]] = None) -> MeshEngineThread:
    """This rank's step loop of its replica (not started): every rank of
    both replicas builds one; replica 1's leader gets its link to rank 0."""
    import torch.distributed as dist

    lead = dist.get_rank() == replicas.leader
    link = ReplicaLink(replicas.link) if lead and replicas.index > 0 else None
    return MeshEngineThread(engine, on_error=on_error, group=replicas.control, link=link)


def start_replicas(replicas, loop: MeshEngineThread,
                   on_error: Optional[Callable[[], None]] = None) -> list:
    """On rank 0: start replica 0's loop and the RemoteReplica of replica
    1; the two engines the duplex controller drives, in replica order."""
    remote = RemoteReplica(replicas.link, replicas.per, check=loop.engine.check,
                           on_error=on_error)
    loop.on_error = on_error
    loop.start()
    remote.start()
    return [loop, remote]
