"""Serving engine: continuous batching over a paged KV pool with chunked
prefill (vita_tpu.serve.engine, single-device path).

- Paged KV with lazy growth and preemption: all slots share one page pool
  (ops.paged_attention). A request reserves its prompt's pages at
  admission and grows before each decode chunk (_ensure_pages); under pool
  pressure the newest request is preempted and later re-prefills
  prompt+generated tokens (recompute on resume), so greedy streams are
  unchanged by a preemption.
- Chunked prefill: a prompt prefills ``prefill_chunk`` tokens per engine
  tick into a linear scratch, interleaved with decode chunks and with other
  prefills; the finished scratch is scattered into the pool
  (install_prefill_pages) and the first token is sampled from the last
  chunk.
- Decode: one sampling.decode_chunk call advances every active slot
  ``decode_chunk_len`` tokens, with the batch padded to the next power of
  two; in pure decode phases up to ``decode_ticks`` chunks chain before the
  host reads the tokens back (one ``.cpu()`` per tick).
- Prompts, image tiles and audio frames pad to fixed buckets, as in the
  JAX package.
- Quantized serving: ``decode_moe_mode='gather_q'`` / ``'gather_q4'``
  decode from an int8 / int4 copy of the expert weights
  (mixtral.quantize_moe_for_decode) while prefill keeps the bf16 weights,
  so both copies are resident; ``kv_int8=True`` keeps the page pool in
  int8 with per-(row, head) scales.

Requests stream tokens to callbacks and can be cancelled mid-decode.
Options of the JAX engine that are not ported raise NotImplementedError:
a mesh (tensor, expert or pipeline parallel serving), the capacity/sort
decode modes, the capacity/sort/gmm prefill modes and ``session_key``
prefix reuse.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vita_tpu_torch.generate import (
    DEFAULT_FRAME_BUCKETS,
    DEFAULT_PROMPT_BUCKETS,
    DEFAULT_TILE_BUCKETS,
    pad_axis0,
    stack_encoded_clips,
    stack_speech_clips,
)
from vita_tpu_torch.models import mixtral, vita
from vita_tpu_torch.ops.moe import MODES
from vita_tpu_torch.ops.paged_attention import (
    PagePool,
    init_page_pool,
    install_prefill_pages,
    pages_needed,
)
from vita_tpu_torch.sampling import choose_sampling_mode, decode_chunk, sample_tokens
from vita_tpu_torch.tokenization import audio_select_arrays, pad_to_bucket

DECODE_MOE_MODES = MODES
PREFILL_MOE_MODES = ("dense",)
_JAX_ONLY_DECODE = ("capacity", "sort")
_JAX_ONLY_PREFILL = ("capacity", "sort", "gmm")


@dataclasses.dataclass
class Request:
    input_ids: np.ndarray  # [S] sentinel-free ids
    max_new_tokens: int = 512
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = 2
    image_mask: Optional[np.ndarray] = None
    audio_mask: Optional[np.ndarray] = None
    images: Optional[np.ndarray] = None
    speech: Optional[np.ndarray] = None
    speech_length: int = 0
    # Whale features encoded ahead of time: [T', whale_hidden] or a list of
    # clips; mutually exclusive with ``speech`` (only the adapter runs)
    audio_encoded: Optional[Any] = None
    audio_encoded_length: Any = 0
    on_token: Optional[Callable[[int], None]] = None
    on_finish: Optional[Callable[[List[int], str], None]] = None
    session_key: Optional[str] = None  # prefix reuse: not ported, must be None
    request_id: int = dataclasses.field(default_factory=itertools.count().__next__)

    # runtime state
    cancelled: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0

    def cancel(self) -> None:
        self.cancelled = True

    @property
    def ttft_s(self) -> float:
        return max(self.first_token_time - self.submit_time, 0.0)

    @property
    def decode_tokens_per_s(self) -> float:
        dt = self.finish_time - self.first_token_time
        return (len(self.tokens) - 1) / dt if dt > 0 and len(self.tokens) > 1 else 0.0


@dataclasses.dataclass
class _PrefillJob:
    req: Request
    slot: int
    pages: List[int]
    true_len: int
    bucket: int
    chunk: int  # chunk size for this bucket
    embeds: torch.Tensor  # [1, bucket, D]
    sk: torch.Tensor  # scratch kv [L, 1, bucket, Hkv, hd]
    sv: torch.Tensor
    mode: str  # sampling tier for this request
    offset: int = 0
    tok: Optional[torch.Tensor] = None  # first token [1] after the last chunk


@torch.no_grad()
def _prefill_chunk(llm_params, llm_cfg, job: _PrefillJob, generator) -> torch.Tensor:
    """One prefill chunk into the job's scratch (in place); samples the
    token after row ``true_len - 1`` (meaningful on the last chunk). The
    chunk attends over the whole bucket scratch with kv_len offset+chunk."""
    off, chunk = job.offset, job.chunk
    dev = job.embeds.device
    x = job.embeds[:, off:off + chunk]
    cache = {"k": job.sk, "v": job.sv,
             "pos": torch.tensor([off], dtype=torch.int32, device=dev)}
    positions = off + torch.arange(chunk, device=dev)[None]
    valid = torch.arange(job.bucket, device=dev)[None] < off + chunk
    hidden, _, _ = mixtral.forward(
        llm_params, llm_cfg, inputs_embeds=x, positions=positions,
        attn_valid=valid, cache=cache, return_hidden=True,
    )
    row = min(max(job.true_len - 1 - off, 0), chunk - 1)
    logits = hidden[:, row] @ llm_params["lm_head"]
    req = job.req
    return sample_tokens(
        logits, generator,
        torch.tensor([req.temperature], dtype=torch.float32, device=dev),
        torch.tensor([req.top_k], dtype=torch.int32, device=dev),
        torch.tensor([req.top_p], dtype=torch.float32, device=dev),
        mode=job.mode,
    )


class Engine:
    """Single-device continuous-batching engine over a paged KV pool."""

    def __init__(
        self,
        params,
        cfg: vita.VITAConfig,
        n_slots: int = 4,
        max_len: int = 4096,
        seed: int = 0,
        decode_moe_mode: Optional[str] = None,  # None = inherit cfg.llm.moe_mode
        prefill_moe_mode: Optional[str] = None,
        page_size: int = 64,
        total_pages: Optional[int] = None,  # default: n_slots * max_len / page
        prefill_chunk: int = 256,
        decode_chunk_len: int = 8,
        decode_ticks: int = 4,
        max_concurrent_prefills: int = 2,
        kv_int8: bool = False,
        prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
        tile_buckets: Sequence[int] = DEFAULT_TILE_BUCKETS,
        frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
        mesh=None,
        device: Optional[torch.device] = None,  # None = where the weights are
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving (tensor/expert/pipeline parallel) is not ported; "
                "the engine runs on one device"
            )
        if decode_moe_mode is None:
            decode_moe_mode = "gather" if cfg.llm.moe_mode == "gmm" else cfg.llm.moe_mode
        if prefill_moe_mode is None:
            prefill_moe_mode = cfg.llm.moe_mode
        for name, mode, ported, jax_only in (
            ("decode_moe_mode", decode_moe_mode, DECODE_MOE_MODES, _JAX_ONLY_DECODE),
            ("prefill_moe_mode", prefill_moe_mode, PREFILL_MOE_MODES, _JAX_ONLY_PREFILL),
        ):
            if mode in jax_only:
                raise NotImplementedError(
                    f"{name} {mode!r} is not ported; ported: {ported}")
            if mode not in ported:
                raise ValueError(f"bad {name} {mode!r}")
        self.params = params
        self.cfg = cfg
        self.device = torch.device(
            device if device is not None else params["llm"]["embed"].device)
        self.n_slots = n_slots
        self.max_len = max_len
        page_size = min(page_size, max_len)
        self.page_size = page_size
        self.decode_chunk_len = decode_chunk_len
        self.decode_ticks = max(1, decode_ticks)
        self.prefill_chunk = prefill_chunk
        buckets = sorted(b for b in prompt_buckets if b <= max_len)
        if not buckets or buckets[-1] < max_len:
            buckets.append(-(-max_len // page_size) * page_size)
        if any(b % page_size for b in buckets):
            raise ValueError("prompt buckets must be multiples of page_size")
        self.prompt_buckets = tuple(buckets)
        g = cfg.image_group_tiles  # framecat tiles come in 5-tuples
        self.tile_buckets = tuple(sorted({-(-b // g) * g for b in tile_buckets}))
        self.frame_buckets = tuple(sorted(frame_buckets))
        self._decode_cfg = dataclasses.replace(cfg.llm, moe_mode=decode_moe_mode)
        self._prefill_cfg = dataclasses.replace(cfg.llm, moe_mode=prefill_moe_mode)
        if decode_moe_mode in ("gather_q", "gather_q4"):
            self._decode_llm = mixtral.quantize_moe_for_decode(
                params["llm"], bits=4 if decode_moe_mode == "gather_q4" else 8)
        else:
            self._decode_llm = params["llm"]

        llm = cfg.llm
        self.max_pages_per_slot = pages_needed(max_len, page_size)
        if total_pages is None:
            total_pages = n_slots * self.max_pages_per_slot
        self.total_pages = total_pages
        self.alloc = PagePool(total_pages)
        self._table_np = np.zeros((n_slots, self.max_pages_per_slot), np.int32)
        self.cache = init_page_pool(
            llm.n_layers, llm.n_kv_heads, total_pages, page_size, llm.head_dim,
            dtype=llm.dtype, device=self.device, quantized=kv_int8,
        )

        # host-side slot state
        self.pos = np.zeros(n_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self._skip: List[int] = [0] * n_slots  # first token already emitted
        self._temps = np.zeros(n_slots, np.float32)
        self._topk = np.zeros(n_slots, np.int32)
        self._topp = np.ones(n_slots, np.float32)
        self._tok_dev = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._pending: collections.deque = collections.deque()
        self.max_concurrent_prefills = max(1, max_concurrent_prefills)
        self._prefill_jobs: List[_PrefillJob] = []
        self._finished: List[Request] = []
        # lifetime TTFT histogram (0.1 ms .. 1000 s, log-spaced)
        self._ttft_hist = np.zeros(256, np.int64)
        self._ttft_edges = np.logspace(-4, 3, 257)
        self._ttft_count = 0
        self._preempt_count = 0

    # -- public API -------------------------------------------------------
    def submit(self, req: Request) -> Request:
        if req.session_key is not None:
            raise NotImplementedError("session_key prefix reuse is not ported")
        if len(req.input_ids) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {len(req.input_ids) + req.max_new_tokens} slots, "
                f"cache holds {self.max_len}"
            )
        if pages_needed(len(req.input_ids) + req.max_new_tokens,
                        self.page_size) > self.total_pages:
            # lazy growth never deadlocks only if the oldest request's worst
            # case fits the pool once newer slots are reclaimed
            raise ValueError(
                "request's worst-case KV exceeds the page pool "
                f"({self.total_pages} pages of {self.page_size})"
            )
        req.submit_time = time.time()
        self.queue.put(req)
        return req

    def stats(self) -> Dict[str, float]:
        """Aggregate serving metrics; TTFT percentiles come from a histogram
        over every finished request."""
        out: Dict[str, float] = {
            "active": float(self.active_count()),
            "queued": float(self.queue.qsize() + len(self._pending)),
            "completed": float(self._ttft_count),
            "free_pages": float(self.alloc.free_count),
            "total_pages": float(self.total_pages),
            "preemptions": float(self._preempt_count),
        }
        if self._ttft_count:
            cum = np.cumsum(self._ttft_hist)
            for name, q in (("ttft_p50_s", 0.5), ("ttft_p99_s", 0.99)):
                i = min(int(np.searchsorted(cum, q * self._ttft_count)),
                        len(self._ttft_hist) - 1)
                out[name] = float(np.sqrt(self._ttft_edges[i] * self._ttft_edges[i + 1]))
        done = self._finished
        if done:
            out["ttft_max_s"] = max(r.ttft_s for r in done)
            tps = [r.decode_tokens_per_s for r in done if r.decode_tokens_per_s > 0]
            if tps:
                out["decode_tokens_per_s_mean"] = sum(tps) / len(tps)
        return out

    def active_count(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def cancel_all(self) -> None:
        """Abort every in-flight and queued request."""
        for r in self.slot_req:
            if r is not None:
                r.cancel()
        for job in self._prefill_jobs:
            job.req.cancel()
        for r in self._pending:
            r.cancel()
        try:
            while True:
                self.queue.get_nowait().cancel()
        except queue.Empty:
            pass

    def step(self) -> int:
        """One engine tick: admit, advance every prefill one chunk, decode
        one round for the active slots. Returns active slots + prefills."""
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        return self.active_count() + len(self._prefill_jobs)

    def run_until_idle(self, max_ticks: int = 100000) -> None:
        for _ in range(max_ticks):
            if self.step() == 0 and self.queue.empty() and not self._pending:
                return

    # -- admission and prefill ----------------------------------------------
    def _admit(self) -> None:
        try:
            while True:
                self._pending.append(self.queue.get_nowait())
        except queue.Empty:
            pass
        # strictly FIFO: a head request that cannot be admitted blocks the rest
        while self._pending and len(self._prefill_jobs) < self.max_concurrent_prefills:
            while self._pending and self._pending[0].cancelled:
                self._free_request(self._pending.popleft(), "cancelled")
            if not self._pending:
                return
            reserved = {job.slot for job in self._prefill_jobs}
            free_slots = [i for i, r in enumerate(self.slot_req)
                          if r is None and i not in reserved]
            if not free_slots:
                return
            req = self._pending[0]
            # only the prompt's pages (a resumed request re-prefills its
            # generated tokens too); decode pages grow in _ensure_pages
            pages = self.alloc.alloc(pages_needed(
                len(req.input_ids) + len(req.tokens), self.page_size))
            if pages is None:
                return
            self._pending.popleft()
            self._start_prefill(free_slots[0], req, pages)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _embed(self, req: Request, ids: np.ndarray, bucket: int) -> torch.Tensor:
        ids_d = self._tensor(ids, torch.int64)[None]
        if req.images is None and req.speech is None and req.audio_encoded is None:
            return self.params["llm"]["embed"][ids_d]

        def padmask(m):
            out = np.zeros(bucket, bool)
            if m is not None:
                mm = np.asarray(m, bool)  # shorter than the prompt on resume
                out[: len(mm)] = mm
            return out

        am = padmask(req.audio_mask)
        kw: Dict[str, Any] = {}
        if req.images is not None:
            kw["images"] = self._tensor(
                pad_axis0(np.asarray(req.images, np.float32), self.tile_buckets))
        if req.speech is not None or req.audio_encoded is not None:
            if req.speech is not None:
                clips, lens, counts = stack_speech_clips(
                    req.speech, req.speech_length, self.frame_buckets)
                kw["speech"], kw["speech_lengths"] = self._tensor(clips), self._tensor(lens)
            else:
                clips, lens, counts = stack_encoded_clips(
                    req.audio_encoded, req.audio_encoded_length, self.frame_buckets)
                kw["audio_encoded"] = self._tensor(clips)
                kw["audio_encoded_lengths"] = self._tensor(lens)
            ci, ri = audio_select_arrays(am, counts)
            kw["audio_select"] = (self._tensor(ci)[None], self._tensor(ri)[None])
        return vita.fuse_embeddings(
            self.params, self.cfg, ids_d,
            image_mask=self._tensor(padmask(req.image_mask))[None],
            audio_mask=self._tensor(am)[None], **kw,
        )

    def _start_prefill(self, slot: int, req: Request, pages: List[int]) -> None:
        ids = np.asarray(req.input_ids, np.int32)
        if req.tokens:
            # resume after preemption: recompute the generated tokens' rows;
            # the sampled token is then the request's next new token
            ids = np.concatenate([ids, np.asarray(req.tokens, np.int32)])
        padded, s = pad_to_bucket(ids, self.prompt_buckets, pad_id=0)
        bucket = len(padded)
        llm = self.cfg.llm
        shape = (llm.n_layers, 1, bucket, llm.n_kv_heads, llm.head_dim)
        chunk = self.prefill_chunk if bucket % self.prefill_chunk == 0 else bucket
        self._prefill_jobs.append(_PrefillJob(
            req=req, slot=slot, pages=pages, true_len=s, bucket=bucket,
            chunk=min(chunk, bucket), embeds=self._embed(req, np.asarray(padded), bucket),
            sk=torch.zeros(shape, dtype=llm.dtype, device=self.device),
            sv=torch.zeros(shape, dtype=llm.dtype, device=self.device),
            mode=choose_sampling_mode(req.temperature, req.top_k, req.top_p),
        ))

    def _prefill_tick(self) -> None:
        still: List[_PrefillJob] = []
        for job in self._prefill_jobs:
            if job.req.cancelled:
                self.alloc.release(job.pages)
                self._free_request(job.req, "cancelled")
                continue
            job.tok = _prefill_chunk(self.params["llm"], self._prefill_cfg, job,
                                     self._generator)
            job.offset += job.chunk
            if job.offset < min(-(-job.true_len // job.chunk) * job.chunk, job.bucket):
                still.append(job)
                continue
            self._finish_prefill(job)
        self._prefill_jobs = still

    def _finish_prefill(self, job: _PrefillJob) -> None:
        # page-id vector padded with out-of-range ids, whose writes drop
        n_pp = job.bucket // self.page_size
        ids = np.full(n_pp, self.total_pages, np.int32)
        use = min(n_pp, len(job.pages))
        ids[:use] = job.pages[:use]
        install_prefill_pages(self.cache["k_pages"], self.cache["v_pages"],
                              job.sk, job.sv, self._tensor(ids),
                              self.cache.get("k_scale"), self.cache.get("v_scale"))
        slot, req = job.slot, job.req
        # unused table entries hold an out-of-range page id: decode writes
        # past the allocation must drop, not land in another request's page
        self._table_np[slot] = self.total_pages
        self._table_np[slot, : len(job.pages)] = job.pages
        self.slot_req[slot] = req
        self.pos[slot] = job.true_len
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._tok_dev[slot] = job.tok[0]
        req._pages = job.pages
        # emit the first token now; the decode chunk feeding it skips it
        self._skip[slot] = 1
        self._emit(slot, req, int(job.tok[0]))

    # -- decode ---------------------------------------------------------------
    def _ensure_pages(self, active_idx, ticks: int) -> bool:
        """Grow each active slot's pages to cover the rows this round
        writes (capped at the request's worst case; writes past it drop).
        Under pool pressure preempt the newest request holding pages, an
        active slot or a prefill job; the oldest is never preempted by a
        newer one, so it always reaches its worst case. Returns True when
        a preemption changed the active set."""
        rows_ahead = self.decode_chunk_len * ticks
        preempted = False
        for i in sorted(active_idx, key=lambda j: self.slot_req[j].request_id):
            req = self.slot_req[i]
            if req is None or getattr(req, "_pages", None) is None:
                continue  # preempted earlier in this pass
            pages = req._pages
            cap = pages_needed(len(req.input_ids) + req.max_new_tokens, self.page_size)
            need = min(pages_needed(int(self.pos[i]) + rows_ahead, self.page_size), cap)
            while need > len(pages):
                got = self.alloc.alloc(need - len(pages))
                if got is not None:
                    self._table_np[i, len(pages):need] = got
                    pages.extend(got)
                    break
                cand = [(self.slot_req[j].request_id, "slot", j)
                        for j in range(self.n_slots) if self.slot_req[j] is not None]
                cand += [(job.req.request_id, "job", k)
                         for k, job in enumerate(self._prefill_jobs)]
                _, kind, victim = max(cand)
                preempted = True
                self._preempt_count += 1
                if kind == "job":
                    job = self._prefill_jobs.pop(victim)
                    self.alloc.release(job.pages)
                    self._pending.appendleft(job.req)
                    continue
                self._preempt_slot(victim)
                if victim == i:
                    break  # this slot itself was the newest — re-queued
        return preempted

    def _preempt_slot(self, slot: int) -> None:
        """Release the slot's pages and re-queue its request at the head of
        the pending deque (it arrived before anything still pending)."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self._skip[slot] = 0
        self.alloc.release(req._pages)
        req._pages = None
        self._pending.appendleft(req)

    def _ticks_this_round(self, active_idx) -> int:
        """Decode chunks to chain before the readback: more than one only
        in pure decode phases, bounded by the largest remaining budget."""
        if (self.decode_ticks <= 1 or self._prefill_jobs or self._pending
                or not self.queue.empty()):
            return 1
        remaining = max(
            self.slot_req[i].max_new_tokens
            - (int(self.pos[i]) - len(self.slot_req[i].input_ids))
            for i in active_idx
        )
        need = -(-max(remaining, 1) // self.decode_chunk_len)
        return max(1, min(self.decode_ticks, need))

    def _decode_tick(self) -> None:
        """Decode one round for the active slots, batch padded to the next
        power of two (padding rows repeat a live slot and are inactive),
        then stream the tokens out."""
        active_idx = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active_idx:
            return
        ticks = self._ticks_this_round(active_idx)
        if self._ensure_pages(active_idx, ticks):
            active_idx = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active_idx:
                return
            ticks = self._ticks_this_round(active_idx)
        na = len(active_idx)
        nb = 1
        while nb < na:
            nb *= 2
        nb = min(nb, self.n_slots)
        idx = np.asarray(active_idx + [active_idx[0]] * (nb - na), np.int64)
        active = np.zeros(nb, bool)
        active[:na] = True
        mode = choose_sampling_mode(self._temps[idx[:na]], self._topk[idx[:na]],
                                    self._topp[idx[:na]])
        cache = dict(self.cache)  # pool (+ scales when kv_int8)
        cache["table"] = self._tensor(self._table_np[idx])
        pos = self._tensor(self.pos[idx])
        args = (self._tensor(active), self._tensor(self._temps[idx]),
                self._tensor(self._topk[idx]), self._tensor(self._topp[idx]))
        tok = self._tok_dev[self._tensor(idx)]
        parts = []
        for _ in range(ticks):
            cache, toks, tok = decode_chunk(
                self._decode_llm, cache, tok, pos, *args, self._generator,
                llm_cfg=self._decode_cfg, chunk_len=self.decode_chunk_len,
                sampling_mode=mode,
            )
            pos = cache["pos"]
            parts.append(toks)
        self._tok_dev[self._tensor(idx[:na])] = tok[:na]
        self.pos[idx[:na]] += self.decode_chunk_len * ticks
        toks = torch.cat(parts, dim=1).cpu().numpy()
        for row, slot in enumerate(active_idx):
            req = self.slot_req[slot]
            for t in toks[row]:
                if self._skip[slot] > 0:
                    self._skip[slot] -= 1
                    continue
                if self._emit(slot, req, int(t)):
                    break

    # -- emission -----------------------------------------------------------
    def _emit(self, slot: int, req: Request, tok: int) -> bool:
        """Deliver one token; returns True when the request finished."""
        if not req.tokens:
            req.first_token_time = time.time()
        if req.cancelled:
            self._free_slot(slot, req, "cancelled")
            return True
        req.tokens.append(tok)
        if req.on_token is not None:
            req.on_token(tok)
        done_reason = None
        if tok == req.eos_id:
            done_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            done_reason = "length"
        elif len(req.input_ids) + len(req.tokens) >= self.max_len:
            done_reason = "cache_full"
        if done_reason is not None:
            self._free_slot(slot, req, done_reason)
            return True
        return False

    def _free_slot(self, slot: int, req: Request, reason: str) -> None:
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self._skip[slot] = 0
        if getattr(req, "_pages", None):
            self.alloc.release(req._pages)
        req._pages = None
        self._free_request(req, reason)

    def _free_request(self, req: Request, reason: str) -> None:
        req.finish_time = time.time()
        if req.tokens:  # cancelled before the first token: no TTFT
            i = int(np.searchsorted(self._ttft_edges, req.ttft_s)) - 1
            self._ttft_hist[min(max(i, 0), len(self._ttft_hist) - 1)] += 1
            self._ttft_count += 1
        self._finished.append(req)
        if len(self._finished) > 1000:  # bounded history
            self._finished = self._finished[-500:]
        if req.on_finish is not None:
            req.on_finish(req.tokens, reason)
