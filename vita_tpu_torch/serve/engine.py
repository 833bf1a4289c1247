"""Serving engine: continuous batching over a paged KV pool with chunked
prefill (vita_tpu.serve.engine, single-device path).

- Paged KV with lazy growth and preemption: all slots share one page pool
  (ops.paged_attention). A request reserves its prompt's pages at
  admission and grows before each decode chunk (_ensure_pages); under pool
  pressure the engine evicts cached session prefixes, then preempts the
  newest request, which later re-prefills prompt+generated tokens
  (recompute on resume), so greedy streams are unchanged by a preemption.
- Chunked prefill: a prompt prefills ``prefill_chunk`` tokens per engine
  tick into a linear scratch, interleaved with decode chunks and with other
  prefills; the finished scratch is scattered into the pool
  (install_prefill_pages) and the first token is sampled from the last
  chunk.
- Decode: one sampling.decode_chunk call advances every active slot
  ``decode_chunk_len`` tokens, with the batch padded to the next power of
  two; in pure decode phases up to ``decode_ticks`` chunks chain into one
  dispatch. The dispatch's tokens start their copy to the host at once
  (pinned memory, a CUDA event after it) and the host cursor ``pos``
  advances; the oldest chunk is read (its event waited on, its rows
  streamed) only once ``decode_inflight`` newer chunks are queued. No
  chunk is dispatched once every active slot's token budget is in flight
  (the JAX Engine dispatches while a slot is active, up to
  ``decode_inflight`` chunks past a request's end): a tick then reads the
  oldest chunk, and with no slot active it reads them all. A row whose
  slot no longer holds the request it was dispatched with (finished,
  cancelled or preempted meanwhile) is dropped. The decode operands (page
  table, pos, the active mask, the sampling knobs, the slot index) stay
  on the device while the slots' state is unchanged (``_dev_state``,
  keyed on ``_state_epoch``, which every change of that state bumps, and
  the padded slot layout); pos advances there with the chunks, and a
  changed state is uploaded from fresh pinned buffers without waiting for
  the device.
- Prompts, image tiles and audio frames pad to fixed buckets, as in the
  JAX package.
- MoE modes: prefill runs ``prefill_moe_mode`` (dense, gmm, sort or
  capacity) over each chunk, decode ``decode_moe_mode`` (the gather modes,
  dense, sort or capacity). Quantized serving: ``decode_moe_mode=
  'gather_q'`` / ``'gather_q4'`` decode from an int8 / int4 copy of the
  expert weights (mixtral.quantize_moe_for_decode) while prefill keeps the
  bf16 weights, so both copies are resident; ``kv_int8=True`` keeps the
  page pool in int8 with per-(row, head) scales.

- KV-prefix reuse: requests sharing a ``session_key`` keep their pages
  after finishing (on eos or length). The next turn gathers the longest
  common prefix of ids and image/audio masks from those pages into its
  prefill scratch (dequantizing int8 pages), rounded down to a whole
  chunk, and prefills only the suffix: its first chunk attends from
  ``q_offset`` = the reused length over rows it did not compute. A prefix
  covers a media run only where the run's span and content digest match
  (``_media_spans``). Cached prefixes are evicted under page pressure,
  oldest first and the requester's own last.

Requests stream tokens to callbacks and can be cancelled mid-decode;
``EngineThread`` drives ``step`` in the background.

- Tensor- and expert-parallel serving (``mesh``, parallel.mesh): SPMD,
  one Engine per rank. Every rank runs this same host loop on the same
  requests in the same order (the caller submits to every rank; the HTTP
  server broadcasts them), so their decisions and collectives line up.
  The full params (CPU views of a mapped file will do) are cut to this
  rank's shards before they reach its device, or come as those shards
  (``sharded``, from ``load_vita_checkpoint(..., mesh=)``); the page pool holds
  Hkv/model heads. Over 'data' and 'fsdp' axes > 1 (the JAX Engine's
  ``param_specs`` placement, its pool without a batch axis) a rank holds
  its 'fsdp' blocks, every layer gathers its weights whole at its top
  (without autograd), and every rank serves the whole batch; 'seq' > 1
  raises ValueError (a KV cache holds whole sequences). Two Engines of one
  launch may serve as duplex replicas over disjoint ranks
  (serve.replicas).
- Pipeline-parallel serving (a 'pipe' axis of S > 1, beside 'model' and
  'expert' or alone): the layer stack and the page pool are split by
  layer (a rank holds its stage's L/S layers, their pool and its own
  prefill scratch), a layer count that does not divide S raises, and
  ``n_slots`` rounds up to a multiple of S. Prefill chunks run the stage
  chain and decode the S-wave ring (parallel.pp_serving): every slot
  rides a fixed [S, n_slots/S] grid, with no active-set buckets. The
  vocabulary (embedding rows, head columns) is split over ('pipe',
  'model') when it divides (``mixtral.vocab_split``), else each stage
  keeps the model axis's block of the whole head. gmm prefill runs
  through ``sharded_gmm_ffn`` inside each stage on every mesh. Admission,
  session reuse, streaming, cancellation and ``MeshEngineThread`` are the
  same.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vita_tpu_torch.generate import (
    DEFAULT_FRAME_BUCKETS,
    DEFAULT_PROMPT_BUCKETS,
    DEFAULT_TILE_BUCKETS,
    decode_params,
    embed_prompt,
    moe_modes,
    prompt_buckets_for,
    tile_buckets_for,
)
from vita_tpu_torch.models import mixtral, vita
from vita_tpu_torch.parallel.mesh import MODEL, PIPE, axis, serving_axes
from vita_tpu_torch.ops.paged_attention import (
    PagePool,
    init_page_pool,
    install_prefill_pages,
    pages_needed,
)
from vita_tpu_torch.parallel.pp_serving import pp_decode_chunk, pp_prefill_chunk
from vita_tpu_torch.sampling import choose_sampling_mode, decode_chunk, sample_tokens
from vita_tpu_torch.tokenization import audio_token_count, pad_to_bucket


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
    # multi-turn KV reuse: requests sharing a session_key keep their pages
    # after finishing; the next one skips prefill for the shared prefix
    session_key: Optional[str] = None
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
class _CachedPrefix:
    ids: np.ndarray  # tokens whose kv rows live in pages (prompt+generated)
    pages: List[int]
    # the prompt's media layout (masks padded to len(ids), generated rows
    # False) and [(start, end, digest)] of each media run: ids alone cannot
    # tell two prompts whose tiles or clips differ apart
    im: Optional[np.ndarray] = None
    am: Optional[np.ndarray] = None
    spans: Optional[List[tuple]] = None


def _gather_pages(pages: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Pages [L, Hkv, P, page, d] at page_ids (clipped into the pool) as a
    linear scratch [L, 1, n*page, Hkv, d]."""
    x = pages[:, :, page_ids.clamp(0, pages.shape[2] - 1)]
    l, hkv, n_pp, page, hd = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(l, 1, n_pp * page, hkv, hd)


def _extract_pages(cache, page_ids: torch.Tensor, dtype: torch.dtype):
    """Inverse of install_prefill_pages: a session's cached pages as the
    next turn's prefill scratch (k, v) [L, 1, n*page, Hkv, d] in ``dtype``.
    int8 pages are dequantized: the float32 product of the values and
    their (row, head) scales [L, Hkv, P, 1, page], cast to ``dtype``."""
    out = []
    for name in ("k", "v"):
        x = _gather_pages(cache[f"{name}_pages"], page_ids)
        scales = cache.get(f"{name}_scale")
        if scales is not None:
            s = scales[:, :, page_ids.clamp(0, scales.shape[2] - 1)]
            l, hkv, n_pp, _, page = s.shape
            s = s.permute(0, 2, 4, 1, 3).reshape(l, 1, n_pp * page, hkv, 1)
            x = x.float() * s
        out.append(x.to(dtype))
    return out


def _host_bytes(x) -> bytes:
    """The bytes of a contiguous host copy of ``x`` in its own dtype (numpy
    or a tensor on any device), so equal media give equal digests."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


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
    knobs: tuple  # the request's temperature, top_k, top_p [1] on the device
    offset: int = 0
    tok: Optional[torch.Tensor] = None  # first token [1] after the last chunk


@torch.no_grad()
def _prefill_chunk(llm_params, llm_cfg, job: _PrefillJob, generator, mesh=None) -> torch.Tensor:
    """One prefill chunk into the job's scratch (in place); samples the
    token after row ``true_len - 1`` (meaningful on the last chunk). The
    chunk attends over the whole bucket scratch with kv_len offset+chunk."""
    off, chunk = job.offset, job.chunk
    dev = job.embeds.device
    x = job.embeds[:, off:off + chunk]
    cache = {"k": job.sk, "v": job.sv,
             "pos": torch.full((1,), off, dtype=torch.int32, device=dev)}
    positions = off + torch.arange(chunk, device=dev)[None]
    valid = torch.arange(job.bucket, device=dev)[None] < off + chunk
    hidden, _, _ = mixtral.forward(
        llm_params, llm_cfg, inputs_embeds=x, positions=positions,
        attn_valid=valid, cache=cache, return_hidden=True, mesh=mesh,
    )
    row = min(max(job.true_len - 1 - off, 0), chunk - 1)
    logits = mixtral.lm_logits(llm_params, hidden[:, row], mesh)
    return sample_tokens(logits, generator, *job.knobs, mode=job.mode)


class Engine:
    """Continuous-batching engine over a paged KV pool, on one device or
    as one rank of a serving mesh."""

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
        decode_inflight: int = 2,  # dispatched chunks queued before the oldest is read
        decode_ticks: int = 4,
        max_concurrent_prefills: int = 2,
        kv_int8: bool = False,
        prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
        tile_buckets: Sequence[int] = DEFAULT_TILE_BUCKETS,
        frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
        mesh=None,  # a serving mesh (expert, model axes): ``params`` are full
        sharded: bool = False,  # under a mesh: params are this rank's shards already
        device: Optional[torch.device] = None,  # None = where the weights are
    ):
        decode_moe_mode, prefill_moe_mode = moe_modes(cfg, decode_moe_mode, prefill_moe_mode)
        self.cfg = cfg
        self.mesh = mesh
        self._pp = axis(mesh, PIPE).size
        if self._pp > 1:
            if cfg.llm.n_layers % self._pp:
                raise ValueError(f"{cfg.llm.n_layers} layers not divisible by pipe axis "
                                 f"{self._pp}")
            # the slots form one wave a stage ([S, Bw] grid): round up
            n_slots = -(-n_slots // self._pp) * self._pp
        self._pp_vocab_split = mixtral.vocab_split(cfg.llm, mesh)
        self.device = torch.device(
            device if device is not None else params["llm"]["embed"].device)
        if mesh is not None and not sharded:  # raises for a 'seq' axis > 1
            params = vita.shard_params(params, cfg, mesh, self.device)
        elif mesh is not None:
            serving_axes(mesh)
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        page_size = min(page_size, max_len)
        self.page_size = page_size
        self.decode_chunk_len = decode_chunk_len
        self.decode_inflight = max(1, decode_inflight)
        self.decode_ticks = max(1, decode_ticks)
        self.prefill_chunk = prefill_chunk
        self.prompt_buckets = prompt_buckets_for(prompt_buckets, max_len, page_size)
        if any(b % page_size for b in self.prompt_buckets):
            raise ValueError("prompt buckets must be multiples of page_size")
        self.tile_buckets = tile_buckets_for(cfg, tile_buckets)
        self.frame_buckets = tuple(sorted(frame_buckets))
        self._decode_cfg = dataclasses.replace(cfg.llm, moe_mode=decode_moe_mode)
        self._prefill_cfg = dataclasses.replace(cfg.llm, moe_mode=prefill_moe_mode)
        self._decode_llm = decode_params(params, cfg, decode_moe_mode, mesh)

        llm = cfg.llm
        self.max_pages_per_slot = pages_needed(max_len, page_size)
        if total_pages is None:
            total_pages = n_slots * self.max_pages_per_slot
        self.total_pages = total_pages
        self.alloc = PagePool(total_pages)
        self._table_np = np.zeros((n_slots, self.max_pages_per_slot), np.int32)
        self._kv_heads = llm.n_kv_heads // axis(mesh, MODEL).size  # this rank's
        self._layers = llm.n_layers // self._pp  # this rank's stage's
        self.cache = init_page_pool(
            self._layers, self._kv_heads, total_pages, page_size, llm.head_dim,
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
        # the decode operands on the device, reused while the slots' state
        # is unchanged: (key, operands...), key = (epoch, padded slot layout)
        # or (epoch,) on the pipe ring; every change of the table, pos,
        # the active set or the knobs bumps the epoch
        self._dev_state: Optional[tuple] = None
        self._state_epoch = 0
        # dispatched chunks not yet read: (tokens on the host, the CUDA
        # event after their copy or None, [(slot, request)] of the rows)
        self._inflight: List[tuple] = []

        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._pending: collections.deque = collections.deque()
        self.max_concurrent_prefills = max(1, max_concurrent_prefills)
        self._prefill_jobs: List[_PrefillJob] = []
        self._finished: List[Request] = []
        # lifetime TTFT histogram (0.1 ms .. 1000 s, log-spaced)
        self._ttft_hist = np.zeros(256, np.int64)
        self._ttft_edges = np.logspace(-4, 3, 257)
        self._ttft_count = 0
        # session_key -> the previous turn's pages and ids (KV-prefix reuse)
        self._prefix_cache: Dict[str, _CachedPrefix] = {}
        self._reused_prefix_rows = 0
        self._preempt_count = 0

    # -- public API -------------------------------------------------------
    def check(self, req: Request) -> None:
        """Raise ValueError when ``req`` can never be served here."""
        if len(req.input_ids) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {len(req.input_ids) + req.max_new_tokens} slots, "
                f"cache holds {self.max_len}"
            )
        if pages_needed(len(req.input_ids) + req.max_new_tokens,
                        self.page_size) > self.total_pages:
            # lazy growth never deadlocks only if the oldest request's worst
            # case fits the pool once caches and newer slots are reclaimed
            raise ValueError(
                "request's worst-case KV exceeds the page pool "
                f"({self.total_pages} pages of {self.page_size})"
            )

    def submit(self, req: Request) -> Request:
        self.check(req)
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
            "cached_prefixes": float(len(self._prefix_cache)),
            "reused_prefix_rows": float(self._reused_prefix_rows),
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

    def warmup(
        self,
        prompt_lens: Optional[Sequence[int]] = None,
        media: bool = False,
        max_new_tokens: int = 4,
    ) -> float:
        """Run dummy requests through each prompt bucket (and, with
        ``media``, one image+audio request), so the first real request does
        not pay first-use costs (kernel build and load, library
        initialisation). Returns the wall seconds spent."""
        t0 = time.time()
        lens = list(prompt_lens) if prompt_lens is not None else [
            b for b in self.prompt_buckets if b + max_new_tokens <= self.max_len
        ]
        for n in lens:
            s = max(min(n - 8, n - 1), 1)
            self.submit(Request(input_ids=np.full(s, 9, np.int32),
                                max_new_tokens=max_new_tokens, eos_id=-1))
            self.run_until_idle()
        if media:
            g = self.cfg.image_group_tiles
            n_img = self.cfg.image_tokens_per_group
            frames = self.frame_buckets[0]
            n_aud = audio_token_count(frames)
            vs = self.cfg.vision.image_size
            s = n_img + n_aud + 16
            im, am = np.zeros(s, bool), np.zeros(s, bool)
            im[8:8 + n_img] = True
            am[8 + n_img:8 + n_img + n_aud] = True
            self.submit(Request(
                input_ids=np.full(s, 9, np.int32), image_mask=im, audio_mask=am,
                images=np.zeros((g, vs, vs, 3), np.float32),
                speech=np.zeros((frames, self.cfg.audio.input_dim), np.float32),
                speech_length=frames, max_new_tokens=max_new_tokens, eos_id=-1,
            ))
            self.run_until_idle()
        return time.time() - t0

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
        one round for the active slots. Returns active slots + prefills +
        chunks in flight, so a loop that ticks until 0 reads every chunk."""
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        return self.active_count() + len(self._prefill_jobs) + len(self._inflight)

    def run_until_idle(self, max_ticks: int = 100000) -> None:
        for _ in range(max_ticks):
            if self.step() == 0 and self.queue.empty() and not self._pending:
                return

    # -- media digests for KV-prefix reuse ---------------------------------
    def _media_spans(self, req: Request) -> Optional[List[tuple]]:
        """[(start, end, digest)] of each contiguous media run of the prompt,
        sorted; [] for text; None when the media cannot be mapped onto the
        mask runs (the request then neither caches nor reuses a prefix).
        Features at media positions are a function of the media content
        alone, so equal digests and masks make cached rows exact."""
        s = len(req.input_ids)
        spans: List[tuple] = []

        def runs(mask):
            m = np.zeros(s, bool)
            mm = np.asarray(mask, bool)[:s]
            m[: len(mm)] = mm
            edges = np.flatnonzero(np.diff(np.concatenate([[0], m.astype(np.int8), [0]])))
            return list(zip(edges[::2], edges[1::2]))

        if req.images is not None:
            if req.image_mask is None:
                return None
            g = self.cfg.image_group_tiles
            tpg = self.cfg.image_tokens_per_group
            tiles = req.images
            ti = 0
            for a, b in runs(req.image_mask):
                n = (b - a) // tpg
                if n * tpg != (b - a) or ti + n * g > len(tiles):
                    return None
                d = hashlib.blake2b(_host_bytes(tiles[ti:ti + n * g]), digest_size=16)
                spans.append((int(a), int(b), "img:" + d.hexdigest()))
                ti += n * g
        elif req.image_mask is not None and np.any(np.asarray(req.image_mask)):
            return None

        if req.speech is not None or req.audio_encoded is not None:
            if req.audio_mask is None:
                return None
            src = req.speech if req.speech is not None else req.audio_encoded
            ln = req.speech_length if req.speech is not None else req.audio_encoded_length
            clips = list(src) if isinstance(src, (list, tuple)) else [src]
            if isinstance(ln, (list, tuple, np.ndarray)):
                lens = [int(x) for x in ln]
            else:
                lens = [int(ln or clips[0].shape[0])]
            if len(lens) != len(clips):
                return None
            if req.speech is not None:
                counts = [audio_token_count(n) for n in lens]
            else:
                counts = [(n - 1) // 2 + 1 for n in lens]
            ci = 0
            for a, b in runs(req.audio_mask):
                need = int(b - a)
                h = hashlib.blake2b(digest_size=16)
                used = 0
                while used < need and ci < len(clips):
                    h.update(_host_bytes(clips[ci][: lens[ci]]))
                    used += counts[ci]
                    ci += 1
                if used != need:
                    return None
                spans.append((int(a), int(b), "aud:" + h.hexdigest()))
        elif req.audio_mask is not None and np.any(np.asarray(req.audio_mask)):
            return None

        spans.sort()
        return spans

    @staticmethod
    def _clamp_shared_to_media(shared: int, cached_spans: Optional[List[tuple]],
                               new_spans: Optional[List[tuple]]) -> int:
        """The largest prefix length <= shared such that every media run
        overlapping it is identical (span and digest) in the cached turn
        and in the new request."""
        if not cached_spans and not new_spans:
            return shared
        if cached_spans is None or new_spans is None:
            return 0
        for i in range(max(len(cached_spans), len(new_spans))):
            cs = cached_spans[i] if i < len(cached_spans) else None
            ns = new_spans[i] if i < len(new_spans) else None
            if cs is not None and cs == ns:
                continue  # identical run: its rows are valid anywhere
            starts = [x[0] for x in (cs, ns) if x is not None]
            if starts:
                shared = min(shared, min(starts))
            break
        return shared

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
            n_pages = pages_needed(len(req.input_ids) + len(req.tokens), self.page_size)
            pages = self.alloc.alloc(n_pages)
            # cached session prefixes are reclaimable: the oldest first, the
            # requester's own last (its reuse is what the cache is for)
            while pages is None and self._prefix_cache:
                others = [k for k in self._prefix_cache if k != req.session_key]
                key = others[0] if others else next(iter(self._prefix_cache))
                self.alloc.release(self._prefix_cache.pop(key).pages)
                pages = self.alloc.alloc(n_pages)
            if pages is None:
                return
            self._pending.popleft()
            self._start_prefill(free_slots[0], req, pages)

    def _upload(self, x) -> torch.Tensor:
        """A device copy of the host array ``x`` that does not wait for the
        device: on a card it is queued on the stream from a fresh pinned
        buffer, which the caching host allocator keeps until the copy has
        run. Later edits of ``x`` do not reach it."""
        t = torch.from_numpy(np.array(x))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _embed(self, req: Request, ids: np.ndarray) -> torch.Tensor:
        # on resume the masks are shorter than the prompt; they pad with False
        return embed_prompt(
            self.params, self.cfg, ids, self.device, self.tile_buckets, self.frame_buckets,
            image_mask=req.image_mask, audio_mask=req.audio_mask, images=req.images,
            speech=req.speech, speech_length=req.speech_length,
            audio_encoded=req.audio_encoded, audio_encoded_length=req.audio_encoded_length,
            mesh=self.mesh,
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
        shape = (self._layers, 1, bucket, self._kv_heads, llm.head_dim)
        chunk = self.prefill_chunk if bucket % self.prefill_chunk == 0 else bucket
        chunk = min(chunk, bucket)
        offset, sk, sv = self._reuse_prefix(req, ids, bucket, chunk)
        if offset == 0:
            sk = torch.zeros(shape, dtype=llm.dtype, device=self.device)
            sv = torch.zeros(shape, dtype=llm.dtype, device=self.device)
        self._prefill_jobs.append(_PrefillJob(
            req=req, slot=slot, pages=pages, true_len=s, bucket=bucket,
            chunk=chunk, embeds=self._embed(req, np.asarray(padded)), sk=sk, sv=sv,
            mode=choose_sampling_mode(req.temperature, req.top_k, req.top_p),
            knobs=(self._upload(np.array([req.temperature], np.float32)),
                   self._upload(np.array([req.top_k], np.int32)),
                   self._upload(np.array([req.top_p], np.float32))),
            offset=offset,
        ))

    def _reuse_prefix(self, req: Request, ids: np.ndarray, bucket: int, chunk: int):
        """Seed the prefill scratch from this session's cached pages: the
        longest common prefix of ids and image/audio masks, clamped to
        identical media runs and rounded down to a whole chunk. Returns
        (offset, k scratch, v scratch); offset 0 (and no scratch) when
        nothing is reused. The cached pages go back to the pool either way."""
        cached = self._prefix_cache.pop(req.session_key, None) if req.session_key else None
        if cached is None:
            return 0, None, None
        s = len(ids)
        m = min(len(cached.ids), s - 1)

        def mask_of(mask, n):
            out = np.zeros(n, bool)
            if mask is not None:
                k = min(n, len(mask))
                out[:k] = np.asarray(mask, bool)[:k]
            return out

        cids = cached.ids
        cim, cam = mask_of(cached.im, len(cids)), mask_of(cached.am, len(cids))
        rim, ram = mask_of(req.image_mask, s), mask_of(req.audio_mask, s)
        same = ((cids[:m] == ids[:m]) & (cim[:m] == rim[:m]) & (cam[:m] == ram[:m]))
        shared = int(m if same.all() else np.argmin(same))
        shared = self._clamp_shared_to_media(shared, cached.spans, self._media_spans(req))
        offset = (shared // chunk) * chunk
        sk = sv = None
        if offset > 0:
            # unused entries pad with page 0 and every id is clipped into
            # the pool when gathered; the rows they give lie past the
            # offset, which the suffix's chunks overwrite
            n_pp = bucket // self.page_size
            vec = np.zeros(n_pp, np.int64)
            use = min(n_pp, len(cached.pages))
            vec[:use] = cached.pages[:use]
            sk, sv = _extract_pages(self.cache, self._upload(vec), self.cfg.llm.dtype)
            self._reused_prefix_rows += offset
        self.alloc.release(cached.pages)
        return offset, sk, sv

    def _prefill_tick(self) -> None:
        still: List[_PrefillJob] = []
        for job in self._prefill_jobs:
            if job.req.cancelled:
                self.alloc.release(job.pages)
                self._free_request(job.req, "cancelled")
                continue
            if self._pp > 1:
                job.tok = pp_prefill_chunk(self.params["llm"], self._prefill_cfg, job,
                                           self._generator, self.mesh, self._pp_vocab_split)
            else:
                job.tok = _prefill_chunk(self.params["llm"], self._prefill_cfg, job,
                                         self._generator, self.mesh)
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
                              job.sk, job.sv, self._upload(ids),
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
        self._state_epoch += 1
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
                    self._state_epoch += 1  # the device table is stale
                    break
                if self._prefix_cache:
                    key = next(iter(self._prefix_cache))
                    self.alloc.release(self._prefix_cache.pop(key).pages)
                    continue
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
        the pending deque (it arrived before anything still pending). Its
        rows of the chunks in flight are dropped: it re-prefills from the
        tokens it has emitted, and may hold this slot again before those
        chunks are read."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self._skip[slot] = 0
        self._state_epoch += 1
        for _, _, slots in self._inflight:
            slots[:] = [(s, None if r is req else r) for s, r in slots]
        self.alloc.release(req._pages)
        req._pages = None
        self._pending.appendleft(req)

    def _ticks_this_round(self, active_idx) -> int:
        """Decode chunks to chain into this round's dispatch: none once
        every active slot's token budget is dispatched (pos is the
        speculative cursor: the rows only wait to be read), more than one
        only in pure decode phases, bounded by the largest remaining
        budget."""
        remaining = max(
            self.slot_req[i].max_new_tokens
            - (int(self.pos[i]) - len(self.slot_req[i].input_ids))
            for i in active_idx
        )
        if remaining <= 0:
            return 0
        if (self.decode_ticks <= 1 or self._prefill_jobs or self._pending
                or not self.queue.empty()):
            return 1
        need = -(-remaining // self.decode_chunk_len)
        return min(self.decode_ticks, need)

    def _decode_tick(self) -> None:
        """Dispatch one round for the active slots, then read the oldest
        chunks until ``decode_inflight`` remain in flight. With every
        active budget already in flight, read only the oldest chunk (a
        tick's worth of tokens, as when dispatching); with no slot active,
        read them all."""
        active_idx = [i for i, r in enumerate(self.slot_req) if r is not None]
        ticks = self._ticks_this_round(active_idx) if active_idx else 0
        if ticks and self._ensure_pages(active_idx, ticks):
            active_idx = [i for i, r in enumerate(self.slot_req) if r is not None]
            ticks = self._ticks_this_round(active_idx) if active_idx else 0
        if ticks and self._pp > 1:
            self._dispatch_ring(active_idx, ticks)
        elif ticks:
            self._dispatch(active_idx, ticks)
        if ticks:
            keep = self.decode_inflight
        elif active_idx:  # every budget in flight: read a tick's worth
            keep = max(len(self._inflight) - 1, 0)
        else:
            keep = 0
        while len(self._inflight) > keep:
            self._process_chunk(*self._inflight.pop(0))

    def _dispatch(self, active_idx, ticks: int) -> None:
        """Queue ``ticks`` chained chunks for the active slots, the batch
        padded to the next power of two (padding rows repeat a live slot
        and are inactive), on the cached device operands."""
        na = len(active_idx)
        nb = 1
        while nb < na:
            nb *= 2
        nb = min(nb, self.n_slots)
        idx = np.asarray(active_idx + [active_idx[0]] * (nb - na), np.int64)
        mode = choose_sampling_mode(self._temps[idx[:na]], self._topk[idx[:na]],
                                    self._topp[idx[:na]])
        key = (self._state_epoch, idx.tobytes())
        if self._dev_state is None or self._dev_state[0] != key:
            active = np.zeros(nb, bool)
            active[:na] = True
            self._dev_state = (key,) + tuple(self._upload(x) for x in (
                idx, self._table_np[idx], self.pos[idx], active, self._temps[idx],
                self._topk[idx], self._topp[idx]))
        _, idx_d, table, pos, active, temps, topk, topp = self._dev_state
        cache = dict(self.cache)  # pool (+ scales when kv_int8)
        cache["table"] = table
        tok = self._tok_dev[idx_d]
        parts = []
        for _ in range(ticks):
            cache, toks, tok = decode_chunk(
                self._decode_llm, cache, tok, pos, active, temps, topk, topp,
                self._generator, llm_cfg=self._decode_cfg, chunk_len=self.decode_chunk_len,
                sampling_mode=mode, mesh=self.mesh,
            )
            pos = cache["pos"]
            parts.append(toks)
        # the device cursor advances with self.pos (a padding row repeats
        # its slot's value)
        self._dev_state = (key, idx_d, table, pos, active, temps, topk, topp)
        self._tok_dev[idx_d[:na]] = tok[:na]
        self.pos[idx[:na]] += self.decode_chunk_len * ticks
        self._queue_chunk(torch.cat(parts, dim=1), [(i, self.slot_req[i]) for i in active_idx])

    def _dispatch_ring(self, active_idx, ticks: int) -> None:
        """The pipeline's round: every slot rides the S-wave ring
        (parallel.pp_serving.pp_decode_chunk) as wave w = slots
        [w*Bw, (w+1)*Bw); inactive slots neither write nor attend."""
        s_waves, n = self._pp, self.n_slots
        bw = n // s_waves
        mode = choose_sampling_mode(self._temps[active_idx], self._topk[active_idx],
                                    self._topp[active_idx])
        key = (self._state_epoch,)
        if self._dev_state is None or self._dev_state[0] != key:
            act = np.zeros(n, bool)
            act[active_idx] = True
            self._dev_state = (key,) + tuple(
                self._upload(x.reshape((s_waves, bw) + x.shape[1:]))
                for x in (self._table_np, self.pos, act, self._temps, self._topk, self._topp))
        _, table, pos, active, temps, topk, topp = self._dev_state
        tok = self._tok_dev.reshape(s_waves, bw)
        parts = []
        for _ in range(ticks):
            toks, tok, pos = pp_decode_chunk(
                self._decode_llm, self.cache, table, tok, pos, active, temps, topk, topp,
                self._generator, llm_cfg=self._decode_cfg, chunk_len=self.decode_chunk_len,
                sampling_mode=mode, mesh=self.mesh, vocab_split=self._pp_vocab_split)
            parts.append(toks)
        self._dev_state = (key, table, pos, active, temps, topk, topp)
        self._tok_dev = tok.reshape(n).clone()
        self.pos[active_idx] += self.decode_chunk_len * ticks
        # rows are slot-indexed: [S, Bw, ticks*chunk] reads as [n, ...]
        self._queue_chunk(torch.cat(parts, dim=2), list(enumerate(self.slot_req)))

    def _queue_chunk(self, toks: torch.Tensor, slots) -> None:
        """Queue a dispatched chunk's tokens: on a card their copy into
        pinned host memory starts now and an event marks its end."""
        event = None
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            toks = host
        self._inflight.append((toks, event, slots))

    def _process_chunk(self, toks: torch.Tensor, event, slots) -> None:
        """Read a queued chunk: wait for its copy, then stream each row to
        its request, unless the slot no longer holds that request."""
        if event is not None:
            event.synchronize()
        rows = toks.reshape(-1, toks.shape[-1]).numpy()
        for row, (slot, req) in enumerate(slots):
            if req is None or self.slot_req[slot] is not req:
                continue  # finished, cancelled or preempted while in flight
            for t in rows[row]:
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
        self._state_epoch += 1
        pages = getattr(req, "_pages", None)
        if pages:
            keep = req.session_key and reason in ("eos", "length")
            spans = self._media_spans(req) if keep else None
            if spans is not None:
                # keep this turn's kv for the session's next request, minus
                # the final emitted token: its row is written only when the
                # token is fed to a decode step, which never happens for the
                # last one
                old = self._prefix_cache.pop(req.session_key, None)
                if old is not None:
                    self.alloc.release(old.pages)
                s = len(req.input_ids)
                n = s + len(req.tokens) - 1

                def padmask(mask):
                    out = np.zeros(n, bool)
                    if mask is not None:
                        out[:s] = np.asarray(mask, bool)[:s]
                    return out

                self._prefix_cache[req.session_key] = _CachedPrefix(
                    ids=np.concatenate([np.asarray(req.input_ids, np.int64),
                                        np.asarray(req.tokens[:-1], np.int64)]),
                    pages=list(pages), im=padmask(req.image_mask),
                    am=padmask(req.audio_mask), spans=spans)
            else:
                self.alloc.release(pages)
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


class EngineThread(threading.Thread):
    """Background loop driving Engine.step (the demo's engine process)."""

    def __init__(self, engine: Engine, tick_idle_s: float = 0.005):
        super().__init__(daemon=True)
        self.engine = engine
        self.tick_idle_s = tick_idle_s
        # not ``_stop``: Thread.join() calls self._stop()
        self._stop_evt = threading.Event()

    def run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                n = self.engine.step()
            except Exception:  # noqa: BLE001 - the serving loop must survive
                # one bad request (or a raising callback) must not stop the
                # loop, or every other admitted request would wait forever
                traceback.print_exc()
                time.sleep(self.tick_idle_s)
                continue
            if n == 0:
                time.sleep(self.tick_idle_s)

    def stop(self) -> None:
        self._stop_evt.set()


# the fields of a Request that travel to the other ranks of a mesh
_REQUEST_FIELDS = tuple(f.name for f in dataclasses.fields(Request)
                        if f.name not in ("on_token", "on_finish", "cancelled", "tokens",
                                          "submit_time", "first_token_time", "finish_time"))


_GROUP_LOCK = threading.Lock()


def end_process_group() -> None:
    """Close this rank's process group and all its subgroups, once (two
    loops of one rank may fail together): the peers' pending collectives
    with this rank then raise instead of waiting."""
    import torch.distributed as dist

    with _GROUP_LOCK:
        if dist.is_initialized():
            dist.destroy_process_group()


class MeshEngineThread(threading.Thread):
    """The loop that steps one rank's Engine of a serving mesh, in place of
    EngineThread: every rank runs it (the leader in the background, beside
    its HTTP server; the others in their main thread).

    Requests reach only the leader, the lowest rank of ``group`` (a gloo
    group of the mesh's ranks; all ranks by default): ``submit`` checks
    them at once against the Engine's limits. Before each step the leader
    broadcasts the new submissions, the ids of requests whose clients
    cancelled them and a stop flag (``broadcast_object_list`` over
    ``group``), and every rank admits the same requests, with the leader's
    ids, in the same order, and cancels the same ones: requests change only
    between steps, so every rank makes the same decisions and the
    collectives line up. The leader's copies stream to the submitted
    requests' callbacks and fill their ``tokens`` and times. A leader
    whose requests come from another rank (a duplex replica other than
    replica 0) has a ``link`` (serve.replicas.ReplicaLink) that exchanges
    them with that rank before each step.

    An error on any rank ends the whole mesh, for a rank cannot tell
    whether its peers raised too or wait in a collective it will never
    join: the rank prints it, keeps it as ``error``, finishes its
    requests in flight with the reason 'error' and closes its process
    group, so the peers' pending collectives raise and they end the same
    way; then ``on_error`` (the leader's server shutdown) is called."""

    def __init__(self, engine: Engine, tick_idle_s: float = 0.005,
                 on_error: Optional[Callable[[], None]] = None, group=None, link=None):
        import torch.distributed as dist

        super().__init__(daemon=True)
        self.engine = engine
        self.tick_idle_s = tick_idle_s
        self.rank = dist.get_rank()
        # collective: every rank builds one (or the caller's, built on every rank)
        self._group = group if group is not None else dist.new_group(backend="gloo")
        self.leader = dist.get_global_rank(self._group, 0)
        self.link = link
        self._lock = threading.Lock()
        self._new: List[Request] = []
        self._live: Dict[int, Request] = {}  # leader: the submitted requests in flight
        self._copies: Dict[int, Request] = {}  # the Engine's requests in flight
        self._stop_evt = threading.Event()
        self.on_error = on_error
        self.error: Optional[BaseException] = None

    def submit(self, req: Request) -> Request:
        self.engine.check(req)
        req.submit_time = time.time()
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"the serving mesh has stopped: {self.error!r}")
            self._new.append(req)
        return req

    def cancel_all(self) -> None:
        """Cancel every submitted request in flight or not yet broadcast
        (the next step's broadcast carries the cancellations)."""
        with self._lock:
            reqs = self._new + list(self._live.values())
        for r in reqs:
            r.cancel()

    def stats(self) -> Dict[str, float]:
        return self.engine.stats()

    def stop(self) -> None:
        self._stop_evt.set()

    def _message(self):
        with self._lock:
            new, self._new = self._new, []
            cancel = [rid for rid, r in self._live.items() if r.cancelled]
            for rid in cancel:
                self._live.pop(rid)
        return new, {"new": [{f: getattr(r, f) for f in _REQUEST_FIELDS} for r in new],
                     "cancel": cancel, "stop": self._stop_evt.is_set()}

    @staticmethod
    def _streamer(orig: Request):
        def on_token(tok: int) -> None:
            if not orig.tokens:
                orig.first_token_time = time.time()
            orig.tokens.append(tok)
            if orig.on_token is not None:
                orig.on_token(tok)
        return on_token

    def _finisher(self, rid: int, orig: Optional[Request]):
        def on_finish(tokens, reason):
            self._copies.pop(rid, None)
            with self._lock:
                self._live.pop(rid, None)
            if orig is not None:
                orig.finish_time = time.time()
                if orig.on_finish is not None:
                    orig.on_finish(tokens, reason)
        return on_finish

    def run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 - ends the mesh, loudly
            traceback.print_exc()
            with self._lock:
                self.error = e
                new, self._new = self._new, []
                live, self._live = list(self._live.values()), {}
            for req in new + live:
                if req.on_finish is not None:
                    req.on_finish(req.tokens, "error")
            end_process_group()
            if self.on_error is not None:
                self.on_error()

    def _loop(self) -> None:
        import torch.distributed as dist

        lead = self.rank == self.leader
        while True:
            if self.link is not None:
                self.link.exchange(self)
            new, msg = self._message() if lead else ([], None)
            box = [msg]
            dist.broadcast_object_list(box, src=self.leader, group=self._group)
            msg = box[0]
            if msg["stop"]:
                return
            for i, fields in enumerate(msg["new"]):
                copy = Request(**fields)
                orig = new[i] if lead else None
                if orig is not None:
                    copy.on_token = self._streamer(orig)
                    with self._lock:
                        self._live[copy.request_id] = orig
                copy.on_finish = self._finisher(copy.request_id, orig)
                self._copies[copy.request_id] = copy
                self.engine.submit(copy)
            for rid in msg["cancel"]:
                if rid in self._copies:
                    self._copies[rid].cancel()
            n = self.engine.step()
            if n == 0 and not self.engine._pending and self.engine.queue.empty():
                time.sleep(self.tick_idle_s)
