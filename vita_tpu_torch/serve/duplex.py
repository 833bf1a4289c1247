"""Duplex interaction controller: generate/monitor role swap with
audio-interrupt, noise rejection via the <2> state token, and sentence-
chunked TTS hand-off.

State-machine parity with the reference's interactive demo wiring
(web_demo/web_interactive_demo.py): two engine replicas run concurrently —
one GENERATOR (streaming the current answer), one MONITOR (watching new
audio); when the monitor's model starts answering a new query (its first
tokens are not '<2>'), the generator is interrupted, queues are cleared,
and the roles swap (:286-293,330-376,953-996). A '<2>' prefix means the
audio was background noise: the response is aborted and roles keep
(:368-370 judge_negative). Completed sentences flush to a pluggable TTS
callback at punctuation boundaries with a minimum length (:572-574).

The controller only needs two engine-like objects with ``submit`` and
``cancel_all`` (vita_tpu.serve.duplex over the port's Engine; under
``--mesh`` rank 0's replica loop and its serve.replicas.RemoteReplica).
On one card the two replicas share one weights dict,
each with its own page pool and EngineThread, so two host threads launch
kernels on the card: they enqueue on the device's default stream, whose
order keeps them apart, every buffer they write is their own engine's,
and the module-level state they share (the kernels' launch counts, the
cached token-slot tensors of the expert FFN wrappers, Whale's positional
table) is written under a lock or only once per shape.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np

from vita_tpu_torch.constants import STATE_TOKEN_NOISY
from vita_tpu_torch.serve.engine import Engine, Request

SENTENCE_PUNCT = set("。！？!?.;；:：\n")
MIN_TTS_CHARS = 5


@dataclasses.dataclass
class DuplexConfig:
    max_new_tokens: int = 512
    temperature: float = 0.0
    eos_id: int = 2


class DuplexController:
    """Drives two engines through the generate/monitor protocol."""

    def __init__(
        self,
        engines: List[Engine],
        decode: Callable[[List[int]], str],
        on_text: Optional[Callable[[str], None]] = None,
        on_tts: Optional[Callable[[str], None]] = None,
        config: Optional[DuplexConfig] = None,
        on_turn: Optional[Callable[["Request", str], None]] = None,
        on_sentence: Optional[Callable[[str, "Request"], None]] = None,
    ):
        config = config or DuplexConfig()  # fresh per controller
        assert len(engines) == 2
        self.engines = engines
        self.decode = decode
        self.on_text = on_text or (lambda s: None)
        self.on_tts = on_tts or (lambda s: None)
        # like on_tts but also receives the originating Request — the TTS
        # worker needs turn identity to drop stale chunks after an
        # interrupt (serve.tts; reference llm_id protocol, :565-601)
        self.on_sentence = on_sentence
        # called with (request, raw response text incl. state token) when a
        # promoted answer completes — the hook multi-turn history hangs off
        self.on_turn = on_turn or (lambda r, t: None)
        self.cfg = config

        self.generator_idx = 0  # engine currently allowed to speak
        self.current: Optional[Request] = None
        self._lock = threading.Lock()  # role handoff (start_event_lock :286)
        self.rejected_noise = 0
        self.interrupts = 0

    @property
    def monitor(self) -> Engine:
        return self.engines[1 - self.generator_idx]

    @property
    def generator(self) -> Engine:
        return self.engines[self.generator_idx]

    def new_request(self, input_ids, **kw) -> Request:
        """Build a Request carrying this controller's configured defaults
        (max_new_tokens / temperature / eos_id from DuplexConfig)."""
        kw.setdefault("max_new_tokens", self.cfg.max_new_tokens)
        kw.setdefault("temperature", self.cfg.temperature)
        kw.setdefault("eos_id", self.cfg.eos_id)
        return Request(input_ids=input_ids, **kw)

    def submit_query(self, request: Request) -> Request:
        """New (VAD-segmented) query goes to the MONITOR engine. Its output
        is gated: '<2>' prefix aborts; anything else interrupts the current
        generator and swaps roles."""
        gate = _StateTokenGate(self, request)
        request.on_token = gate.on_token
        request.on_finish = gate.on_finish
        with self._lock:
            host = self.monitor
            # remember which engine runs this request: _promote must never
            # cancel the promoted request's own host
            request._duplex_engine_idx = self.engines.index(host)
            host.submit(request)
        return request

    # internal: called by the gate when the first visible text is known
    def _promote(self, request: Request) -> None:
        with self._lock:
            self.interrupts += 1 if self.current is not None else 0
            if self.current is not None and not self.current.cancelled:
                self.current.cancel()  # interrupt (stop_event :345-351)
            # the promoted request's host becomes the generator; cancel
            # everything on the OTHER engine. (When two queries were
            # submitted to the same monitor back-to-back, the pre-swap
            # 'generator' IS the host — cancelling it would kill the very
            # answer being promoted.)
            host = getattr(request, "_duplex_engine_idx", 1 - self.generator_idx)
            self.engines[1 - host].cancel_all()
            self.generator_idx = host  # role swap
            self.current = request

    def _reject(self, request: Request) -> None:
        with self._lock:
            self.rejected_noise += 1
            request.cancel()


class _StateTokenGate:
    """Buffers the first tokens of a monitor response to classify
    noise (<2>) vs. real answer, then streams + sentence-chunks."""

    def __init__(self, ctl: DuplexController, request: Request):
        self.ctl = ctl
        self.req = request
        self.decided = False
        self.buffer: List[int] = []
        self.text_out = ""  # exact text already delivered to on_text
        self.tts_pending = ""
        self._tts_scan = 0  # resume point for the sentence scan

    def on_token(self, tok: int) -> None:
        self.buffer.append(tok)
        text = self.ctl.decode(self.buffer)
        if not self.decided:
            stripped = text.lstrip()
            if not stripped:
                return
            if stripped.startswith(STATE_TOKEN_NOISY):
                self.decided = True
                self.ctl._reject(self.req)
                return
            # keep buffering until any leading state token is complete, so
            # streaming below never sees a half-emitted '<1'
            if stripped.startswith("<") and ">" not in stripped[:3]:
                if len(stripped) < 3:
                    return
            self.decided = True
            self.ctl._promote(self.req)
        self._stream(text)

    def _stream(self, text: str, final: bool = False) -> None:
        clean = _strip_state_tokens(text)
        if not final:
            # a token boundary can split a multi-byte character: hold a
            # trailing replacement char until it decodes for real
            clean = clean.rstrip("�")
        # emit only a monotonic extension of what was delivered: stripping
        # a just-completed state token SHRINKS the text, and a naive
        # length diff would misalign (swallow or duplicate characters)
        if clean.startswith(self.text_out) and len(clean) > len(self.text_out):
            delta = clean[len(self.text_out):]
            self.ctl.on_text(delta)
            self.tts_pending += delta
            self.text_out = clean
        # flush complete sentences to TTS (>=5 chars, punct boundary
        # :572-574); a too-short sentence merges FORWARD into the next one
        # (resuming the scan past its punctuation — never re-cutting the
        # same spot, which would block TTS for the rest of the turn)
        while True:
            cut = next(
                (i for i in range(self._tts_scan, len(self.tts_pending))
                 if self.tts_pending[i] in SENTENCE_PUNCT),
                None,
            )
            if cut is None:
                break
            candidate = self.tts_pending[: cut + 1]
            if len(candidate.strip()) >= MIN_TTS_CHARS:
                self._emit_tts(candidate)
                self.tts_pending = self.tts_pending[cut + 1 :]
                self._tts_scan = 0
            else:
                self._tts_scan = cut + 1

    def _emit_tts(self, sentence: str) -> None:
        self.ctl.on_tts(sentence)
        if self.ctl.on_sentence is not None:
            self.ctl.on_sentence(sentence, self.req)

    def on_finish(self, tokens: List[int], reason: str) -> None:
        if self.decided and reason != "cancelled":
            # deliver any held-back tail (trailing partial char, unstreamed
            # remainder) before the final TTS flush
            self._stream(self.ctl.decode(tokens), final=True)
            if self.tts_pending.strip():
                self._emit_tts(self.tts_pending)
                self.tts_pending = ""
        if self.decided and not self.req.cancelled and reason != "cancelled":
            self.ctl.on_turn(self.req, self.ctl.decode(tokens))


def _strip_state_tokens(text: str) -> str:
    for t in ("<1>", "<2>", "<3>", "</s>"):
        text = text.replace(t, "")
    return text
