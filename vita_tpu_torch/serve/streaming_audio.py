"""Streaming audio frontend: fbank + Whale encode overlap speech capture
(vita_tpu.serve.streaming_audio on the port).

The Whale streaming step (models/whale.py::streaming_step) runs DURING
speech at the mic-chunk cadence, on the device that holds the audio
weights; end-of-speech leaves at most one flush step (<1 mic chunk of
frames), cutting the utterance-length encode out of the duplex TTFT.

Pieces:
- StreamingFbank     incremental Kaldi fbank over a growing sample stream
                     (frame-local ops make streaming == batch exactly).
- StreamingWhaleEncoder  drives whale.streaming_step in fixed-size frame
                     blocks (one block shape for every step; the partial
                     flush goes through chunk_len). Features stay on the
                     device until finish() reads them back once.
- StreamingAudioFrontend  VAD + fbank + encoder glue for the duplex loop:
                     process(chunk) -> EncodedUtterance at end-of-speech.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from vita_tpu_torch.data.audio import FRAME_LENGTH_MS, FRAME_SHIFT_MS, SAMPLE_RATE, fbank
from vita_tpu_torch.models import whale
from vita_tpu_torch.serve.vad import StreamingVAD

WIN_SAMPLES = int(FRAME_LENGTH_MS * SAMPLE_RATE / 1000)  # 400
SHIFT_SAMPLES = int(FRAME_SHIFT_MS * SAMPLE_RATE / 1000)  # 160


class StreamingFbank:
    """Incremental log-mel fbank: feed samples, get back exactly the frames
    the batch `fbank` would produce over the concatenated stream.

    Every per-frame op (DC removal, preemphasis, Povey window, FFT, mel) is
    frame-local in data.audio.fbank, so computing frames from the yet-
    unconsumed sample suffix is bit-identical to the batch call."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self.frames_emitted = 0

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Returns the newly completed frames [n, 80] (possibly empty)."""
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        if len(self._buf) < WIN_SAMPLES:
            return np.zeros((0, 80), np.float32)
        frames = fbank(self._buf)
        k = frames.shape[0]
        # frame k would start at sample k*shift of the remaining buffer
        self._buf = self._buf[k * SHIFT_SAMPLES:]
        self.frames_emitted += k
        return frames


class StreamingWhaleEncoder:
    """Drives whale.streaming_step in fixed ``frame_block`` chunks, on the
    device of ``audio_params``.

    Every step takes one block shape (full blocks and the final partial
    flush both go through chunk_len). ``left_context`` bounds the attention
    span in subsampled frames. Outputs equal the full forward under the
    equivalent chunk-causal mask (tests assert this): chunk-causality is
    inherent to emitting features during speech."""

    def __init__(
        self,
        audio_params: Any,
        cfg: whale.WhaleConfig,
        frame_block: int = 64,
        left_context: int = 1024,
    ):
        self.params = audio_params
        self.cfg = cfg
        self.frame_block = frame_block
        self.left_context = left_context
        self.device = audio_params["cmvn"]["mean"].device
        self.reset()

    def reset(self) -> None:
        self._state = None  # lazy: allocated on first feed
        self._pending = np.zeros((0, self.cfg.input_dim), np.float32)
        self._outs: List[Tuple[Any, int]] = []  # (device feats [1,max_out,D], t_out)
        self._tail = 0  # host mirror of state tail_len
        self.frames_fed = 0

    def _dispatch(self, block: np.ndarray, n_valid: int) -> None:
        if self._state is None:
            self._state = whale.streaming_init(
                self.cfg, 1, self.frame_block, self.left_context, device=self.device
            )
        # host mirror of the state's tail: the step itself never reads back
        t_total = self._tail + n_valid
        t_out = max(int(whale.subsampled_length(t_total)), 0)
        self._tail = min(t_total - 4 * t_out, whale.TAIL_MAX)
        chunk = torch.from_numpy(np.ascontiguousarray(block[None])).to(self.device)
        feats, _, self._state = whale.streaming_step(
            self.params, self.cfg, self._state, chunk, n_valid
        )
        if t_out > 0:
            self._outs.append((feats, t_out))

    def feed(self, frames: np.ndarray) -> None:
        """Accumulate fbank frames; dispatch every full frame_block."""
        if frames.shape[0] == 0:
            return
        self.frames_fed += frames.shape[0]
        self._pending = np.concatenate([self._pending, frames.astype(np.float32)])
        while self._pending.shape[0] >= self.frame_block:
            block = self._pending[: self.frame_block]
            self._pending = self._pending[self.frame_block:]
            self._dispatch(block, self.frame_block)

    def flush_steps_remaining(self) -> int:
        """How many encode steps finish() still owes (<= 1 by construction)."""
        t_total = self._tail + self._pending.shape[0]
        return 1 if whale.subsampled_length(t_total) > 0 else 0

    def finish(self) -> np.ndarray:
        """Flush the partial tail block and return all features [T', hidden].

        At most ONE extra streaming_step runs here (pending < frame_block
        always), so encode latency at end-of-speech is one block, not the
        utterance length."""
        if self._pending.shape[0] > 0:
            n = self._pending.shape[0]
            block = np.zeros((self.frame_block, self.cfg.input_dim), np.float32)
            block[:n] = self._pending
            self._pending = np.zeros((0, self.cfg.input_dim), np.float32)
            self._dispatch(block, n)
        if not self._outs:
            return np.zeros((0, self.cfg.hidden), np.float32)
        feats = torch.cat([f[0, :t] for f, t in self._outs])
        return feats.float().cpu().numpy()


@dataclasses.dataclass
class EncodedUtterance:
    """One VAD-segmented utterance with its Whale features already encoded."""

    wav: np.ndarray  # [T_samples] float32, what the VAD emitted
    features: np.ndarray  # [T_sub, whale_hidden] post-ln_final encoder output
    num_frames: int  # raw fbank frames (drives audio_token_count parity)

    @property
    def token_count(self) -> int:
        """LLM tokens after the CNN adapter (stride-2): (T'-1)//2+1."""
        return (self.features.shape[0] - 1) // 2 + 1


class StreamingAudioFrontend:
    """VAD + incremental fbank + streaming Whale encode for the duplex loop.

    process(chunk) mirrors StreamingVAD.process but returns an
    EncodedUtterance whose encoder work already happened during speech:
    at end-of-speech only the <1-block flush remains
    (flush_steps_remaining() <= 1, asserted by tests)."""

    def __init__(
        self,
        audio_params: Any,
        cfg: whale.WhaleConfig,
        vad: Optional[StreamingVAD] = None,
        frame_block: int = 64,
        left_context: int = 1024,
    ):
        self.vad = vad or StreamingVAD()
        self.fbank = StreamingFbank()
        self.encoder = StreamingWhaleEncoder(
            audio_params, cfg, frame_block=frame_block, left_context=left_context
        )

    def process(self, chunk: np.ndarray) -> Optional[EncodedUtterance]:
        was_in = self.vad.in_speech
        seg = self.vad.process(chunk)
        now_in = self.vad.in_speech

        if not was_in and now_in:
            # speech started on this chunk: the VAD segment begins with
            # pad_ms of pre-onset context — encode exactly those samples
            self.fbank.reset()
            self.encoder.reset()
            self.encoder.feed(
                self.fbank.feed(np.concatenate(self.vad.segment))
            )
            return None
        if was_in and now_in:
            self.encoder.feed(self.fbank.feed(chunk))
            return None
        if was_in and not now_in:
            # utterance ended (emitted) or was dropped as too short
            if seg is None:
                self.fbank.reset()
                self.encoder.reset()
                return None
            # the final chunk is part of the emitted segment
            self.encoder.feed(self.fbank.feed(chunk))
            num_frames = self.encoder.frames_fed
            features = self.encoder.finish()
            self.fbank.reset()
            self.encoder.reset()
            return EncodedUtterance(
                wav=seg, features=features, num_frames=num_frames
            )
        return None
