"""Streaming voice-activity detection with start/end hysteresis.

State-machine parity with the reference's silero-based VADIterator
(web_demo/wakeup_and_vad/wakeup_and_vad.py:12-100,175-194): audio arrives
in fixed-size chunks; speech starts when probability exceeds
``threshold_start``, ends after ``min_silence_ms`` below ``threshold_end``;
the emitted segment includes ``pad_ms`` of leading context; dialogs
shorter than ``min_dialog_s`` are dropped by the caller
(web_interactive_demo.py:827-829).

The probability function is pluggable: the default is the trained MLP
model (serve.vad_model, silero's role in the reference) when its
checked-in weights are present, else a normalized energy+spectral-flatness
detector; a silero ONNX session can also be dropped in via ``prob_fn``.

A copy of vita_tpu.serve.vad, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np

CHUNK_SAMPLES = 4096  # 16 frames x 256 shift, like the reference
SAMPLE_RATE = 16000


def energy_vad_prob(chunk: np.ndarray, noise_floor: float = 3e-4) -> float:
    """Cheap speech probability: RMS energy vs floor, shaped by spectral
    concentration in the speech band (~80 Hz - 4 kHz)."""
    rms = float(np.sqrt(np.mean(chunk**2)))
    if rms < noise_floor:
        return 0.0
    spec = np.abs(np.fft.rfft(chunk * np.hanning(len(chunk))))
    freqs = np.fft.rfftfreq(len(chunk), 1.0 / SAMPLE_RATE)
    band = (freqs > 80) & (freqs < 4000)
    total = float(spec.sum()) + 1e-9
    concentration = float(spec[band].sum()) / total
    level = min(rms / (noise_floor * 30), 1.0)
    return level * concentration


def default_prob_fn() -> Callable[[np.ndarray], float]:
    """Trained MLP model when its weights ship with the package (the
    silero-equivalent, serve.vad_model), else the energy heuristic."""
    from vita_tpu_torch.serve import vad_model

    if os.path.exists(vad_model.WEIGHTS_PATH):
        return vad_model.load_trained_vad()
    return energy_vad_prob


@dataclasses.dataclass
class VADConfig:
    threshold_start: float = 0.7
    threshold_end: float = 0.55
    min_silence_ms: float = 500.0
    pad_ms: float = 300.0
    min_dialog_s: float = 1.5


class StreamingVAD:
    """Feed chunks; get back completed speech segments."""

    def __init__(
        self,
        config: Optional[VADConfig] = None,
        prob_fn: Optional[Callable[[np.ndarray], float]] = None,
    ):
        self.cfg = config or VADConfig()  # fresh per instance (mutable)
        if prob_fn is None:
            prob_fn = default_prob_fn()
        self.prob_fn = prob_fn
        self.reset()

    def reset(self) -> None:
        self.in_speech = False
        self.silence_samples = 0
        self.pad_buffer: List[np.ndarray] = []
        self.segment: List[np.ndarray] = []

    def _pad_chunks(self) -> int:
        return max(1, int(self.cfg.pad_ms / 1000 * SAMPLE_RATE / CHUNK_SAMPLES))

    def process(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        """Returns a completed segment (float32 [T]) at end-of-speech, else
        None. Chunks should be CHUNK_SAMPLES long at 16 kHz."""
        prob = self.prob_fn(chunk)

        if not self.in_speech:
            if prob >= self.cfg.threshold_start:
                self.in_speech = True
                # the segment starts with pad_ms of PRE-onset context plus
                # the triggering chunk (the reference prepends last_audio —
                # wakeup_and_vad.py predict's cat([last_audio, audio]));
                # trimming before the append keeps the leading context
                self.segment = list(self.pad_buffer) + [chunk]
                self.silence_samples = 0
            else:
                self.pad_buffer.append(chunk)
                self.pad_buffer = self.pad_buffer[-self._pad_chunks():]
            return None

        self.segment.append(chunk)
        # reference VADIterator semantics: the silence clock starts at the
        # first dip below threshold_end, keeps running through the
        # intermediate band [end, start) (it is wall-clock from temp_end),
        # and resets ONLY on confident speech (prob >= threshold_start) —
        # audio hovering between the thresholds must still end the
        # utterance instead of stalling the duplex turn forever.
        if prob >= self.cfg.threshold_start:
            self.silence_samples = 0
        elif prob < self.cfg.threshold_end or self.silence_samples > 0:
            self.silence_samples += len(chunk)
            if self.silence_samples >= self.cfg.min_silence_ms / 1000 * SAMPLE_RATE:
                seg = np.concatenate(self.segment).astype(np.float32)
                self.reset()
                if len(seg) / SAMPLE_RATE >= self.cfg.min_dialog_s:
                    return seg
                return None  # too short: dropped (reference :827-829)
        return None
