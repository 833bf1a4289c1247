"""Local TTS for the duplex loop: synthesis, stale-drop, paced streaming.

The reference's duplex demo runs a tts_worker process that synthesizes one
sentence-chunk at a time (an external TTS model), drops chunks whose
``llm_id`` no longer matches the active turn (an interrupt arrived), emits
a short pause marker on turn change, and a text_streamer that paces the UI
by each clip's audio duration (web_demo/web_interactive_demo.py:419-601,
743-772). This module reproduces that protocol with a dependency-free
formant synthesizer (source-filter, robotic but audible) so the loop is
complete without any external model or audio stack:

- normalize_tts_text: the reference's text cleanup (strip state/special
  tokens, uncommon punctuation, spoken math substitutions, lowercase).
- FormantSynthesizer: letters -> crude phones; voiced phones are a glottal
  pulse train convolved with damped-sinusoid formant kernels, fricatives
  are band-shaped noise, stops are closure + burst. Pure numpy, 16 kHz.
- TTSWorker: thread consuming (llm_id, sentence) -> (llm_id, text, wav,
  duration); a new llm_id flushes pending state and emits a PAUSE chunk.
- PacedStreamer: plays chunks in arrival order, skipping chunks whose
  llm_id is no longer current, sleeping pace_factor * duration per chunk.

A copy of vita_tpu.serve.tts, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import queue
import re
import threading
import wave
from typing import Callable, List, Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000

_SPECIAL_TOKENS = ("<1>", "<2>", "<3>", "<unk>", "</s>")
# spoken substitutions for math-y text (the reference additionally maps to
# Chinese for zh prompts; we keep the English set)
_MATH_WORDS = {
    "sin": " sine ", "cos": " cosine ", "tan": " tangent ",
    "cot": " cotangent ", "log": " logarithm ", "ln": " natural logarithm ",
    "sqrt": " square root ", "pi": " pie ",
}
_COMMON_PUNCT = ".,!?;:()[]，。！？、：；（） "


def normalize_tts_text(text: str) -> str:
    """Reference cleanup chain (remove_special_tokens ->
    remove_uncommon_punctuation -> replace_equation -> lower)."""
    for t in _SPECIAL_TOKENS:
        text = text.replace(t, "")
    # math substitutions first: '^' would not survive the punct filter
    for k, v in _MATH_WORDS.items():
        text = re.sub(rf"\b{k}\b", v, text)
    text = re.sub(r"(\d+)\s*\^\s*(\w+)", r"\1 to the power \2", text)
    text = re.sub(rf"[^\w\s{re.escape(_COMMON_PUNCT)}]", "", text)
    return re.sub(r"\s+", " ", text).strip().lower()


# crude grapheme -> phone classes: (kind, data)
#   vowel: (f1, f2, f3) formant Hz;  fricative: (lo, hi) noise band;
#   stop: burst band;  nasal: murmur formant;  liquid: vowel-like glide
_VOWELS = {
    "a": (730, 1090, 2440), "e": (530, 1840, 2480), "i": (270, 2290, 3010),
    "o": (570, 840, 2410), "u": (300, 870, 2240), "y": (270, 2100, 2900),
}
_FRICS = {
    "s": (4000, 7500), "z": (3800, 7000), "f": (1500, 7000), "v": (1000, 5000),
    "h": (500, 3000), "x": (3000, 7000), "c": (3500, 7000), "j": (2000, 5000),
}
_STOPS = {"p": 800, "b": 500, "t": 4000, "d": 3000, "k": 1800, "g": 1200, "q": 1800}
_NASALS = {"m": 250, "n": 300}
_LIQUIDS = {"l": (380, 1200, 2600), "r": (420, 1300, 1600), "w": (300, 700, 2200)}


@dataclasses.dataclass
class Voice:
    f0: float = 118.0  # base pitch, Hz
    decl: float = 0.12  # per-sentence pitch declination fraction
    vowel_s: float = 0.11
    cons_s: float = 0.055
    gap_s: float = 0.012


class FormantSynthesizer:
    """Rule-based source-filter synthesis, numpy only."""

    def __init__(self, voice: Optional[Voice] = None, sample_rate: int = SAMPLE_RATE):
        self.voice = voice or Voice()
        self.sr = sample_rate

    # -- building blocks ---------------------------------------------------
    def _formant_kernel(self, freqs, bws=(90.0, 110.0, 170.0), dur=0.02):
        """Impulse response of cascaded formant resonators: sum of damped
        sinusoids (amplitude falls with formant index)."""
        t = np.arange(int(dur * self.sr)) / self.sr
        out = np.zeros_like(t)
        for i, f in enumerate(freqs):
            bw = bws[min(i, len(bws) - 1)]
            out += (0.9 ** i) * np.exp(-np.pi * bw * t) * np.sin(2 * np.pi * f * t)
        return out

    def _voiced(self, freqs, dur, f0):
        """Glottal pulse train convolved with the formant kernel."""
        n = int(dur * self.sr)
        period = max(int(self.sr / f0), 1)
        pulses = np.zeros(n)
        pulses[::period] = 1.0
        # slight jitter-free shimmer: alternate pulse strength
        pulses[period::2 * period] = 0.92
        sig = np.convolve(pulses, self._formant_kernel(freqs))[:n]
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.01 * self.sr))
        return sig * env

    def _noise_band(self, lo, hi, dur, rng):
        """Noise shaped to [lo, hi] Hz via FFT masking."""
        n = int(dur * self.sr)
        x = rng.standard_normal(n)
        spec = np.fft.rfft(x)
        f = np.fft.rfftfreq(n, 1.0 / self.sr)
        spec[(f < lo) | (f > hi)] = 0
        y = np.fft.irfft(spec, n)
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.004 * self.sr))
        m = np.max(np.abs(y)) or 1.0
        return 0.5 * y / m * env

    # -- synthesis ---------------------------------------------------------
    def synthesize(self, text: str) -> np.ndarray:
        """Sentence -> float32 mono [-1, 1] at self.sr. Deterministic for a
        given text (seeded from the text) so tests and replays are stable."""
        v = self.voice
        text = normalize_tts_text(text)
        rng = np.random.default_rng(abs(hash(text)) % (2 ** 32))
        rising = text.rstrip().endswith("?")
        # pitch contour over voiced phones: declination (or final rise)
        voiced_positions = [i for i, ch in enumerate(text) if ch.isalnum()]
        total = max(len(voiced_positions), 1)
        pieces: List[np.ndarray] = []
        vi = 0
        for ch in text:
            frac = vi / total
            f0 = v.f0 * (1.0 - v.decl * frac)
            if rising and frac > 0.7:
                f0 = v.f0 * (1.0 + 0.25 * (frac - 0.7) / 0.3)
            if ch in _VOWELS:
                pieces.append(self._voiced(_VOWELS[ch], v.vowel_s, f0))
                vi += 1
            elif ch in _LIQUIDS:
                pieces.append(self._voiced(_LIQUIDS[ch], v.cons_s, f0))
                vi += 1
            elif ch in _FRICS:
                lo, hi = _FRICS[ch]
                pieces.append(self._noise_band(lo, hi, v.cons_s, rng))
                vi += 1
            elif ch in _STOPS:
                center = _STOPS[ch]
                closure = np.zeros(int(0.03 * self.sr))
                burst = self._noise_band(center * 0.6, center * 1.8, 0.025, rng)
                pieces.append(np.concatenate([closure, burst]))
                vi += 1
            elif ch in _NASALS:
                pieces.append(0.6 * self._voiced((_NASALS[ch], 1200, 2300), v.cons_s, f0))
                vi += 1
            elif ch.isdigit():
                # digits: two-tone beep encoding (distinct and short)
                d = int(ch)
                tone = self._voiced((300 + 60 * d, 1000 + 120 * d, 2500), v.vowel_s, f0)
                pieces.append(tone)
                vi += 1
            elif ch == " ":
                pieces.append(np.zeros(int(0.045 * self.sr)))
            elif ch in ".!?;:":
                pieces.append(np.zeros(int(0.18 * self.sr)))
            elif ch in ",、":
                pieces.append(np.zeros(int(0.09 * self.sr)))
            else:
                continue
            pieces.append(np.zeros(int(v.gap_s * self.sr)))
        if not pieces:
            return np.zeros(0, np.float32)
        out = np.concatenate(pieces)
        peak = np.max(np.abs(out)) or 1.0
        return (0.55 * out / peak).astype(np.float32)


def write_wav(path: str, samples: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes((np.clip(samples, -1, 1) * 32767).astype(np.int16).tobytes())


@dataclasses.dataclass
class TTSChunk:
    llm_id: int
    text: str  # "" for a PAUSE chunk
    audio: Optional[np.ndarray]
    duration_s: float

    @property
    def is_pause(self) -> bool:
        return self.audio is None


class TTSWorker:
    """Thread: (llm_id, sentence) in -> TTSChunk out.

    Turn-change semantics mirror the reference tts_worker
    (web_interactive_demo.py:565-601): when a sentence arrives under a NEW
    llm_id, any not-yet-synthesized text of the old turn is abandoned and
    a 0.2 s PAUSE chunk precedes the new turn's audio. Synthesis happens
    on this thread, off the engine/controller threads."""

    def __init__(self, synth: Optional[FormantSynthesizer] = None,
                 out_queue: Optional["queue.Queue[TTSChunk]"] = None):
        self.synth = synth or FormantSynthesizer()
        self.inputs: "queue.Queue[Optional[Tuple[int, str]]]" = queue.Queue()
        self.outputs: "queue.Queue[TTSChunk]" = out_queue or queue.Queue()
        self._past_llm_id = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, llm_id: int, sentence: str) -> None:
        self.inputs.put((llm_id, sentence))

    def stop(self, timeout: float = 10.0) -> None:
        self.inputs.put(None)
        self._thread.join(timeout=timeout)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until every submitted sentence has been synthesized."""
        import time

        t0 = time.time()
        while not self.inputs.empty() and time.time() - t0 < timeout:
            time.sleep(0.01)

    def _run(self) -> None:
        while True:
            item = self.inputs.get()
            if item is None:
                return
            llm_id, sentence = item
            if self._past_llm_id != 0 and llm_id != self._past_llm_id:
                self.outputs.put(TTSChunk(llm_id, "", None, 0.2))
            self._past_llm_id = llm_id
            text = normalize_tts_text(sentence)
            if not text:
                continue
            audio = self.synth.synthesize(text)
            if audio.size == 0:
                continue
            self.outputs.put(
                TTSChunk(llm_id, text, audio, len(audio) / self.synth.sr)
            )


class PacedStreamer:
    """Plays TTSChunks at audio cadence, dropping stale turns.

    ``current_llm_id`` is a callable returning the active turn id (the
    reference checks interrupt_signal.value, :756-758): chunks from an
    older turn that were already synthesized when the interrupt landed are
    skipped, not played. Each played chunk sleeps pace_factor * duration
    (reference sleeps 1.5x, :768) so text never runs ahead of audio."""

    def __init__(
        self,
        chunks: "queue.Queue[TTSChunk]",
        current_llm_id: Callable[[], int],
        on_play: Callable[[TTSChunk], None],
        pace_factor: float = 1.5,
        sleep: Callable[[float], None] = None,
    ):
        import time

        self.chunks = chunks
        self.current_llm_id = current_llm_id
        self.on_play = on_play
        self.pace_factor = pace_factor
        self._sleep = sleep or time.sleep
        self.played: List[TTSChunk] = []
        self.skipped_stale = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                chunk = self.chunks.get(timeout=0.05)
            except queue.Empty:
                continue
            if chunk.llm_id != self.current_llm_id():
                self.skipped_stale += 1
                continue
            if chunk.is_pause:
                self._sleep(chunk.duration_s)
                continue
            self.played.append(chunk)
            self.on_play(chunk)
            self._sleep(self.pace_factor * chunk.duration_s)
