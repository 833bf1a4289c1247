"""Trained streaming-VAD probability model (silero-class role).

The reference gates the interactive demo's microphone with silero-VAD
(web_demo/wakeup_and_vad/wakeup_and_vad.py:129-156, a torch.jit model).
This is its dependency-free equivalent: a small MLP over per-chunk
spectral features, trained on synthetic speech/noise (tools/train_vad.py)
with the weights checked in (vad_weights.npz). It plugs into
StreamingVAD via ``prob_fn`` and — unlike the round-1 energy detector —
rejects loud non-speech noise (white/pink/hum/clicks) because it looks at
harmonicity and band shape, not level.

Features per 4096-sample chunk (16 frames x 256):
  16 log-band means + 16 log-band stds over frames + zero-crossing rate +
  log RMS + spectral flatness + low-band ratio + band-energy temporal
  modulation = 37 dims.

A copy of vita_tpu.serve.vad_model, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

CHUNK = 4096
N_FRAMES, FRAME = 16, 256
N_BANDS = 16
_WINDOW = np.hanning(FRAME).astype(np.float32)
WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "vad_weights.npz")


def _band_edges() -> np.ndarray:
    # mel-ish band edges over 0..8 kHz for 129 rfft bins
    mel = np.linspace(0, 2595 * np.log10(1 + 8000 / 700), N_BANDS + 1)
    hz = 700 * (10 ** (mel / 2595) - 1)
    return np.clip((hz / 8000 * (FRAME // 2)).astype(int), 0, FRAME // 2)


_EDGES = _band_edges()


def vad_features(chunk: np.ndarray) -> np.ndarray:
    """[4096] float32 -> [37] features."""
    x = np.asarray(chunk, np.float32)
    if len(x) < CHUNK:
        x = np.pad(x, (0, CHUNK - len(x)))
    frames = x[:CHUNK].reshape(N_FRAMES, FRAME) * _WINDOW
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # [16, 129]
    bands = np.empty((N_FRAMES, N_BANDS), np.float32)
    for b in range(N_BANDS):
        lo, hi = _EDGES[b], max(_EDGES[b + 1], _EDGES[b] + 1)
        bands[:, b] = spec[:, lo:hi].mean(axis=1)
    logb = np.log1p(bands * 1e4)
    zcr = float(np.mean(np.abs(np.diff(np.signbit(x))) > 0))
    rms = float(np.sqrt(np.mean(x**2)))
    flat = float(
        np.mean(
            np.exp(np.mean(np.log(spec + 1e-12), axis=1))
            / (np.mean(spec, axis=1) + 1e-12)
        )
    )
    total = spec.sum() + 1e-12
    low_ratio = float(spec[:, _EDGES[1] : _EDGES[8]].sum() / total)
    # syllabic modulation: band energies fluctuate over frames for speech
    mod = float(np.mean(np.std(logb, axis=0) / (np.mean(logb, axis=0) + 1e-6)))
    return np.concatenate([
        logb.mean(axis=0), logb.std(axis=0),
        [zcr, np.log10(rms + 1e-7), flat, low_ratio, mod],
    ]).astype(np.float32)


FEATURE_DIM = 2 * N_BANDS + 5


def mlp_prob(weights: dict, feats: np.ndarray) -> float:
    h = np.tanh((feats - weights["mu"]) / weights["sigma"] @ weights["w1"]
                + weights["b1"])
    z = float(h @ weights["w2"] + weights["b2"])
    return float(1.0 / (1.0 + np.exp(-z)))


def load_trained_vad(path: Optional[str] = None) -> Callable[[np.ndarray], float]:
    """Returns a prob_fn for StreamingVAD using the checked-in weights."""
    w = dict(np.load(path or WEIGHTS_PATH))

    def prob_fn(chunk: np.ndarray) -> float:
        return mlp_prob(w, vad_features(chunk))

    return prob_fn


# ---------------------------------------------------------------------------
# synthetic speech/noise generators (training + fixture sets)
# ---------------------------------------------------------------------------
def synth_speech(rng: np.random.Generator, n: int = CHUNK) -> np.ndarray:
    """Harmonic source with formant shaping and syllabic AM."""
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(80, 300) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = np.zeros(n)
    formants = rng.uniform([300, 800, 2000], [900, 2400, 3500])
    for h in range(1, 24):
        fh = h * np.mean(f0)
        if fh > 7000:
            break
        gain = sum(np.exp(-((fh - fm) ** 2) / (2 * 300.0**2)) for fm in formants)
        sig += (gain + 0.05) / h * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    am = 0.4 + 0.6 * np.clip(np.sin(2 * np.pi * rng.uniform(2, 8) * t
                                    + rng.uniform(0, 6)), 0, None)
    sig = sig * am + 0.01 * rng.standard_normal(n)
    sig /= np.max(np.abs(sig)) + 1e-9
    return (sig * rng.uniform(0.02, 0.6)).astype(np.float32)


def synth_noise(rng: np.random.Generator, n: int = CHUNK) -> np.ndarray:
    """Non-speech: white / pink / hum / clicks / band noise, loud or soft."""
    kind = rng.integers(0, 5)
    t = np.arange(n) / 16000.0
    if kind == 0:  # white
        sig = rng.standard_normal(n)
    elif kind == 1:  # pink-ish (integrated white, high-passed)
        w = rng.standard_normal(n)
        sig = np.cumsum(w)
        sig -= np.convolve(sig, np.ones(64) / 64, mode="same")
    elif kind == 2:  # mains hum + harmonics
        sig = sum(np.sin(2 * np.pi * 50 * h * t + rng.uniform(0, 6)) / h
                  for h in range(1, 5))
        sig += 0.2 * rng.standard_normal(n)
    elif kind == 3:  # impulsive clicks
        sig = 0.05 * rng.standard_normal(n)
        for _ in range(rng.integers(1, 6)):
            i = rng.integers(0, n - 64)
            sig[i : i + 64] += rng.uniform(2, 6) * np.exp(-np.arange(64) / 8.0)
    else:  # narrow-band noise burst (non-harmonic)
        w = rng.standard_normal(n)
        f = np.fft.rfft(w)
        c = rng.integers(20, len(f) - 40)
        mask = np.zeros(len(f))
        mask[c : c + 30] = 1.0
        sig = np.fft.irfft(f * mask, n)
    sig = np.asarray(sig, np.float32)
    sig /= np.max(np.abs(sig)) + 1e-9
    return (sig * rng.uniform(0.005, 0.6)).astype(np.float32)
