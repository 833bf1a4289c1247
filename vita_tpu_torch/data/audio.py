"""Kaldi-compatible log-mel fbank, pure numpy (host) — the audio frontend
(a copy of vita_tpu.data.audio, so that the port loads no module of the
reference package; tests/test_torch_data.py holds it equal to the original).

Replaces the reference's torchaudio.compliance.kaldi.fbank call
(vita/model/multimodal_encoder/whale/init_model.py:35-60; deploy params in
model_weight_file/feature_extractor/preprocessor_config.json): 16 kHz,
int16 scaling (x * 2^15), 80 mel bins, 25 ms frames / 10 ms shift,
energy_floor=0, snip_edges, Povey window, preemphasis 0.97, DC removal,
mel range 20 Hz..Nyquist, log with float-eps floor. ``dither`` defaults to
0 here (deterministic eval); training passes 1.0.

The deployed CMVN statistics (means/istds) ride in the checkpoint and are
applied inside the Whale encoder, not here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import functools

import numpy as np

SAMPLE_RATE = 16000
FRAME_LENGTH_MS = 25
FRAME_SHIFT_MS = 10
NUM_MEL_BINS = 80
PREEMPH = 0.97
LOW_FREQ = 20.0


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_scale(freq: np.ndarray | float) -> np.ndarray | float:
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(
    num_bins: int, fft_size: int, sample_rate: float, low_freq: float, high_freq: float
) -> np.ndarray:
    """Kaldi triangular mel filterbank over FFT bins [0, fft_size/2)."""
    nyquist = 0.5 * sample_rate
    if high_freq <= 0:
        high_freq = nyquist + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins), np.float32)
    mel_centers = mel_low + np.arange(num_bins + 2) * mel_delta
    fft_mels = mel_scale(np.arange(num_fft_bins) * fft_bin_width)
    for b in range(num_bins):
        left, center, right = mel_centers[b], mel_centers[b + 1], mel_centers[b + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        bins[b] = np.maximum(0.0, np.minimum(up, down))
    return bins


def fbank(
    waveform: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    num_mel_bins: int = NUM_MEL_BINS,
    frame_length_ms: float = FRAME_LENGTH_MS,
    frame_shift_ms: float = FRAME_SHIFT_MS,
    dither: float = 0.0,
    preemph: float = PREEMPH,
    low_freq: float = LOW_FREQ,
    high_freq: float = 0.0,
    scale_to_int16: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """waveform [T] float in [-1, 1] -> log-mel features [frames, bins]."""
    x = np.asarray(waveform, np.float64)
    if x.ndim == 2:  # [channels, T] — take first channel like torchaudio.load
        x = x[0]
    if scale_to_int16:
        x = x * 32768.0

    win = int(frame_length_ms * sample_rate / 1000)
    shift = int(frame_shift_ms * sample_rate / 1000)
    if len(x) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(x) - win) // shift

    idx = np.arange(win)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = x[idx]  # [F, win]

    if dither != 0.0:
        rng = rng or np.random.default_rng()
        frames = frames + dither * rng.standard_normal(frames.shape)

    frames = frames - frames.mean(axis=1, keepdims=True)  # remove_dc_offset
    # Kaldi preemphasis: x[0] -= p*x[0] for the first sample
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - preemph * pre

    n = np.arange(win)
    povey = (0.5 - 0.5 * np.cos(2 * math.pi * n / (win - 1))) ** 0.85
    frames = frames * povey

    fft_size = _next_pow2(win)
    spec = np.fft.rfft(frames, fft_size)
    power = (spec.real**2 + spec.imag**2)[:, : fft_size // 2]

    banks = mel_banks(num_mel_bins, fft_size, sample_rate, low_freq, high_freq)
    mel = power @ banks.T
    mel = np.log(np.maximum(mel, np.finfo(np.float32).eps))
    return mel.astype(np.float32)


def load_wav(path: str, target_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Read a PCM wav file to mono float32 in [-1, 1], resampled if needed."""
    import wave

    with wave.open(path, "rb") as f:
        rate = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 3:
        # 24-bit PCM (common recorder format): widen each little-endian
        # 3-byte sample to int32 with sign extension
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        data = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
        ).astype(np.float32)
    elif width in (1, 2, 4):
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported wav sample width: {width} bytes")
    if width == 1:
        data = (data - 128.0) / 128.0
    else:
        data = data / float(2 ** (8 * width - 1))
    if channels > 1:
        data = data.reshape(-1, channels)[:, 0]
    if rate != target_rate:
        data = resample(data, rate, target_rate)
    return data


def resample(x: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy), matching torchaudio's kaiser approach
    closely enough for feature parity at 16 kHz targets."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_rate, new_rate)
    return resample_poly(x, new_rate // g, orig_rate // g).astype(np.float32)


def wav_to_features(path: str, dither: float = 0.0) -> Tuple[np.ndarray, int]:
    """wav file -> (fbank [T, 80], num_frames): the audioEncoderProcessor
    equivalent (whale/init_model.py:35-60)."""
    wav = load_wav(path)
    feats = fbank(wav, dither=dither)
    return feats, feats.shape[0]
