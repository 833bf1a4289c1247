"""Native (C++) host-side components, bound via ctypes (a copy of
vita_tpu.native).

The Kaldi-compatible log-mel fbank (fbank.cc beside this file, a
byte-equal copy of the repository's native/fbank.cc). The shared library
is built on first use with g++ into build/native/ at the repository root;
`fbank_native` mirrors vita_tpu_torch.data.audio.fbank (the parity
oracle) and `fbank_best` picks native when buildable, numpy otherwise.
This is host preprocessing, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fbank.cc")
_LIB = os.path.join(_REPO_ROOT, "build", "native", "libvitafbank.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
                os.makedirs(os.path.dirname(_LIB), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
                    check=True, capture_output=True,
                )
            lib = ctypes.CDLL(_LIB)
            lib.vita_fbank.restype = ctypes.c_int32
            lib.vita_fbank.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
            ]
            lib.vita_fbank_num_frames.restype = ctypes.c_int32
            lib.vita_fbank_num_frames.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ]
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def fbank_native(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    dither: float = 0.0,
    preemph: float = 0.97,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native fbank library unavailable (g++ build failed)")
    wav = np.ascontiguousarray(np.asarray(waveform, np.float32))
    if wav.ndim == 2:
        wav = wav[0]
    n_frames = lib.vita_fbank_num_frames(
        len(wav), sample_rate, frame_length_ms, frame_shift_ms
    )
    out = np.empty((max(n_frames, 0), num_mel_bins), np.float32)
    if n_frames <= 0:
        return out
    rc = lib.vita_fbank(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav), sample_rate,
        num_mel_bins, frame_length_ms, frame_shift_ms, dither, preemph,
        low_freq, high_freq, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc < 0:
        raise RuntimeError(f"vita_fbank failed: rc={rc}")
    return out


def fbank_best(waveform: np.ndarray, **kw) -> np.ndarray:
    """Native fbank when available, numpy fallback otherwise."""
    if native_available():
        return fbank_native(waveform, **kw)
    from vita_tpu_torch.data.audio import fbank

    return fbank(waveform, **{k.replace("_ms", "_ms"): v for k, v in kw.items()})
