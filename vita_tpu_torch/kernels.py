"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``vita_tpu_torch/csrc/*.cu`` expose a plain C interface.
At first use they are compiled by ``nvcc`` for ``sm_90a`` into one shared
library under ``build/kernels/`` at the repository root (named by a hash
of the sources, so an edited source rebuilds), and loaded with ``ctypes``.
Nothing is built or loaded at import time: the CPU-only test runs import
every module of the package.

Every wrapper that launches a kernel adds one to its entry of
``launches`` right where it launches, and nowhere else; a caller can
zero the counts with ``reset_launches()`` and read them after a run to
show that the run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {
    "flash_fwd": 0,
    "paged_attention": 0,
    "gather_expert_ffn": 0,
    "masked_expert_ffn": 0,
}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale, causal, dtype, stream
    "vita_flash_fwd": [_P] * 6 + [_I] * 5 + [_F, _I, _I, _P],
    # q, k_pages, v_pages, o, tables, lengths, B, layer, Hq, Hkv, n_pool,
    # page, max_pages, scale, dtype, stream
    "vita_paged_attn": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # x, eids, toks, w_gate, w_up, w_down, h, y, R, nt, D, F, dtype, stream
    "vita_expert_ffn": [_P] * 8 + [_I] * 5 + [_P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libvita_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and prints the compiler's output."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(*tensors: torch.Tensor) -> int:
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(
            "kernel takes float32 or bfloat16 tensors of one dtype, got "
            f"{[t.dtype for t in tensors]}"
        )
    return DTYPE_CODES[dt]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel needs all operands on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous operands")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
