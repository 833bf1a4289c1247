"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``vita_tpu_torch/csrc/*.cu`` expose a plain C interface.
At first use each is compiled by its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library under
``build/kernels/`` at the repository root (named by a hash of the sources,
so an edited source rebuilds), which is loaded with ``ctypes``.
Nothing is built or loaded at import time: the CPU-only test runs import
every module of the package.

Every wrapper that launches a kernel adds one to its entry of
``launches`` (``count_launch``, under a lock) right where it launches,
and nowhere else; a caller can
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
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# expert weight formats of csrc/expert_ffn.cu
WFMT_PLAIN, WFMT_INT8, WFMT_INT4 = 0, 1, 2

launches: Dict[str, int] = {
    "flash_fwd": 0,
    "paged_attention": 0,
    "paged_attention_q": 0,
    "gather_expert_ffn": 0,
    "masked_expert_ffn": 0,
    "gather_expert_ffn_q": 0,
    "gather_expert_ffn_q4": 0,
    "masked_expert_ffn_q": 0,
    "masked_expert_ffn_q4": 0,
    "gmm": 0,
    "gmm_small": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "gmm_wgrad": 0,
}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale, causal, dtype, stream
    "vita_flash_fwd": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dq, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale,
    # causal, dtype, stream
    "vita_flash_bwd_dq": [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, kv_len, q_off, B, Sq, Skv, Hq, Hkv,
    # scale, causal, dtype, stream
    "vita_flash_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P],
    # q, k_pages, v_pages, o, tables, lengths, B, layer, Hq, Hkv, n_pool,
    # page, max_pages, scale, dtype, stream
    "vita_paged_attn": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # q, k_pages, v_pages, k_scale, v_scale, o, tables, lengths, B, layer,
    # Hq, Hkv, n_pool, page, max_pages, scale, dtype, stream
    "vita_paged_attn_q": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    # B, Hkv, max_pages -> splits (blocks of a cluster) of a vita_paged_attn(_q) launch
    "vita_paged_attn_splits": [_I] * 3,
    # which (0: bf16 pages, 1: int8 pages), out int[4]
    "vita_paged_attn_info": [_I, _P],
    # x, eids, toks, w_gate, w_up, w_down, s_gate, s_up, s_down, n_sg, n_sd,
    # h, y, R, nt, D, F, dtype, wfmt, stream
    "vita_expert_ffn": [_P] * 9 + [_I] * 2 + [_P] * 2 + [_I] * 6 + [_P],
    # x, eids, toks, w_gate, w_up, w_down, h, part, y, R, nt, D, F, padded,
    # stream (bf16 x over bf16 experts, both schedules)
    "vita_expert_ffn_bf16": [_P] * 9 + [_I] * 5 + [_P],
    # F -> pieces of F a down block of vita_expert_ffn_bf16 takes
    "vita_expert_ffn_bf16_splits": [_I],
    # which (0, 1: up at 8, 16 token slots; 2, 3: down), out int[4]
    "vita_expert_ffn_bf16_info": [_I, _P],
    # x, eids, toks, w_gate, w_up, w_down, s_gate, s_up, s_down, h, part, y,
    # R, nt, D, F, bits, padded, stream (bf16 x over int4/int8 experts with
    # per-channel scales, both schedules)
    "vita_expert_ffn_q": [_P] * 12 + [_I] * 6 + [_P],
    # F -> pieces of F a down block of vita_expert_ffn_q takes
    "vita_expert_ffn_q_splits": [_I],
    # which (int4 0-3, int8 4-7: up at 8, 16 token slots, then down), out int[4]
    "vita_expert_ffn_q_info": [_I, _P],
    # x, w, gids, out, R, K, N, E, tile_m, trans, stream (float32)
    "vita_gmm": [_P] * 4 + [_I] * 6 + [_P],
    # x, w, gids, out, R, K, N, E, tile_m, trans, stream (bf16)
    "vita_gmm_wgmma": [_P] * 4 + [_I] * 6 + [_P],
    # a, b, gids, out, R, K, N, E, tile_m, dtype, stream
    "vita_gmm_wgrad": [_P] * 4 + [_I] * 6 + [_P],
    # which (0: B5a/B5b, 1: their dx, 2: B12), out int[4]
    "vita_gmm_wgmma_info": [_I, _P],
    # which (0: a pair of q heads a block, 1: one), out int[4]
    "vita_flash_fwd_info": [_I, _P],
    # which (0: B10, 1: B11), out int[4]
    "vita_flash_bwd_mma_info": [_I, _P],
}


# the two duplex Engines launch from two host threads: a plain ``+= 1``
# could lose a count between its read and its write
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (called where it is launched)."""
    with _launches_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _launches_lock:
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


def _run_all(cmds) -> List[str]:
    """Run the commands at once and return their output; raise with the
    first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed with exit code "
                               f"{p.returncode}:\n{text}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and prints the compiler's output."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    ptxas = ("-Xptxas", "-v") if verbose else ()
    logs = _run_all([[_nvcc(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources, objs)])
    tmp = out.with_name(f"{tag}.tmp")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    if verbose:
        print("".join(logs), flush=True)
    for obj in objs:
        obj.unlink()
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


def resources(info_fn, names) -> Dict[str, Dict[str, int]]:
    """What ``info_fn(which, out)`` (a ``vita_*_info`` of the library)
    reports for kernel ``which`` = 0, 1, ... on the current card, under
    ``names``: registers and spilled (local) bytes a thread, shared bytes a
    block, resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    info = {}
    for which, name in enumerate(names):
        out = (ctypes.c_int * 4)()
        check_launch(info_fn(which, out), name)
        info[name] = dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), out))
    return info


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
