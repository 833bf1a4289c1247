"""PyTorch port: imports without jax or the reference package, launches a
kernel or raises (never the plain version) for non-CPU tensors, and
chip_smoke.py refuses to run without a CUDA card."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from vita_tpu_torch import kernels
from vita_tpu_torch.ops import flash_attention, moe_decode, paged_attention

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(code_or_args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), **(env_extra or {}))
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys, vita_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vita_tpu_torch.__path__, 'vita_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "ref = [m for m in sys.modules if m == 'vita_tpu' or m.startswith('vita_tpu.')]\n"
        "assert not ref, ref\n"
        "print(len(names))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "vita_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import jax|from jax|import vita_tpu\b|from vita_tpu[ .])", re.M)
    offenders = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_chip_smoke_fails_without_cuda():
    proc = _run(["chip_smoke.py"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "{" not in proc.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    """The *_cuda launchers never run on CPU tensors; the public functions
    take the plain version only because the tensor lies on the CPU."""
    before = dict(kernels.launches)
    x = torch.zeros(1, 4, 2, 128)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_mha_cuda(x, x, x, lens, lens, True, 1.0)
    pool = torch.zeros(1, 2, 2, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention_cuda(torch.zeros(1, 2, 128), pool, pool,
                                             torch.zeros(1, 2, dtype=torch.int32), lens, 0, 1.0)
    w = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        moe_decode.gather_expert_ffn_cuda(torch.zeros(1, 8), torch.zeros(1, 2, dtype=torch.int32),
                                          w, w, w.transpose(1, 2).contiguous())
    qpool = paged_attention.init_page_pool(1, 2, 2, 8, 128, quantized=True)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention_cuda(torch.zeros(1, 2, 128), qpool["k_pages"],
                                             qpool["v_pages"], torch.zeros(1, 2, dtype=torch.int32),
                                             lens, 0, 1.0, qpool["k_scale"], qpool["v_scale"])
    p = {"router": torch.zeros(8, 2), "w_gate": w, "w_up": w, "w_down": w.transpose(1, 2).contiguous()}
    idx = torch.zeros(4, 2, dtype=torch.int32)
    for q, bits in ((moe_decode.quantize_expert_weights(p), 8),
                    (moe_decode.quantize_expert_weights_int4(p), 4)):
        with pytest.raises(ValueError, match="CUDA"):
            moe_decode.gather_expert_ffn_q_cuda(torch.zeros(4, 8), idx, q, bits)
        act, m = moe_decode._active_expert_plan(torch.ones(4, 2), idx, 2)
        with pytest.raises(ValueError, match="CUDA"):
            moe_decode.masked_expert_ffn_q_cuda(torch.zeros(4, 8), act, m, q, bits)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.on_cuda(torch.zeros(1, device="meta"))
    assert kernels.launches == before


def test_library_path_tracks_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert json.dumps(sorted(kernels.launches)) == json.dumps(
        ["flash_fwd", "gather_expert_ffn", "gather_expert_ffn_q", "gather_expert_ffn_q4",
         "masked_expert_ffn", "masked_expert_ffn_q", "masked_expert_ffn_q4", "paged_attention",
         "paged_attention_q"])
