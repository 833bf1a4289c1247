"""PyTorch port: imports without jax or the reference package (no module,
the CLIs with media files included, and not chip_smoke.py), launches a
kernel or raises (never the plain version) for non-CPU tensors, and
chip_smoke.py refuses to run without a CUDA card."""

import json
import os
import wave
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import numpy as np
import torch_port_util  # noqa: F401  (pins torch threads)
from vita_tpu_torch import kernels
from vita_tpu_torch.ops import flash_attention, moe_decode, moe_gmm, paged_attention

ROOT = pathlib.Path(__file__).resolve().parent.parent
NO_REFERENCE = (
    "assert 'jax' not in sys.modules, 'jax imported'\n"
    "ref = [m for m in sys.modules if m == 'vita_tpu' or m.startswith('vita_tpu.')]\n"
    "assert not ref, ref\n"
)


def _run(code_or_args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), **(env_extra or {}))
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_package_imports_without_jax():
    code = (
        "import importlib, json, pkgutil, sys, vita_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vita_tpu_torch.__path__, 'vita_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        + NO_REFERENCE +
        "lib = [m for m in ('safetensors', 'transformers') if m in sys.modules]\n"
        "assert not lib, lib\n"
        "print(json.dumps(names))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    names = json.loads(proc.stdout)
    assert len(names) >= 30 and "vita_tpu_torch.cli" in names
    assert "vita_tpu_torch.train.cli" in names and "vita_tpu_torch.data.dataset" in names


def _wav(path):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.random.default_rng(0).standard_normal(8000) * 3000)
                      .astype(np.int16).tobytes())
    return str(path)


def test_clis_with_media_files_load_no_reference_module(tmp_path):
    """The inference CLI given an audio file, and the train CLI given a
    dataset with audio, on the CPU: neither loads jax or vita_tpu."""
    wav = _wav(tmp_path / "q.wav")
    chat = tmp_path / "chat.json"
    chat.write_text(json.dumps([{"conversations": [{"from": "human", "value": "<audio>\n"},
                                                   {"from": "gpt", "value": "ok"}],
                                 "audio": wav}] * 2))
    code = (
        "import sys\n"
        "from vita_tpu_torch import cli\n"
        "from vita_tpu_torch.train import cli as train_cli\n"
        f"assert cli.main(['--model', 'tiny-random', '--audio', {wav!r}, '--device', 'cpu',"
        " '--max-new-tokens', '2']) == 0\n"
        f"assert train_cli.main(['--model', 'tiny-random', '--data', {str(chat)!r},"
        f" '--output-dir', {str(tmp_path / 'run')!r}, '--batch-size', '2', '--device', 'cpu'])"
        " == 0\n"
        + NO_REFERENCE
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "[done] 1 steps" in proc.stdout


def test_cli_on_checkpoint_directory_loads_no_reference_module(tmp_path):
    """The inference CLI on an exported checkpoint directory with its
    tokenizer, on the CPU: neither jax nor vita_tpu is loaded (transformers,
    which the tokenizer needs, is)."""
    from torch_port_util import write_tiny_tokenizer
    from vita_tpu_torch import checkpoint
    from vita_tpu_torch.models import vita

    cfg = vita.VITAConfig.tiny()
    checkpoint.export_hf_vita_checkpoint(
        str(tmp_path), cfg, vita.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    write_tiny_tokenizer(tmp_path)
    code = (
        "import sys\n"
        "from vita_tpu_torch import cli\n"
        f"assert cli.main(['--model', {str(tmp_path)!r}, '--question', 'Hello', '--device',"
        " 'cpu', '--max-new-tokens', '2']) == 0\n"
        "assert 'transformers' in sys.modules\n"
        + NO_REFERENCE
    )
    proc = _run(code, env_extra={"HF_HUB_OFFLINE": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "[new tokens] 2" in proc.stdout


def test_port_sources_leave_safetensors_and_transformers_to_tests():
    """The port reads and writes safetensors files itself and imports
    transformers only inside the function that loads a tokenizer."""
    files = sorted((ROOT / "vita_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    any_import = re.compile(r"^\s*(import safetensors|from safetensors)", re.M)
    top_level = re.compile(r"^(import transformers|from transformers)", re.M)
    assert not [str(f) for f in files if any_import.search(f.read_text())]
    assert not [str(f) for f in files if top_level.search(f.read_text())]
    lazy = [f.name for f in files if re.search(r"^\s+from transformers import", f.read_text(),
                                               re.M)]
    assert lazy == ["cli.py"]


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
        flash_attention.flash_fwd_cuda(x, x, x, lens, lens, True, 1.0)
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
    gids = torch.zeros(2, dtype=torch.int32)
    for trans in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            moe_gmm.gmm_cuda(torch.zeros(256, 8), w, gids, trans, 128)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm.gmm_wgrad_cuda(torch.zeros(256, 8), torch.zeros(256, 4), gids, 2, 128)
    stats = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_bwd_dq_cuda(x, x, x, x, stats, stats, lens, lens, True, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_bwd_dkv_cuda(x, x, x, x, stats, stats, lens, lens, True, 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.on_cuda(torch.zeros(1, device="meta"))
    assert kernels.launches == before


def test_library_path_tracks_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert json.dumps(sorted(kernels.launches)) == json.dumps(
        ["flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "gather_expert_ffn",
         "gather_expert_ffn_q", "gather_expert_ffn_q4", "gmm", "gmm_small", "gmm_wgrad",
         "masked_expert_ffn", "masked_expert_ffn_q", "masked_expert_ffn_q4",
         "paged_attention", "paged_attention_q"])
