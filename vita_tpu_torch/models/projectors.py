"""Modality projectors (vita_tpu.models.projectors): the mlp2x_gelu vision
MLP and the audio CNN-subsampling adapter.

Vision: Linear(in, D) -> exact GELU -> Linear(D, D).

Audio: padding frames zeroed, zero right-pad of k-1 frames, Conv1d(d, 2d,
k=5, stride 2), LayerNorm (eps 1e-3), exact GELU, Linear(2d, D); halves the
frame rate. The conv kernel keeps the JAX layout [k, in, out].

The other vision projector variants are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def _nrm(shape, scale, generator, device, dtype):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)


def init_vision_projector(in_dim: int, llm_dim: int, generator: torch.Generator,
                          device=None, dtype=torch.float32) -> Params:
    return {
        "fc1_w": _nrm((in_dim, llm_dim), in_dim ** -0.5, generator, device, dtype),
        "fc1_b": torch.zeros(llm_dim, dtype=dtype, device=device),
        "fc2_w": _nrm((llm_dim, llm_dim), llm_dim ** -0.5, generator, device, dtype),
        "fc2_b": torch.zeros(llm_dim, dtype=dtype, device=device),
    }


def vision_projector(params: Params, feats: torch.Tensor) -> torch.Tensor:
    h = F.gelu(feats @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]


def init_audio_projector(in_dim: int, llm_dim: int, generator: torch.Generator,
                         kernel: int = 5, device=None, dtype=torch.float32) -> Params:
    return {
        "conv_w": _nrm((kernel, in_dim, 2 * in_dim), (kernel * in_dim) ** -0.5,
                       generator, device, dtype),
        "conv_b": torch.zeros(2 * in_dim, dtype=dtype, device=device),
        "ln_w": torch.ones(2 * in_dim, dtype=dtype, device=device),
        "ln_b": torch.zeros(2 * in_dim, dtype=dtype, device=device),
        "proj_w": _nrm((2 * in_dim, llm_dim), (2 * in_dim) ** -0.5, generator, device, dtype),
        "proj_b": torch.zeros(llm_dim, dtype=dtype, device=device),
    }


def audio_projector(
    params: Params, feats: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, d], valid [B, T] -> ([B, (T-1)//2+1, D], new valid)."""
    w = params["conv_w"]  # [k, in, out]
    k = w.shape[0]
    x = torch.where(valid[..., None], feats, 0).to(w.dtype)
    x = F.pad(x.transpose(1, 2), (0, k - 1))  # [B, d, T + k - 1]
    x = F.conv1d(x, w.permute(2, 1, 0), params["conv_b"], stride=2).transpose(1, 2)
    x = F.gelu(layer_norm(x, params["ln_w"], params["ln_b"], eps=1e-3))
    return x @ params["proj_w"] + params["proj_b"], valid[:, 0::2]
