"""Rotary position embeddings (vita_tpu.ops.rope): Llama/Mixtral
half-split rotation in float32 with explicit positions."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float = 1e6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape positions.shape + (head_dim,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 1e6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q, k of shape [B, S, H, D] by absolute ``positions`` [B, S]."""
    cos, sin = rope_tables(positions, q.shape[-1], theta)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
