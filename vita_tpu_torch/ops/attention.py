"""Plain softmax attention and mask builders (vita_tpu.ops.attention).

Tensors keep the JAX package's layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv,
D], additive float32 biases broadcastable to [B, Hq, Sq, Skv]. This is the
towers' attention and the "xla" backend of the LLM; the blocked flash
kernel lives in ops.flash_attention.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: fully masked rows stay NaN-free


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, H_kv, D] -> [B, S, H_kv*n_rep, D] by head repetition (GQA)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def causal_mask_bias(
    q_len: int, kv_len: int, q_offset: int = 0, device=None
) -> torch.Tensor:
    """Additive causal bias [1, 1, q_len, kv_len]; ``q_offset`` is the
    absolute position of the first query."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
    return bias[None, None]


def padding_mask_bias(kv_valid: torch.Tensor) -> torch.Tensor:
    """Additive bias [B, 1, 1, S_kv] from a boolean keep-mask over keys."""
    return torch.where(kv_valid[:, None, None, :], 0.0, NEG_INF).to(torch.float32)


def mha_xla(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference softmax attention: float32 logits and softmax, output in
    q's dtype."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
