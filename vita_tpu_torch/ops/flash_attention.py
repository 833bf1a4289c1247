"""Flash attention forward (vita_tpu.ops.flash_attention.flash_mha).

``flash_mha`` keeps the JAX signature and layout: q [B, Sq, Hq, D], k/v
[B, Skv, Hkv, D], per-batch ``kv_len`` (keys at or past it are masked) and
``q_offset`` (absolute position of q row 0, for causal masking against a
longer key range). GQA maps q head h to kv head h // (Hq / Hkv).

On a CUDA tensor it launches the hand-written kernel (csrc/flash_fwd.cu,
head dim 128, float32 or bfloat16); on a CPU tensor it runs
``flash_mha_plain``, the masked-softmax version of the same function.
Rows with no valid key give zeros in both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vita_tpu_torch import kernels


def _normalize(q, k, kv_len, q_offset) -> Tuple[torch.Tensor, torch.Tensor]:
    b, skv = q.shape[0], k.shape[1]
    dev = q.device
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=dev)
    kv_len = torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(-1)
    q_offset = torch.as_tensor(q_offset, device=dev).to(torch.int32).reshape(-1)
    if q_offset.numel() == 1:
        q_offset = q_offset.expand(b)
    return kv_len.expand(b).contiguous(), q_offset.contiguous()


def flash_mha_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor,  # [B] int32
    q_offset: torch.Tensor,  # [B] int32
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """Masked softmax attention in float32 with GQA by head grouping."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, sq, hkv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    k_pos = torch.arange(skv, device=q.device)
    mask = k_pos[None, None, :] < kv_len[:, None, None]  # [B, 1, Skv]
    if causal:
        q_pos = torch.arange(sq, device=q.device)[None, :] + q_offset[:, None]
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])  # [B, Sq, Skv]
    mask = mask[:, None, None]  # [B, 1, 1, Sq|1, Skv]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))  # masked -> exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p / torch.where(l > 0, l, 1.0), v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def flash_mha_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor,
    q_offset: torch.Tensor,
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """Launch csrc/flash_fwd.cu (see its header for the design)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kernels.require_cuda(q, k, v, kv_len, q_offset)
    kernels.require(d == 128, f"flash kernel takes head dim 128, got {d}")
    kernels.require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d,
                    f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    kernels.require(kv_len.dtype == torch.int32 and q_offset.dtype == torch.int32
                    and kv_len.shape == (b,) and q_offset.shape == (b,),
                    "kv_len and q_offset must be int32 [B]")
    dt = kernels.dtype_code(q, k, v)
    o = torch.empty_like(q)
    if sq == 0 or b * hq == 0:
        return o
    err = kernels.lib().vita_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        kv_len.data_ptr(), q_offset.data_ptr(),
        b, sq, skv, hq, hkv, float(scale), int(causal), dt, kernels.stream_of(q),
    )
    kernels.check_launch(err, "flash_fwd")
    kernels.launches["flash_fwd"] += 1
    return o


def flash_mha(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,  # [B] valid kv lengths
    q_offset=0,  # absolute q-row-0 position: int or [B]
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with native GQA. Returns [B, Sq, Hq, D]."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    kv_len, q_offset = _normalize(q, k, kv_len, q_offset)
    if kernels.on_cuda(q):
        return flash_mha_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              kv_len, q_offset, causal, scale)
    return flash_mha_plain(q, k, v, kv_len, q_offset, causal, scale)
