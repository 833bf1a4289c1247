"""Flash attention, forward and backward (vita_tpu.ops.flash_attention.flash_mha).

``flash_mha`` keeps the JAX signature and layout: q [B, Sq, Hq, D], k/v
[B, Skv, Hkv, D], per-batch ``kv_len`` (keys at or past it are masked) and
``q_offset`` (absolute position of q row 0, for causal masking against a
longer key range). GQA maps q head h to kv head h // (Hq / Hkv).

It is a ``torch.autograd.Function``. The forward saves q, k, v, o and the
per-row log-sum-exp lse [B, Hq, Sq] (float32, -inf for a row that sees no
key); the backward computes delta = rowsum(dO o) in PyTorch, as the JAX
package computes it outside Pallas, then dq and dk/dv by the flash-2
recurrence from lse. On CUDA tensors the three steps launch the
hand-written kernels (csrc/flash_fwd.cu, B1; csrc/flash_bwd.cu, B10 and
B11; float32 or bfloat16: each runs tensor-core kernels in bfloat16, B1
on wgmma + TMA and the backward on mma.sync, and FMA kernels in float32);
on CPU tensors the same Function runs their plain versions. Rows with no
valid key give zeros and no gradient in both.

The kernels are built for head dim ``KERNEL_D`` (128). A narrower head
(Whale's flash path passes 65: 64 plus the key-bias column) is zero-padded
along d to 128 by the CUDA wrappers, and o, dq, dk and dv are sliced back.
The padding is exact: zero columns add exact zeros to q.k and give zero
output columns, and lse is unchanged. The scale is the caller's, never
recomputed from the padded width. (A bf16 row of 65 elements, 130 bytes,
is no legal TMA stride either.) Each launch also counts its head dim in
``kernels.launch_keys`` (``flash_fwd:d65``), so a caller can show which
width a run took.
"""

from __future__ import annotations

import numbers
from typing import Dict, Optional, Tuple

import torch

import torch.nn.functional as F

from vita_tpu_torch import kernels

KERNEL_D = 128  # the head dim csrc/flash_fwd.cu and csrc/flash_bwd.cu are built for


def _normalize(q, k, kv_len, q_offset) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv_len and q_offset as int32 [B] on q's device. A Python integer is
    filled on the device: copying it from the host would wait for the
    device's queue on every call."""
    b, dev = q.shape[0], q.device

    def per_row(x):
        if isinstance(x, numbers.Integral):
            return torch.full((b,), int(x), dtype=torch.int32, device=dev)
        return torch.as_tensor(x, device=dev).to(torch.int32).reshape(-1).expand(b).contiguous()

    return per_row(k.shape[1] if kv_len is None else kv_len), per_row(q_offset)


def _mask(q, k, kv_len, q_offset, causal: bool) -> torch.Tensor:
    """[B, 1, 1, Sq|1, Skv] bool: the keys each q row attends."""
    sq, skv = q.shape[1], k.shape[1]
    k_pos = torch.arange(skv, device=q.device)
    mask = k_pos[None, None, :] < kv_len[:, None, None]  # [B, 1, Skv]
    if causal:
        q_pos = torch.arange(sq, device=q.device)[None, :] + q_offset[:, None]
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])  # [B, Sq, Skv]
    return mask[:, None, None]


def _scores(q, k, kv_len, q_offset, causal, scale):
    """Scaled masked scores [B, Hkv, rep, Sq, Skv] in float32 (-inf where
    masked) and the mask."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    mask = _mask(q, k, kv_len, q_offset, causal)
    return s.masked_fill(~mask, float("-inf")), mask


def flash_fwd_plain(q, k, v, kv_len, q_offset, causal: bool, scale: float):
    """Masked softmax attention in float32 with GQA by head grouping:
    (o [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] float32). The PV
    product takes p = exp(s - m) rounded to v's dtype, as the Pallas
    kernel's ``p.astype(v.dtype)``; l sums the unrounded p."""
    b, sq, hq, d = q.shape
    s, _ = _scores(q, k, kv_len, q_offset, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))  # masked -> exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    o = o / l_safe.permute(0, 3, 1, 2, 4)  # [B, Hkv, rep, Sq, 1] -> [B, Sq, Hkv, rep, 1]
    lse = torch.where(l > 0, m + torch.log(l_safe), float("-inf"))
    return o.reshape(b, sq, hq, d).to(q.dtype), lse[..., 0].reshape(b, hq, sq)


def _probs_and_dscores(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale):
    """p = exp(s - lse) and ds = p (dp - delta) scale, [B, Hkv, rep, Sq, Skv]
    float32; 0 where masked or where the row saw no key."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    s, mask = _scores(q, k, kv_len, q_offset, causal, scale)
    lse_g = lse.reshape(b, hkv, hq // hkv, sq, 1)
    keep = mask & torch.isfinite(lse_g)
    p = torch.where(keep, torch.exp(s - torch.where(keep, lse_g, 0.0)), 0.0)
    dog = do.float().reshape(b, sq, hkv, hq // hkv, d)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, hq // hkv, sq, 1)) * scale
    return p, ds, dog


def flash_bwd_dq_plain(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale):
    """dq = ds k, in q's dtype; ds rounded to k's dtype before the product,
    as the Pallas kernel rounds it."""
    b, sq, hq, d = q.shape
    _, ds, _ = _probs_and_dscores(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale)
    ds = ds.to(k.dtype).float()
    return torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float()).reshape(b, sq, hq, d).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale):
    """(dk = ds^T q, dv = p^T dO), each summed over the q heads of its GQA
    group, in k's dtype; ds rounded to q's dtype and p to dO's before the
    products, as the Pallas kernel rounds them."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    p, ds, dog = _probs_and_dscores(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale)
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(do.dtype).float(), dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, kv_len, q_offset, *others):
    b, sq, hq, d = q.shape
    kernels.require_cuda(q, k, v, kv_len, q_offset, *others)
    kernels.require(0 < d <= KERNEL_D, f"flash kernel takes head dim 1..{KERNEL_D}, got {d}")
    kernels.require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d,
                    f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    kernels.require(kv_len.dtype == torch.int32 and q_offset.dtype == torch.int32
                    and kv_len.shape == (b,) and q_offset.shape == (b,),
                    "kv_len and q_offset must be int32 [B]")


def _pad_d(*tensors):
    """Each tensor zero-padded along its last dim to KERNEL_D (as is, when
    it is that wide)."""
    return [x if x.shape[-1] == KERNEL_D else F.pad(x, (0, KERNEL_D - x.shape[-1]))
            for x in tensors]


def flash_fwd_cuda(q, k, v, kv_len, q_offset, causal: bool, scale: float):
    """B1 (csrc/flash_fwd.cu): (o, lse); bfloat16 runs the wgmma + TMA
    kernel, float32 the FMA kernel. A head dim below 128 runs zero-padded."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check(q, k, v, kv_len, q_offset)
    dt = kernels.dtype_code(q, k, v)
    qp, kp, vp = _pad_d(q, k, v)
    o = torch.empty_like(qp)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    if sq == 0 or b * hq == 0:
        return o[..., :d], lse
    err = kernels.lib().vita_flash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(), lse.data_ptr(),
        kv_len.data_ptr(), q_offset.data_ptr(),
        b, sq, skv, hq, hkv, float(scale), int(causal), dt, kernels.stream_of(q),
    )
    kernels.check_launch(err, "flash_fwd")
    kernels.count_launch("flash_fwd", f"d{d}")
    return (o if d == KERNEL_D else o[..., :d].contiguous()), lse


def _check_bwd(q, k, v, do, lse, delta, kv_len, q_offset):
    _check(q, k, v, kv_len, q_offset, do, lse, delta)
    b, sq, hq, _ = q.shape
    kernels.require(do.shape == q.shape, f"dO shape {tuple(do.shape)} is not q's {tuple(q.shape)}")
    kernels.require(lse.shape == (b, hq, sq) == delta.shape
                    and lse.dtype == delta.dtype == torch.float32,
                    "lse and delta must be float32 [B, Hq, Sq]")
    return kernels.dtype_code(q, k, v, do)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale):
    """B10 (csrc/flash_bwd.cu). A head dim below 128 runs zero-padded."""
    dt = _check_bwd(q, k, v, do, lse, delta, kv_len, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q, k, v, do = _pad_d(q, k, v, do)
    dq = torch.empty_like(q)
    if sq == 0 or b * hq == 0:
        return dq[..., :d]
    err = kernels.lib().vita_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
        b, sq, skv, hq, hkv, float(scale), int(causal), dt, kernels.stream_of(q))
    kernels.check_launch(err, "flash_bwd_dq")
    kernels.count_launch("flash_bwd_dq", f"d{d}")
    return dq if d == KERNEL_D else dq[..., :d].contiguous()


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kv_len, q_offset, causal, scale):
    """B11 (csrc/flash_bwd.cu): (dk, dv). A head dim below 128 runs
    zero-padded."""
    dt = _check_bwd(q, k, v, do, lse, delta, kv_len, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q, k, v, do = _pad_d(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if skv == 0 or b * hkv == 0:
        return dk[..., :d], dv[..., :d]
    err = kernels.lib().vita_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), b, sq, skv, hq, hkv, float(scale), int(causal), dt,
        kernels.stream_of(q))
    kernels.check_launch(err, "flash_bwd_dkv")
    kernels.count_launch("flash_bwd_dkv", f"d{d}")
    if d == KERNEL_D:
        return dk, dv
    return dk[..., :d].contiguous(), dv[..., :d].contiguous()


def flash_fwd_info() -> Dict[str, Dict[str, int]]:
    """Resources of B1's bfloat16 wgmma + TMA kernel on the current card,
    with a pair of q heads a block and with one (``kernels.resources``)."""
    return kernels.resources(kernels.lib().vita_flash_fwd_info,
                             ("flash_fwd q-head pair", "flash_fwd one q head"))


def flash_bwd_mma_info() -> Dict[str, Dict[str, int]]:
    """Resources of B10's and B11's bfloat16 tensor-core kernels on the
    current card (``kernels.resources``)."""
    return kernels.resources(kernels.lib().vita_flash_bwd_mma_info,
                             ("flash_bwd_dq", "flash_bwd_dkv"))


def flash_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """rowsum(dO o) [B, Hq, Sq] float32."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _Flash(torch.autograd.Function):
    """flash_mha with the flash-2 backward: kernels on CUDA tensors, their
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, causal, scale):
        fwd = flash_fwd_cuda if kernels.on_cuda(q) else flash_fwd_plain
        o, lse = fwd(q, k, v, kv_len, q_offset, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, kv_len, q_offset)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_len, q_offset = ctx.saved_tensors
        do = do.contiguous()
        args = (q, k, v, do, lse, flash_delta(do, o), kv_len, q_offset, ctx.causal, ctx.scale)
        if kernels.on_cuda(q):
            dq, (dk, dv) = flash_bwd_dq_cuda(*args), flash_bwd_dkv_cuda(*args)
        else:
            dq, (dk, dv) = flash_bwd_dq_plain(*args), flash_bwd_dkv_plain(*args)
        return dq, dk, dv, None, None, None, None


def flash_mha(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,  # [B] valid kv lengths
    q_offset=0,  # absolute q-row-0 position: int or [B]
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with native GQA, differentiable in q, k and v.
    Returns [B, Sq, Hq, D]."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    kv_len, q_offset = _normalize(q, k, kv_len, q_offset)
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_len, q_offset,
                        causal, scale)
