"""Ring attention: exact sequence-parallel attention over the 'seq' axis
(vita_tpu.parallel.ring_attention).

Each rank of the ``seq`` axis holds the q/k/v of s_loc = S/n consecutive
positions, rank i the block [i*s_loc, (i+1)*s_loc) (``shard_seq`` cuts it
from the whole sequence); heads may be split over 'model' as well, each
rank holding its heads' block. n steps: attend the local q block to the
k/v block held (B1, flash attention with its log-sum-exp, with the block's
position offset), merge into the running output by the two log-sum-exps,
and pass the k/v block to the previous rank of the ring (point-to-point,
``parallel.mesh.shift_down``). At step t a rank holds the block of rank
src = (i + t) % n, so its keys sit at src*s_loc and the kernel gets
q_offset = (i - src)*s_loc and kv_len = clip(lengths - src*s_loc, 0,
s_loc), as ``_ring_island`` computes them. A block wholly in the future
of the local queries (causal, src > i: q_offset <= -s_loc, so every key is
masked) is not launched: it would add nothing, exactly. The last rotation
is skipped, its block being unused.

The log-sum-exps are floored at -1e30 before the merge, as the JAX
package floors them: the kernels give -inf for a row that sees no key in
a block, and exp(-inf - -inf) is NaN. A row that sees no key at all keeps
o = 0 and a merged lse of -1e30.

``torch.distributed`` point-to-point carries no autograd, so the ring is
one ``torch.autograd.Function`` whose backward is a ring too, in the
flash-2 form: with the merged lse and delta = rowsum(dO o) every block's
p = exp(s - lse) is the global softmax, so each step runs B10 for this
rank's dq against the block it holds and B11 for that block's dk/dv
(summed over the GQA group). The dk/dv accumulators (float32) travel
around the ring with their k/v, and one last shift brings each block's
gradient home. On CPU tensors the steps run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from vita_tpu_torch import kernels
from vita_tpu_torch.ops import flash_attention as fa
from vita_tpu_torch.parallel.mesh import SEQ, axis, shift_down

_BIG_NEG = -1e30


def shard_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of the whole sequence ``x`` along ``dim``: the
    s_loc = S/n positions of its coordinate on the 'seq' axis (a view)."""
    a = axis(mesh, SEQ)
    s = x.shape[dim]
    if s % a.size:
        raise ValueError(f"sequence length {s} not divisible by seq axis {a.size}")
    step = s // a.size
    return x.narrow(dim, a.rank * step, step)


def _offsets(lengths: torch.Tensor, idx: int, src: int, s_loc: int):
    """(kv_len, q_offset) int32 [B] of the block of rank ``src``."""
    kv_len = (lengths - src * s_loc).clamp(0, s_loc).to(torch.int32)
    q_off = torch.full_like(kv_len, (idx - src) * s_loc)
    return kv_len, q_off


def _blocks(n: int, idx: int, causal: bool):
    """(step, src, skip) for the ring's n steps on rank ``idx``."""
    for t in range(n):
        src = (idx + t) % n
        yield t, src, causal and src > idx


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale, mesh):
        a = axis(mesh, SEQ)
        n, idx, s_loc = a.size, a.rank, q.shape[1]
        on_cuda = kernels.on_cuda(q)
        fwd = fa.flash_fwd_cuda if on_cuda else fa.flash_fwd_plain
        b, _, hq, d = q.shape
        o_acc = torch.zeros(b, s_loc, hq, d, dtype=torch.float32, device=q.device)
        lse_acc = torch.full((b, hq, s_loc), _BIG_NEG, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for t, src, skip in _blocks(n, idx, causal):
            if not skip:
                kv_len, q_off = _offsets(lengths, idx, src, s_loc)
                o_t, lse_t = fwd(q, k_blk, v_blk, kv_len, q_off, causal, scale)
                lse_t = lse_t.clamp_min(_BIG_NEG)
                new = torch.logaddexp(lse_acc, lse_t)
                w_old = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
                w_new = torch.exp(lse_t - new).transpose(1, 2)[..., None]
                o_acc = o_acc * w_old + o_t.float() * w_new
                lse_acc = new
            if t < n - 1:
                k_blk, v_blk = shift_down([k_blk, v_blk], mesh, SEQ)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc, lengths)
        ctx.causal, ctx.scale, ctx.mesh = causal, scale, mesh
        ctx.mark_non_differentiable(lse_acc)
        return o, lse_acc

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        a = axis(ctx.mesh, SEQ)
        n, idx, s_loc = a.size, a.rank, q.shape[1]
        do = do.contiguous()
        delta = fa.flash_delta(do, o)
        if kernels.on_cuda(q):
            bwd_dq, bwd_dkv = fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda
        else:
            bwd_dq, bwd_dkv = fa.flash_bwd_dq_plain, fa.flash_bwd_dkv_plain
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_blk, v_blk = k, v
        for t, src, skip in _blocks(n, idx, ctx.causal):
            if not skip:
                kv_len, q_off = _offsets(lengths, idx, src, s_loc)
                args = (q, k_blk, v_blk, do, lse, delta, kv_len, q_off, ctx.causal, ctx.scale)
                dq += bwd_dq(*args).float()
                dk_t, dv_t = bwd_dkv(*args)
                dk += dk_t.float()
                dv += dv_t.float()
            if t < n - 1:
                k_blk, v_blk, dk, dv = shift_down([k_blk, v_blk, dk, dv], ctx.mesh, SEQ)
            else:  # the block held last is the next rank's: send its gradient home
                dk, dv = shift_down([dk, dv], ctx.mesh, SEQ)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_flash_mha_with_lse(q, k, v, lengths, causal: bool = True,
                            scale: Optional[float] = None, mesh=None):
    """``ring_flash_mha`` that also returns the merged log-sum-exp
    [B, Hq/tp, S/n] float32 (-1e30 for a row that sees no key; not
    differentiable)."""
    if mesh is None:
        raise ValueError("ring_flash_mha requires a mesh with a 'seq' axis")
    if q.shape[1] != k.shape[1]:
        raise ValueError("ring attention requires Sq == Skv (no KV cache)")
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32).reshape(-1)
    lengths = lengths.expand(q.shape[0]).contiguous()
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), lengths, causal, scale,
                       mesh)


def ring_flash_mha(
    q: torch.Tensor,  # [B, S/n, Hq/tp, d]: this rank's block (shard_seq)
    k: torch.Tensor,  # [B, S/n, Hkv/tp, d]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid sequence lengths of the whole sequence
    causal: bool = True,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """Sequence-parallel exact attention over the mesh's 'seq' axis: this
    rank's block of flash_mha(q, k, v, kv_len=lengths, causal=causal) over
    the whole sequence, [B, S/n, Hq/tp, d]. Query positions start at 0
    (the cacheless training and prefill path). Differentiable in q, k and
    v; every rank of the axis calls it, in the same order."""
    return ring_flash_mha_with_lse(q, k, v, lengths, causal, scale, mesh)[0]
