"""The serving kernels per shard (vita_tpu.parallel.sharded_ops).

Each wrapper takes this rank's local shards and the mesh, and calls the
single-device kernel on them; with its axis of size 1 (or no mesh) it is
that call and nothing else, so single-device output is bit-identical.

- Attention (B1, B2/B9 and the kv row writes): heads shard over 'model'
  in contiguous blocks, so a rank holds q heads [r*Hq/tp, (r+1)*Hq/tp)
  and the kv heads they read, and the kernel's GQA mapping holds locally.
  No collective: the output projection's row block and the all_reduce
  after it are the model's (models/mixtral.py). Under a 'seq' axis the
  cacheless flash path runs the ring (parallel.ring_attention).
- MoE (B3/B4, B6/B7, B8a/B8b through moe_decode; B5a/B5b through
  moe_gmm): experts shard over 'expert'. Routing is global, so every rank
  sees every (token, k) pair; it clamps the ids of pairs routed to other
  ranks into its range and zeroes their combine weights, runs the
  single-device dispatcher over its [E/ep] experts, and the weighted
  partials are summed over the 'expert' group in float32 and rounded once.
  Each pair's term comes from exactly one rank. Under training's
  ``param_specs`` the experts' ffn columns are split over 'model' too
  (w_gate/w_up by columns, w_down by rows): the SwiGLU is elementwise in
  those columns, so each rank's output is a partial sum over them as
  well, combined in float32 and summed over ('expert', 'model') before it
  is rounded. The FFN's input and the combine
  weights enter through ``parallel.mesh.all_reduce_grad`` over the same
  axes, so the gradients they pass on (to the layer's input and the
  router) collect every rank's pairs and columns.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vita_tpu_torch.parallel.mesh import (
    EXPERT,
    MODEL,
    SEQ,
    all_reduce_grad,
    all_reduce_sum,
    axis,
)


def _local_heads(hq: int, hkv: int, mesh) -> None:
    if hq % hkv:
        raise ValueError(f"local q heads ({hq}) not a multiple of local kv heads ({hkv}) "
                         f"on a model axis of {axis(mesh, MODEL).size}")


def sharded_paged_attention(
    q: torch.Tensor,  # [B, Hq/tp, d] this rank's q heads
    k_pages: torch.Tensor,  # [L, Hkv/tp, P, page, d] this rank's kv heads
    v_pages: torch.Tensor,
    table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B]
    layer: int,
    mesh=None,
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv/tp, P, 1, page] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode attention (B2; B9 over an int8 pool) over the local
    heads: [B, Hq/tp, d]."""
    from vita_tpu_torch.ops.paged_attention import paged_attention

    _local_heads(q.shape[1], k_pages.shape[1], mesh)
    return paged_attention(q, k_pages, v_pages, table, lengths, layer,
                           k_scale=k_scale, v_scale=v_scale)


def sharded_write_kv_rows(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    layer: int,
    table: torch.Tensor,
    pos: torch.Tensor,
    k: torch.Tensor,  # [B, Hkv/tp, d]
    v: torch.Tensor,
    active: Optional[torch.Tensor],
    mesh=None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """One kv row per slot into the local heads' pages, in place (an int8
    pool quantizes each (row, head) with its own scale, so no head needs
    another's)."""
    from vita_tpu_torch.ops.paged_attention import write_kv_rows

    if k.shape[1] != k_pages.shape[1]:
        raise ValueError(f"{k.shape[1]} kv heads written into a pool of {k_pages.shape[1]}")
    return write_kv_rows(k_pages, v_pages, layer, table, pos, k, v, active,
                         k_scale=k_scale, v_scale=v_scale)


def sharded_flash_mha(
    q: torch.Tensor,  # [B, S, Hq/tp, d] (S/n rows under a 'seq' axis of n)
    k: torch.Tensor,  # [B, Skv, Hkv/tp, d]
    v: torch.Tensor,
    kv_len: torch.Tensor,  # [B] (of the whole sequence under a 'seq' axis)
    q_offset: torch.Tensor,  # [B]
    causal: bool,
    mesh=None,
) -> torch.Tensor:
    """Flash attention (B1) over the local heads: [B, S, Hq/tp, d]. Under
    a 'seq' axis > 1 the cacheless path (Sq == Skv, this rank's block of
    the sequence) runs the ring schedule (parallel.ring_attention), B1 in
    the forward and B10/B11 in the backward at every step. ``q_offset`` is
    dropped there: with Sq == Skv a common position base shifts query and
    key positions alike, so the causal triangle does not move, and the
    ring's block offsets carry the relative positions."""
    from vita_tpu_torch.ops.flash_attention import flash_mha

    _local_heads(q.shape[2], k.shape[2], mesh)
    if axis(mesh, SEQ).size > 1:
        from vita_tpu_torch.parallel.ring_attention import ring_flash_mha

        if q.shape[1] != k.shape[1]:
            raise ValueError(
                "seq-parallel attention supports the cacheless path only (Sq == Skv); "
                "KV-cache decode/prefill needs seq axis 1")
        return ring_flash_mha(q, k, v, kv_len, causal=causal, mesh=mesh)
    return flash_mha(q, k, v, kv_len=kv_len, q_offset=q_offset, causal=causal)


def _local_routing(topk_w, topk_idx, n_experts: int, mesh) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(weights with other ranks' pairs zeroed, ids clamped into this
    rank's [0, E/ep), E/ep)."""
    ep = axis(mesh, EXPERT).size
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts not divisible by expert axis {ep}")
    e_local = n_experts // ep
    e0 = axis(mesh, EXPERT).rank * e_local
    local = (topk_idx >= e0) & (topk_idx < e0 + e_local)
    idx = (topk_idx - e0).clamp(0, e_local - 1).to(topk_idx.dtype)
    return torch.where(local, topk_w, torch.zeros_like(topk_w)), idx, e_local


def sharded_gather_ffn(
    x: torch.Tensor,  # [T, D]
    topk_w: torch.Tensor,  # [T, k] combine weights (float)
    topk_idx: torch.Tensor,  # [T, k] per-layer expert ids in [0, E)
    moe_stacked: Dict[str, torch.Tensor],  # leaves [L, E/ep, ...] (+ scales), no router
    layer_idx: int,
    n_experts: int,
    mode: str,  # 'gather' | 'gather_q' | 'gather_q4'
    mesh=None,
    pairs: bool = False,
) -> torch.Tensor:
    """EP-sharded selected-expert FFN: the WEIGHTED output [T, D].

    The local stacked experts are viewed flat as [L*E/ep, ...] and indexed
    by layer*E/ep + local id, which is the single-device decode layout.
    ``pairs`` keeps the per-pair gather kernel at every T (the
    pipeline's decode ring, as the JAX package's ring calls it)."""
    from vita_tpu_torch.ops.moe_decode import selected_expert_ffn

    flat = {k: v.flatten(0, 1) for k, v in moe_stacked.items()}
    if axis(mesh, EXPERT).size == 1:
        return selected_expert_ffn(mode, x, topk_w, topk_idx + layer_idx * n_experts, flat,
                                   n_experts=n_experts, pairs=pairs)
    w_loc, idx_loc, e_local = _local_routing(topk_w, topk_idx, n_experts, mesh)
    out = selected_expert_ffn(mode, x, w_loc, idx_loc + layer_idx * e_local, flat,
                              n_experts=e_local, out_dtype=torch.float32, pairs=pairs)
    return all_reduce_sum(out, mesh, EXPERT).to(x.dtype)


def sharded_gmm_ffn(
    x: torch.Tensor,  # [T, D]
    topk_w: torch.Tensor,  # [T, k] combine weights (float)
    topk_idx: torch.Tensor,  # [T, k] expert ids in [0, E)
    moe_stacked: Dict[str, torch.Tensor],  # {'w_gate' [L, E/ep, D, F(/tp)], 'w_up', 'w_down'}
    layer_idx: int,
    n_experts: int,
    mesh=None,
    axes: Tuple[str, ...] = (EXPERT,),
) -> torch.Tensor:
    """Sharded dropless grouped-matmul FFN (B5a/B5b forward and dx, B12
    dw): [T, D]. Every rank runs all T*k pairs over its local experts,
    other ranks' pairs weighted 0, and the partials are summed over
    ``axes``: ('expert',), or ('expert', 'model') where the experts' ffn
    columns are split over 'model' (training). Over 'expert' alone a
    rank's pairs are whole experts' terms, rounded as the unsharded
    combine rounds them; a block of the ffn columns gives part of a term,
    so there the ranks combine their pairs in float32 and the sum is
    rounded once."""
    from vita_tpu_torch.ops.moe_gmm import moe_ffn_gmm

    layer = {k: moe_stacked[k][layer_idx] for k in ("w_gate", "w_up", "w_down")}
    if all(axis(mesh, a).size == 1 for a in axes):
        return moe_ffn_gmm(layer, x, topk_w, topk_idx)
    x, topk_w = all_reduce_grad(x, mesh, axes), all_reduce_grad(topk_w, mesh, axes)
    w_loc, idx_loc, _ = _local_routing(topk_w, topk_idx, n_experts, mesh)
    split_f = axis(mesh, MODEL).size > 1 and MODEL in axes
    out = moe_ffn_gmm(layer, x, w_loc, idx_loc, out_dtype=torch.float32 if split_f else None)
    return all_reduce_sum(out, mesh, axes).to(x.dtype)
