"""Mixture-of-Experts routing and the dense expert path (vita_tpu.ops.moe).

Routing follows Mixtral: softmax over all experts in float32, top-k, then
the k weights renormalised to sum to 1. Expert weights keep the JAX
layout: router [D, E], w_gate/w_up [E, D, F], w_down [E, F, D].

``mode="dense"`` runs every expert on every token, weighted by the zeroed
router weights (exact). ``gmm`` is the dropless grouped matmul of
ops.moe_gmm (exact, top-k FLOPs only). ``sort`` and ``capacity`` give each
expert C = ceil(T*k/E * capacity_factor) slots and drop the (token, slot)
pairs past them, the same pairs in both: ``sort`` scatters the pairs
sorted by expert into an [E, C, D] buffer, ``capacity`` dispatches and
combines with one-hot einsums. The decode modes ``gather``, ``gather_q``
and ``gather_q4`` run only the selected experts through ops.moe_decode
(``gather_q``/``gather_q4`` take params quantized by
moe_decode.quantize_expert_weights / quantize_expert_weights_int4).

``chunk`` runs a training mode over token chunks of that size, each under
``torch.utils.checkpoint``, so that the backward holds one chunk's expert
intermediates at a time. As in the JAX package, aux is then the mean of
the chunk-local aux losses weighted by each chunk's valid tokens, and the
capacity of sort/capacity modes is per chunk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vita_tpu_torch.ops.moe_gmm import moe_ffn_gmm, sorted_pairs

# selected-expert decode modes (ops.moe_decode.selected_expert_ffn)
GATHER_MODES = ("gather", "gather_q", "gather_q4")
TRAIN_MODES = ("dense", "capacity", "sort", "gmm")
MODES = TRAIN_MODES + GATHER_MODES


def route_topk(
    router_logits: torch.Tensor, top_k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(topk_weights [T,k] f32, topk_idx [T,k] int32, probs [T,E] f32)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    topk_w, topk_i = torch.topk(probs, top_k, dim=-1)
    topk_w = topk_w / topk_w.sum(-1, keepdim=True)
    return topk_w, topk_i.to(torch.int32), probs


def load_balancing_loss(
    probs: torch.Tensor,  # [T, E]
    topk_idx: torch.Tensor,  # [T, k]
    n_experts: int,
    token_mask: Optional[torch.Tensor] = None,  # [T] 1 for real tokens
) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e, padding excluded
    through ``token_mask``."""
    sel = F.one_hot(topk_idx.long(), n_experts).float()  # [T, k, E]
    if token_mask is not None:
        m = token_mask.float()
        denom = m.sum().clamp_min(1.0)
        f = (sel * m[:, None, None]).sum((0, 1)) / (denom * sel.shape[1])
        p = (probs * m[:, None]).sum(0) / denom
    else:
        f = sel.sum(1).mean(0) / sel.shape[1]
        p = probs.mean(0)
    return n_experts * (f * p).sum()


def _expert_ffn(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: x [E, C, D] -> [E, C, D]."""
    gate = torch.einsum("ecd,edf->ecf", x, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", x, params["w_up"])
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, params["w_down"])


def np_ceil(v: float) -> int:
    return int(-(-v // 1))


def _capacity(t: int, top_k: int, e: int, capacity_factor: float) -> int:
    return int(max(top_k, np_ceil(t * top_k / e * capacity_factor)))


def _sort_dispatch(params, x, topk_w, topk_i, capacity: int) -> torch.Tensor:
    """The pairs sorted by expert (moe_gmm.sorted_pairs) fill [E, C, D]; a
    pair at position >= C is written to a spare row C that is cut off, and
    contributes nothing."""
    t, d = x.shape
    e = params["w_gate"].shape[0]
    order, fe_s, tok_s, pos, _ = sorted_pairs(topk_i, e)
    keep = pos < capacity
    expert_in = x.new_zeros(e, capacity + 1, d)
    expert_in[fe_s, torch.where(keep, pos, capacity)] = x[tok_s]
    expert_out = _expert_ffn(params, expert_in[:, :capacity])  # [E, C, D]
    y = expert_out[fe_s, torch.where(keep, pos, 0)] * keep[:, None].to(x.dtype)
    w_s = topk_w.reshape(-1)[order].to(x.dtype)
    return x.new_zeros(t, d).index_add_(0, tok_s, y * w_s[:, None])


def _capacity_dispatch(params, x, topk_w, topk_i, capacity: int) -> torch.Tensor:
    """GShard one-hot dispatch/combine einsums with C slots per expert."""
    t, _ = x.shape
    k = topk_i.shape[1]
    e = params["w_gate"].shape[0]
    dt = x.dtype
    sel = F.one_hot(topk_i.long(), e)  # [T, k, E]
    sel_flat = sel.reshape(t * k, e)
    pos = torch.cumsum(sel_flat, 0) - 1
    pos = (pos * sel_flat).sum(-1).reshape(t, k)  # slot within the expert
    keep = pos < capacity
    disp = (sel.to(dt)[..., None]
            * F.one_hot(torch.where(keep, pos, 0), capacity).to(dt)[:, :, None, :]
            * keep[..., None, None].to(dt))  # [T, k, E, C]
    dispatch = disp.sum(1)
    combine = (disp * topk_w[..., None, None].to(dt)).sum(1)
    expert_out = _expert_ffn(params, torch.einsum("tec,td->ecd", dispatch, x))
    return torch.einsum("tec,ecd->td", combine, expert_out)


def moe_ffn(
    params,
    x: torch.Tensor,  # [T, D]
    top_k: int = 2,
    mode: str = "dense",
    capacity_factor: float = 1.25,
    token_mask: Optional[torch.Tensor] = None,
    chunk: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [T, D], aux_loss scalar). ``chunk`` is ignored when
    T <= chunk, when chunk does not divide T, or in a gather mode."""
    if mode not in MODES:
        raise ValueError(f"unknown moe mode {mode!r}")
    t, d = x.shape
    if chunk and 0 < chunk < t and t % chunk == 0 and mode in TRAIN_MODES:
        tms = (torch.ones(t // chunk, chunk, device=x.device) if token_mask is None
               else token_mask.reshape(-1, chunk))
        outs, auxs = [], []
        for xc, tc in zip(x.split(chunk), tms):
            out, aux = checkpoint(moe_ffn, params, xc, top_k, mode, capacity_factor, tc,
                                  use_reentrant=False)
            outs.append(out)
            auxs.append(aux)
        ns = tms.float().sum(1)
        return torch.cat(outs), (torch.stack(auxs) * ns).sum() / ns.sum().clamp_min(1.0)
    e = params["w_gate"].shape[0]
    router_logits = x.float() @ params["router"].float()
    topk_w, topk_i, probs = route_topk(router_logits, top_k)
    aux = load_balancing_loss(probs, topk_i, e, token_mask)
    if mode in GATHER_MODES:
        from vita_tpu_torch.ops import moe_decode as md

        out = md.selected_expert_ffn(mode, x, topk_w, topk_i, params, n_experts=e)
    elif mode == "gmm":
        out = moe_ffn_gmm(params, x, topk_w, topk_i)
    elif mode == "sort":
        out = _sort_dispatch(params, x, topk_w, topk_i, _capacity(t, top_k, e, capacity_factor))
    elif mode == "capacity":
        out = _capacity_dispatch(params, x, topk_w, topk_i,
                                 _capacity(t, top_k, e, capacity_factor))
    else:
        w_full = torch.zeros(t, e, dtype=torch.float32, device=x.device)
        w_full.scatter_add_(1, topk_i.long(), topk_w)
        out_e = _expert_ffn(params, x.expand(e, t, d))  # [E, T, D]
        out = torch.einsum("te,etd->td", w_full.to(x.dtype), out_e)
    return out.to(x.dtype), aux
