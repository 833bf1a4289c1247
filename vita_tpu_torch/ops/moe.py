"""Mixture-of-Experts routing and the dense expert path (vita_tpu.ops.moe).

Routing follows Mixtral: softmax over all experts in float32, top-k, then
the k weights renormalised to sum to 1. Expert weights keep the JAX
layout: router [D, E], w_gate/w_up [E, D, F], w_down [E, F, D].

``mode="dense"`` runs every expert on every token, weighted by the zeroed
router weights (exact, used for prefill). The decode modes ``gather``,
``gather_q`` and ``gather_q4`` run only the selected experts through
ops.moe_decode (``gather_q``/``gather_q4`` take params quantized by
moe_decode.quantize_expert_weights / quantize_expert_weights_int4). The
capacity/sort/gmm training modes are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# selected-expert decode modes (ops.moe_decode.selected_expert_ffn)
GATHER_MODES = ("gather", "gather_q", "gather_q4")
MODES = ("dense",) + GATHER_MODES


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


def moe_ffn(
    params,
    x: torch.Tensor,  # [T, D]
    top_k: int = 2,
    mode: str = "dense",
    token_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [T, D], aux_loss scalar)."""
    if mode not in MODES:
        raise NotImplementedError(f"moe_ffn mode {mode!r} is not ported; ported: {MODES}")
    t, d = x.shape
    e = params["w_gate"].shape[0]
    router_logits = x.float() @ params["router"].float()
    topk_w, topk_i, probs = route_topk(router_logits, top_k)
    aux = load_balancing_loss(probs, topk_i, e, token_mask)
    if mode != "dense":
        from vita_tpu_torch.ops import moe_decode as md

        out = md.selected_expert_ffn(mode, x, topk_w, topk_i, params, n_experts=e)
        return out.to(x.dtype), aux
    w_full = torch.zeros(t, e, dtype=torch.float32, device=x.device)
    w_full.scatter_add_(1, topk_i.long(), topk_w)
    out_e = _expert_ffn(params, x.expand(e, t, d))  # [E, T, D]
    out = torch.einsum("te,etd->td", w_full.to(x.dtype), out_e)
    return out.to(x.dtype), aux
