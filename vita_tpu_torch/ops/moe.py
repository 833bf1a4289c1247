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

``chunk`` runs a training mode over token chunks of that size
(``over_chunks``, which models.mixtral's sharded gmm layer takes too),
each under ``torch.utils.checkpoint``, so that the backward holds one
chunk's expert intermediates at a time. As in the JAX package, aux is
then the mean of the chunk-local aux losses weighted by each chunk's
valid tokens, and the capacity of sort/capacity modes is per chunk.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e, padding excluded
    through ``token_mask``. ``reduce`` maps the sums [2E + 1] (tokens
    sent to each expert, router probabilities per expert, real tokens)
    before they are divided: the seq-parallel forward sums them over
    'seq' (models.mixtral.forward), so the loss is the whole sequence's."""
    sel = F.one_hot(topk_idx.long(), n_experts).float()  # [T, k, E]
    m = (torch.ones(probs.shape[0], device=probs.device) if token_mask is None
         else token_mask.float())
    sums = torch.cat([(sel * m[:, None, None]).sum((0, 1)), (probs * m[:, None]).sum(0),
                      m.sum()[None]])
    if reduce is not None:
        sums = reduce(sums)
    denom = sums[-1].clamp_min(1.0)
    f = sums[:n_experts] / (denom * sel.shape[1])
    p = sums[n_experts:2 * n_experts] / denom
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


def _sort_dispatch(params, x, topk_w, topk_i, capacity: int, e0: int = 0) -> torch.Tensor:
    """The pairs sorted by expert (moe_gmm.sorted_pairs) fill [E, C, D]; a
    pair at position >= C is written to a spare row C that is cut off, and
    contributes nothing. With experts [e0, e0 + E_local) only (a rank of an
    expert-parallel mesh), positions count over all experts and the other
    experts' pairs go to the spare row too."""
    t, d = x.shape
    e = params["w_gate"].shape[0]
    order, fe_s, tok_s, pos, _ = sorted_pairs(topk_i, params["router"].shape[-1])
    keep = (pos < capacity) & (fe_s >= e0) & (fe_s < e0 + e)
    fe_s = (fe_s - e0).clamp(0, e - 1)
    expert_in = x.new_zeros(e, capacity + 1, d)
    expert_in[fe_s, torch.where(keep, pos, capacity)] = x[tok_s]
    expert_out = _expert_ffn(params, expert_in[:, :capacity])  # [E, C, D]
    y = expert_out[fe_s, torch.where(keep, pos, 0)] * keep[:, None].to(x.dtype)
    w_s = topk_w.reshape(-1)[order].to(x.dtype)
    return x.new_zeros(t, d).index_add_(0, tok_s, y * w_s[:, None])


def _capacity_dispatch(params, x, topk_w, topk_i, capacity: int, e0: int = 0,
                       out_dtype=None) -> torch.Tensor:
    """GShard one-hot dispatch/combine einsums with C slots per expert;
    slots count over all experts, then experts [e0, e0 + E_local) run."""
    t, _ = x.shape
    k = topk_i.shape[1]
    e = params["router"].shape[-1]
    e_local = params["w_gate"].shape[0]
    dt = x.dtype
    sel = F.one_hot(topk_i.long(), e)  # [T, k, E]
    sel_flat = sel.reshape(t * k, e)
    pos = torch.cumsum(sel_flat, 0) - 1
    pos = (pos * sel_flat).sum(-1).reshape(t, k)  # slot within the expert
    keep = pos < capacity
    disp = (sel.to(dt)[..., None]
            * F.one_hot(torch.where(keep, pos, 0), capacity).to(dt)[:, :, None, :]
            * keep[..., None, None].to(dt))  # [T, k, E, C]
    disp = disp[:, :, e0:e0 + e_local]
    dispatch = disp.sum(1)
    combine = (disp * topk_w[..., None, None].to(dt)).sum(1)
    expert_out = _expert_ffn(params, torch.einsum("tec,td->ecd", dispatch, x))
    if out_dtype is not None:
        return torch.einsum("tec,ecd->td", combine.to(out_dtype), expert_out.to(out_dtype))
    return torch.einsum("tec,ecd->td", combine, expert_out)


def chunks_of(t: int, chunk: int) -> bool:
    """Whether ``chunk`` splits T tokens: 0 < chunk < T and chunk divides
    T (otherwise a layer runs whole)."""
    return 0 < chunk < t and t % chunk == 0


def over_chunks(fn: Callable, x: torch.Tensor, chunk: int,
                token_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(x_chunk, mask_chunk) -> (out, aux)`` over token chunks of
    ``chunk`` rows (``chunks_of``), each rematerialized in the backward:
    the outputs joined, and aux the chunks' mean weighted by their valid
    tokens."""
    t = x.shape[0]
    tms = (torch.ones(t // chunk, chunk, device=x.device) if token_mask is None
           else token_mask.reshape(-1, chunk))
    outs, auxs = zip(*(checkpoint(fn, xc, tc, use_reentrant=False)
                       for xc, tc in zip(x.split(chunk), tms)))
    ns = tms.float().sum(1)
    return torch.cat(outs), (torch.stack(auxs) * ns).sum() / ns.sum().clamp_min(1.0)


def moe_ffn(
    params,
    x: torch.Tensor,  # [T, D]
    top_k: int = 2,
    mode: str = "dense",
    capacity_factor: float = 1.25,
    token_mask: Optional[torch.Tensor] = None,
    chunk: int = 0,
    expert_offset: int = 0,
    out_dtype=None,
    reduce_stats: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    expert_inputs: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [T, D], aux_loss scalar). ``chunk`` is ignored when
    T <= chunk, when chunk does not divide T, or in a gather mode.

    ``params`` may hold experts [expert_offset, expert_offset + E_local)
    of the router's E only (a rank of an expert-parallel mesh, dense, sort
    and capacity modes): routing, capacity and aux stay global, and the
    output is those experts' weighted partial sum. ``out_dtype`` float32
    leaves the output unrounded (dense and capacity combine in float32),
    for ranks that add their partial sums before rounding.
    ``reduce_stats`` is aux's ``reduce`` (``load_balancing_loss``).
    ``expert_inputs`` maps (x, topk_w) to what the experts take, after
    the router has read x (an expert-parallel training mesh's
    ``all_reduce_grad``, whose backward must not reach the router's
    path)."""
    if mode not in MODES:
        raise ValueError(f"unknown moe mode {mode!r}")
    t, d = x.shape
    if mode in TRAIN_MODES and chunks_of(t, chunk):
        return over_chunks(
            lambda xc, tc: moe_ffn(params, xc, top_k, mode, capacity_factor, tc, 0,
                                   expert_offset, out_dtype, None, expert_inputs),
            x, chunk, token_mask)
    e = params["router"].shape[-1]
    e_local = params["w_gate"].shape[0]
    if (e_local != e or expert_offset) and mode not in ("dense", "sort", "capacity"):
        raise ValueError(f"mode {mode!r} takes every expert; sharded experts go through "
                         "parallel.sharded_ops")
    router_logits = x.float() @ params["router"].float()
    topk_w, topk_i, probs = route_topk(router_logits, top_k)
    aux = load_balancing_loss(probs, topk_i, e, token_mask, reduce_stats)
    if expert_inputs is not None:
        x, topk_w = expert_inputs(x, topk_w)
    if mode in GATHER_MODES:
        from vita_tpu_torch.ops import moe_decode as md

        out = md.selected_expert_ffn(mode, x, topk_w, topk_i, params, n_experts=e)
    elif mode == "gmm":
        out = moe_ffn_gmm(params, x, topk_w, topk_i)
    elif mode == "sort":
        out = _sort_dispatch(params, x, topk_w, topk_i, _capacity(t, top_k, e, capacity_factor),
                             expert_offset)
    elif mode == "capacity":
        out = _capacity_dispatch(params, x, topk_w, topk_i,
                                 _capacity(t, top_k, e, capacity_factor), expert_offset, out_dtype)
    else:
        w_full = torch.zeros(t, e, dtype=torch.float32, device=x.device)
        w_full.scatter_add_(1, topk_i.long(), topk_w)
        w_full = w_full[:, expert_offset:expert_offset + e_local]
        out_e = _expert_ffn(params, x.expand(e_local, t, d))  # [E, T, D]
        w_full = w_full.to(x.dtype)
        if out_dtype is not None:
            w_full, out_e = w_full.to(out_dtype), out_e.to(out_dtype)
        out = torch.einsum("te,etd->td", w_full, out_e)
    return out.to(out_dtype or x.dtype), aux
