"""MoE decode: compute only the selected experts (vita_tpu.ops.moe_decode).

Two schedules of one function, as in the JAX package:

- ``gather_expert_ffn``: per (token, k) pair, the SwiGLU of the selected
  expert, unweighted -> [T, k, D]. Batches of 2-3 tokens run it over the
  pairs sorted by expert (``_sorted_pair_gather``).
- ``masked_expert_ffn``: the weighted output [T, D]. For 4 <= T <= 16 each
  unique active expert (``_active_expert_plan``) runs on all T tokens, so
  its weights are read once for the batch, and the routing weights fold in
  afterwards by an [A, T] x [A, T, D] einsum; other batch sizes take the
  gather schedule and combine its pairs.

Expert ids may be flat ``layer * E + e`` into the stacked weights viewed as
[L * E, D, F] / [L * E, F, D] (a free view in torch).

On CUDA tensors both schedules launch the hand-written kernels of
csrc/expert_ffn.cu (float32 or bfloat16, D and F even); on CPU tensors
they run ``gather_expert_ffn_plain`` / ``masked_expert_ffn_plain``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from vita_tpu_torch import kernels

MASKED_MIN_T = 4
MASKED_MAX_T = 16


def _swiglu_rows(x, w_gate, w_up, w_down):
    """x [R, N, D] against per-row weights [R, D, F] / [R, F, D]: gate and
    up in the weight dtype, silu product in float32, rounded to the weight
    dtype for the down projection (the TPU kernel's order)."""
    gate = torch.bmm(x, w_gate)
    up = torch.bmm(x, w_up)
    h = F.silu(gate.float()) * up.float()
    return torch.bmm(h.to(w_down.dtype), w_down)


def gather_expert_ffn_plain(x, topk_idx, w_gate, w_up, w_down) -> torch.Tensor:
    """Gather the selected experts' weights and run the SwiGLU per pair."""
    t, d = x.shape
    k = topk_idx.shape[1]
    flat = topk_idx.reshape(-1).long()
    xr = x.repeat_interleave(k, dim=0)[:, None, :]  # [T*k, 1, D]
    out = _swiglu_rows(xr, w_gate[flat], w_up[flat], w_down[flat])
    return out.reshape(t, k, d).to(x.dtype)


def _expert_ffn_cuda(x, eids, toks, w_gate, w_up, w_down) -> torch.Tensor:
    """Both schedules' launch: rows of (expert id, token slots)."""
    kernels.require_cuda(x, eids, toks, w_gate, w_up, w_down)
    r, nt = toks.shape
    d, f = w_gate.shape[1], w_gate.shape[2]
    kernels.require(x.shape[1] == d and w_up.shape == w_gate.shape
                    and w_down.shape == (w_gate.shape[0], f, d),
                    "expert weight shapes do not match x")
    kernels.require(d % 2 == 0 and f % 2 == 0, f"expert kernel needs even D and F, got {d}, {f}")
    kernels.require(all(w.data_ptr() % (2 * w.element_size()) == 0
                        for w in (x, w_gate, w_up, w_down)),
                    "expert kernel reads element pairs: operands must be 2-element aligned")
    kernels.require(nt in (1, 2, 4, 8, 16), f"token slots per row must be 1/2/4/8/16, got {nt}")
    kernels.require(eids.dtype == torch.int32 and toks.dtype == torch.int32
                    and eids.shape == (r,), "eids [R] and toks [R, nt] must be int32")
    dt = kernels.dtype_code(x, w_gate, w_up, w_down)
    h = torch.empty(r, nt, f, dtype=w_gate.dtype, device=x.device)
    y = torch.empty(r, nt, d, dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    err = kernels.lib().vita_expert_ffn(
        x.data_ptr(), eids.data_ptr(), toks.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), y.data_ptr(),
        r, nt, d, f, dt, kernels.stream_of(x),
    )
    kernels.check_launch(err, "expert_ffn")
    return y


def gather_expert_ffn_cuda(x, topk_idx, w_gate, w_up, w_down) -> torch.Tensor:
    """One kernel row per (token, k) pair, one token slot each."""
    t, d = x.shape
    k = topk_idx.shape[1]
    eids = topk_idx.reshape(-1).to(torch.int32).contiguous()
    toks = torch.arange(t, dtype=torch.int32, device=x.device).repeat_interleave(k)[:, None]
    y = _expert_ffn_cuda(x.contiguous(), eids, toks.contiguous(), w_gate, w_up, w_down)
    kernels.launches["gather_expert_ffn"] += 1
    return y.reshape(t, k, d)


def gather_expert_ffn(
    x: torch.Tensor,  # [T, D]
    topk_idx: torch.Tensor,  # [T, k] int32
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,  # [E, D, F]
    w_down: torch.Tensor,  # [E, F, D]
) -> torch.Tensor:
    """Per-(token, k) expert FFN outputs [T, k, D], unweighted."""
    if kernels.on_cuda(x):
        return gather_expert_ffn_cuda(x, topk_idx, w_gate, w_up, w_down)
    return gather_expert_ffn_plain(x, topk_idx, w_gate, w_up, w_down)


def _sorted_pair_gather(x, topk_idx, run) -> torch.Tensor:
    """Run the per-pair schedule with the flattened pairs sorted by expert
    id (duplicate experts across the batch sit on adjacent rows), then
    invert the permutation back to [T, k, D]. Each pair's output is the
    same as unsorted."""
    t, k = topk_idx.shape
    flat = topk_idx.reshape(t * k)
    order = torch.argsort(flat, stable=True)
    inv = torch.argsort(order)
    x_rows = x.repeat_interleave(k, dim=0)[order]
    out = run(x_rows, flat[order][:, None])  # [T*k, 1, D]
    return out.reshape(t * k, -1)[inv].reshape(t, k, x.shape[-1])


def _gather_combine(eo, topk_w, x) -> torch.Tensor:
    return (eo * topk_w[..., None].to(x.dtype)).sum(1).to(x.dtype)


def _active_expert_plan(topk_w, topk_idx, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(act [A] int32, m [A, T] f32) for A = min(T*k, n_experts).

    ``act`` lists each unique selected expert once (ascending), padded by
    repeating the last unique id; ``m[a, t]`` is token t's routing weight
    for expert act[a], zero on padding rows so the repeated id is not
    counted twice."""
    t, k = topk_idx.shape
    a_len = min(t * k, n_experts)
    c = torch.sort(topk_idx.reshape(-1).to(torch.int32)).values
    first = torch.ones_like(c, dtype=torch.bool)
    first[1:] = c[1:] != c[:-1]
    pos = torch.cumsum(first.long(), 0) - 1  # unique rank of each sorted element
    u = pos[-1] + 1
    act = torch.zeros(a_len, dtype=torch.int32, device=c.device)
    act.scatter_(0, pos.clamp(max=a_len - 1), c)
    ar = torch.arange(a_len, device=c.device)
    act = torch.where(ar < u, act, c[-1])
    valid = (ar < u).float()
    hit = (topk_idx[None, :, :] == act[:, None, None]).float()  # [A, T, k]
    m = torch.einsum("tk,atk->at", topk_w.float(), hit) * valid[:, None]
    return act, m


def masked_expert_ffn_plain(x, act, m, w_gate, w_up, w_down) -> torch.Tensor:
    """Each active expert on all T tokens, then the weighted combine."""
    a = act.long()
    y = _swiglu_rows(x.expand(a.shape[0], *x.shape), w_gate[a], w_up[a], w_down[a])
    return torch.einsum("at,atd->td", m, y.to(x.dtype).float()).to(x.dtype)


def masked_expert_ffn_cuda(x, act, m, w_gate, w_up, w_down) -> torch.Tensor:
    """One kernel row per active expert with all T tokens (slots padded to
    a power of two; empty slots compute zeros)."""
    t = x.shape[0]
    nt = 1
    while nt < t:
        nt *= 2
    slots = torch.arange(nt, dtype=torch.int32, device=x.device)
    toks = torch.where(slots < t, slots, -1).expand(act.shape[0], nt).contiguous()
    y = _expert_ffn_cuda(x.contiguous(), act.to(torch.int32).contiguous(), toks,
                         w_gate, w_up, w_down)
    kernels.launches["masked_expert_ffn"] += 1
    return torch.einsum("at,atd->td", m, y[:, :t].float()).to(x.dtype)


def masked_expert_ffn(
    x: torch.Tensor,  # [T, D]
    topk_w: torch.Tensor,  # [T, k] routing weights
    topk_idx: torch.Tensor,  # [T, k] int32 (flat layer*E+e ids allowed)
    w_gate: torch.Tensor,  # [E_rows, D, F]
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # [E_rows, F, D]
    n_experts: int,  # true expert count (bounds unique ids per call)
) -> torch.Tensor:
    """Weighted MoE FFN output [T, D] from the selected experts only."""
    t = x.shape[0]
    if t < MASKED_MIN_T or t > MASKED_MAX_T:
        run = lambda xr, ir: gather_expert_ffn(xr, ir, w_gate, w_up, w_down)
        eo = run(x, topk_idx) if t < 2 else _sorted_pair_gather(x, topk_idx, run)
        return _gather_combine(eo, topk_w, x)
    act, m = _active_expert_plan(topk_w, topk_idx, n_experts)
    if kernels.on_cuda(x):
        return masked_expert_ffn_cuda(x, act, m, w_gate, w_up, w_down)
    return masked_expert_ffn_plain(x, act, m, w_gate, w_up, w_down)
