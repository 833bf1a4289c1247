"""Grouped matmul for the prefill MoE (vita_tpu.ops.moe_gmm, forward).

``gmm(x, w, gids)`` multiplies row tile i of ``x`` (tokens sorted by
expert, each expert's rows padded to a ``tile_m`` multiple by
``sorted_layout``) by ``w[gids[i]]``; ``moe_ffn_gmm`` runs the three
expert matmuls of the SwiGLU that way: dropless, so it matches the dense
mode's combination, with top-k FLOPs only.

Two schedules, chosen as the JAX package chooses them (``_gmm_raw``):
R <= SMALL_R_MAX or tile_m <= SMALL_TILE_M takes the weights-once
schedule (kernel B5b, counter ``gmm_small``), larger R the k-blocked one
(B5a, counter ``gmm``). The tile constants keep the JAX values, since
they decide the layout and the schedule.

On CUDA tensors ``gmm`` launches a hand-written kernel of csrc/gmm.cu:
bfloat16 B5a and B5b run the wgmma + TMA kernel (128 x 256 tiles grouped
16 M tiles at a time, which up to R 2048 is the TPU kernel's weights-once
order for B5b), float32 the 128 x 128 FMA tile routine; on CPU
tensors it runs ``gmm_plain``. ``gmm`` is a ``torch.autograd.Function``
with the JAX package's custom VJP: dx is ``gmm`` itself with
``transpose_rhs`` flipped (B5a/B5b by the same rule), and dw is
``gmm_wgrad`` (kernel B12 in csrc/gmm.cu, counter ``gmm_wgrad``: wgmma +
TMA in bfloat16, FMA in float32; ``gmm_wgrad_plain`` on the CPU), the
per-group a^T b summed in float32 and written in a's dtype. Every expert
owns at least one row tile (``sorted_layout``), so an expert without
tokens gets a dw of exactly 0.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vita_tpu_torch import kernels

TILE_M = 512
TILE_N = 512
TILE_K = 2048
SMALL_R_MAX = 16384
SMALL_TILE_M = 128
BLOCK_M = 128  # rows per block of csrc/gmm.cu; must divide tile_m


def _shapes(x, w, gids, transpose_rhs: bool, tile_m: int):
    """(R, K, N) after the checks both versions share."""
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    r, k_dim = x.shape
    if transpose_rhs:
        _, n_dim, k_w = w.shape
    else:
        _, k_w, n_dim = w.shape
    if k_w != k_dim:
        raise ValueError(f"contraction mismatch: x K={k_dim}, w K={k_w}")
    if r >= tile_m and r % tile_m:
        raise ValueError(f"rows {r} not divisible by tile_m {tile_m}")
    want = r // tile_m if r >= tile_m else 1
    if gids.dim() != 1 or gids.shape[0] < want:
        raise ValueError(f"gids needs {want} group ids (one per row tile), got {tuple(gids.shape)}")
    return r, k_dim, n_dim


def sorted_pairs(topk_idx: torch.Tensor, n_experts: int):
    """The flat (token, slot) pairs sorted by expert, stably (each expert
    keeps the flat order): (order, expert of each sorted pair, its token,
    its position within its expert) [T*k] int64, and counts [E]."""
    k = topk_idx.shape[1]
    fe = topk_idx.reshape(-1).long()
    order = torch.argsort(fe, stable=True)
    fe_s = fe[order]
    # bincount sizes its output from the data (a device sync); a scatter does not
    counts = torch.zeros(n_experts, dtype=torch.long, device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(fe.shape[0], device=fe.device) - starts[fe_s]
    return order, fe_s, order // k, pos, counts


def sorted_layout(topk_idx: torch.Tensor, n_experts: int, tile_m: int = TILE_M):
    """Static-shape sorted and padded row layout for ``gmm``.

    Returns (dest [T*k] row of each (token, slot) pair in the padded
    buffer, tok_s [T*k] source token of each sorted pair, order [T*k],
    gids [R/tile_m], R), int32, equal to the JAX package's. Each expert's
    rows are padded to a tile_m multiple (at least one tile each), and R
    is the worst case ceil(T*k/tile_m)*tile_m + E*tile_m, computed on the
    host from shapes. No token is dropped."""
    t, k = topk_idx.shape
    e = n_experts
    r = -(-(t * k) // tile_m) * tile_m + e * tile_m
    order, fe_s, tok_s, pos, counts = sorted_pairs(topk_idx, e)
    pad_counts = torch.clamp(-(-counts // tile_m), min=1) * tile_m
    ends_pad = torch.cumsum(pad_counts, 0)
    dest = (ends_pad - pad_counts)[fe_s] + pos
    tile_starts = torch.arange(r // tile_m, device=topk_idx.device) * tile_m
    gids = torch.searchsorted(ends_pad, tile_starts, right=True).clamp(0, e - 1)
    i32 = torch.int32
    return dest.to(i32), tok_s.to(i32), order.to(i32), gids.to(i32), r


def gmm_plain(x, w, gids, transpose_rhs: bool = False, tile_m: int = TILE_M) -> torch.Tensor:
    """Each expert's rows times its weight with ``torch.matmul`` (float32
    accumulation, output in x's dtype)."""
    r, _, n_dim = _shapes(x, w, gids, transpose_rhs, tile_m)
    row_g = _row_groups(gids, r, tile_m)
    out = torch.zeros(r, n_dim, dtype=x.dtype, device=x.device)
    for e in range(w.shape[0]):
        rows = row_g == e
        we = w[e].transpose(0, 1) if transpose_rhs else w[e]
        out[rows] = (x[rows] @ we).to(x.dtype)
    return out


def gmm_cuda(x, w, gids, transpose_rhs: bool = False, tile_m: int = TILE_M) -> torch.Tensor:
    """csrc/gmm.cu, B5b (small R) or B5a (large R) as ``_gmm_raw``
    chooses: the wgmma + TMA kernel in bfloat16, the 128 x 128 FMA tile
    routine in float32."""
    kernels.require_cuda(x, w, gids)
    r, k_dim, n_dim = _shapes(x, w, gids, transpose_rhs, tile_m)
    kernels.require(r < tile_m or tile_m % BLOCK_M == 0,
                    f"gmm kernel blocks of {BLOCK_M} rows must not cross a tile_m {tile_m} tile")
    kernels.require(gids.dtype == torch.int32, "gids must be int32")
    kernels.dtype_code(x, w)  # float32 or bfloat16, one dtype
    out = torch.empty(r, n_dim, dtype=x.dtype, device=x.device)
    if r and n_dim:
        large = not (r <= SMALL_R_MAX or tile_m <= SMALL_TILE_M)
        args = (x.data_ptr(), w.data_ptr(), gids.data_ptr(), out.data_ptr(), r, k_dim, n_dim,
                w.shape[0], tile_m, int(transpose_rhs))
        if x.dtype == torch.bfloat16:
            err = kernels.lib().vita_gmm_wgmma(*args, kernels.stream_of(x))
        else:
            err = kernels.lib().vita_gmm(*args, kernels.stream_of(x))
        kernels.check_launch(err, "gmm")
        kernels.launches["gmm" if large else "gmm_small"] += 1
    return out


def gmm_wgmma_info() -> Dict[str, Dict[str, int]]:
    """Resources of the bfloat16 wgmma + TMA kernels on the current card
    (the forward of B5a and B5b, also with transpose_rhs as dx runs it, and
    B12; ``kernels.resources``)."""
    return kernels.resources(kernels.lib().vita_gmm_wgmma_info,
                             ("gmm and gmm_small", "gmm and gmm_small dx", "gmm_wgrad"))


def _gmm_raw(x, w, gids, transpose_rhs: bool, tile_m: int) -> torch.Tensor:
    if kernels.on_cuda(x):
        return gmm_cuda(x, w, gids, transpose_rhs, tile_m)
    return gmm_plain(x, w, gids, transpose_rhs, tile_m)


def _row_groups(gids, r: int, tile_m: int) -> torch.Tensor:
    """The group of every row [R]."""
    return gids.repeat_interleave(tile_m)[:r] if r >= tile_m else gids[:1].expand(r)


def gmm_wgrad_plain(a, b, gids, n_groups: int, tile_m: int = TILE_M) -> torch.Tensor:
    """dw [E, K, N] = each group's a^T b in float32, cast to a's dtype."""
    r, k_dim = a.shape
    out = torch.zeros(n_groups, k_dim, b.shape[1], dtype=torch.float32, device=a.device)
    row_g = _row_groups(gids, r, tile_m)
    for e in range(n_groups):
        rows = row_g == e
        out[e] = a[rows].float().T @ b[rows].float()
    return out.to(a.dtype)


def gmm_wgrad_cuda(a, b, gids, n_groups: int, tile_m: int = TILE_M) -> torch.Tensor:
    """csrc/gmm.cu's B12: dw in a's dtype, written by the kernel."""
    kernels.require_cuda(a, b, gids)
    r, k_dim = a.shape
    n_dim = b.shape[1]
    kernels.require(b.shape[0] == r, f"a has {r} rows, b {b.shape[0]}")
    kernels.require(gids.dtype == torch.int32 and gids.dim() == 1
                    and gids.shape[0] >= (r // tile_m if r >= tile_m else 1),
                    "gids must be int32, one per row tile")
    dt = kernels.dtype_code(a, b)
    out = torch.empty(n_groups, k_dim, n_dim, dtype=a.dtype, device=a.device)
    if n_groups and k_dim and n_dim:
        err = kernels.lib().vita_gmm_wgrad(
            a.data_ptr(), b.data_ptr(), gids.data_ptr(), out.data_ptr(), r, k_dim, n_dim,
            n_groups, tile_m, dt, kernels.stream_of(a))
        kernels.check_launch(err, "gmm_wgrad")
        kernels.launches["gmm_wgrad"] += 1
    return out


def gmm_wgrad(a, b, gids, n_groups: int, tile_m: int = TILE_M) -> torch.Tensor:
    """dw [E, K, N] = per-group a^T b over the sorted row tiles."""
    if kernels.on_cuda(a):
        return gmm_wgrad_cuda(a, b, gids, n_groups, tile_m)
    return gmm_wgrad_plain(a, b, gids, n_groups, tile_m)


class _Gmm(torch.autograd.Function):
    """gmm with the JAX package's VJP (vita_tpu.ops.moe_gmm._gmm_bwd)."""

    @staticmethod
    def forward(ctx, x, w, gids, transpose_rhs, tile_m):
        ctx.save_for_backward(x, w, gids)
        ctx.transpose_rhs, ctx.tile_m = transpose_rhs, tile_m
        return _gmm_raw(x, w, gids, transpose_rhs, tile_m)

    @staticmethod
    def backward(ctx, dy):
        x, w, gids = ctx.saved_tensors
        trans, tile_m = ctx.transpose_rhs, ctx.tile_m
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_raw(dy, w, gids, not trans, tile_m).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # y = x w^T -> dw[e] = dy^T x, [E, N, K]; else dw[e] = x^T dy, [E, K, N]
            a, b = (dy, x) if trans else (x, dy)
            dw = gmm_wgrad(a, b, gids, w.shape[0], tile_m).to(w.dtype)
        return dx, dw, None, None, None


def gmm(
    x: torch.Tensor,  # [R, K]
    w: torch.Tensor,  # [E, K, N], or [E, N, K] with transpose_rhs
    gids: torch.Tensor,  # [R / tile_m] int32, non-decreasing
    transpose_rhs: bool = False,
    tile_m: int = TILE_M,
) -> torch.Tensor:
    """Grouped matmul: row tile i of ``x`` times ``w[gids[i]]`` -> [R, N];
    differentiable in x and w."""
    return _Gmm.apply(x, w, gids, transpose_rhs, tile_m)


def moe_ffn_gmm(params, x, topk_w, topk_idx) -> torch.Tensor:
    """Dropless grouped-matmul expert FFN: out [T, D].

    params: {'w_gate' [E,D,F], 'w_up', 'w_down' [E,F,D]}. Prefill-sized
    T (T*k <= SMALL_R_MAX) uses row tiles of SMALL_TILE_M, larger T tiles
    of TILE_M."""
    t, d = x.shape
    k = topk_idx.shape[1]
    e = params["w_gate"].shape[0]
    tile_m = SMALL_TILE_M if t * k <= SMALL_R_MAX else TILE_M
    dest, tok_s, order, gids, r = sorted_layout(topk_idx, e, tile_m)
    dest, tok_s = dest.long(), tok_s.long()

    xs = x.new_zeros(r, d)
    xs[dest] = x[tok_s]
    g = gmm(xs, params["w_gate"], gids, tile_m=tile_m)
    u = gmm(xs, params["w_up"], gids, tile_m=tile_m)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    del g, u
    ys = gmm(h, params["w_down"], gids, tile_m=tile_m)

    y = ys[dest]  # [T*k, D] in sorted pair order
    w_s = topk_w.reshape(-1)[order.long()].to(x.dtype)
    return x.new_zeros(t, d).index_add_(0, tok_s, y * w_s[:, None])
