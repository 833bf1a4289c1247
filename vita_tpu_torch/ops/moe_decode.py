"""MoE decode: compute only the selected experts (vita_tpu.ops.moe_decode).

Two schedules of one function, over bf16/f32, int8 or int4 expert weights,
as in the JAX package:

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

Weight-only quantized experts (``quantize_expert_weights``: int8 with one
f32 scale per output column; ``quantize_expert_weights_int4``: int4 packed
two per byte by halves, per-column or grouped scales) run the ``_q`` /
``_q4`` functions. Their plain versions follow the TPU kernels' arithmetic,
not the JAX package's CPU twins: the dot runs over the exact integers in
float32 and a per-column scale multiplies its result (grouped int4 scales
multiply each value first, rounded to bf16), and h is rounded to bf16
before the down projection whatever x's dtype.

On CUDA tensors both schedules over bfloat16 experts with bfloat16
activations launch the tensor-core kernel of csrc/expert_ffn_bf16.cu (any
D and F); with bfloat16 activations, both schedules over int8 experts and
over int4 experts with per-channel scales launch the one of
csrc/expert_ffn_q.cu (D and F multiples of 4); every other schedule
launches the SIMT kernels of csrc/expert_ffn.cu (float32 activations and
grouped int4 scales; D and F even, F a multiple of 4 for quantized
weights). On CPU tensors they run the ``*_plain`` versions.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from vita_tpu_torch import kernels
from vita_tpu_torch.ops.moe import GATHER_MODES, route_topk

MASKED_MIN_T = 4
MASKED_MIN_T_Q4 = 8
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


def _expert_ffn_cuda(x, eids, toks, w_gate, w_up, w_down, scales=None,
                     wfmt: int = kernels.WFMT_PLAIN) -> torch.Tensor:
    """The SIMT kernel's launch: rows of (expert id, token slots), over
    float32 weights for float32 x (``scales`` None) or int8/int4 weights
    with their f32 scales (w_gate_scale, w_up_scale, w_down_scale)."""
    kernels.require_cuda(x, eids, toks, w_gate, w_up, w_down, *(scales or ()))
    r, nt = toks.shape
    rows, f = w_gate.shape[0], w_gate.shape[2]
    packed = wfmt == kernels.WFMT_INT4
    d = 2 * w_gate.shape[1] if packed else w_gate.shape[1]
    kernels.require(x.shape[1] == d and w_up.shape == w_gate.shape
                    and w_down.shape == (rows, f, d // 2 if packed else d),
                    "expert weight shapes do not match x")
    kernels.require(d % 2 == 0 and f % 2 == 0, f"expert kernel needs even D and F, got {d}, {f}")
    kernels.require(nt in (1, 2, 4, 8, 16), f"token slots per row must be 1/2/4/8/16, got {nt}")
    kernels.require(eids.dtype == torch.int32 and toks.dtype == torch.int32
                    and eids.shape == (r,), "eids [R] and toks [R, nt] must be int32")
    dt = kernels.dtype_code(x)
    if scales is None:
        kernels.require(all(t.dtype == torch.float32 for t in (x, w_gate, w_up, w_down)),
                        "the SIMT expert kernel takes float32 activations and experts")
        kernels.require(all(w.data_ptr() % (2 * w.element_size()) == 0
                            for w in (w_gate, w_up, w_down)),
                        "expert kernel reads element pairs: weights must be 2-element aligned")
        n_sg = n_sd = 1
        sptr = (0, 0, 0)
        h_dtype = w_gate.dtype
    else:
        sg, su, sd = scales
        n_sg, n_sd = sg.shape[1], sd.shape[1]
        kernels.require(all(w.dtype == torch.int8 for w in (w_gate, w_up, w_down))
                        and all(s.dtype == torch.float32 for s in scales),
                        "quantized experts take int8 weights and float32 scales")
        kernels.require(sg.shape == su.shape == (rows, n_sg, f) and sd.shape == (rows, n_sd, d),
                        "expert scale shapes do not match the weights")
        kernels.require((packed and d % n_sg == 0 and f % n_sd == 0)
                        or (n_sg == 1 and n_sd == 1),
                        f"scale groups {n_sg}, {n_sd} do not divide D {d} / F {f}")
        kernels.require(f % 4 == 0 and w_gate.data_ptr() % 4 == 0 and w_up.data_ptr() % 4 == 0
                        and w_down.data_ptr() % 2 == 0,
                        "quantized expert kernel reads 4-byte words: F % 4 == 0 and aligned weights")
        sptr = tuple(s.data_ptr() for s in scales)
        h_dtype = torch.bfloat16
    h = torch.empty(r, nt, f, dtype=h_dtype, device=x.device)
    y = torch.empty(r, nt, d, dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    err = kernels.lib().vita_expert_ffn(
        x.data_ptr(), eids.data_ptr(), toks.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), *sptr, n_sg, n_sd, h.data_ptr(),
        y.data_ptr(), r, nt, d, f, dt, wfmt, kernels.stream_of(x),
    )
    kernels.check_launch(err, "expert_ffn")
    return y


def _expert_ffn_mma(x, eids, toks, w_gate, w_up, w_down, padded: bool) -> torch.Tensor:
    """bf16 x over bf16 experts on tensor cores (csrc/expert_ffn_bf16.cu):
    y [R, nt, D] for rows of (expert id, token slots). With ``padded`` (the
    masked schedule's plan), a row whose id repeats the previous row's is a
    padding row: it reads no weights and gives zeros."""
    kernels.require_cuda(x, eids, toks, w_gate, w_up, w_down)
    r, nt = toks.shape
    rows, d, f = w_gate.shape
    kernels.require(x.shape[1] == d and w_up.shape == w_gate.shape
                    and w_down.shape == (rows, f, d), "expert weight shapes do not match x")
    kernels.require(all(w.dtype == torch.bfloat16 for w in (x, w_gate, w_up, w_down)),
                    "the bf16 expert kernel takes bf16 activations and weights")
    kernels.require(nt in (1, 2, 4, 8, 16), f"token slots per row must be 1/2/4/8/16, got {nt}")
    kernels.require(eids.dtype == torch.int32 and toks.dtype == torch.int32
                    and eids.shape == (r,), "eids [R] and toks [R, nt] must be int32")
    lib = kernels.lib()
    h = torch.empty(r, nt, f, dtype=torch.bfloat16, device=x.device)
    part = torch.empty(lib.vita_expert_ffn_bf16_splits(f), r, nt, d, dtype=torch.float32,
                       device=x.device)
    y = torch.empty(r, nt, d, dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    err = lib.vita_expert_ffn_bf16(
        x.data_ptr(), eids.data_ptr(), toks.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), h.data_ptr(), part.data_ptr(), y.data_ptr(), r, nt, d, f,
        int(padded), kernels.stream_of(x))
    kernels.check_launch(err, "expert_ffn_bf16")
    return y


def expert_ffn_bf16_info() -> Dict[str, Dict[str, int]]:
    """Resources of the tensor-core bf16 kernels on the current card (up and
    down at up to 8 and 16 token slots; ``kernels.resources``)."""
    return kernels.resources(kernels.lib().vita_expert_ffn_bf16_info,
                             ("bf16 up, 8 slots", "bf16 up, 16 slots", "bf16 down, 8 slots",
                              "bf16 down, 16 slots"))


def _expert_rows(x, eids, toks, w_gate, w_up, w_down, padded: bool) -> torch.Tensor:
    """Both schedules' launch over experts in x's dtype: the tensor-core
    kernel for bf16 activations, the SIMT kernel for float32."""
    if x.dtype == torch.bfloat16:
        return _expert_ffn_mma(x, eids, toks, w_gate, w_up, w_down, padded)
    return _expert_ffn_cuda(x, eids, toks, w_gate, w_up, w_down)


# The token slots of a schedule depend only on its shape: each is made
# once per shape and device (kernels only read it), which keeps its small
# launches and host work out of every decode step.
@functools.lru_cache(maxsize=64)
def _pair_tokens(t: int, k: int, device: torch.device) -> torch.Tensor:
    """toks [t * k, 1] int32 of the gather schedule: row r holds token r // k."""
    return torch.arange(t, dtype=torch.int32, device=device).repeat_interleave(k)[:, None]


@functools.lru_cache(maxsize=64)
def _plan_tokens(t: int, rows: int, device: torch.device) -> torch.Tensor:
    """toks [rows, nt] int32 of the masked plan: tokens 0 .. t - 1 in every
    row and -1 in the slots past t (nt the power of two at or above t)."""
    nt = 1
    while nt < t:
        nt *= 2
    slots = torch.arange(nt, dtype=torch.int32, device=device)
    return torch.where(slots < t, slots, -1).expand(rows, nt).contiguous()


def _pair_rows(x, topk_idx):
    """The gather schedule's rows: (expert id, token) per (token, k) pair."""
    t, k = topk_idx.shape
    eids = topk_idx.reshape(-1).to(torch.int32).contiguous()
    return eids, _pair_tokens(t, k, x.device)


def gather_expert_ffn_cuda(x, topk_idx, w_gate, w_up, w_down) -> torch.Tensor:
    """One kernel row per (token, k) pair, one token slot each."""
    t, d = x.shape
    y = _expert_rows(x.contiguous(), *_pair_rows(x, topk_idx), w_gate, w_up, w_down, False)
    kernels.count_launch("gather_expert_ffn")
    return y.reshape(t, topk_idx.shape[1], d)


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


def _gather_combine(eo, topk_w, x, out_dtype=None) -> torch.Tensor:
    """The weighted sum over k; ``out_dtype`` float32 keeps it unrounded
    (a partial sum that ranks of an expert mesh add before rounding)."""
    y = eo * topk_w[..., None].to(x.dtype)
    return y.sum(1).to(x.dtype) if out_dtype is None else y.sum(1, dtype=out_dtype)


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


def masked_expert_ffn_plain(x, act, m, w_gate, w_up, w_down, out_dtype=None) -> torch.Tensor:
    """Each active expert on all T tokens, then the weighted combine."""
    a = act.long()
    y = _swiglu_rows(x.expand(a.shape[0], *x.shape), w_gate[a], w_up[a], w_down[a])
    return torch.einsum("at,atd->td", m, y.to(x.dtype).float()).to(out_dtype or x.dtype)


def _active_rows(x, act):
    """The masked schedule's rows: each active expert with all T tokens
    (slots padded to a power of two; empty slots compute zeros)."""
    return act.to(torch.int32).contiguous(), _plan_tokens(x.shape[0], act.shape[0], x.device)


def _masked_combine(m, y, x, out_dtype=None) -> torch.Tensor:
    return torch.einsum("at,atd->td", m, y[:, :x.shape[0]].float()).to(out_dtype or x.dtype)


def masked_expert_ffn_cuda(x, act, m, w_gate, w_up, w_down, out_dtype=None) -> torch.Tensor:
    """One kernel row per active expert with all T tokens; in bf16 the
    plan's padding rows read no weights."""
    y = _expert_rows(x.contiguous(), *_active_rows(x, act), w_gate, w_up, w_down, True)
    kernels.count_launch("masked_expert_ffn")
    return _masked_combine(m, y, x, out_dtype)


def masked_expert_ffn(
    x: torch.Tensor,  # [T, D]
    topk_w: torch.Tensor,  # [T, k] routing weights
    topk_idx: torch.Tensor,  # [T, k] int32 (flat layer*E+e ids allowed)
    w_gate: torch.Tensor,  # [E_rows, D, F]
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # [E_rows, F, D]
    n_experts: int,  # true expert count (bounds unique ids per call)
    out_dtype=None,  # None: x's dtype; float32: the unrounded sum
) -> torch.Tensor:
    """Weighted MoE FFN output [T, D] from the selected experts only."""
    def masked(act, m):
        fn = masked_expert_ffn_cuda if kernels.on_cuda(x) else masked_expert_ffn_plain
        return fn(x, act, m, w_gate, w_up, w_down, out_dtype)

    return _schedule(x, topk_w, topk_idx, n_experts, MASKED_MIN_T,
                     lambda xr, ir: gather_expert_ffn(xr, ir, w_gate, w_up, w_down), masked,
                     out_dtype)


def _schedule(x, topk_w, topk_idx, n_experts: int, min_t: int, gather, masked,
              out_dtype=None) -> torch.Tensor:
    """The weighted output [T, D]: ``masked(act, m)`` for min_t <= T <=
    MASKED_MAX_T, else ``gather(x, idx)`` per (token, k) pair (sorted by
    expert for T >= 2) and the weighted combine."""
    t = x.shape[0]
    if t < min_t or t > MASKED_MAX_T:
        eo = gather(x, topk_idx) if t < 2 else _sorted_pair_gather(x, topk_idx, gather)
        return _gather_combine(eo, topk_w, x, out_dtype)
    return masked(*_active_expert_plan(topk_w, topk_idx, n_experts))


# ---------------------------------------------------------------------------
# weight-only quantized experts: int8 (half the bytes) and int4 (a quarter)
# ---------------------------------------------------------------------------
def _per_layer(w, fn):
    """fn over w [E, A, B], or over each layer of w [L, E, A, B] (bounds
    the float32 temporaries), stacking the (q, scale) results."""
    if w.dim() == 4:
        qs = [fn(w[i]) for i in range(w.shape[0])]
        return torch.stack([q for q, _ in qs]), torch.stack([sc for _, sc in qs])
    return fn(w)


def quantize_expert_weights(params) -> dict:
    """Per-output-channel symmetric int8 quantization of the expert
    matrices: w [.., A, B] -> int8 q and float32 scale [.., 1, B] with
    w ~ q * scale. The router stays as it is."""
    def q_one(w):
        wf = w.float()
        # times the float32 reciprocal: XLA's rewrite of "/ 127.0" under jit
        scale = (wf.abs().amax(dim=-2, keepdim=True) * (1.0 / 127.0)).clamp_min(1e-8)
        return torch.round(wf / scale).clamp(-127, 127).to(torch.int8), scale

    out = {"router": params["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        out[name], out[name + "_scale"] = _per_layer(params[name], q_one)
    return out


def _pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int4 values ([-7, 7] in an int8 tensor) two per byte, pairing
    the two HALVES along ``axis``: row a in the low nibble, row a + n/2 in
    the high one."""
    lo, hi = torch.chunk(q.to(torch.int32), 2, dim=axis)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def _unpack_int4(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of _pack_int4 -> bfloat16 values (exact integers)."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8  # sign-extend the low nibble
    hi = p32 >> 4  # arithmetic shift recovers the high nibble
    return torch.cat([lo, hi], dim=axis).to(torch.bfloat16)


def quantize_expert_weights_int4(params, group: int = 0) -> dict:
    """Symmetric int4 quantization. ``group=0`` scales per output channel;
    group > 0 adds one scale per ``group`` contracted rows (w_down's group
    is capped at 64, as in the JAX package). Gate/up pack along their input
    axis D ([E, D/2, F]); down packs along its output axis D ([E, F, D/2]).
    Scales are float32 [E, A/g, B]."""
    def q_one(w, pack_axis, g):
        wf = w.float()  # [E, A, B]
        e, a, b = wf.shape
        g = g if g and a % g == 0 else a
        wg = wf.reshape(e, a // g, g, b)
        scale = (wg.abs().amax(dim=2, keepdim=True) * (1.0 / 7.0)).clamp_min(1e-8)
        q = torch.round(wg / scale).clamp(-7, 7).reshape(e, a, b).to(torch.int8)
        return _pack_int4(q, pack_axis), scale[:, :, 0]

    out = {"router": params["router"]}
    axes = {"w_gate": (-2, group), "w_up": (-2, group),
            "w_down": (-1, min(group, 64) if group else 0)}
    for name, (ax, g) in axes.items():
        out[name], out[name + "_scale"] = _per_layer(
            params[name], lambda w, ax=ax, g=g: q_one(w, ax, g))
    return out


def _apply_group_scale(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """w [.., A, B] (integers) times scale [.., A/g, B] over each g-row
    group, in bfloat16 as the TPU kernel multiplies: the exact product of
    the two bfloat16 values rounded once to bfloat16."""
    *lead, a, b = w.shape
    ng = scale.shape[-2]
    wr = w.float().reshape(*lead, ng, a // ng, b)
    s = scale.to(torch.bfloat16).float()[..., :, None, :]
    return (wr * s).reshape(*lead, a, b).to(torch.bfloat16)


def _qmatmul(a, w, scale) -> torch.Tensor:
    """a [R, N, K] times integer weights w [R, K, M] with scales [R, G, M]:
    one group folds after the float32 dot, several scale w first."""
    if scale.shape[-2] == 1:
        return torch.bmm(a, w.float()) * scale
    return torch.bmm(a, _apply_group_scale(w, scale).float())


def _swiglu_rows_q(x, qparams, ids, bits: int) -> torch.Tensor:
    """x [R, N, D] against the quantized experts ``ids`` [R]: the TPU
    kernels' arithmetic in float32, h rounded to bf16. Returns [R, N, D]
    float32."""
    ids = ids.long()
    w = {name: qparams[name][ids] for name in
         ("w_gate", "w_up", "w_down", "w_gate_scale", "w_up_scale", "w_down_scale")}
    if bits == 4:
        for name, axis in (("w_gate", -2), ("w_up", -2), ("w_down", -1)):
            w[name] = _unpack_int4(w[name], axis)
    xf = x.float()
    gate = _qmatmul(xf, w["w_gate"], w["w_gate_scale"])
    up = _qmatmul(xf, w["w_up"], w["w_up_scale"])
    h = (F.silu(gate) * up).to(torch.bfloat16).float()
    return _qmatmul(h, w["w_down"], w["w_down_scale"])


def _q_scales(qparams):
    return tuple(qparams[n].contiguous() for n in ("w_gate_scale", "w_up_scale", "w_down_scale"))


def _q_launch(x, eids, toks, qparams, bits: int) -> torch.Tensor:
    wfmt = kernels.WFMT_INT4 if bits == 4 else kernels.WFMT_INT8
    return _expert_ffn_cuda(x.contiguous(), eids, toks, qparams["w_gate"], qparams["w_up"],
                            qparams["w_down"], _q_scales(qparams), wfmt)


def _q_suffix(bits: int) -> str:
    return "_q4" if bits == 4 else "_q"


def gather_expert_ffn_q_plain(x, topk_idx, qparams, bits: int) -> torch.Tensor:
    t, d = x.shape
    k = topk_idx.shape[1]
    xr = x.repeat_interleave(k, dim=0)[:, None, :]  # [T*k, 1, D]
    out = _swiglu_rows_q(xr, qparams, topk_idx.reshape(-1), bits)
    return out.reshape(t, k, d).to(x.dtype)


def gather_expert_ffn_q_cuda(x, topk_idx, qparams, bits: int) -> torch.Tensor:
    """One kernel row per (token, k) pair over int8 (bits 8) or int4 (4)
    weights; bf16 activations over int8 or per-channel int4 experts (the
    serving path's) take the tensor-core kernel, which computes every row,
    also rows that repeat an expert."""
    t, d = x.shape
    rows = _pair_rows(x, topk_idx)
    if _q_mma(x, qparams, bits):
        y = _expert_ffn_q_mma(x.contiguous(), *rows, qparams, bits, False)
    else:
        y = _q_launch(x, *rows, qparams, bits)
    kernels.count_launch("gather_expert_ffn" + _q_suffix(bits))
    return y.reshape(t, topk_idx.shape[1], d)


def _gather_q(x, topk_idx, qparams, bits: int) -> torch.Tensor:
    if kernels.on_cuda(x):
        return gather_expert_ffn_q_cuda(x, topk_idx, qparams, bits)
    return gather_expert_ffn_q_plain(x, topk_idx, qparams, bits)


def gather_expert_ffn_q(x, topk_idx, qparams) -> torch.Tensor:
    """Per-(token, k) expert FFN outputs [T, k, D] over int8 experts
    (quantize_expert_weights)."""
    return _gather_q(x, topk_idx, qparams, 8)


def gather_expert_ffn_q4(x, topk_idx, qparams) -> torch.Tensor:
    """Per-(token, k) expert FFN outputs [T, k, D] over int4 experts
    (quantize_expert_weights_int4, per-channel or grouped)."""
    return _gather_q(x, topk_idx, qparams, 4)


def masked_expert_ffn_q_plain(x, act, m, qparams, bits: int, out_dtype=None) -> torch.Tensor:
    y = _swiglu_rows_q(x.expand(act.shape[0], *x.shape), qparams, act, bits)
    return torch.einsum("at,atd->td", m, y.to(x.dtype).float()).to(out_dtype or x.dtype)


def _q_mma(x, qparams, bits: int) -> bool:
    """Whether the tensor-core kernel of csrc/expert_ffn_q.cu computes
    these experts: bf16 activations over int8, or over int4 with
    per-channel scales."""
    per_channel = all(qparams[n].shape[-2] == 1 for n in ("w_gate_scale", "w_down_scale"))
    return x.dtype == torch.bfloat16 and (bits == 8 or per_channel)


def _expert_ffn_q_mma(x, eids, toks, qparams, bits: int, padded: bool) -> torch.Tensor:
    """bf16 x over per-channel int4 (bits 4) or int8 (bits 8) experts on
    tensor cores (csrc/expert_ffn_q.cu): y [R, nt, D] for rows of (expert
    id, token slots). With ``padded`` (the masked schedule's plan), a row
    whose id repeats the previous row's is a padding row: it reads no
    weights and gives zeros."""
    wg, wu, wd = (qparams[n] for n in ("w_gate", "w_up", "w_down"))
    scales = _q_scales(qparams)
    kernels.require_cuda(x, eids, toks, wg, wu, wd, *scales)
    r, nt = toks.shape
    d = x.shape[1]
    rows, k, f = wg.shape
    kernels.require(bits in (4, 8) and d == k * (8 // bits) and wu.shape == wg.shape
                    and wd.shape == (rows, f, k), "expert weight shapes do not match x")
    kernels.require(all(w.dtype == torch.int8 for w in (wg, wu, wd))
                    and scales[0].shape == scales[1].shape == (rows, 1, f)
                    and scales[2].shape == (rows, 1, d)
                    and all(s.dtype == torch.float32 for s in scales),
                    "the quantized tensor-core kernel takes int8(-packed) weights and "
                    "per-channel float32 scales")
    kernels.require(d % 4 == 0 and f % 4 == 0, f"quantized expert kernel needs D and F "
                    f"multiples of 4, got {d}, {f}")
    kernels.require(x.dtype == torch.bfloat16, "the quantized tensor-core kernel takes bf16 x")
    kernels.require(nt in (1, 2, 4, 8, 16), f"token slots per row must be 1/2/4/8/16, got {nt}")
    kernels.require(eids.dtype == torch.int32 and toks.dtype == torch.int32
                    and eids.shape == (r,), "eids [R] and toks [R, nt] must be int32")
    lib = kernels.lib()
    h = torch.empty(r, nt, f, dtype=torch.bfloat16, device=x.device)
    part = torch.empty(lib.vita_expert_ffn_q_splits(f), r, nt, d, dtype=torch.float32,
                       device=x.device)
    y = torch.empty(r, nt, d, dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    err = lib.vita_expert_ffn_q(
        x.data_ptr(), eids.data_ptr(), toks.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), *(s.data_ptr() for s in scales), h.data_ptr(), part.data_ptr(),
        y.data_ptr(), r, nt, d, f, bits, int(padded), kernels.stream_of(x))
    kernels.check_launch(err, "expert_ffn_q")
    return y


def expert_ffn_q_info() -> Dict[str, Dict[str, int]]:
    """Resources of the quantized tensor-core kernels on the current card
    (int4 and int8; up and down at up to 8 and 16 token slots;
    ``kernels.resources``)."""
    return kernels.resources(kernels.lib().vita_expert_ffn_q_info,
                             tuple(f"{fmt} {kind}, {nt} slots" for fmt in ("int4", "int8")
                                   for kind in ("up", "down") for nt in (8, 16)))


def masked_expert_ffn_q_cuda(x, act, m, qparams, bits: int, out_dtype=None) -> torch.Tensor:
    """One kernel row per active expert with all T tokens, int8 or int4;
    bf16 activations over int8 or per-channel int4 experts (the serving
    path's) take the tensor-core kernel, whose plan's padding rows read no
    weights."""
    rows = _active_rows(x, act)
    if _q_mma(x, qparams, bits):
        y = _expert_ffn_q_mma(x.contiguous(), *rows, qparams, bits, True)
    else:
        y = _q_launch(x, *rows, qparams, bits)
    kernels.count_launch("masked_expert_ffn" + _q_suffix(bits))
    return _masked_combine(m, y, x, out_dtype)


def _masked_q(x, topk_w, topk_idx, qparams, n_experts: int, bits: int,
              out_dtype=None) -> torch.Tensor:
    # grouped int4 scales keep the per-pair schedule, as in the JAX package
    grouped = bits == 4 and (qparams["w_gate_scale"].shape[-2] != 1
                             or qparams["w_down_scale"].shape[-2] != 1)
    min_t = MASKED_MIN_T_Q4 if bits == 4 else MASKED_MIN_T

    def masked(act, m):
        fn = masked_expert_ffn_q_cuda if kernels.on_cuda(x) else masked_expert_ffn_q_plain
        return fn(x, act, m, qparams, bits, out_dtype)

    return _schedule(x, topk_w, topk_idx, n_experts, MASKED_MAX_T + 1 if grouped else min_t,
                     lambda xr, ir: _gather_q(xr, ir, qparams, bits), masked, out_dtype)


def masked_expert_ffn_q(x, topk_w, topk_idx, qparams, n_experts: int,
                        out_dtype=None) -> torch.Tensor:
    """Weighted MoE FFN output [T, D] over int8 experts; each unique
    selected expert's weights are read once for 4 <= T <= 16."""
    return _masked_q(x, topk_w, topk_idx, qparams, n_experts, 8, out_dtype)


def masked_expert_ffn_q4(x, topk_w, topk_idx, qparams, n_experts: int,
                         out_dtype=None) -> torch.Tensor:
    """Weighted MoE FFN output [T, D] over int4 experts; the masked
    schedule for 8 <= T <= 16 with per-channel scales, else per pair."""
    return _masked_q(x, topk_w, topk_idx, qparams, n_experts, 4, out_dtype)


def selected_expert_ffn(mode: str, x, topk_w, topk_idx, params, n_experts: int,
                        out_dtype=None, pairs: bool = False) -> torch.Tensor:
    """The weighted output [T, D] of decode mode ``mode`` (moe.GATHER_MODES)
    over ``params``: the expert weights as they are ('gather'), or from
    quantize_expert_weights ('gather_q') / quantize_expert_weights_int4
    ('gather_q4'). ``out_dtype`` float32 leaves the weighted sum
    unrounded. ``pairs`` runs the per-(token, k) gather kernel (B3, B6,
    B7) at every T, never the masked schedule."""
    if pairs:
        if mode == "gather":
            eo = gather_expert_ffn(x, topk_idx, params["w_gate"], params["w_up"],
                                   params["w_down"])
        elif mode == "gather_q":
            eo = gather_expert_ffn_q(x, topk_idx, params)
        elif mode == "gather_q4":
            eo = gather_expert_ffn_q4(x, topk_idx, params)
        else:
            raise ValueError(f"no selected-expert decode mode {mode!r}; modes: {GATHER_MODES}")
        return _gather_combine(eo, topk_w, x, out_dtype)
    if mode == "gather":
        return masked_expert_ffn(x, topk_w, topk_idx, params["w_gate"], params["w_up"],
                                 params["w_down"], n_experts, out_dtype)
    if mode == "gather_q":
        return masked_expert_ffn_q(x, topk_w, topk_idx, params, n_experts, out_dtype)
    if mode == "gather_q4":
        return masked_expert_ffn_q4(x, topk_w, topk_idx, params, n_experts, out_dtype)
    raise ValueError(f"no selected-expert decode mode {mode!r}; modes: {GATHER_MODES}")


def moe_ffn_decode_q(qparams, x, top_k: int = 2):
    """int8 weight-only decode MoE: route in float32, run the selected
    experts. Returns (out [T, D], aux = 0)."""
    logits = x.float() @ qparams["router"].float()
    topk_w, topk_i, _ = route_topk(logits, top_k)
    out = _gather_combine(gather_expert_ffn_q(x, topk_i, qparams), topk_w, x)
    return out, torch.zeros((), dtype=torch.float32, device=x.device)
