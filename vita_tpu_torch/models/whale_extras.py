"""Optional Whale encoder components (vita_tpu.models.whale_extras):
constructible, unused by the shipped VITA configuration, kept for parity
with the reference's extras.

  - FSMN memory layer (left taps include the current frame, right taps
    look ahead, each with its dilation);
  - causal or centred Conv1d layer with folded BatchNorm and a residual;
  - depthwise temporal (DTC) block;
  - soft-attention pooling;
  - a selective state-space (Mamba-style) layer: the recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t,
    which the JAX package runs as an associative scan and this module as a
    sequential loop over time (the same recurrence in float32).

init_* build the parameters; the apply functions are pure. BatchNorm is
folded to inference-mode scale and shift, as the reference uses it at
eval. Parameters keep the JAX layout ([k, in, out] conv kernels, x @ w).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _nrm(shape, scale, generator, device, dtype):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, T, C] moved n frames later (n > 0) or earlier (n < 0) along
    T, zero-filled."""
    if n == 0:
        return x
    if n > 0:
        return F.pad(x, (0, 0, n, 0))[:, : x.shape[1]]
    return F.pad(x, (0, 0, 0, -n))[:, -n:]


# -- FSMN --------------------------------------------------------------
def init_fsmn(input_dim, out_dim, hidden_dim, generator, left=1, right=1, device=None,
              dtype=torch.float32) -> Params:
    nrm = lambda shape, s: _nrm(shape, s, generator, device, dtype)
    return {
        "w_in": nrm((input_dim, hidden_dim), input_dim ** -0.5),
        "b_in": torch.zeros(hidden_dim, dtype=dtype, device=device),
        # depthwise memory taps: the left ones include the current frame
        "mem_left": nrm((left + 1, hidden_dim), (left + 1) ** -0.5),
        "mem_right": nrm((right, hidden_dim), max(right, 1) ** -0.5),
        "w_out": nrm((hidden_dim, out_dim), hidden_dim ** -0.5),
        "b_out": torch.zeros(out_dim, dtype=dtype, device=device),
    }


def fsmn_layer(params: Params, x: torch.Tensor, hidden: Optional[torch.Tensor] = None,
               left_dilation: int = 1, right_dilation: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (relu(out) [B, T, out_dim], the memory state p_out)."""
    p_in = x @ params["w_in"] + params["b_in"]
    lk, rk = params["mem_left"].shape[0], params["mem_right"].shape[0]
    p_left = torch.zeros_like(p_in)
    for i in range(lk):  # tap i looks (lk-1-i) * dilation frames back
        p_left = p_left + _shift(p_in, (lk - 1 - i) * left_dilation) * params["mem_left"][i]
    p_right = torch.zeros_like(p_in)
    for i in range(rk):  # tap i looks (i+1) * dilation frames ahead
        p_right = p_right + _shift(p_in, -(i + 1) * right_dilation) * params["mem_right"][i]
    p_out = p_in + p_left + p_right
    if hidden is not None:
        p_out = p_out + hidden
    return torch.relu(p_out @ params["w_out"] + params["b_out"]), p_out


# -- Conv1d layer -------------------------------------------------------
def init_conv1d_layer(input_dim, output_dim, kernel, generator, device=None,
                      dtype=torch.float32) -> Params:
    return {
        "w": _nrm((kernel, input_dim, output_dim), (kernel * input_dim) ** -0.5,
                  generator, device, dtype),
        "b": torch.zeros(output_dim, dtype=dtype, device=device),
        "bn_scale": torch.ones(output_dim, dtype=dtype, device=device),
        "bn_shift": torch.zeros(output_dim, dtype=dtype, device=device),
    }


def _time_pad(x: torch.Tensor, kernel: int, dilation: int, causal: bool) -> torch.Tensor:
    """[B, T, C] -> [B, C, T + pad]: left pad (causal) or centred pad."""
    lorder = (kernel - 1) * dilation
    if not causal and lorder % 2:
        # centred padding needs an odd kernel span: an even one would
        # silently shorten the output by one off-centre frame
        raise ValueError(f"non-causal conv needs an odd effective kernel; got kernel="
                         f"{kernel}, dilation={dilation}")
    pad = (lorder, 0) if causal else (lorder // 2, lorder // 2)
    return F.pad(x.transpose(1, 2), pad)


def conv1d_layer(params: Params, x: torch.Tensor, stride: int = 1, causal: bool = True,
                 dilation: int = 1, residual: bool = True) -> torch.Tensor:
    """[B, T, D] -> [B, T', out]: conv, folded BatchNorm, residual (stride 1,
    equal widths), ReLU."""
    w = params["w"]  # [k, in, out]
    h = _time_pad(x, w.shape[0], dilation, causal)
    h = F.conv1d(h, w.permute(2, 1, 0), params["b"], stride=stride,
                 dilation=dilation).transpose(1, 2)
    h = h * params["bn_scale"] + params["bn_shift"]
    if stride == 1 and residual and x.shape[-1] == h.shape[-1]:
        h = h + x
    return torch.relu(h)


# -- DTC block ----------------------------------------------------------
def init_dtc(dim, kernel, generator, device=None, dtype=torch.float32) -> Params:
    nrm = lambda shape, s: _nrm(shape, s, generator, device, dtype)
    ones = lambda: torch.ones(dim, dtype=dtype, device=device)
    zeros = lambda: torch.zeros(dim, dtype=dtype, device=device)
    return {
        "depth_w": nrm((kernel, dim), kernel ** -0.5), "depth_b": zeros(),
        "pw1_w": nrm((dim, dim), dim ** -0.5), "pw1_b": zeros(),
        "pw2_w": nrm((dim, dim), dim ** -0.5), "pw2_b": zeros(),
        "bn1_scale": ones(), "bn1_shift": zeros(),
        "bn2_scale": ones(), "bn2_shift": zeros(),
        "bn3_scale": ones(), "bn3_shift": zeros(),
    }


def dtc_block(params: Params, x: torch.Tensor, stride: int = 1, causal: bool = True,
              dilation: int = 1) -> torch.Tensor:
    """Depthwise temporal conv -> BN -> pointwise -> BN -> ReLU ->
    pointwise -> BN (+ residual at stride 1) -> ReLU."""
    w = params["depth_w"]  # [k, D]
    h = _time_pad(x, w.shape[0], dilation, causal)
    h = F.conv1d(h, w.T[:, None, :], params["depth_b"], stride=stride, dilation=dilation,
                 groups=x.shape[-1]).transpose(1, 2)
    h = h * params["bn1_scale"] + params["bn1_shift"]
    h = h @ params["pw1_w"] + params["pw1_b"]
    h = torch.relu(h * params["bn2_scale"] + params["bn2_shift"])
    h = h @ params["pw2_w"] + params["pw2_b"]
    h = h * params["bn3_scale"] + params["bn3_shift"]
    if stride == 1:
        h = h + x
    return torch.relu(h)


# -- soft-attention pooling ---------------------------------------------
def init_soft_attention(in_dim, hidden_dim, generator, device=None,
                        dtype=torch.float32) -> Params:
    return {
        "q": torch.rand(hidden_dim, generator=generator, device=device, dtype=dtype),
        "w": _nrm((in_dim, hidden_dim), in_dim ** -0.5, generator, device, dtype),
        "b": torch.zeros(hidden_dim, dtype=dtype, device=device),
    }


def soft_attention(params: Params, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention pooling [B, T, D] -> [B, D]; ``mask`` (True = drop) zeroes
    a frame's weight after the softmax, as the reference does."""
    hidden = torch.tanh(x @ params["w"] + params["b"])
    score = torch.softmax(torch.einsum("btd,d->bt", hidden, params["q"]), dim=-1)
    if mask is not None:
        score = torch.where(mask, 0.0, score)
    return torch.einsum("bt,btd->bd", score, x)


# -- selective SSM (Mamba-style) -----------------------------------------
def init_ssm(dim, generator, state_dim=16, dt_rank=None, device=None,
             dtype=torch.float32) -> Params:
    dt_rank = dt_rank or max(dim // 16, 1)
    nrm = lambda shape, s: _nrm(shape, s, generator, device, dtype)
    a_log = torch.log(torch.arange(1, state_dim + 1, dtype=torch.float32, device=device))
    return {
        # A negative-real diagonal (S4D-real init)
        "a_log": a_log[None, :] * torch.ones(dim, 1, device=device),
        "d": torch.ones(dim, dtype=dtype, device=device),
        "w_b": nrm((dim, state_dim), dim ** -0.5),
        "w_c": nrm((dim, state_dim), dim ** -0.5),
        "w_dt": nrm((dim, dt_rank), dim ** -0.5),
        "w_dt_proj": nrm((dt_rank, dim), dt_rank ** -0.5),
        "dt_bias": torch.zeros(dim, dtype=dtype, device=device),
    }


def ssm_scan(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Selective state-space layer, x [B, T, D] -> y [B, T, D]: h_t = a_t
    h_{t-1} + b_t with a_t = exp(dt_t A) and b_t = dt_t x_t B_t, one time
    step after another."""
    a = -torch.exp(params["a_log"])  # [D, N]
    dt = F.softplus((x @ params["w_dt"]) @ params["w_dt_proj"] + params["dt_bias"])  # [B, T, D]
    bmat, cmat = x @ params["w_b"], x @ params["w_c"]  # [B, T, N]
    decay = torch.exp(dt[..., None] * a)  # [B, T, D, N]
    drive = (dt * x)[..., None] * bmat[:, :, None, :]
    h = torch.zeros_like(drive[:, 0])
    hs = []
    for t in range(x.shape[1]):
        h = decay[:, t] * h + drive[:, t]
        hs.append(h)
    return torch.einsum("btdn,btn->btd", torch.stack(hs, dim=1), cmat) + x * params["d"]
