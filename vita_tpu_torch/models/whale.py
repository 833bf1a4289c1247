"""Whale audio encoder, full-context path (vita_tpu.models.whale.forward).

As deployed with VITA: GlobalCMVN -> Conv2dSubsampling4 (two 3x3 stride-2
valid convs, T -> ((T-1)//2-1)//2) -> linear + LayerNorm + ReLU -> x*sqrt(d)
-> 24 pre-norm layers of Transformer-XL-style relative-position attention
without rel_shift and a ReLU FFN -> final LayerNorm. Attention is the
plain softmax branch of the JAX package (its default ``attn_backend``
'xla'); padded frames are masked as keys.

Parameters keep the JAX layout: conv kernels HWIO [3, 3, in, out] for a
[B, T, F, C] input, matrices used as x @ w. The streaming (chunked) encoder
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vita_tpu_torch.ops.attention import NEG_INF
from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhaleConfig:
    input_dim: int = 80
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def conv_out_freq(self) -> int:
        return ((self.input_dim - 1) // 2 - 1) // 2

    @staticmethod
    def vita(**kw) -> "WhaleConfig":
        return WhaleConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "WhaleConfig":
        base = dict(input_dim=80, hidden=32, n_layers=2, n_heads=4, ffn_dim=64)
        base.update(kw)
        return WhaleConfig(**base)


def subsampled_length(t):
    """Frame count after Conv2dSubsampling4 (two k=3 s=2 valid convs)."""
    return ((t - 1) // 2 - 1) // 2


def sinusoid_table(max_len: int, d: int) -> np.ndarray:
    """The WeNet positional table: sin on even dims, cos on odd."""
    pe = np.zeros((max_len, d), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def init_params(cfg: WhaleConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    dt, d, nl = cfg.dtype, cfg.hidden, cfg.n_layers
    s = d ** -0.5

    def nrm(shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=dt).mul_(scale)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    fo = d * cfg.conv_out_freq
    return {
        "cmvn": {
            "mean": torch.zeros(cfg.input_dim, dtype=torch.float32, device=device),
            "istd": torch.ones(cfg.input_dim, dtype=torch.float32, device=device),
        },
        "sub": {
            "conv1_w": nrm((3, 3, 1, d), 9 ** -0.5), "conv1_b": zeros(d),
            "conv2_w": nrm((3, 3, d, d), (9 * d) ** -0.5), "conv2_b": zeros(d),
            "out_w": nrm((fo, d), fo ** -0.5), "out_b": zeros(d),
        },
        "embed": {"w": nrm((d, d), s), "b": zeros(d), "ln_w": ones(d), "ln_b": zeros(d)},
        "layers": {
            "q_w": nrm((nl, d, d), s), "q_b": zeros(nl, d),
            "k_w": nrm((nl, d, d), s), "k_b": zeros(nl, d),
            "v_w": nrm((nl, d, d), s), "v_b": zeros(nl, d),
            "out_w": nrm((nl, d, d), s), "out_b": zeros(nl, d),
            "pos_w": nrm((nl, d, d), s),
            "pos_bias_u": nrm((nl, cfg.n_heads, cfg.head_dim)),
            "pos_bias_v": nrm((nl, cfg.n_heads, cfg.head_dim)),
            "ffn1_w": nrm((nl, d, cfg.ffn_dim), s), "ffn1_b": zeros(nl, cfg.ffn_dim),
            "ffn2_w": nrm((nl, cfg.ffn_dim, d), cfg.ffn_dim ** -0.5), "ffn2_b": zeros(nl, d),
            "norm1_w": ones(nl, d), "norm1_b": zeros(nl, d),
            "norm2_w": ones(nl, d), "norm2_b": zeros(nl, d),
        },
        "ln_final": {"w": ones(d), "b": zeros(d)},
    }


def _conv_subsample(sub: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, T, F] -> [B, T', hidden] via two stride-2 valid convs + linear.

    The JAX convs run NHWC x HWIO over (H=time, W=freq); here the same
    convs run NCHW x OIHW, and the flatten keeps torch's (channel, freq)
    order."""
    x = x[:, None]  # [B, 1, T, F]
    x = F.relu(F.conv2d(x, sub["conv1_w"].permute(3, 2, 0, 1), sub["conv1_b"], stride=2))
    x = F.relu(F.conv2d(x, sub["conv2_w"].permute(3, 2, 0, 1), sub["conv2_b"], stride=2))
    b, c, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    return x @ sub["out_w"] + sub["out_b"]


@torch.no_grad()
def forward(
    params: Params,
    cfg: WhaleConfig,
    speech: torch.Tensor,  # [B, T, input_dim] fbank features
    lengths: torch.Tensor,  # [B] valid frame counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (features [B, T', hidden], valid_mask [B, T'])."""
    b = speech.shape[0]
    x = (speech.float() - params["cmvn"]["mean"]) * params["cmvn"]["istd"]
    x = _conv_subsample(params["sub"], x.to(cfg.dtype))
    t_sub = x.shape[1]
    out_len = subsampled_length(lengths.long())
    valid = torch.arange(t_sub, device=x.device)[None, :] < out_len[:, None]

    e = params["embed"]
    x = F.relu(layer_norm(x @ e["w"] + e["b"], e["ln_w"], e["ln_b"], eps=1e-5))
    x = x * math.sqrt(cfg.hidden)
    pos = torch.from_numpy(sinusoid_table(t_sub, cfg.hidden)).to(x.device, cfg.dtype)
    bias = torch.where(valid[:, None, None, :], 0.0, NEG_INF).to(torch.float32)

    nh, hd = cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["norm1_w"], lp["norm1_b"], cfg.ln_eps)
        q = (h @ lp["q_w"] + lp["q_b"]).reshape(b, t_sub, nh, hd)
        k = (h @ lp["k_w"] + lp["k_b"]).reshape(b, t_sub, nh, hd)
        v = (h @ lp["v_w"] + lp["v_b"]).reshape(b, t_sub, nh, hd)
        p = (pos @ lp["pos_w"]).reshape(t_sub, nh, hd)
        # Transformer-XL terms without rel_shift: content (q+u)·k plus
        # position (q+v)·p
        ac = torch.einsum("bqhd,bkhd->bhqk", (q + lp["pos_bias_u"]).float(), k.float())
        bd = torch.einsum("bqhd,khd->bhqk", (q + lp["pos_bias_v"]).float(), p.float())
        probs = torch.softmax((ac + bd) * scale + bias, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t_sub, cfg.hidden)
        x = x + (attn @ lp["out_w"] + lp["out_b"])
        h = layer_norm(x, lp["norm2_w"], lp["norm2_b"], cfg.ln_eps)
        h = F.relu(h @ lp["ffn1_w"] + lp["ffn1_b"])
        x = x + (h @ lp["ffn2_w"] + lp["ffn2_b"])
    x = layer_norm(x, params["ln_final"]["w"], params["ln_final"]["b"], cfg.ln_eps)
    return x, valid
