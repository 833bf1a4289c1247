"""Whale audio encoder (vita_tpu.models.whale): the full-context forward
and the streaming (chunked) encoder.

As deployed with VITA: GlobalCMVN -> Conv2dSubsampling4 (two 3x3 stride-2
valid convs, T -> ((T-1)//2-1)//2) -> linear + LayerNorm + ReLU -> x*sqrt(d)
-> 24 pre-norm layers of Transformer-XL-style relative-position attention
without rel_shift and a ReLU FFN -> final LayerNorm; padded frames are
masked as keys. ``attn_backend`` picks the attention: 'xla' (the default)
is plain softmax over float32 scores [B, H, T', T']; 'flash' (full
context only) folds the relative-position terms into one augmented head
dim and runs the flash kernel (ops.flash_attention, B1 at head dim 65),
which never holds the scores: the way to encode long sessions.

``forward`` takes an optional chunk mask [T', T'] (``chunk_mask``) for
chunk-causal attention. ``streaming_init`` / ``streaming_step`` encode a
stream block by block: the state carries the unconsumed raw frames (the
subsampling convs need a 7-frame receptive field), per-layer K/V of the
last ``left_context`` subsampled frames and the absolute position offset,
and stays on the device (no step reads back to the host). Concatenated,
the valid outputs equal ``forward`` under the matching chunk mask.
Streaming and chunk-masked forwards take the softmax path under either
backend.

Parameters keep the JAX layout: conv kernels HWIO [3, 3, in, out] for a
[B, T, F, C] input, matrices used as x @ w.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vita_tpu_torch.ops.attention import NEG_INF
from vita_tpu_torch.ops.flash_attention import flash_mha
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
    max_positions: int = 5000  # sinusoid table rows; streaming positions wrap
    attn_backend: str = "xla"  # 'xla' | 'flash' (full context only)
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


def param_specs(cfg: WhaleConfig) -> Params:
    """Spec tuples mirroring init_params' tree, equal to the JAX package's
    PartitionSpecs."""
    ff = {
        "q_w": (None, "fsdp", "model"), "q_b": (None, None),
        "k_w": (None, "fsdp", "model"), "k_b": (None, None),
        "v_w": (None, "fsdp", "model"), "v_b": (None, None),
        "out_w": (None, "model", "fsdp"), "out_b": (None, None),
        "pos_w": (None, "fsdp", "model"),
        "pos_bias_u": (None, None, None), "pos_bias_v": (None, None, None),
        "ffn1_w": (None, "fsdp", "model"), "ffn1_b": (None, None),
        "ffn2_w": (None, "model", "fsdp"), "ffn2_b": (None, None),
        "norm1_w": (None, None), "norm1_b": (None, None),
        "norm2_w": (None, None), "norm2_b": (None, None),
    }
    return {
        "cmvn": {"mean": (None,), "istd": (None,)},
        "sub": {
            "conv1_w": (None, None, None, "model"), "conv1_b": (None,),
            "conv2_w": (None, None, None, "model"), "conv2_b": (None,),
            "out_w": ("fsdp", None), "out_b": (None,),
        },
        "embed": {"w": ("fsdp", None), "b": (None,), "ln_w": (None,), "ln_b": (None,)},
        "layers": ff,
        "ln_final": {"w": (None,), "b": (None,)},
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


def chunk_mask(t: int, chunk_size: int, left_chunks: int = -1) -> np.ndarray:
    """WeNet chunked attention mask [t, t]: frame i attends within its
    chunk and up to ``left_chunks`` chunks back (all history if -1)."""
    chunk_of = np.arange(t) // chunk_size
    q = chunk_of[:, None]
    kv = chunk_of[None, :]
    ok = kv <= q
    if left_chunks >= 0:
        ok &= kv >= q - left_chunks
    return ok


def forward(
    params: Params,
    cfg: WhaleConfig,
    speech: torch.Tensor,  # [B, T, input_dim] fbank features
    lengths: torch.Tensor,  # [B] valid frame counts
    attn_chunk_mask: Optional[torch.Tensor] = None,  # [T', T'] bool (streaming)
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
    keep = valid[:, None, None, :]  # key padding [B, 1, 1, T']
    if attn_chunk_mask is not None:
        keep = keep & torch.as_tensor(attn_chunk_mask, device=x.device)[None, None]
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)

    nh, hd = cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    flash = cfg.attn_backend == "flash" and attn_chunk_mask is None
    if flash:  # the augmented head dim's column of q (ones) and of v (zeros)
        ones = torch.ones(b, t_sub, nh, 1, dtype=x.dtype, device=x.device)
        zeros = torch.zeros_like(ones)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["norm1_w"], lp["norm1_b"], cfg.ln_eps)
        q = (h @ lp["q_w"] + lp["q_b"]).reshape(b, t_sub, nh, hd)
        k = (h @ lp["k_w"] + lp["k_b"]).reshape(b, t_sub, nh, hd)
        v = (h @ lp["v_w"] + lp["v_b"]).reshape(b, t_sub, nh, hd)
        p = (pos @ lp["pos_w"]).reshape(t_sub, nh, hd)
        if flash:
            # without rel_shift, (q+u)·k + (q+v)·p = q·(k+p) + [u·k + v·p]:
            # keys k+p plus a per-key bias, which rides an extra head dim
            # (q gets a 1, k the bias, v a 0)
            key_bias = (torch.einsum("hd,bkhd->bkh", lp["pos_bias_u"], k)
                        + torch.einsum("hd,khd->kh", lp["pos_bias_v"], p)[None])
            q_aug = torch.cat([q, ones], dim=-1)
            k_aug = torch.cat([k + p[None], key_bias[..., None].to(k.dtype)], dim=-1)
            v_aug = torch.cat([v, zeros], dim=-1)
            attn = flash_mha(q_aug, k_aug, v_aug, kv_len=out_len, causal=False,
                             scale=scale)[..., :hd].reshape(b, t_sub, cfg.hidden)
        else:
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


# ---------------------------------------------------------------------------
# streaming (chunked) inference
# ---------------------------------------------------------------------------
TAIL_MAX = 8  # raw frames carried between chunks (receptive-field overlap)


@functools.lru_cache(maxsize=8)
def _pe_table(n: int, d: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The sinusoid table on ``device``, built once per (rows, width)."""
    return torch.from_numpy(sinusoid_table(n, d)).to(device, dtype)


def streaming_init(cfg: WhaleConfig, batch: int, chunk_frames: int,
                   left_context: int = 128, device=None) -> Params:
    """State for streaming_step, on ``device``. ``chunk_frames`` is raw
    fbank frames per step; ``left_context`` the attention span kept per
    layer, in subsampled frames."""
    del chunk_frames  # the state does not depend on it
    kv = (cfg.n_layers, batch, left_context, cfg.n_heads, cfg.head_dim)
    scalar = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return {
        "raw_tail": torch.zeros(batch, TAIL_MAX, cfg.input_dim, device=device),
        "tail_len": scalar(),
        "k": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "ctx_len": scalar(),
        "pos_offset": scalar(),
    }


@torch.no_grad()
def streaming_step(
    params: Params, cfg: WhaleConfig, state: Params, chunk: torch.Tensor,
    chunk_len=None,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """Encode one chunk [B, chunk_frames, input_dim] of fbank features.

    Returns (features [B, max_out, hidden], valid [B, max_out], new state).
    ``chunk_len`` (an int or an int32 tensor; default chunk_frames) counts
    the real leading frames of ``chunk``: a final flush rarely fills a
    block, and its padding must never become a key (attention is
    bidirectional within the chunk). Relative positions index the sinusoid
    table by absolute key position, modulo its size, with no rel_shift."""
    b, chunk_frames, _ = chunk.shape
    dev = chunk.device
    max_out = subsampled_length(TAIL_MAX + chunk_frames)
    left = state["k"].shape[2]
    nh, hd = cfg.n_heads, cfg.head_dim
    if chunk_len is None:
        chunk_len = chunk_frames
    chunk_len = torch.as_tensor(chunk_len, dtype=torch.int32, device=dev)

    x_cm = (chunk.float() - params["cmvn"]["mean"]) * params["cmvn"]["istd"]
    # [tail || chunk]: the tail is right-aligned in its buffer, so one roll
    # by TAIL_MAX - tail_len makes the valid frames contiguous from 0
    total_buf = TAIL_MAX + chunk_frames
    buf = torch.cat([state["raw_tail"], x_cm], dim=1)
    tail_len = state["tail_len"]
    ar_buf = torch.arange(total_buf, device=dev)
    buf = buf[:, (ar_buf + TAIL_MAX - tail_len) % total_buf]
    t_total = tail_len + chunk_len
    # fewer than 3 buffered frames subsample to nothing (the formula goes
    # negative there, which would corrupt the carried state)
    t_out = subsampled_length(t_total).clamp_min(0)
    new_tail_len = (t_total - 4 * t_out).clamp(0, TAIL_MAX)

    feats = _conv_subsample(params["sub"], buf.to(cfg.dtype))[:, :max_out]
    ar_out = torch.arange(max_out, device=dev)
    out_valid = (ar_out < t_out)[None].expand(b, max_out)

    # carry the unconsumed raw frames right-aligned: slot TAIL_MAX-1 holds
    # the newest frame (buffer row t_total-1)
    ar_tail = torch.arange(TAIL_MAX, device=dev)
    new_tail = buf[:, (t_total - TAIL_MAX + ar_tail).clamp(0, total_buf - 1)]
    keep = (ar_tail >= TAIL_MAX - new_tail_len)[None, :, None]
    new_tail = torch.where(keep, new_tail, 0.0)

    e = params["embed"]
    h = F.relu(layer_norm(feats @ e["w"] + e["b"], e["ln_w"], e["ln_b"], eps=1e-5))
    h = h * math.sqrt(cfg.hidden)

    # absolute positions of the cached context and of this chunk's outputs
    pos_offset, ctx_len = state["pos_offset"], state["ctx_len"]
    ar_left = torch.arange(left, device=dev)
    kv_abs = torch.cat([pos_offset - ctx_len + ar_left, pos_offset + ar_out])
    kv_valid = torch.cat([ar_left < ctx_len, ar_out < t_out])
    # positions wrap at the table size (the reference's pe_index % max_len)
    pe = _pe_table(cfg.max_positions, cfg.hidden, dev, cfg.dtype)
    pe_rows = pe[torch.remainder(kv_abs, cfg.max_positions).long()]
    scale = 1.0 / math.sqrt(hd)

    # each layer's new cache: the last `left` valid keys of [ctx | new],
    # valid entries first in their order, left-aligned
    total = left + max_out
    order = torch.arange(total, device=dev)
    perm = torch.argsort(torch.where(kv_valid, 0, 1) * total + order)
    n_valid = ctx_len + t_out
    start = (n_valid - torch.clamp(n_valid, max=left)).clamp_min(0)
    sel = perm[(start + ar_left).clamp(0, total - 1)]

    new_k, new_v = [], []
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        hn = layer_norm(h, lp["norm1_w"], lp["norm1_b"], cfg.ln_eps)
        q = (hn @ lp["q_w"] + lp["q_b"]).reshape(b, max_out, nh, hd)
        k = (hn @ lp["k_w"] + lp["k_b"]).reshape(b, max_out, nh, hd)
        v = (hn @ lp["v_w"] + lp["v_b"]).reshape(b, max_out, nh, hd)
        k_all = torch.cat([state["k"][i], k.to(state["k"].dtype)], dim=1)
        v_all = torch.cat([state["v"][i], v.to(state["v"].dtype)], dim=1)
        p_all = (pe_rows @ lp["pos_w"]).reshape(total, nh, hd)
        ac = torch.einsum("bqhd,bkhd->bhqk", (q + lp["pos_bias_u"]).float(), k_all.float())
        bd = torch.einsum("bqhd,khd->bhqk", (q + lp["pos_bias_v"]).float(), p_all.float())
        logits = torch.where(kv_valid, (ac + bd) * scale, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v_all.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v_all).reshape(b, max_out, cfg.hidden)
        h = h + (attn @ lp["out_w"] + lp["out_b"])
        hn = layer_norm(h, lp["norm2_w"], lp["norm2_b"], cfg.ln_eps)
        hn = F.relu(hn @ lp["ffn1_w"] + lp["ffn1_b"])
        h = h + (hn @ lp["ffn2_w"] + lp["ffn2_b"])
        new_k.append(k_all[:, sel])
        new_v.append(v_all[:, sel])
    h = layer_norm(h, params["ln_final"]["w"], params["ln_final"]["b"], cfg.ln_eps)

    new_state = {
        "raw_tail": new_tail,
        "tail_len": new_tail_len.to(torch.int32),
        "k": torch.stack(new_k),
        "v": torch.stack(new_v),
        "ctx_len": torch.clamp(n_valid, max=left).to(torch.int32),
        "pos_offset": (pos_offset + t_out).to(torch.int32),
    }
    return h, out_valid, new_state
