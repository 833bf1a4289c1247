"""Mixtral MoE decoder-only LM (vita_tpu.models.mixtral).

Parameters are a plain dict of tensors in the JAX package's layout, layers
stacked on a leading L axis: attn wq [L, D, Hq*hd] (used as x @ w), wk/wv
[L, D, Hkv*hd], wo [L, Hq*hd, D]; moe router [L, D, E], w_gate/w_up
[L, E, D, F], w_down [L, E, F, D]; ln_attn/ln_moe [L, D]; embed [V, D];
lm_head [D, V]. The layer loop is a Python loop.

``forward`` serves three paths:
  - cacheless (whole sequence, causal + validity mask);
  - linear scratch {'k','v','pos'} [L, B, S_max, Hkv, hd]: a prefill chunk
    writes its rows into the scratch IN PLACE and attends over it;
  - paged pool {'k_pages','v_pages','table','pos'[,'active']} (an int8
    pool adds 'k_scale','v_scale'): single-token decode against
    ops.paged_attention, pool updated IN PLACE.
MoE runs ``dense`` (every expert, exact) or a selected-expert decode mode
through ops.moe_decode over flat layer*E+e ids into the stacked weights:
``gather`` (weights as they are), ``gather_q`` / ``gather_q4`` (expert
weights from ``quantize_moe_for_decode``, int8 / int4).

Shapes follow the deployed VITA config
(web_demo/vllm_tools/model_weight_file/config.json:17-44): 32L, 4096d,
32 q-heads / 8 kv-heads, 8 experts top-2, ffn 14336, rope 1e6, vocab 51760.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from vita_tpu_torch.ops.attention import NEG_INF, mha_xla
from vita_tpu_torch.ops.flash_attention import flash_mha
from vita_tpu_torch.ops.moe import GATHER_MODES, MODES, load_balancing_loss, moe_ffn, route_topk
from vita_tpu_torch.ops import moe_decode
from vita_tpu_torch.ops.norms import rms_norm
from vita_tpu_torch.ops.paged_attention import paged_attention, write_kv_rows
from vita_tpu_torch.ops.rope import apply_rope

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 51760
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    top_k: int = 2
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    moe_mode: str = "dense"  # 'dense' | 'gather' | 'gather_q' | 'gather_q4'
    attn_backend: str = "xla"  # 'xla' | 'flash'
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def vita_8x7b(**kw) -> "MixtralConfig":
        return MixtralConfig(**{**dict(dtype=torch.bfloat16, attn_backend="flash"), **kw})

    @staticmethod
    def tiny(**kw) -> "MixtralConfig":
        """Small config for tests / CPU development."""
        base = dict(
            vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, n_experts=4, top_k=2,
        )
        base.update(kw)
        return MixtralConfig(**base)


def init_params(cfg: MixtralConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    dt, d, hd, nl = cfg.dtype, cfg.d_model, cfg.head_dim, cfg.n_layers
    e, f = cfg.n_experts, cfg.d_ff

    def nrm(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return w.mul_(scale)

    s = d ** -0.5
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "embed": nrm((cfg.vocab_size, d), s),
        "layers": {
            "attn": {
                "wq": nrm((nl, d, cfg.n_heads * hd), s),
                "wk": nrm((nl, d, cfg.n_kv_heads * hd), s),
                "wv": nrm((nl, d, cfg.n_kv_heads * hd), s),
                "wo": nrm((nl, cfg.n_heads * hd, d), s),
            },
            "moe": {
                "router": nrm((nl, d, e), s),
                "w_gate": nrm((nl, e, d, f), s),
                "w_up": nrm((nl, e, d, f), s),
                "w_down": nrm((nl, e, f, d), f ** -0.5),
            },
            "ln_attn": ones(nl, d),
            "ln_moe": ones(nl, d),
        },
        "ln_final": ones(d),
        "lm_head": nrm((d, cfg.vocab_size), s),
    }


def quantize_moe_for_decode(params: Params, bits: int = 8) -> Params:
    """Weight-only quantization of every layer's expert weights for the
    'gather_q' (bits 8) or 'gather_q4' (bits 4, per-channel scales) decode
    modes. Every other tensor is shared with ``params``, not copied."""
    if bits == 8:
        qmoe = moe_decode.quantize_expert_weights(params["layers"]["moe"])
    elif bits == 4:
        qmoe = moe_decode.quantize_expert_weights_int4(params["layers"]["moe"])
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    return {**params, "layers": {**params["layers"], "moe": qmoe}}


def _qkv(lp: Params, cfg: MixtralConfig, x, positions):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"]).reshape(b, s, hq, hd)
    k = (x @ lp["wk"]).reshape(b, s, hkv, hd)
    v = (x @ lp["wv"]).reshape(b, s, hkv, hd)
    q, k = apply_rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def _attention_block(
    lp: Params,
    cfg: MixtralConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    kv_valid: torch.Tensor,  # [B, S_kv] bool
    layer_k: Optional[torch.Tensor],  # scratch [B, S_max, Hkv, hd] or None
    layer_v: Optional[torch.Tensor],
    cache_pos: Optional[torch.Tensor],  # [B]
) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(lp, cfg, x, positions)
    if layer_k is not None:
        # rows land at cache_pos + i; rows past the scratch are dropped
        s_max = layer_k.shape[1]
        s_idx = cache_pos.long()[:, None] + torch.arange(s, device=x.device)[None, :]
        b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s)
        keep = (s_idx >= 0) & (s_idx < s_max)
        layer_k[b_idx[keep], s_idx[keep]] = k[keep].to(layer_k.dtype)
        layer_v[b_idx[keep], s_idx[keep]] = v[keep].to(layer_v.dtype)
        k_all, v_all = layer_k, layer_v
        kv_positions = torch.arange(s_max, device=x.device)[None, :]
    else:
        k_all, v_all = k, v
        kv_positions = positions

    if cfg.attn_backend == "flash":
        # kv rows sit at their absolute positions and validity is a prefix,
        # so causal + kv_len masking inside the kernel is exact
        out = flash_mha(
            q, k_all.to(q.dtype), v_all.to(q.dtype),
            kv_len=kv_valid.sum(1).to(torch.int32),
            q_offset=positions[:, 0].to(torch.int32), causal=True,
        )
    elif cfg.attn_backend == "xla":
        causal = kv_positions[:, None, :] <= positions[:, :, None]  # [B, Sq, Skv]
        keep = causal & kv_valid[:, None, :]
        bias = torch.where(keep[:, None], 0.0, NEG_INF).to(torch.float32)
        out = mha_xla(q, k_all.to(q.dtype), v_all.to(q.dtype), bias=bias)
    else:
        raise ValueError(f"unknown attn_backend {cfg.attn_backend!r}")
    return out.reshape(b, s, -1) @ lp["wo"]


def _attention_block_paged(
    lp: Params,
    cfg: MixtralConfig,
    x: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,  # [B, 1]
    cache: Params,
    layer_idx: int,
) -> torch.Tensor:
    """Decode attention against the paged pool; writes this token's kv row
    first (inactive slots are dropped and attend nothing). An int8 pool
    (scales in the cache) quantizes the row on the way in and keeps q in
    x's dtype."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("paged cache supports single-token decode only")
    q, k, v = _qkv(lp, cfg, x, positions)
    pos, active = cache["pos"], cache.get("active")
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    write_kv_rows(cache["k_pages"], cache["v_pages"], layer_idx, cache["table"],
                  pos, k[:, 0], v[:, 0], active, k_scale=ks, v_scale=vs)
    lengths = pos + 1
    if active is not None:
        lengths = torch.where(active, lengths, 0)
    q_dt = x.dtype if ks is not None else cache["k_pages"].dtype
    out = paged_attention(
        q[:, 0].to(q_dt), cache["k_pages"], cache["v_pages"],
        cache["table"], lengths, layer_idx, k_scale=ks, v_scale=vs,
    ).to(x.dtype)
    return out.reshape(b, s, -1) @ lp["wo"]


def _moe_gather_layer(h2d, router, flat_w, layer_idx: int, cfg: MixtralConfig, tm_flat):
    router_logits = h2d.float() @ router.float()
    topk_w, topk_i, probs = route_topk(router_logits, cfg.top_k)
    aux = load_balancing_loss(probs, topk_i, cfg.n_experts, tm_flat)
    idx = topk_i + layer_idx * cfg.n_experts
    out = moe_decode.selected_expert_ffn(cfg.moe_mode, h2d, topk_w, idx, flat_w,
                                         n_experts=cfg.n_experts)
    return out.to(h2d.dtype), aux


@torch.no_grad()
def forward(
    params: Params,
    cfg: MixtralConfig,
    input_ids: Optional[torch.Tensor] = None,  # [B, S]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, D]
    positions: Optional[torch.Tensor] = None,  # [B, S]
    attn_valid: Optional[torch.Tensor] = None,  # [B, S_kv] bool
    cache: Optional[Params] = None,
    token_mask: Optional[torch.Tensor] = None,  # [B, S] real tokens, for aux loss
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits [B, S, V] or final-norm hidden [B, S, D],
    cache with the advanced ``pos`` or None, moe_aux_loss scalar).

    Cache tensors are updated in place and returned in the new cache."""
    if cfg.moe_mode not in MODES:
        raise NotImplementedError(
            f"moe_mode {cfg.moe_mode!r} is not ported; use one of {MODES}"
        )
    paged = cache is not None and "k_pages" in cache
    if inputs_embeds is None:
        inputs_embeds = params["embed"][input_ids.long()]
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        base = cache["pos"][:, None] if cache is not None else 0
        positions = torch.arange(s, device=dev)[None, :].expand(b, s) + base
    if attn_valid is None and not paged:
        kv_len = cache["k"].shape[2] if cache is not None else s
        attn_valid = torch.ones(b, kv_len, dtype=torch.bool, device=dev)
    tm_flat = None if token_mask is None else token_mask.reshape(-1)

    layers = params["layers"]
    gather = cfg.moe_mode in GATHER_MODES
    # expert weights (and quantization scales) as flat [L*E, ...] views
    flat_w = ({k: v.flatten(0, 1) for k, v in layers["moe"].items() if k != "router"}
              if gather else None)
    x = inputs_embeds
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers["attn"].items()}
        h = rms_norm(x, layers["ln_attn"][i], cfg.rms_eps)
        if paged:
            attn_out = _attention_block_paged(lp, cfg, h, positions, cache, i)
        else:
            attn_out = _attention_block(
                lp, cfg, h, positions, attn_valid,
                cache["k"][i] if cache is not None else None,
                cache["v"][i] if cache is not None else None,
                cache["pos"] if cache is not None else None,
            )
        x = x + attn_out
        h = rms_norm(x, layers["ln_moe"][i], cfg.rms_eps).reshape(b * s, d)
        if gather:
            moe_out, aux = _moe_gather_layer(h, layers["moe"]["router"][i], flat_w,
                                             i, cfg, tm_flat)
        else:
            moe_out, aux = moe_ffn({k: v[i] for k, v in layers["moe"].items()}, h,
                                   cfg.top_k, mode="dense", token_mask=tm_flat)
        x = x + moe_out.reshape(b, s, d)
        aux_total = aux_total + aux

    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    logits = x if return_hidden else x @ params["lm_head"]
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["pos"] = cache["pos"] + s
    return logits, new_cache, aux_total / cfg.n_layers
