"""Mixtral MoE decoder-only LM (vita_tpu.models.mixtral).

Parameters are a plain dict of tensors in the JAX package's layout, layers
stacked on a leading L axis: attn wq [L, D, Hq*hd] (used as x @ w), wk/wv
[L, D, Hkv*hd], wo [L, Hq*hd, D]; moe router [L, D, E], w_gate/w_up
[L, E, D, F], w_down [L, E, F, D]; ln_attn/ln_moe [L, D]; embed [V, D];
lm_head [D, V]. The layer loop is a Python loop.

``forward`` serves three paths:
  - cacheless (whole sequence, causal + validity mask), the training path:
    gradients pass through it, and with ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` on the
    layer scan body) when autograd records;
  - linear scratch {'k','v','pos'} [L, B, S_max, Hkv, hd]: a prefill chunk
    writes its rows into the scratch IN PLACE and attends over it;
  - paged pool {'k_pages','v_pages','table','pos'[,'active']} (an int8
    pool adds 'k_scale','v_scale'): single-token decode against
    ops.paged_attention, pool updated IN PLACE.
MoE runs a selected-expert decode mode through ops.moe_decode over flat
layer*E+e ids into the stacked weights: ``gather`` (weights as they are),
``gather_q`` / ``gather_q4`` (expert weights from
``quantize_moe_for_decode``, int8 / int4); or ops.moe.moe_ffn on each
layer's views of the stacked weights: ``dense`` (every expert, exact),
``gmm`` (grouped matmul, exact), ``sort`` / ``capacity`` (capacity
dropping with ``moe_capacity_factor``). Every mode runs on every path;
``moe_chunk`` > 0 runs the training modes over token chunks (ops.moe).
The serving callers (Engine, Generator, decode_chunk) run it under
``torch.no_grad()``.

With a serving ``mesh`` (parallel.mesh; expert and model axes) the
params are this rank's shards (``shard_params``): attention heads and the
vocabulary split over 'model' (wq/wk/wv by columns, wo by rows with an
all_reduce after it; the embedding by rows, looked up masked and
all_reduced; lm_head by columns, the logits all_gathered so every rank
samples from the same row), experts over 'expert' (whole experts: each
rank of a model group holds the same ones). Gather and gmm MoE go through
parallel.sharded_ops; dense, sort and capacity route globally, run the
local experts with the other ranks' pairs zeroed and all_reduce over
'expert', with capacity positions counted as unsharded, so the same pairs
drop.

Shapes follow the deployed VITA config
(web_demo/vllm_tools/model_weight_file/config.json:17-44): 32L, 4096d,
32 q-heads / 8 kv-heads, 8 experts top-2, ffn 14336, rope 1e6, vocab 51760.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vita_tpu_torch.ops.attention import NEG_INF, mha_xla
from vita_tpu_torch.ops.moe import GATHER_MODES, MODES, load_balancing_loss, moe_ffn, route_topk
from vita_tpu_torch.ops import moe_decode
from vita_tpu_torch.ops.norms import rms_norm
from vita_tpu_torch.ops.rope import apply_rope
from vita_tpu_torch.parallel.mesh import (
    DATA,
    EXPERT,
    FSDP,
    MODEL,
    PIPE,
    SEQ,
    all_gather_cat,
    all_reduce_sum,
    axis,
    local_shard,
    serving_axes,
    sum_stat,
)
from vita_tpu_torch.parallel.sharded_ops import (
    sharded_flash_mha,
    sharded_gather_ffn,
    sharded_gmm_ffn,
    sharded_paged_attention,
    sharded_write_kv_rows,
)

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
    moe_mode: str = "dense"  # ops.moe.MODES
    moe_capacity_factor: float = 1.25
    # >0: each layer's MoE over token chunks of this size, each
    # rematerialized in the backward (chunk-local aux; ops.moe.moe_ffn)
    moe_chunk: int = 0
    attn_backend: str = "xla"  # 'xla' | 'flash'
    remat: bool = False  # checkpoint each layer when training
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def vita_8x7b(**kw) -> "MixtralConfig":
        return MixtralConfig(
            **{**dict(dtype=torch.bfloat16, attn_backend="flash", remat=True), **kw})

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


def param_specs(cfg: MixtralConfig) -> Params:
    """Spec tuples (one entry per dim: None or a mesh axis) mirroring
    init_params' tree, equal to the JAX package's PartitionSpecs: 'model'
    shards heads, ffn columns and the vocabulary, 'expert' the expert axis,
    'fsdp' the remaining large dim."""
    return {
        "embed": ("model", "fsdp"),
        "layers": {
            "attn": {
                "wq": (None, "fsdp", "model"),
                "wk": (None, "fsdp", "model"),
                "wv": (None, "fsdp", "model"),
                "wo": (None, "model", "fsdp"),
            },
            "moe": {
                "router": (None, "fsdp", None),
                "w_gate": (None, "expert", "fsdp", "model"),
                "w_up": (None, "expert", "fsdp", "model"),
                "w_down": (None, "expert", "model", "fsdp"),
            },
            "ln_attn": (None, None),
            "ln_moe": (None, None),
        },
        "ln_final": (None,),
        "lm_head": ("fsdp", "model"),
    }


def decode_param_specs(cfg: MixtralConfig, params: Params) -> Params:
    """param_specs extended to quantized decode params: the int8/int4
    scale leaves shard like their weights, the expert axis on 'expert'."""
    specs = param_specs(cfg)
    moe = specs["layers"]["moe"]
    for k, v in params["layers"]["moe"].items():
        if k not in moe:
            moe[k] = (None, "expert") + (None,) * (v.dim() - 2)
    return specs


def serving_specs(cfg: MixtralConfig, params: Params) -> Params:
    """The specs the port's serving shards follow: decode_param_specs with
    each expert whole ('model' dropped from the expert leaves; the JAX
    package's kernel islands gather them whole too)."""
    specs = decode_param_specs(cfg, params)
    moe = specs["layers"]["moe"]
    for k, spec in moe.items():
        moe[k] = tuple(None if a == "model" else a for a in spec)
    return specs


def shard_params(params: Params, cfg: MixtralConfig, mesh, device=None) -> Params:
    """This rank's shards of the full ``params`` (plain or quantized, on
    any device: CPU views of a mapped file are read only where this rank's
    blocks lie), contiguous on ``device``."""
    ep, tp = serving_axes(mesh)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.vocab_size % tp:
        raise ValueError(f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads and a vocabulary of "
                         f"{cfg.vocab_size} must divide over a model axis of {tp}")
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts not divisible by expert axis {ep}")

    def cut(tree, specs):
        if isinstance(tree, dict):
            return {k: cut(v, specs[k]) for k, v in tree.items()}
        return local_shard(tree, specs, mesh).to(device).contiguous()

    return cut(params, serving_specs(cfg, params))


def embed_tokens(params: Params, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Embedding rows of ``ids``; over a 'model' axis each rank holds a
    block of the vocabulary, looks up the ids in it (zeros elsewhere) and
    the blocks' rows are summed (exact: one is nonzero)."""
    emb = params["embed"]
    tp = axis(mesh, MODEL)
    if tp.size == 1:
        return emb[ids.long()]
    v_local = emb.shape[0]
    local = ids.long() - tp.rank * v_local
    mine = (local >= 0) & (local < v_local)
    rows = emb[local.clamp(0, v_local - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return all_reduce_sum(rows, mesh, MODEL)


def lm_logits(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x @ lm_head; over a 'model' axis the vocabulary blocks' logits are
    gathered, so every rank holds the full row."""
    return all_gather_cat(x @ params["lm_head"], mesh, MODEL, dim=-1)


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


def init_kv_cache(cfg: MixtralConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> Params:
    """Linear KV cache {'k','v'} [L, B, max_len, Hkv, hd] and per-slot
    'pos' [B] int32, all zero."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def _qkv(lp: Params, cfg: MixtralConfig, x, positions):
    """q, k, v over the heads the weights hold (all, or this rank's)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ lp["wq"]).reshape(b, s, -1, hd)
    k = (x @ lp["wk"]).reshape(b, s, -1, hd)
    v = (x @ lp["wv"]).reshape(b, s, -1, hd)
    q, k = apply_rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor, mesh) -> torch.Tensor:
    """o @ wo; over a 'model' axis each rank's row block of wo gives a
    partial sum, taken in float32 and rounded once after the all_reduce.
    On a card a 16-bit partial is one GEMM with a float32 output (no
    float32 copy of o or wo)."""
    if axis(mesh, MODEL).size == 1:
        return o @ wo
    if o.dtype == torch.float32:
        part = o @ wo
    elif o.is_cuda:
        part = torch.mm(o.reshape(-1, o.shape[-1]), wo, out_dtype=torch.float32)
        part = part.reshape(*o.shape[:-1], wo.shape[-1])
    else:
        part = o.float() @ wo.float()
    return all_reduce_sum(part, mesh, MODEL).to(o.dtype)


def _attention_block(
    lp: Params,
    cfg: MixtralConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    kv_valid: torch.Tensor,  # [B, S_kv] bool
    layer_k: Optional[torch.Tensor],  # scratch [B, S_max, Hkv, hd] or None
    layer_v: Optional[torch.Tensor],
    cache_pos: Optional[torch.Tensor],  # [B]
    mesh=None,
    kv_len: Optional[torch.Tensor] = None,  # [B] int32 valid keys, else kv_valid's count
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
        out = sharded_flash_mha(
            q, k_all.to(q.dtype), v_all.to(q.dtype),
            kv_len=kv_valid.sum(1).to(torch.int32) if kv_len is None else kv_len,
            q_offset=positions[:, 0].to(torch.int32), causal=True, mesh=mesh,
        )
    elif cfg.attn_backend == "xla":
        causal = kv_positions[:, None, :] <= positions[:, :, None]  # [B, Sq, Skv]
        keep = causal & kv_valid[:, None, :]
        bias = torch.where(keep[:, None], 0.0, NEG_INF).to(torch.float32)
        out = mha_xla(q, k_all.to(q.dtype), v_all.to(q.dtype), bias=bias)
    else:
        raise ValueError(f"unknown attn_backend {cfg.attn_backend!r}")
    return _out_proj(out.reshape(b, s, -1), lp["wo"], mesh)


def _attention_block_paged(
    lp: Params,
    cfg: MixtralConfig,
    x: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,  # [B, 1]
    cache: Params,
    layer_idx: int,
    mesh=None,
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
    sharded_write_kv_rows(cache["k_pages"], cache["v_pages"], layer_idx, cache["table"],
                          pos, k[:, 0], v[:, 0], active, mesh=mesh, k_scale=ks, v_scale=vs)
    lengths = pos + 1
    if active is not None:
        lengths = torch.where(active, lengths, 0)
    q_dt = x.dtype if ks is not None else cache["k_pages"].dtype
    out = sharded_paged_attention(
        q[:, 0].to(q_dt), cache["k_pages"], cache["v_pages"],
        cache["table"], lengths, layer_idx, mesh=mesh, k_scale=ks, v_scale=vs,
    ).to(x.dtype)
    return _out_proj(out.reshape(b, s, -1), lp["wo"], mesh)


def _moe_routed_layer(h2d, moe: Params, layer_idx: int, cfg: MixtralConfig, tm_flat, mesh,
                      reduce_stats=None):
    """A gather mode (every mesh), or gmm under a mesh: the router, then
    the selected experts through parallel.sharded_ops over the stacked
    (local) expert weights."""
    router_logits = h2d.float() @ moe["router"][layer_idx].float()
    topk_w, topk_i, probs = route_topk(router_logits, cfg.top_k)
    aux = load_balancing_loss(probs, topk_i, cfg.n_experts, tm_flat, reduce_stats)
    experts = {k: v for k, v in moe.items() if k != "router"}
    if cfg.moe_mode == "gmm":
        out = sharded_gmm_ffn(h2d, topk_w, topk_i, experts, layer_idx, cfg.n_experts,
                              mesh=mesh)
    else:
        out = sharded_gather_ffn(h2d, topk_w, topk_i, experts, layer_idx, cfg.n_experts,
                                 cfg.moe_mode, mesh=mesh)
    return out.to(h2d.dtype), aux


def _check_seq_forward(cfg: MixtralConfig, mesh, cache) -> None:
    """The seq-parallel forward is the cacheless one, over a mesh of the
    'seq' axis alone, with the ring as its attention and token-local MoE
    statistics; the rest raises (a missing port names its ROADMAP item)."""
    if cache is not None:
        raise ValueError("seq-parallel attention supports the cacheless path only (Sq == Skv); "
                         "KV-cache decode/prefill needs seq axis 1")
    if axis(mesh, PIPE).size > 1:
        raise NotImplementedError("a 'pipe' axis beside 'seq' is not ported yet (ROADMAP A11c)")
    if any(axis(mesh, a).size > 1 for a in (DATA, FSDP, EXPERT, MODEL)):
        raise NotImplementedError(
            "a 'seq' axis with data/fsdp/expert/model axes > 1 needs differentiable "
            "collectives over those axes, not ported yet (ROADMAP A11d)")
    if cfg.attn_backend != "flash":
        raise ValueError("a 'seq' axis > 1 runs attention as the ring: attn_backend must be "
                         f"'flash', got {cfg.attn_backend!r}")
    if cfg.moe_mode in ("sort", "capacity") or cfg.moe_chunk:
        raise NotImplementedError(
            f"moe_mode {cfg.moe_mode!r} with moe_chunk {cfg.moe_chunk} under a 'seq' axis: "
            "capacity drops and chunk-local aux are decided over the whole sequence's tokens "
            "in their global order, which no rank holds (ROADMAP A11b (capacity under seq))")


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
    mesh=None,  # a serving mesh over which ``params`` are this rank's shards
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits [B, S, V] or final-norm hidden [B, S, D],
    cache with the advanced ``pos`` or None, moe_aux_loss scalar).

    Cache tensors are updated in place and returned in the new cache.

    Under a mesh of a 'seq' axis of n > 1 (and no other axis > 1) this is
    the seq-parallel cacheless forward: ``params`` are whole on every
    rank, and ``input_ids``/``inputs_embeds``, ``attn_valid``,
    ``token_mask`` and ``positions`` are this rank's block of S/n
    positions of the whole sequence (``parallel.ring_attention.shard_seq``);
    positions default to the global ones, the ring's kv_len counts the
    valid keys of the whole sequence (summed over 'seq'), attention runs
    the ring (attn_backend 'flash'), and the logits are the block's. The
    MoE must be token-local (dense, gmm or a gather mode). The aux loss is
    the whole sequence's, on every rank; its sums go over 'seq' through
    ``parallel.mesh.sum_stat``, whose backward keeps each rank's gradient
    its own. The contract: when each rank's objective is its block's
    share of the loss plus the aux term in full, the gradients of the
    parameters summed over the 'seq' ranks equal the unsharded ones."""
    if cfg.moe_mode not in MODES:
        raise ValueError(f"unknown moe_mode {cfg.moe_mode!r}; modes: {MODES}")
    ep, sp = axis(mesh, EXPERT), axis(mesh, SEQ)
    if sp.size > 1:
        _check_seq_forward(cfg, mesh, cache)
    elif mesh is not None:
        serving_axes(mesh)
    paged = cache is not None and "k_pages" in cache
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, mesh)
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        base = cache["pos"][:, None] if cache is not None else sp.rank * s
        positions = torch.arange(s, device=dev)[None, :].expand(b, s) + base
    if attn_valid is None and not paged:
        kv_len = cache["k"].shape[2] if cache is not None else s
        attn_valid = torch.ones(b, kv_len, dtype=torch.bool, device=dev)
    seq_kv_len = None
    if sp.size > 1:  # the ring masks keys by the whole sequence's valid count
        seq_kv_len = all_reduce_sum(attn_valid.sum(1).to(torch.int32), mesh, SEQ)
    tm_flat = None if token_mask is None else token_mask.reshape(-1)
    # aux's sums over the whole sequence
    reduce_stats = (lambda sums: sum_stat(sums, mesh, SEQ)) if sp.size > 1 else None

    layers = params["layers"]
    routed = cfg.moe_mode in GATHER_MODES or (cfg.moe_mode == "gmm" and mesh is not None)
    e_local = layers["moe"]["router"].shape[-1] // ep.size

    def layer(x, i: int):
        lp = {k: v[i] for k, v in layers["attn"].items()}
        h = rms_norm(x, layers["ln_attn"][i], cfg.rms_eps)
        if paged:
            attn_out = _attention_block_paged(lp, cfg, h, positions, cache, i, mesh)
        else:
            attn_out = _attention_block(
                lp, cfg, h, positions, attn_valid,
                cache["k"][i] if cache is not None else None,
                cache["v"][i] if cache is not None else None,
                cache["pos"] if cache is not None else None, mesh, seq_kv_len,
            )
        x = x + attn_out
        h = rms_norm(x, layers["ln_moe"][i], cfg.rms_eps).reshape(b * s, d)
        if routed:
            moe_out, aux = _moe_routed_layer(h, layers["moe"], i, cfg, tm_flat, mesh,
                                             reduce_stats)
        else:
            moe_out, aux = moe_ffn({k: v[i] for k, v in layers["moe"].items()}, h,
                                   cfg.top_k, mode=cfg.moe_mode,
                                   capacity_factor=cfg.moe_capacity_factor, token_mask=tm_flat,
                                   chunk=cfg.moe_chunk, expert_offset=ep.rank * e_local,
                                   out_dtype=torch.float32 if ep.size > 1 else None,
                                   reduce_stats=reduce_stats)
            moe_out = all_reduce_sum(moe_out, mesh, EXPERT).to(h.dtype)
        return x + moe_out.reshape(b, s, d), aux

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    x = inputs_embeds
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        if remat:
            x, aux = checkpoint(layer, x, i, use_reentrant=False)
        else:
            x, aux = layer(x, i)
        aux_total = aux_total + aux

    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    logits = x if return_hidden else lm_logits(params, x, mesh)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["pos"] = cache["pos"] + s
    return logits, new_cache, aux_total / cfg.n_layers
