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

With a serving ``mesh`` (parallel.mesh; expert and model axes, and
'fsdp' blocks gathered whole at each layer's top, as training gathers
them) the params are this rank's shards (``shard_params``): attention
heads and the
vocabulary split over 'model' (wq/wk/wv by columns, wo by rows with an
all_reduce after it; the embedding by rows, looked up masked and
all_reduced; lm_head by columns, the logits all_gathered so every rank
samples from the same row), experts over 'expert' (whole experts: each
rank of a model group holds the same ones). Gather and gmm MoE go through
parallel.sharded_ops; dense, sort and capacity route globally, run the
local experts with the other ranks' pairs zeroed and all_reduce over
'expert', with capacity positions counted as unsharded, so the same pairs
drop.

Under a training mesh the params are this rank's blocks by
``param_specs``: heads and the vocabulary over 'model' as above, and the
experts over 'expert' with their ffn columns over 'model' too (w_gate /
w_up by columns, w_down by rows). The ranks of one 'model' x 'expert'
group hold the same tokens and compute the same loss, and the
collectives come in Megatron's pairs (parallel.mesh): a tensor every
rank holds whole enters its rank's part of a split product through
``all_reduce_grad`` ("f": the attention's input, the experts' input and
combine weights, the head's input), a split product's partial sums leave
through ``all_reduce_sum`` ("g": after wo, after the experts, the
embedding's lookup), and the logits are gathered with
``all_gather_slice``. So each rank's gradient of a split leaf is its
block of the one loss's gradient, and of a replicated leaf the whole
gradient.

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
from vita_tpu_torch.ops.moe import (
    GATHER_MODES,
    MODES,
    chunks_of,
    load_balancing_loss,
    moe_ffn,
    over_chunks,
    route_topk,
)
from vita_tpu_torch.ops import moe_decode
from vita_tpu_torch.ops.norms import rms_norm
from vita_tpu_torch.ops.rope import apply_rope
from vita_tpu_torch.parallel import fsdp
from vita_tpu_torch.parallel.mesh import (
    DATA,
    EXPERT,
    FSDP,
    MODEL,
    PIPE,
    SEQ,
    all_gather_cat,
    all_gather_slice,
    all_reduce_grad,
    all_reduce_sum,
    axis,
    local_shard,
    serving_axes,
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
    # GPipe pipeline parallelism over the mesh's 'pipe' axis
    # (parallel/pipeline.py): > 1 needs forward(..., mesh=...) and the
    # cacheless path; n_layers % pipe_stages == 0
    pipe_stages: int = 1
    pipe_microbatches: int = 4
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
    'fsdp' the remaining large dim, and 'pipe' leads the stacked layer
    leaves when ``pipe_stages`` > 1 (stage s holds layers
    [s*L/S, (s+1)*L/S))."""
    lead = "pipe" if cfg.pipe_stages > 1 else None
    return {
        "embed": ("model", "fsdp"),
        "layers": {
            "attn": {
                "wq": (lead, "fsdp", "model"),
                "wk": (lead, "fsdp", "model"),
                "wv": (lead, "fsdp", "model"),
                "wo": (lead, "model", "fsdp"),
            },
            "moe": {
                "router": (lead, "fsdp", None),
                "w_gate": (lead, "expert", "fsdp", "model"),
                "w_up": (lead, "expert", "fsdp", "model"),
                "w_down": (lead, "expert", "model", "fsdp"),
            },
            "ln_attn": (lead, None),
            "ln_moe": (lead, None),
        },
        "ln_final": (None,),
        "lm_head": ("fsdp", "model"),
    }


def decode_param_specs(cfg: MixtralConfig, params: Params) -> Params:
    """param_specs extended to quantized decode params: the int8/int4
    scale leaves shard like their weights, the expert axis on 'expert'
    (and the layer axis on 'pipe' when ``pipe_stages`` > 1)."""
    specs = param_specs(cfg)
    lead = "pipe" if cfg.pipe_stages > 1 else None
    moe = specs["layers"]["moe"]
    for k, v in params["layers"]["moe"].items():
        if k not in moe:
            moe[k] = (lead, "expert") + (None,) * (v.dim() - 2)
    return specs


def vocab_split(cfg: MixtralConfig, mesh) -> bool:
    """Whether serving shards the vocabulary (embed rows, lm_head columns)
    over ('pipe', 'model') rather than 'model' alone: a 'pipe' axis > 1
    whose blocks divide the vocabulary. Otherwise every stage holds the
    model axis's block of the whole head."""
    pp, tp = axis(mesh, PIPE).size, axis(mesh, MODEL).size
    return pp > 1 and cfg.vocab_size % (pp * tp) == 0


def vocab_axes(params: Params, cfg: MixtralConfig, mesh) -> Tuple[str, ...]:
    """The axes ``params``' vocabulary is split over: ('pipe', 'model')
    when its embedding holds V/(pipe*model) rows, else ('model',)."""
    pp, tp = axis(mesh, PIPE).size, axis(mesh, MODEL).size
    if pp > 1 and params["embed"].shape[0] * pp * tp == cfg.vocab_size:
        return (PIPE, MODEL)
    return (MODEL,)


def serving_specs(cfg: MixtralConfig, params: Params, mesh=None) -> Params:
    """The specs the port's serving shards follow: decode_param_specs with
    each expert whole ('model' dropped from the expert leaves; the JAX
    package's kernel islands gather them whole too), the layer leaves led
    by 'pipe' when the mesh has a 'pipe' axis > 1, and the vocabulary
    over ('pipe', 'model') where ``vocab_split``."""
    pp = axis(mesh, PIPE).size
    specs = decode_param_specs(dataclasses.replace(cfg, pipe_stages=pp), params)
    moe = specs["layers"]["moe"]
    for k, spec in moe.items():
        moe[k] = tuple(None if a == "model" else a for a in spec)
    if vocab_split(cfg, mesh):
        specs["embed"] = ((PIPE, MODEL), "fsdp")
        specs["lm_head"] = ("fsdp", (PIPE, MODEL))
    return specs


def shard_params(params: Params, cfg: MixtralConfig, mesh, device=None, specs=None) -> Params:
    """This rank's shards of the full ``params`` (plain or quantized, on
    any device: CPU views of a mapped file are read only where this rank's
    blocks lie), contiguous on ``device``; cut by ``serving_specs`` unless
    ``specs`` are given (``param_specs`` for the GPipe training path)."""
    if specs is None:  # raises for the axes serving does not shard over
        serving_axes(mesh)
    ep, tp, pp = (axis(mesh, a).size for a in (EXPERT, MODEL, PIPE))
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.vocab_size % tp:
        raise ValueError(f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads and a vocabulary of "
                         f"{cfg.vocab_size} must divide over a model axis of {tp}")
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts not divisible by expert axis {ep}")
    if cfg.n_layers % pp:
        raise ValueError(f"layer count {cfg.n_layers} not divisible by pipe axis {pp}")

    def cut(tree, specs):
        if isinstance(tree, dict):
            return {k: cut(v, specs[k]) for k, v in tree.items()}
        return local_shard(tree, specs, mesh).to(device).contiguous()

    return cut(params, serving_specs(cfg, params, mesh) if specs is None else specs)


def embed_tokens(params: Params, ids: torch.Tensor, mesh=None, axes=(MODEL,)) -> torch.Tensor:
    """Embedding rows of ``ids``; with the vocabulary split over ``axes``
    (``vocab_axes``) each rank holds a block of it, looks up the ids in it
    (zeros elsewhere) and the blocks' rows are summed (exact: one is
    nonzero). Under an 'fsdp' axis the embedding is gathered whole first
    (parallel.fsdp)."""
    emb = fsdp.gather(params["embed"], (None, FSDP), mesh)
    size, rank = 1, 0
    for n in axes:
        a = axis(mesh, n)
        size, rank = size * a.size, rank * a.size + a.rank
    if size == 1:
        return emb[ids.long()]
    v_local = emb.shape[0]
    local = ids.long() - rank * v_local
    mine = (local >= 0) & (local < v_local)
    rows = emb[local.clamp(0, v_local - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return all_reduce_sum(rows, mesh, axes)


def lm_logits(params: Params, x: torch.Tensor, mesh=None, axes=(MODEL,)) -> torch.Tensor:
    """x @ lm_head; with the vocabulary split over ``axes`` the blocks'
    logits are gathered, so every rank holds the full row. Under an
    'fsdp' axis the head is gathered whole first (parallel.fsdp). In
    training every rank of ``axes`` computes the same loss from the whole
    row: x enters through ``all_reduce_grad`` (each rank's dx covers its
    vocabulary block) and the gather's backward takes the rank's block of
    the logits' gradient (``all_gather_slice``)."""
    head = fsdp.gather(params["lm_head"], (FSDP, None), mesh)
    return all_gather_slice(all_reduce_grad(x, mesh, axes) @ head, mesh, axes, dim=-1)


def unstack_layers(params: Params) -> Params:
    """The stacked [L, ...] layer leaves as a list of per-layer trees
    (views). ``forward`` takes stacked layers; the JAX package's reason
    for unstacking (no per-layer weight copies at its kernels' operands)
    does not arise in torch, where a layer's slice is a view, so this is
    the conversion for callers that want per-layer trees."""
    stacked = params["layers"]
    n_layers = stacked["ln_attn"].shape[0]

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]

    return {**params, "layers": [take(stacked, i) for i in range(n_layers)]}


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


class _MatmulF32(torch.autograd.Function):
    """A 16-bit o [N, K] @ w [K, M] with a float32 output, as one GEMM on a
    card (no float32 copy of o or w). The backward is the 16-bit
    product's: the incoming float32 gradient is rounded to o's dtype (the
    gradient of a sum that is rounded to o's dtype after it is exactly
    representable there) and multiplied in it."""

    @staticmethod
    def forward(ctx, o, wo):
        ctx.save_for_backward(o, wo)
        if o.is_cuda:
            part = torch.mm(o.reshape(-1, o.shape[-1]), wo, out_dtype=torch.float32)
        else:
            part = o.reshape(-1, o.shape[-1]).float() @ wo.float()
        return part.reshape(*o.shape[:-1], wo.shape[-1])

    @staticmethod
    def backward(ctx, g):
        o, wo = ctx.saved_tensors
        g = g.to(o.dtype)
        do = g @ wo.T if ctx.needs_input_grad[0] else None
        dwo = None
        if ctx.needs_input_grad[1]:
            dwo = o.reshape(-1, o.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return do, dwo


def _out_proj(o: torch.Tensor, wo: torch.Tensor, mesh) -> torch.Tensor:
    """o @ wo; over a 'model' axis each rank's row block of wo gives a
    partial sum, taken in float32 and rounded once after the all_reduce
    (whose backward hands every rank the whole gradient). A 16-bit
    partial is one GEMM with a float32 output (``_MatmulF32``)."""
    if axis(mesh, MODEL).size == 1:
        return o @ wo
    part = o @ wo if o.dtype == torch.float32 else _MatmulF32.apply(o, wo)
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
    # this rank's heads: the gradient into x covers them only ("f")
    q, k, v = _qkv(lp, cfg, all_reduce_grad(x, mesh, MODEL), positions)
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


def expert_axes(moe: Params, cfg: MixtralConfig, mesh) -> Tuple[str, ...]:
    """The axes the experts' partial outputs are summed over: 'expert',
    and 'model' where the expert leaves hold a block of the ffn columns
    (training's ``param_specs``; ``serving_specs`` keeps each expert
    whole)."""
    if axis(mesh, MODEL).size > 1 and moe["w_gate"].shape[-1] != cfg.d_ff:
        return (EXPERT, MODEL)
    return (EXPERT,)


def _moe_routed_layer(h2d, moe: Params, layer_idx: int, cfg: MixtralConfig, tm_flat, mesh,
                      reduce_stats=None, pairs: bool = False):
    """A gather mode (every mesh), or gmm under a mesh: the router, then
    the selected experts through parallel.sharded_ops over the stacked
    (local) expert weights. ``pairs`` runs the gather modes' per-pair
    kernel at every batch size (the pipeline's decode ring). gmm with
    ``moe_chunk`` runs over token chunks as ``ops.moe.moe_ffn`` does
    (``ops.moe.over_chunks``)."""
    if cfg.moe_mode == "gmm" and chunks_of(h2d.shape[0], cfg.moe_chunk):
        one = dataclasses.replace(cfg, moe_chunk=0)
        return over_chunks(lambda xc, tc: _moe_routed_layer(xc, moe, layer_idx, one, tc, mesh),
                           h2d, cfg.moe_chunk, tm_flat)
    router_logits = h2d.float() @ moe["router"][layer_idx].float()
    topk_w, topk_i, probs = route_topk(router_logits, cfg.top_k)
    aux = load_balancing_loss(probs, topk_i, cfg.n_experts, tm_flat, reduce_stats)
    experts = {k: v for k, v in moe.items() if k != "router"}
    if cfg.moe_mode == "gmm":
        out = sharded_gmm_ffn(h2d, topk_w, topk_i, experts, layer_idx, cfg.n_experts,
                              mesh=mesh, axes=expert_axes(moe, cfg, mesh))
    else:
        out = sharded_gather_ffn(h2d, topk_w, topk_i, experts, layer_idx, cfg.n_experts,
                                 cfg.moe_mode, mesh=mesh, pairs=pairs)
    return out.to(h2d.dtype), aux


def _moe_over_batch(moe, h2d: torch.Tensor, tm_flat, b: int, s: int, mesh):
    """``moe(x, token_mask, reduce_stats)`` (a layer's MoE: its output and
    aux) over the whole batch's tokens in their global order, for the
    capacity and sort modes and ``moe_chunk`` when the tokens are split
    between ranks (rows over ('data', 'fsdp'), positions over 'seq'):
    capacity positions and chunks run over the global token order, as in
    the JAX package. Every rank gathers the tokens (``all_gather_cat``,
    whose backward sums each rank's gradient into the tokens' owners),
    runs the MoE on all of them and keeps its own rows of the output. The
    aux term, the whole batch's on every rank, is taken with a gradient of
    1/n on each of the n ranks, so the gradients summed over them hold it
    once."""
    from vita_tpu_torch.parallel.fsdp import BATCH_AXES

    d = h2d.shape[-1]

    def whole(x):
        return all_gather_cat(all_gather_cat(x, mesh, SEQ, dim=1), mesh, BATCH_AXES, dim=0)

    x = whole(h2d.reshape(b, s, d))
    tm = None if tm_flat is None else whole(tm_flat.reshape(b, s).float()).reshape(-1)
    out, aux = moe(x.reshape(-1, d), tm, None)
    out = local_shard(out.reshape(x.shape), (BATCH_AXES, SEQ), mesh).reshape(b * s, d)
    n = 1
    for a in (DATA, FSDP, SEQ):
        n *= axis(mesh, a).size
    return out, aux / n + (aux - aux / n).detach()


def _check_split_forward(cfg: MixtralConfig, mesh, cache) -> None:
    """The forward over tokens split between ranks ('data'/'fsdp' rows,
    'seq' positions) is the cacheless training one, with the ring as its
    attention under 'seq' (on this rank's heads beside 'model')."""
    if axis(mesh, SEQ).size > 1 and cfg.attn_backend != "flash":
        raise ValueError("a 'seq' axis > 1 runs attention as the ring: attn_backend must be "
                         f"'flash', got {cfg.attn_backend!r}")


def _check_pipe_forward(params: Params, cfg: MixtralConfig, mesh, cache) -> None:
    """The GPipe forward is the cacheless one over stacked layers, with a
    mesh whose 'pipe' axis is ``pipe_stages`` (the JAX package's
    ValueErrors); ``params`` hold this stage's L/S layers."""
    if cache is not None or cfg.moe_mode in GATHER_MODES or isinstance(params["layers"], list):
        raise ValueError(
            "pipe_stages > 1 supports the cacheless stacked-layer training/prefill path only "
            "(no KV cache, no gather decode)")
    if cfg.moe_mode == "gmm":
        raise ValueError(
            "moe_mode='gmm' is not supported with pipeline parallelism; use 'dense', 'sort' "
            "or 'capacity' with pipe_stages > 1")
    if mesh is None:
        raise ValueError("pipe_stages > 1 requires forward(..., mesh=...)")
    if axis(mesh, PIPE).size != cfg.pipe_stages:
        raise ValueError(f"pipe axis size {axis(mesh, PIPE).size} != pipe_stages "
                         f"{cfg.pipe_stages}")
    if cfg.n_layers % cfg.pipe_stages:
        raise ValueError(f"layer count {cfg.n_layers} not divisible by pipe_stages="
                         f"{cfg.pipe_stages}")
    held = params["layers"]["ln_attn"].shape[0]
    if held != cfg.n_layers // cfg.pipe_stages:
        raise ValueError(f"params hold {held} layers; a stage of {cfg.n_layers} layers over "
                         f"{cfg.pipe_stages} stages holds {cfg.n_layers // cfg.pipe_stages}")


def _layer_of(layers, i: int):
    """(stacked layer tree, index) of layer i: the stack and i for stacked
    leaves, a one-layer stack (views) and 0 for a list of layers."""
    if isinstance(layers, list):
        def one(tree):
            if isinstance(tree, dict):
                return {k: one(v) for k, v in tree.items()}
            return tree[None]
        return one(layers[i]), 0
    return layers, i


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def n_layers_of(layers) -> int:
    """The layers a stacked tree or a list of layers holds."""
    return len(layers) if isinstance(layers, list) else layers["ln_attn"].shape[0]


def run_layers(
    layers,  # stacked [L', ...] leaves (all layers, or a stage's) or a list of layers
    cfg: MixtralConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    attn_valid: Optional[torch.Tensor] = None,  # [B, S_kv] (not for the paged pool)
    cache: Optional[Params] = None,  # layer-indexed like ``layers``
    tm_flat: Optional[torch.Tensor] = None,
    mesh=None,
    seq_kv_len: Optional[torch.Tensor] = None,
    reduce_stats=None,
    remat: bool = False,
    pairs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder layers of ``layers`` in order: (x, aux summed over
    them). The cache (linear scratch or paged pool) is indexed by the same
    layer numbers and written in place. ``remat`` checkpoints each layer
    (torch.utils.checkpoint); ``pairs`` runs a gather mode's per-pair
    kernel at every batch size. Under an 'fsdp' axis > 1 the stacked
    leaves are this rank's blocks (``param_specs``) and each layer gathers
    its weights whole at its top (parallel.fsdp.gather), inside what remat
    recomputes: the gathered layer lives through its forward and is
    gathered again for its backward, whose gradient the gather's backward
    reduce-scatters over 'fsdp' right after it (ZeRO-3); serving gathers
    them the same way, without autograd."""
    b, s, d = x.shape
    paged = cache is not None and "k_pages" in cache
    ep = axis(mesh, EXPERT)
    routed = cfg.moe_mode in GATHER_MODES or (cfg.moe_mode == "gmm" and mesh is not None)
    gathered = axis(mesh, FSDP).size > 1
    specs = None
    if gathered:  # decode_param_specs: a quantized copy's leaves too (whole over 'fsdp')
        moe = (layers[0] if isinstance(layers, list) else layers)["moe"]
        specs = decode_param_specs(cfg, {"layers": {"moe": moe}})["layers"]
    # capacity drops and chunk-local aux over tokens split between ranks
    whole_batch = (cache is None and (cfg.moe_mode in ("sort", "capacity") or cfg.moe_chunk > 0)
                   and any(axis(mesh, a).size > 1 for a in (DATA, FSDP, SEQ)))

    def layer(x, i: int):
        stack, li = _layer_of(layers, i)
        if gathered:  # this layer's weights whole, as a one-layer stack
            stack = fsdp.gather_tree(_tree_map(lambda w: w[li], stack),
                                     _tree_map(lambda sp: sp[1:], specs), mesh)
            stack, li = _tree_map(lambda w: w[None], stack), 0
        lp = {k: v[li] for k, v in stack["attn"].items()}
        h = rms_norm(x, stack["ln_attn"][li], cfg.rms_eps)
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
        h = rms_norm(x, stack["ln_moe"][li], cfg.rms_eps).reshape(b * s, d)
        if routed:
            def moe(h, tm, stats):
                return _moe_routed_layer(h, stack["moe"], li, cfg, tm, mesh, stats, pairs)
        else:
            e_local = stack["moe"]["router"].shape[-1] // ep.size
            over = expert_axes(stack["moe"], cfg, mesh)
            split = any(axis(mesh, a).size > 1 for a in over)

            def moe(h, tm, stats):
                out, aux = moe_ffn({k: v[li] for k, v in stack["moe"].items()}, h,
                                   cfg.top_k, mode=cfg.moe_mode,
                                   capacity_factor=cfg.moe_capacity_factor, token_mask=tm,
                                   chunk=cfg.moe_chunk, expert_offset=ep.rank * e_local,
                                   out_dtype=torch.float32 if split else None,
                                   reduce_stats=stats,
                                   expert_inputs=lambda x, w: (all_reduce_grad(x, mesh, over),
                                                               all_reduce_grad(w, mesh, over)))
                return all_reduce_sum(out, mesh, over).to(h.dtype), aux
        if whole_batch:
            moe_out, aux = _moe_over_batch(moe, h, tm_flat, b, s, mesh)
        else:
            moe_out, aux = moe(h, tm_flat, reduce_stats)
        return x + moe_out.reshape(b, s, d), aux

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_layers_of(layers)):
        if remat:
            x, aux = checkpoint(layer, x, i, use_reentrant=False)
        else:
            x, aux = layer(x, i)
        aux_total = aux_total + aux
    return x, aux_total


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
    mesh=None,  # a mesh over which ``params`` are this rank's shards
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits [B, S, V] or final-norm hidden [B, S, D],
    cache with the advanced ``pos`` or None, moe_aux_loss scalar).

    Cache tensors are updated in place and returned in the new cache.
    ``params["layers"]`` may also be a list of per-layer trees
    (``unstack_layers``).

    Under a training mesh (any of the six axes) this is the
    cacheless forward over tokens split between ranks ('data', 'fsdp',
    'seq'), beside heads, ffn columns, the vocabulary and experts split
    over 'model' and 'expert' (above). ``input_ids``/``inputs_embeds``, ``attn_valid``,
    ``token_mask`` and ``positions`` are this rank's rows of the batch
    over ('data', 'fsdp') (``parallel.fsdp.batch_rows``) and, under a
    'seq' axis of n > 1, its block of S/n positions of the whole sequence
    (``parallel.ring_attention.shard_seq``); positions default to the
    global ones, the ring's kv_len counts the valid keys of the whole
    sequence (summed over 'seq'), attention runs the ring (attn_backend
    'flash'), and the logits are the block's. Under 'fsdp' > 1 ``params``
    are this rank's blocks (``param_specs``), gathered where they are
    used: the embedding and the head whole, each layer at its top
    (``run_layers``). Dense and gmm MoE run on the rank's tokens, and
    the aux loss is the whole batch's on every rank: its sums go over
    ('data', 'fsdp', 'seq') through ``parallel.mesh.all_reduce_sum``,
    whose backward keeps each rank's gradient its own. The capacity and
    sort modes and ``moe_chunk`` decide drops and chunks over the whole
    batch's token order, so each layer's MoE runs there on the tokens of
    every rank (``_moe_over_batch``). The contract: when
    each rank's objective is its tokens' share of the loss plus the aux
    term in full, the gradients summed over those ranks (the blocks'
    summed over 'fsdp' by the gathers' backward) equal the unsharded
    ones.

    With ``cfg.pipe_stages`` > 1 this is the GPipe forward
    (parallel.pipeline.pipeline_layer_stack, ``pipe_microbatches``
    microbatches; ``remat`` recomputes each stage's microbatch in the
    backward): ``params`` hold this stage's layers (``shard_params`` with
    ``param_specs``), the embedding and head whole or split over 'model';
    every rank returns the whole batch's logits, and every leaf replicated
    over 'pipe' gets the whole gradient on every rank. The aux loss is the
    microbatches' mean, as in the JAX package. Beside a 'seq' axis each
    stage runs the ring over its rank's block."""
    if cfg.moe_mode not in MODES:
        raise ValueError(f"unknown moe_mode {cfg.moe_mode!r}; modes: {MODES}")
    sp, pp = axis(mesh, SEQ), axis(mesh, PIPE)
    if cfg.pipe_stages > 1:
        _check_pipe_forward(params, cfg, mesh, cache)
    elif pp.size > 1:
        raise ValueError(f"pipe axis size {pp.size} != pipe_stages {cfg.pipe_stages}")
    # tokens split between ranks: the cacheless training forward (every
    # rank of a serving mesh's 'data' and 'fsdp' axes holds the whole batch)
    split = [a for a in (DATA, FSDP, SEQ) if axis(mesh, a).size > 1 and cache is None]
    if split:
        _check_split_forward(cfg, mesh, cache)
    elif mesh is not None:
        serving_axes(mesh)
    paged = cache is not None and "k_pages" in cache
    axes = vocab_axes(params, cfg, mesh) if mesh is not None else (MODEL,)
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, mesh, axes)
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
    # aux's sums over the whole batch's tokens
    reduce_stats = (lambda sums: all_reduce_sum(sums, mesh, tuple(split))) if split else None

    if cfg.pipe_stages > 1:
        from vita_tpu_torch.parallel.pipeline import pipeline_layer_stack

        def pp_layer(lp, x, c):
            tm = c["tm"]
            one = {k: ({n: t[None] for n, t in v.items()} if isinstance(v, dict) else v[None])
                   for k, v in lp.items()}
            return run_layers(one, cfg, x, c["pos"], c["valid"],
                              tm_flat=None if tm is None else tm.reshape(-1), mesh=mesh,
                              seq_kv_len=c["kv_len"], reduce_stats=reduce_stats)

        consts = {"pos": positions, "valid": attn_valid, "tm": token_mask,
                  "kv_len": seq_kv_len}
        x, aux_total = pipeline_layer_stack(mesh, pp_layer, params["layers"], inputs_embeds,
                                            consts, cfg.pipe_stages, cfg.pipe_microbatches,
                                            remat=cfg.remat)
    else:
        tm_flat = None if token_mask is None else token_mask.reshape(-1)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        x, aux_total = run_layers(params["layers"], cfg, inputs_embeds, positions, attn_valid,
                                  cache, tm_flat, mesh, seq_kv_len, reduce_stats, remat)

    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    logits = x if return_hidden else lm_logits(params, x, mesh, axes)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["pos"] = cache["pos"] + s
    return logits, new_cache, aux_total / cfg.n_layers


# ---------------------------------------------------------------------------
# pipeline-parallel greedy generation (the wave-major layer-split cache)
# ---------------------------------------------------------------------------
def init_pp_kv_cache(cfg: MixtralConfig, n_waves: int, batch: int, max_len: int, dtype=None,
                     device=None, mesh=None) -> Params:
    """Wave-major KV cache for pipeline-parallel decode: {'k','v'}
    [L/S, W, B, T, Hkv, hd] (this stage's layers under ``mesh``'s 'pipe'
    axis of S; all L without a mesh) and 'pos' [W, B] int32, all zero."""
    n_local = cfg.n_layers // axis(mesh, PIPE).size
    shape = (n_local, n_waves, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros(n_waves, batch, dtype=torch.int32, device=device)}


def pp_kv_cache_specs() -> Params:
    """The wave-major cache's specs: the layer dim over 'pipe'."""
    return {"k": ("pipe",), "v": ("pipe",), "pos": ()}


@torch.no_grad()
def pp_prefill(params: Params, cfg: MixtralConfig, mesh, prompts: torch.Tensor,
               max_len: int) -> Tuple[Params, torch.Tensor]:
    """Pipeline-parallel prefill of W == S waves of prompts [W, B, T0]:
    the GPipe schedule (parallel.pipeline.pipeline_prefill_kv, dense MoE)
    fills this stage's rows of the wave-major cache that
    ``pp_decode_greedy`` reads. ``params`` are this rank's shards
    (``shard_params``). Returns (cache, first greedy tokens [W, B] on
    every rank)."""
    from vita_tpu_torch.parallel.pipeline import pipeline_prefill_kv

    w, b, t0 = prompts.shape
    dev = params["embed"].device
    axes = vocab_axes(params, cfg, mesh)
    x = embed_tokens(params, prompts.reshape(w * b, t0), mesh, axes)
    x = x.reshape(w, b, t0, -1).to(cfg.dtype)
    positions = torch.arange(t0, device=dev)[None, None].expand(w, b, t0)
    kv_valid = (torch.arange(max_len, device=dev) < t0)[None, None].expand(w, b, max_len)
    hkv = cfg.n_kv_heads // axis(mesh, MODEL).size
    kv_template = torch.zeros(b, max_len, hkv, cfg.head_dim, dtype=cfg.dtype, device=dev)
    dense = dataclasses.replace(cfg, moe_mode="dense")

    def body(lp, xx, cw, kv_zeros):
        one = {k: ({n: t[None] for n, t in v.items()} if isinstance(v, dict) else v[None])
               for k, v in lp.items()}
        kv_k, kv_v = kv_zeros, kv_zeros.clone()
        cache = {"k": kv_k[None], "v": kv_v[None],
                 "pos": torch.zeros(xx.shape[0], dtype=torch.int32, device=dev)}
        y, _ = run_layers(one, dense, xx, cw["pos"], cw["valid"], cache, mesh=mesh)
        return y, kv_k, kv_v

    x_out, ck, cv = pipeline_prefill_kv(mesh, body, params["layers"], x,
                                        {"pos": positions, "valid": kv_valid}, kv_template,
                                        axis(mesh, PIPE).size)
    h = rms_norm(x_out[:, :, -1], params["ln_final"], cfg.rms_eps)
    first = lm_logits(params, h, mesh, axes).float().argmax(-1).to(torch.int32)
    cache = {"k": ck, "v": cv, "pos": torch.full((w, b), t0, dtype=torch.int32, device=dev)}
    return cache, first


@torch.no_grad()
def pp_generate(params: Params, cfg: MixtralConfig, mesh, prompts: torch.Tensor,
                n_tokens: int, max_len: int) -> torch.Tensor:
    """Pipeline-parallel greedy generation: ``pp_prefill`` into the
    layer-split cache, then the S-wave ring decode. Returns tokens
    [W, n_tokens + 1, B] on every rank (the prefill's first token and
    n_tokens more)."""
    cache, first = pp_prefill(params, cfg, mesh, prompts, max_len)
    toks, _ = pp_decode_greedy(params, cfg, mesh, cache, first, n_tokens)
    return torch.cat([first[:, None], toks], dim=1)


@torch.no_grad()
def pp_decode_greedy(params: Params, cfg: MixtralConfig, mesh, cache: Params,
                     first_tokens: torch.Tensor, n_tokens: int) -> Tuple[torch.Tensor, Params]:
    """Pipeline-parallel greedy decode: S waves ride the 'pipe' ring
    (parallel.pipeline.pipeline_decode_greedy) over the wave-major cache
    (``init_pp_kv_cache``, prefilled per wave; written in place).
    ``params`` are this rank's shards. The MoE follows ``cfg.moe_mode``:
    the gather modes run their per-pair kernel over the stage's stacked
    experts (flat layer*E+e ids), any other mode ``moe_ffn``. The last
    stage finishes each token with the whole head (gathered once when the
    vocabulary is split). Returns (tokens [W, n_tokens, B] on every rank,
    the cache with the advanced 'pos')."""
    from vita_tpu_torch.parallel.pipeline import pipeline_decode_greedy

    axes = vocab_axes(params, cfg, mesh)
    head = {"ln_final": params["ln_final"],
            "lm_head": all_gather_cat(fsdp.gather(params["lm_head"], (FSDP, None), mesh), mesh,
                                      axes, dim=1),
            "embed": all_gather_cat(fsdp.gather(params["embed"], (None, FSDP), mesh), mesh,
                                    axes, dim=0)}

    def stage_fn(local, ck_w, cv_w, x, positions, kv_valid, cache_pos):
        y, _ = run_layers(local, cfg, x, positions, kv_valid,
                          {"k": ck_w, "v": cv_w, "pos": cache_pos}, mesh=mesh, pairs=True)
        return y

    def finish_fn(hp, y):
        h = rms_norm(y, hp["ln_final"], cfg.rms_eps)[:, 0]
        tok = (h @ hp["lm_head"]).float().argmax(-1).to(torch.int32)
        return tok, hp["embed"][tok.long()][:, None]

    x0 = embed_tokens(params, first_tokens.reshape(-1), mesh, axes)
    x0 = x0.reshape(first_tokens.shape + (1, -1)).to(cfg.dtype)
    toks = pipeline_decode_greedy(mesh, stage_fn, finish_fn, params["layers"], head,
                                  cache["k"], cache["v"], x0, cache["pos"], n_tokens)
    return toks, {**cache, "pos": cache["pos"] + n_tokens}
