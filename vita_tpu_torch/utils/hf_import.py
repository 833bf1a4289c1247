"""HF-format checkpoints to and from the port's parameter dicts
(vita_tpu.utils.hf_import).

The name tables are the ones the reference uses to move weights between
its stacks (web_demo/vllm_tools/vllm_file/mixtral.py:1197-1221): HF
state-dict names on one side, the stacked-layer dict on the other. Weights
are transposed to the x @ w layout ([d_in, d_out]) and per-layer tensors
stacked on a leading L axis, as in the JAX package, so both packages read
and write the same files.

Import takes a mapping of torch tensors or numpy arrays and builds each
leaf in ``dtype`` on ``device`` (the transposes and stacks run there).
Export returns float32 tensors on the parameters' device, as the JAX
package returns float32 arrays. The alternative towers import from
transformers' CLIPVisionModel / SiglipVisionModel state dicts and the
reference's EVA ViT; every vision projector kind but mlp2x_gelu (the
reference's linear_1/linear_2) and identity (no parameters) goes both
ways as its own leaves under ``native.<path>`` names, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vita_tpu_torch.utils import safetensors_io

Tensors = Dict[str, torch.Tensor]


def _t(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """A leaf of a state dict (tensor or numpy array) as ``dtype`` on
    ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).detach().to(device=device, dtype=dtype)


def _getter(state: Mapping[str, Any], dtype, device, prefix: str = ""):
    return lambda name: _t(state[prefix + name], dtype, device)


def _stacker(g, n_layers: int):
    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return torch.stack([g(fmt.format(l=l)).T if transpose else g(fmt.format(l=l))
                            for l in range(n_layers)])
    return stack


def mixtral_params_from_hf(state: Mapping[str, Any], cfg, prefix: str = "model.",
                           dtype=torch.float32, device=None) -> Dict[str, Any]:
    """An HF MixtralForCausalLM state dict -> the port's Mixtral params."""
    g = _getter(state, dtype, device)
    stack = _stacker(g, cfg.n_layers)

    def stack_experts(fmt: str) -> torch.Tensor:  # [L, E, d_in, d_out]
        return torch.stack([torch.stack([g(fmt.format(l=l, e=e)).T
                                         for e in range(cfg.n_experts)])
                            for l in range(cfg.n_layers)])

    p = prefix
    moe = p + "layers.{l}.block_sparse_moe."
    return {
        "embed": g(f"{p}embed_tokens.weight"),
        "layers": {
            "attn": {
                "wq": stack(p + "layers.{l}.self_attn.q_proj.weight"),
                "wk": stack(p + "layers.{l}.self_attn.k_proj.weight"),
                "wv": stack(p + "layers.{l}.self_attn.v_proj.weight"),
                "wo": stack(p + "layers.{l}.self_attn.o_proj.weight"),
            },
            "moe": {
                "router": stack(moe + "gate.weight"),
                "w_gate": stack_experts(moe + "experts.{e}.w1.weight"),
                "w_up": stack_experts(moe + "experts.{e}.w3.weight"),
                "w_down": stack_experts(moe + "experts.{e}.w2.weight"),
            },
            "ln_attn": stack(p + "layers.{l}.input_layernorm.weight", False),
            "ln_moe": stack(p + "layers.{l}.post_attention_layernorm.weight", False),
        },
        "ln_final": g(f"{p}norm.weight"),
        "lm_head": g("lm_head.weight").T.contiguous(),
    }


def load_safetensors_state(paths) -> Tensors:
    """Flat name -> tensor mapping from one or more .safetensors files
    (views of the mapped files, on the CPU)."""
    state: Tensors = {}
    for path in paths if isinstance(paths, (list, tuple)) else [paths]:
        state.update(safetensors_io.load_file(str(path)))
    return state


def internvit_params_from_hf(state: Mapping[str, Any], n_layers: int, dtype=torch.float32,
                             device=None) -> Dict[str, Any]:
    """InternVisionModel weights (modeling_intern_vit.py names) -> the
    port's InternViT params; the conv patch embedding becomes a
    [p*p*3, D] matmul (the conv weight's (in_c, kh, kw) order is
    patchify's)."""
    g = _getter(state, dtype, device)
    stack = _stacker(g, n_layers)
    pw = g("embeddings.patch_embedding.weight")  # [D, 3, p, p]
    lay = "encoder.layers.{l}."
    return {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).T.contiguous(),
                        "b": g("embeddings.patch_embedding.bias")},
        "cls": g("embeddings.class_embedding"),
        "pos_embed": g("embeddings.position_embedding"),
        "layers": {ours: stack(lay + hf, tr) for hf, ours, tr in _INTERNVIT_LAYER},
    }


# (HF name under encoder.layers.{l}., ours, transposed)
_INTERNVIT_LAYER = [
    ("attn.qkv.weight", "qkv_w", True), ("attn.qkv.bias", "qkv_b", False),
    ("attn.proj.weight", "proj_w", True), ("attn.proj.bias", "proj_b", False),
    ("mlp.fc1.weight", "fc1_w", True), ("mlp.fc1.bias", "fc1_b", False),
    ("mlp.fc2.weight", "fc2_w", True), ("mlp.fc2.bias", "fc2_b", False),
    ("norm1.weight", "norm1_w", False), ("norm1.bias", "norm1_b", False),
    ("norm2.weight", "norm2_w", False), ("norm2.bias", "norm2_b", False),
    ("ls1", "ls1", False), ("ls2", "ls2", False),
]
_WHALE_LAYER = [
    ("attn.linear_q.weight", "q_w", True), ("attn.linear_q.bias", "q_b", False),
    ("attn.linear_k.weight", "k_w", True), ("attn.linear_k.bias", "k_b", False),
    ("attn.linear_v.weight", "v_w", True), ("attn.linear_v.bias", "v_b", False),
    ("attn.linear_out.weight", "out_w", True), ("attn.linear_out.bias", "out_b", False),
    ("attn.linear_pos.weight", "pos_w", True),
    ("attn.pos_bias_u", "pos_bias_u", False), ("attn.pos_bias_v", "pos_bias_v", False),
    ("feed_forward.w_1.weight", "ffn1_w", True), ("feed_forward.w_1.bias", "ffn1_b", False),
    ("feed_forward.w_2.weight", "ffn2_w", True), ("feed_forward.w_2.bias", "ffn2_b", False),
    ("norm1.weight", "norm1_w", False), ("norm1.bias", "norm1_b", False),
    ("norm2.weight", "norm2_w", False), ("norm2.bias", "norm2_b", False),
]


def whale_params_from_hf(state: Mapping[str, Any], n_layers: int, cmvn_mean=None,
                         cmvn_istd=None, dtype=torch.float32, device=None) -> Dict[str, Any]:
    """WhaleAudioModel weights (modeling_whale.py names) -> the port's
    Whale params. CMVN lives outside the HF state dict (the feature
    extractor's config) and is passed in; it stays float32."""
    g = _getter(state, dtype, device)
    stack = _stacker(g, n_layers)
    cmvn = lambda v, fill: (torch.full((80,), fill, dtype=torch.float32, device=device)
                            if v is None else _t(v, torch.float32, device))
    lay = "encoder.layers.{l}."
    return {
        "cmvn": {"mean": cmvn(cmvn_mean, 0.0), "istd": cmvn(cmvn_istd, 1.0)},
        "sub": {
            # OIHW -> HWIO
            "conv1_w": g("subsampling.conv_in.0.weight").permute(2, 3, 1, 0).contiguous(),
            "conv1_b": g("subsampling.conv_in.0.bias"),
            "conv2_w": g("subsampling.conv_in.2.weight").permute(2, 3, 1, 0).contiguous(),
            "conv2_b": g("subsampling.conv_in.2.bias"),
            "out_w": g("subsampling.out.weight").T.contiguous(),
            "out_b": g("subsampling.out.bias"),
        },
        "embed": {
            "w": g("embeddings.embedding.0.weight").T.contiguous(),
            "b": g("embeddings.embedding.0.bias"),
            "ln_w": g("embeddings.embedding.1.weight"),
            "ln_b": g("embeddings.embedding.1.bias"),
        },
        "layers": {ours: stack(lay + hf, tr) for hf, ours, tr in _WHALE_LAYER},
        "ln_final": {"w": g("encoder.layer_norm.weight"), "b": g("encoder.layer_norm.bias")},
    }


def vision_projector_from_hf(state: Mapping[str, Any], prefix: str = "", dtype=torch.float32,
                             kind: str = "mlp2x_gelu", template=None,
                             device=None) -> Dict[str, Any]:
    """mlp2x_gelu from the reference's linear_1/linear_2 layout; any other
    kind fills ``template`` (an ``init_vision_projector_kind`` tree, meta
    tensors will do) from its ``native.<path>`` leaves."""
    g = _getter(state, dtype, device, prefix)
    if kind == "mlp2x_gelu":
        return {"fc1_w": g("linear_1.weight").T.contiguous(), "fc1_b": g("linear_1.bias"),
                "fc2_w": g("linear_2.weight").T.contiguous(), "fc2_b": g("linear_2.bias")}
    if kind == "identity":
        return {}
    if template is None:
        raise ValueError(f"loading projector kind {kind!r} needs a template")

    def fill(tree, path=""):
        if isinstance(tree, Mapping):
            return {k: fill(v, f"{path}{k}.") for k, v in tree.items()}
        return g(f"native.{path[:-1]}").reshape(tree.shape)

    return fill(template)


def audio_projector_from_hf(state: Mapping[str, Any], prefix: str = "", dtype=torch.float32,
                            device=None) -> Dict[str, Any]:
    g = _getter(state, dtype, device, prefix)
    return {
        # [2D, D, k] -> [k, D, 2D]
        "conv_w": g("conv1d.weight").permute(2, 1, 0).contiguous(),
        "conv_b": g("conv1d.bias"),
        "ln_w": g("norm.weight"), "ln_b": g("norm.bias"),
        "proj_w": g("linear.weight").T.contiguous(), "proj_b": g("linear.bias"),
    }


def eva_params_from_reference(state: Mapping[str, Any], n_layers: int, dtype=torch.float32,
                              device=None) -> Dict[str, Any]:
    """The reference's EVA ViT weights (eva_clip/eva_vit.py, as
    Eva2LargePlusEncoder builds it) -> the port's EVA params. ``n_layers``
    is the effective depth: the reference's forward skips its last block,
    so a depth-24 checkpoint imports as 23 and blocks.23.* is dropped. The
    rope tables are rebuilt (eva_clip.vision_rope_tables), not imported."""
    g = _getter(state, dtype, device)
    stack = _stacker(g, n_layers)
    pw = g("patch_embed.proj.weight")  # [D, 3, p, p]
    lay = "blocks.{l}."
    return {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).T.contiguous(),
                        "b": g("patch_embed.proj.bias")},
        "cls": g("cls_token").reshape(-1),
        "pos_embed": g("pos_embed")[0],
        "layers": {ours: stack(lay + hf, tr) for hf, ours, tr in _EVA_LAYER},
    }


_EVA_LAYER = [
    ("attn.q_proj.weight", "q_w", True), ("attn.q_bias", "q_b", False),
    ("attn.k_proj.weight", "k_w", True),
    ("attn.v_proj.weight", "v_w", True), ("attn.v_bias", "v_b", False),
    ("attn.inner_attn_ln.weight", "inner_ln_w", False),
    ("attn.inner_attn_ln.bias", "inner_ln_b", False),
    ("attn.proj.weight", "o_w", True), ("attn.proj.bias", "o_b", False),
    ("mlp.w1.weight", "w1", True), ("mlp.w1.bias", "w1_b", False),
    ("mlp.w2.weight", "w2", True), ("mlp.w2.bias", "w2_b", False),
    ("mlp.ffn_ln.weight", "ffn_ln_w", False), ("mlp.ffn_ln.bias", "ffn_ln_b", False),
    ("mlp.w3.weight", "w3", True), ("mlp.w3.bias", "w3_b", False),
    ("norm1.weight", "ln1_w", False), ("norm1.bias", "ln1_b", False),
    ("norm2.weight", "ln2_w", False), ("norm2.bias", "ln2_b", False),
]
# transformers' CLIP and SigLIP encoder layers (under encoder.layers.{l}.)
_HF_VIT_LAYER = [
    ("self_attn.q_proj.weight", "q_w", True), ("self_attn.q_proj.bias", "q_b", False),
    ("self_attn.k_proj.weight", "k_w", True), ("self_attn.k_proj.bias", "k_b", False),
    ("self_attn.v_proj.weight", "v_w", True), ("self_attn.v_proj.bias", "v_b", False),
    ("self_attn.out_proj.weight", "o_w", True), ("self_attn.out_proj.bias", "o_b", False),
    ("mlp.fc1.weight", "fc1_w", True), ("mlp.fc1.bias", "fc1_b", False),
    ("mlp.fc2.weight", "fc2_w", True), ("mlp.fc2.bias", "fc2_b", False),
    ("layer_norm1.weight", "ln1_w", False), ("layer_norm1.bias", "ln1_b", False),
    ("layer_norm2.weight", "ln2_w", False), ("layer_norm2.bias", "ln2_b", False),
]


def clip_params_from_hf(state: Mapping[str, Any], n_layers: int, dtype=torch.float32,
                        device=None) -> Dict[str, Any]:
    """A transformers CLIPVisionModel state dict -> the port's CLIP params
    (the conv patch embedding has no bias)."""
    g = _getter(state, dtype, device, "vision_model.")
    stack = _stacker(g, n_layers)
    pw = g("embeddings.patch_embedding.weight")  # [D, 3, p, p]
    lay = "encoder.layers.{l}."
    return {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).T.contiguous()},
        "cls": g("embeddings.class_embedding"),
        "pos_embed": g("embeddings.position_embedding.weight"),
        "pre_ln": {"w": g("pre_layrnorm.weight"), "b": g("pre_layrnorm.bias")},
        "layers": {ours: stack(lay + hf, tr) for hf, ours, tr in _HF_VIT_LAYER},
    }


def siglip_params_from_hf(state: Mapping[str, Any], n_layers: int, dtype=torch.float32,
                          device=None) -> Dict[str, Any]:
    """A transformers SiglipVisionModel state dict -> the port's SigLIP
    params."""
    g = _getter(state, dtype, device, "vision_model.")
    stack = _stacker(g, n_layers)
    pw = g("embeddings.patch_embedding.weight")
    lay = "encoder.layers.{l}."
    return {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).T.contiguous(),
                        "b": g("embeddings.patch_embedding.bias")},
        "pos_embed": g("embeddings.position_embedding.weight"),
        "layers": {ours: stack(lay + hf, tr) for hf, ours, tr in _HF_VIT_LAYER},
        "post_ln": {"w": g("post_layernorm.weight"), "b": g("post_layernorm.bias")},
    }


# ---------------------------------------------------------------------------
# export: the inverse tables, float32 on the parameters' device
# ---------------------------------------------------------------------------
def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().float()


def mixtral_params_to_hf(params, cfg, prefix: str = "model.") -> Tensors:
    """The port's Mixtral params -> HF state-dict names (the inverse of
    mixtral_params_from_hf)."""
    out: Tensors = {
        f"{prefix}embed_tokens.weight": _f32(params["embed"]),
        f"{prefix}norm.weight": _f32(params["ln_final"]),
        "lm_head.weight": _f32(params["lm_head"]).T,
    }
    attn, moe = params["layers"]["attn"], params["layers"]["moe"]
    for l in range(cfg.n_layers):
        lay = f"{prefix}layers.{l}."
        for hf, ours in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"),
                         ("o_proj", "wo")):
            out[lay + f"self_attn.{hf}.weight"] = _f32(attn[ours][l]).T
        out[lay + "block_sparse_moe.gate.weight"] = _f32(moe["router"][l]).T
        for e in range(cfg.n_experts):
            ex = lay + f"block_sparse_moe.experts.{e}."
            out[ex + "w1.weight"] = _f32(moe["w_gate"][l, e]).T
            out[ex + "w3.weight"] = _f32(moe["w_up"][l, e]).T
            out[ex + "w2.weight"] = _f32(moe["w_down"][l, e]).T
        out[lay + "input_layernorm.weight"] = _f32(params["layers"]["ln_attn"][l])
        out[lay + "post_attention_layernorm.weight"] = _f32(params["layers"]["ln_moe"][l])
    return out


def _layers_to_hf(layers, n_layers: int, table) -> Tensors:
    return {f"encoder.layers.{l}.{hf}": _f32(layers[ours][l]).T if tr else _f32(layers[ours][l])
            for l in range(n_layers) for hf, ours, tr in table}


def internvit_params_to_hf(params, n_layers: int) -> Tensors:
    """The inverse of internvit_params_from_hf."""
    pw = _f32(params["patch_embed"]["w"]).T  # [D, p*p*3]
    side = int(round((pw.shape[1] // 3) ** 0.5))
    return {
        "embeddings.patch_embedding.weight": pw.reshape(pw.shape[0], 3, side, side),
        "embeddings.patch_embedding.bias": _f32(params["patch_embed"]["b"]),
        "embeddings.class_embedding": _f32(params["cls"]),
        "embeddings.position_embedding": _f32(params["pos_embed"]),
        **_layers_to_hf(params["layers"], n_layers, _INTERNVIT_LAYER),
    }


def whale_params_to_hf(params, n_layers: int) -> Tensors:
    """The inverse of whale_params_from_hf. CMVN is not part of the HF
    state dict (it ships in the feature extractor's config)."""
    sub, emb = params["sub"], params["embed"]
    return {
        "subsampling.conv_in.0.weight": _f32(sub["conv1_w"]).permute(3, 2, 0, 1),
        "subsampling.conv_in.0.bias": _f32(sub["conv1_b"]),
        "subsampling.conv_in.2.weight": _f32(sub["conv2_w"]).permute(3, 2, 0, 1),
        "subsampling.conv_in.2.bias": _f32(sub["conv2_b"]),
        "subsampling.out.weight": _f32(sub["out_w"]).T,
        "subsampling.out.bias": _f32(sub["out_b"]),
        "embeddings.embedding.0.weight": _f32(emb["w"]).T,
        "embeddings.embedding.0.bias": _f32(emb["b"]),
        "embeddings.embedding.1.weight": _f32(emb["ln_w"]),
        "embeddings.embedding.1.bias": _f32(emb["ln_b"]),
        "encoder.layer_norm.weight": _f32(params["ln_final"]["w"]),
        "encoder.layer_norm.bias": _f32(params["ln_final"]["b"]),
        **_layers_to_hf(params["layers"], n_layers, _WHALE_LAYER),
    }


def vision_projector_to_hf(params, kind: str = "mlp2x_gelu") -> Tensors:
    """mlp2x_gelu in the reference's layout; any other kind as its own
    leaves under ``native.<path>`` (no reference layout exists for them)."""
    if kind == "mlp2x_gelu":
        return {"linear_1.weight": _f32(params["fc1_w"]).T,
                "linear_1.bias": _f32(params["fc1_b"]),
                "linear_2.weight": _f32(params["fc2_w"]).T,
                "linear_2.bias": _f32(params["fc2_b"])}

    def paths(tree, prefix=""):
        if isinstance(tree, Mapping):
            return [item for k in sorted(tree) for item in paths(tree[k], f"{prefix}{k}.")]
        return [(prefix[:-1], tree)]

    return {f"native.{p}": _f32(v) for p, v in paths(params)}


def audio_projector_to_hf(params) -> Tensors:
    return {
        "conv1d.weight": _f32(params["conv_w"]).permute(2, 1, 0),
        "conv1d.bias": _f32(params["conv_b"]),
        "norm.weight": _f32(params["ln_w"]), "norm.bias": _f32(params["ln_b"]),
        "linear.weight": _f32(params["proj_w"]).T, "linear.bias": _f32(params["proj_b"]),
    }


def vita_params_to_hf(params, cfg) -> Tensors:
    """The whole model in the deployed HF layout (the inverse of
    checkpoint's HF import; the reference's tables at
    web_demo/vllm_tools/vllm_file/mixtral.py:1189-1329)."""
    if cfg.vision_tower != "internvit":
        raise ValueError(f"the HF deploy layout holds the internvit tower only, got "
                         f"vision_tower={cfg.vision_tower!r}")
    parts = (
        ("language_model.", mixtral_params_to_hf(params["llm"], cfg.llm, prefix="model.")),
        ("vision_tower.", internvit_params_to_hf(params["vision"], cfg.vision.n_layers)),
        ("vision_projector.", vision_projector_to_hf(params["vision_proj"],
                                                     kind=cfg.vision_projector)),
        ("audio_model.", whale_params_to_hf(params["audio"], cfg.audio.n_layers)),
        ("audio_projector.", audio_projector_to_hf(params["audio_proj"])),
    )
    return {pre + k: v for pre, part in parts for k, v in part.items()}
