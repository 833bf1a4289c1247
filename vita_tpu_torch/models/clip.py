"""CLIP vision tower (vita_tpu.models.clip), an alternative to InternViT.

The reference's CLIPVisionTower around HF CLIPVisionModel: a ViT with a
class embedding, learned positions, a LayerNorm before the encoder
(``pre_ln``), quick-GELU and biased q/k/v/mlp; the features are the
hidden state at ``select_layer`` (-2: the input of the last layer) with
CLS dropped. Parameters keep the JAX layout (stacked layers, x @ w); the
conv patch embedding (no bias) is a patchify reshape plus one matmul, and
attention is plain softmax attention (ops.attention.mha_xla).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from vita_tpu_torch.models.internvit import patchify
from vita_tpu_torch.ops.attention import mha_xla
from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    ln_eps: float = 1e-5
    select_layer: int = -2  # index into the hidden states
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def out_tokens(self) -> int:
        return self.num_patches

    @property
    def out_dim(self) -> int:
        return self.hidden

    @staticmethod
    def tiny(**kw) -> "CLIPConfig":
        base = dict(image_size=56, patch_size=14, hidden=32, n_layers=3, n_heads=4, mlp_dim=64)
        base.update(kw)
        return CLIPConfig(**base)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def init_params(cfg: CLIPConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    dt, d, nl, m = cfg.dtype, cfg.hidden, cfg.n_layers, cfg.mlp_dim
    s = d ** -0.5

    def nrm(shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=dt).mul_(scale)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "patch_embed": {"w": nrm((cfg.patch_size ** 2 * 3, d))},
        "cls": nrm((d,)),
        "pos_embed": nrm((cfg.num_patches + 1, d)),
        "pre_ln": {"w": ones(d), "b": zeros(d)},
        "layers": {
            "q_w": nrm((nl, d, d), s), "q_b": zeros(nl, d),
            "k_w": nrm((nl, d, d), s), "k_b": zeros(nl, d),
            "v_w": nrm((nl, d, d), s), "v_b": zeros(nl, d),
            "o_w": nrm((nl, d, d), s), "o_b": zeros(nl, d),
            "fc1_w": nrm((nl, d, m), s), "fc1_b": zeros(nl, m),
            "fc2_w": nrm((nl, m, d), m ** -0.5), "fc2_b": zeros(nl, d),
            "ln1_w": ones(nl, d), "ln1_b": zeros(nl, d),
            "ln2_w": ones(nl, d), "ln2_b": zeros(nl, d),
        },
    }


def forward(params: Params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> features at select_layer, CLS dropped: [B, P, hidden]."""
    b, d, nh = images.shape[0], cfg.hidden, cfg.n_heads
    x = patchify(images.to(cfg.dtype), cfg.patch_size) @ params["patch_embed"]["w"]
    cls = params["cls"].expand(b, 1, d).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)
    x = layer_norm(x, params["pre_ln"]["w"], params["pre_ln"]["b"], cfg.ln_eps)
    # hidden_states[select_layer]: the layers before it run, the rest not
    n_run = cfg.n_layers + 1 + cfg.select_layer if cfg.select_layer < 0 else cfg.select_layer
    layers = params["layers"]
    for i in range(min(n_run, cfg.n_layers)):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        q, k, v = ((h @ lp[f"{n}_w"] + lp[f"{n}_b"]).reshape(b, -1, nh, d // nh)
                   for n in ("q", "k", "v"))
        x = x + (mha_xla(q, k, v).reshape(b, -1, d) @ lp["o_w"] + lp["o_b"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        x = x + (quick_gelu(h @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"])
    return x[:, 1:]
