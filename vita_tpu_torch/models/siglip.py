"""SigLIP vision tower and the S2 multiscale wrapper (vita_tpu.models.siglip).

SigLIP: a ViT without CLS, learned positions, tanh-approximated GELU,
biased q/k/v/mlp and a final LayerNorm; the features are the last hidden
state (every patch token). ``s2_multiscale_forward`` is the reference's
s2wrapper: per scale, resize, split into tower-size crops, run the tower
batched, merge the crops back, average-pool to the base grid, and
concatenate the scales' channels. Parameters keep the JAX layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from vita_tpu_torch.models.internvit import patchify
from vita_tpu_torch.ops.attention import mha_xla
from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden: int = 1152
    n_layers: int = 27
    n_heads: int = 16
    mlp_dim: int = 4304
    ln_eps: float = 1e-6
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
    def tiny(**kw) -> "SigLIPConfig":
        base = dict(image_size=56, patch_size=14, hidden=32, n_layers=2, n_heads=4, mlp_dim=64)
        base.update(kw)
        return SigLIPConfig(**base)


def init_params(cfg: SigLIPConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    dt, d, nl, m = cfg.dtype, cfg.hidden, cfg.n_layers, cfg.mlp_dim
    s = d ** -0.5

    def nrm(shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=dt).mul_(scale)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "patch_embed": {"w": nrm((cfg.patch_size ** 2 * 3, d)), "b": zeros(d)},
        "pos_embed": nrm((cfg.num_patches, d)),
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
        "post_ln": {"w": ones(d), "b": zeros(d)},
    }


def forward(params: Params, cfg: SigLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> last hidden state [B, P, hidden] (no CLS to drop)."""
    b, d, nh = images.shape[0], cfg.hidden, cfg.n_heads
    x = patchify(images.to(cfg.dtype), cfg.patch_size)
    x = x @ params["patch_embed"]["w"] + params["patch_embed"]["b"]
    x = x + params["pos_embed"].to(x.dtype)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        q, k, v = ((h @ lp[f"{n}_w"] + lp[f"{n}_b"]).reshape(b, -1, nh, d // nh)
                   for n in ("q", "k", "v"))
        x = x + (mha_xla(q, k, v).reshape(b, -1, d) @ lp["o_w"] + lp["o_b"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        h = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh")
        x = x + (h @ lp["fc2_w"] + lp["fc2_b"])
    return layer_norm(x, params["post_ln"]["w"], params["post_ln"]["b"], cfg.ln_eps)


def _resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, 3] with half-pixel centres, as
    jax.image.resize(..., "bilinear"): no antialiasing up, a triangle
    filter widened by the factor down. Held against it at the factory's
    scales (base and 2 x base, from a 2 x base input: a 2x downscale and
    the identity); other factors are not checked."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=size < images.shape[1])
    return x.permute(0, 2, 3, 1).to(images.dtype)


def s2_multiscale_forward(
    tower_fn: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,  # [B, H, W, 3] at the largest scale
    scales: Sequence[int],
    base_size: int,
) -> torch.Tensor:
    """The s2wrapper forward: [B, base_grid^2, C * len(scales)]."""
    b = images.shape[0]
    outs: List[torch.Tensor] = []
    base_grid = None
    for scale in scales:
        n = scale // base_size
        img = _resize(images, scale)
        crops = img.reshape(b, n, base_size, n, base_size, 3).permute(0, 1, 3, 2, 4, 5)
        feats = tower_fn(crops.reshape(b * n * n, base_size, base_size, 3))  # [B*n^2, P, C]
        g = int(feats.shape[1] ** 0.5)
        base_grid = base_grid or g
        # the crops merged back into one map [B, n*g, n*g, C]
        feats = feats.reshape(b, n, n, g, g, -1).permute(0, 1, 3, 2, 4, 5)
        feats = feats.reshape(b, n * g, n * g, -1)
        if n > 1:
            feats = feats.reshape(b, base_grid, n, base_grid, n, -1).mean(dim=(2, 4))
        outs.append(feats.reshape(b, base_grid * base_grid, -1))
    return torch.cat(outs, dim=-1)
