"""InternViT vision tower (vita_tpu.models.internvit).

InternViT-300M as deployed with VITA: 24 layers, hidden 1024, 16 heads,
mlp 4096, 448px tiles, patch 14, LayerNorm eps 1e-6, qkv bias, learnable
layer scales, exact GELU. Output per tile: last hidden state without CLS,
scaled by 0.5, pixel-shuffled x0.5 -> 256 tokens of dim 4096.

Parameters keep the JAX layout (stacked layers, x @ w matrices). The patch
embedding is a patchify reshape plus one matmul; attention is plain
softmax attention (ops.attention.mha_xla), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from vita_tpu_torch.ops.attention import mha_xla
from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class InternViTConfig:
    image_size: int = 448
    patch_size: int = 14
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    ln_eps: float = 1e-6
    pixel_shuffle_scale: float = 0.5
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def out_dim(self) -> int:
        return self.hidden * int(1 / self.pixel_shuffle_scale) ** 2

    @property
    def out_tokens(self) -> int:
        return int(self.num_patches * self.pixel_shuffle_scale ** 2)

    @staticmethod
    def vita_300m(**kw) -> "InternViTConfig":
        return InternViTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "InternViTConfig":
        base = dict(image_size=56, patch_size=14, hidden=32, n_layers=2, n_heads=4, mlp_dim=64)
        base.update(kw)
        return InternViTConfig(**base)


def init_params(cfg: InternViTConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    dt, d, nl = cfg.dtype, cfg.hidden, cfg.n_layers
    pdim = cfg.patch_size * cfg.patch_size * 3
    s = d ** -0.5

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator, device=device, dtype=dt).mul_(scale)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "patch_embed": {"w": nrm((pdim, d), pdim ** -0.5), "b": zeros(d)},
        "cls": nrm((1, 1, d), 0.02),
        "pos_embed": nrm((1, cfg.num_patches + 1, d), 0.02),
        "layers": {
            "qkv_w": nrm((nl, d, 3 * d), s), "qkv_b": zeros(nl, 3 * d),
            "proj_w": nrm((nl, d, d), s), "proj_b": zeros(nl, d),
            "fc1_w": nrm((nl, d, cfg.mlp_dim), s), "fc1_b": zeros(nl, cfg.mlp_dim),
            "fc2_w": nrm((nl, cfg.mlp_dim, d), cfg.mlp_dim ** -0.5), "fc2_b": zeros(nl, d),
            "norm1_w": ones(nl, d), "norm1_b": zeros(nl, d),
            "norm2_w": ones(nl, d), "norm2_b": zeros(nl, d),
            "ls1": ones(nl, d), "ls2": ones(nl, d),
        },
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, (H/p)*(W/p), p*p*3], features ordered (c, kh, kw)
    like a flattened torch Conv2d weight."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """InternVL pixel-unshuffle: [B, G, G, C] -> [B, G*s, G*s, C/s^2]."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale), int(c / scale)).permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale), int(w * scale), int(c / (scale * scale)))
    return x.permute(0, 2, 1, 3)


def _torch_bicubic_matrix(src: int, dst: int) -> torch.Tensor:
    """[dst, src] interpolation matrix matching torch F.interpolate
    mode='bicubic', align_corners=False: cubic convolution kernel with
    a = -0.75 and index clamping at the borders. Same numpy construction
    as the JAX package (whose module cannot be imported without jax)."""
    a = -0.75

    def w(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    m = np.zeros((dst, src), np.float64)
    scale = src / dst
    for i in range(dst):
        s_pos = (i + 0.5) * scale - 0.5
        base = int(np.floor(s_pos))
        t = s_pos - base
        for k in range(-1, 3):
            m[i, min(max(base + k, 0), src - 1)] += w(k - t)
    return torch.from_numpy(m.astype(np.float32))


def interpolate_pos_embed(pos: torch.Tensor, src_grid: int, dst_grid: int) -> torch.Tensor:
    """Bicubic-resize the patch position table [1, src^2+1, D] to dst^2+1;
    the CLS slot passes through."""
    if src_grid == dst_grid:
        return pos
    cls, patch = pos[:, :1], pos[:, 1:]
    d = patch.shape[-1]
    grid = patch.reshape(src_grid, src_grid, d).float()
    m = _torch_bicubic_matrix(src_grid, dst_grid).to(pos.device)
    grid = torch.einsum("ys,sxd->yxd", m, torch.einsum("xs,ysd->yxd", m, grid))
    return torch.cat([cls, grid.reshape(1, dst_grid * dst_grid, d).to(pos.dtype)], dim=1)


@torch.no_grad()
def forward(params: Params, cfg: InternViTConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (preprocessed pixels) -> features [B, T, out_dim]."""
    b, ih, iw = images.shape[:3]
    if ih != iw or ih % cfg.patch_size:
        raise ValueError(
            f"InternViT expects square images with side % {cfg.patch_size} == 0, got {ih}x{iw}"
        )
    if (ih // cfg.patch_size) % 2:
        raise ValueError(
            f"pixel-shuffle x0.5 needs an EVEN patch grid: side {ih} gives "
            f"grid {ih // cfg.patch_size}; use a multiple of {2 * cfg.patch_size}"
        )
    d, nh = cfg.hidden, cfg.n_heads
    g = ih // cfg.patch_size
    x = patchify(images.to(cfg.dtype), cfg.patch_size)
    x = x @ params["patch_embed"]["w"] + params["patch_embed"]["b"]
    cls = params["cls"].expand(b, 1, d).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(params["pos_embed"], cfg.grid, g).to(x.dtype)

    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["norm1_w"], lp["norm1_b"], cfg.ln_eps)
        qkv = (h @ lp["qkv_w"] + lp["qkv_b"]).reshape(b, -1, 3, nh, d // nh)
        attn = mha_xla(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        attn = attn.reshape(b, -1, d) @ lp["proj_w"] + lp["proj_b"]
        x = x + attn * lp["ls1"]
        h = layer_norm(x, lp["norm2_w"], lp["norm2_b"], cfg.ln_eps)
        h = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"])
        x = x + (h @ lp["fc2_w"] + lp["fc2_b"]) * lp["ls2"]

    feats = x[:, 1:].reshape(b, g, g, d)
    feats = pixel_shuffle(feats * cfg.pixel_shuffle_scale, cfg.pixel_shuffle_scale)
    return feats.reshape(b, int(g * g * cfg.pixel_shuffle_scale ** 2), cfg.out_dim)
