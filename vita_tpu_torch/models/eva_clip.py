"""EVA02-CLIP vision tower (vita_tpu.models.eva_clip).

EVA02-CLIP-L-14-336 as the reference's Eva2LargePlusEncoder builds it:
width 1024, 16 heads of 64, SwiGLU with mlp_ratio 8/3, sub-LayerNorm (an
inner LayerNorm on the attention output and on the FFN hidden), 2-D axial
rotary embeddings on the patch tokens' q and k (CLS unrotated), q and v
biases and no k bias, learned absolute positions; the output is every
patch feature, CLS dropped. The reference skips its last block, so the
effective depth is 23 (``utils.hf_import.eva_params_from_reference``
drops the dead block). Parameters keep the JAX layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vita_tpu_torch.models.internvit import patchify
from vita_tpu_torch.ops.attention import mha_xla
from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EVAConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden: int = 1024
    n_layers: int = 23  # EVA02-L's 24 blocks less the one the reference skips
    n_heads: int = 16
    mlp_ratio: float = 8 / 3  # SwiGLU hidden = int(hidden * ratio)
    ln_eps: float = 1e-6
    rope_pt_seq_len: int = 16  # pretraining grid side, for rope frequency interpolation
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden * self.mlp_ratio)

    @property
    def out_tokens(self) -> int:
        return self.num_patches

    @property
    def out_dim(self) -> int:
        return self.hidden

    @staticmethod
    def tiny(**kw) -> "EVAConfig":
        base = dict(image_size=56, patch_size=14, hidden=32, n_layers=2, n_heads=4,
                    rope_pt_seq_len=4)
        base.update(kw)
        return EVAConfig(**base)


def vision_rope_tables(cfg: EVAConfig) -> Tuple[np.ndarray, np.ndarray]:
    """2-D axial rotary tables (cos, sin) [grid^2, head_dim]: half the head
    dim rotates with the row, half with the column, in interleaved pairs;
    frequencies scaled by rope_pt_seq_len / grid."""
    hd = cfg.head_dim
    dim_side = hd // 2
    freqs = 1.0 / (10000 ** (np.arange(0, dim_side, 2, dtype=np.float64) / dim_side))
    g = cfg.grid
    t = np.arange(g, dtype=np.float64) * (cfg.rope_pt_seq_len / g)
    angles = np.repeat(np.outer(t, freqs), 2, axis=-1)  # [g, dim_side]
    row = np.broadcast_to(angles[:, None, :], (g, g, angles.shape[-1]))
    col = np.broadcast_to(angles[None, :, :], (g, g, angles.shape[-1]))
    ang = np.concatenate([row, col], axis=-1).reshape(g * g, hd)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs (x0, x1) -> (-x1, x0)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_vision_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D] patch tokens (no CLS)."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x * c + _rotate_pairs(x) * s).to(x.dtype)


def init_params(cfg: EVAConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    dt, d, nl, mh = cfg.dtype, cfg.hidden, cfg.n_layers, cfg.mlp_hidden
    s = d ** -0.5

    def nrm(shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=dt).mul_(scale)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "patch_embed": {"w": nrm((cfg.patch_size ** 2 * 3, d)), "b": zeros(d)},
        "cls": nrm((d,)),
        "pos_embed": nrm((cfg.num_patches + 1, d)),
        "layers": {
            "q_w": nrm((nl, d, d), s), "q_b": zeros(nl, d),
            "k_w": nrm((nl, d, d), s),  # no k bias
            "v_w": nrm((nl, d, d), s), "v_b": zeros(nl, d),
            "inner_ln_w": ones(nl, d), "inner_ln_b": zeros(nl, d),
            "o_w": nrm((nl, d, d), s), "o_b": zeros(nl, d),
            "w1": nrm((nl, d, mh), s), "w1_b": zeros(nl, mh),
            "w2": nrm((nl, d, mh), s), "w2_b": zeros(nl, mh),
            "ffn_ln_w": ones(nl, mh), "ffn_ln_b": zeros(nl, mh),
            "w3": nrm((nl, mh, d), mh ** -0.5), "w3_b": zeros(nl, d),
            "ln1_w": ones(nl, d), "ln1_b": zeros(nl, d),
            "ln2_w": ones(nl, d), "ln2_b": zeros(nl, d),
        },
    }


def forward(params: Params, cfg: EVAConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> patch features [B, P, hidden] (CLS dropped)."""
    b, d, nh, hd = images.shape[0], cfg.hidden, cfg.n_heads, cfg.head_dim
    cos, sin = (torch.from_numpy(t).to(images.device) for t in vision_rope_tables(cfg))
    x = patchify(images.to(cfg.dtype), cfg.patch_size)
    x = x @ params["patch_embed"]["w"] + params["patch_embed"]["b"]
    cls = params["cls"].expand(b, 1, d).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)

    def rope(t):  # CLS keeps its unrotated projection
        return torch.cat([t[:, :1], apply_vision_rope(t[:, 1:], cos, sin)], dim=1)

    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        t = h.shape[1]
        q = rope((h @ lp["q_w"] + lp["q_b"]).reshape(b, t, nh, hd))
        k = rope((h @ lp["k_w"]).reshape(b, t, nh, hd))
        v = (h @ lp["v_w"] + lp["v_b"]).reshape(b, t, nh, hd)
        attn = mha_xla(q, k, v, scale=hd ** -0.5).reshape(b, t, d)
        attn = layer_norm(attn, lp["inner_ln_w"], lp["inner_ln_b"], cfg.ln_eps)  # sub-LN
        x = x + (attn @ lp["o_w"] + lp["o_b"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        hidden = F.silu(h @ lp["w1"] + lp["w1_b"]) * (h @ lp["w2"] + lp["w2_b"])
        hidden = layer_norm(hidden, lp["ffn_ln_w"], lp["ffn_ln_b"], cfg.ln_eps)  # sub-LN
        x = x + (hidden @ lp["w3"] + lp["w3_b"])
    return x[:, 1:]
