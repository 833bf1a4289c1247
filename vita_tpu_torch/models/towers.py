"""Vision-tower factory (vita_tpu.models.towers): the reference's
build_vision_tower, which picks a tower by substrings of its name:
InternViT (the shipped one), CLIP, SigLIP, SigLIP with S2 and EVA-CLIP.
Each tower has one surface: its config, ``init(generator, device)`` and
``forward(params, images [B, H, W, 3]) -> [B, T, out_dim]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from vita_tpu_torch.models import clip as clip_mod
from vita_tpu_torch.models import eva_clip as eva_mod
from vita_tpu_torch.models import internvit as internvit_mod
from vita_tpu_torch.models import siglip as siglip_mod


@dataclasses.dataclass(frozen=True)
class Tower:
    name: str
    cfg: Any
    init: Callable  # (generator, device=None) -> params
    forward: Callable  # (params, images) -> [B, T, out_dim]
    out_dim: int


def build_vision_tower(name: str, tiny: bool = False, **overrides) -> Tower:
    """Name matching as the reference factory's: 'internvit' (or
    'intern_vit'), 'siglip' with 's2', 'siglip', 'eva', 'clip'."""
    lname = name.lower()
    if "internvit" in lname or "intern_vit" in lname:
        cfg = (internvit_mod.InternViTConfig.tiny(**overrides) if tiny
               else internvit_mod.InternViTConfig.vita_300m(**overrides))
        return Tower("internvit", cfg, functools.partial(internvit_mod.init_params, cfg),
                     lambda p, x: internvit_mod.forward(p, cfg, x), cfg.out_dim)
    if "siglip" in lname and "s2" in lname:
        cfg = (siglip_mod.SigLIPConfig.tiny(**overrides) if tiny
               else siglip_mod.SigLIPConfig(**overrides))
        scales = (cfg.image_size, cfg.image_size * 2)

        def fwd(p, x):
            return siglip_mod.s2_multiscale_forward(
                lambda crops: siglip_mod.forward(p, cfg, crops), x, scales=scales,
                base_size=cfg.image_size)

        return Tower("siglip-s2", cfg, functools.partial(siglip_mod.init_params, cfg), fwd,
                     cfg.out_dim * len(scales))
    if "siglip" in lname:
        cfg = (siglip_mod.SigLIPConfig.tiny(**overrides) if tiny
               else siglip_mod.SigLIPConfig(**overrides))
        return Tower("siglip", cfg, functools.partial(siglip_mod.init_params, cfg),
                     lambda p, x: siglip_mod.forward(p, cfg, x), cfg.out_dim)
    if "eva" in lname:
        cfg = eva_mod.EVAConfig.tiny(**overrides) if tiny else eva_mod.EVAConfig(**overrides)
        return Tower("eva-clip", cfg, functools.partial(eva_mod.init_params, cfg),
                     lambda p, x: eva_mod.forward(p, cfg, x), cfg.out_dim)
    if "clip" in lname:
        cfg = clip_mod.CLIPConfig.tiny(**overrides) if tiny else clip_mod.CLIPConfig(**overrides)
        return Tower("clip", cfg, functools.partial(clip_mod.init_params, cfg),
                     lambda p, x: clip_mod.forward(p, cfg, x), cfg.out_dim)
    raise ValueError(f"unknown vision tower {name!r}")
