"""VITA omni-modal model: encoders + projectors + Mixtral, fused
(vita_tpu.models.vita).

The host expands every media placeholder to its exact feature count, so
fusing is a cumsum-gather: the k-th True position of a mask takes the k-th
feature row. The tower is picked from a registry (InternViT, the shipped
one; CLIP, SigLIP, EVA-CLIP) and the vision projector from
``projectors.PROJECTOR_KINDS``; 'patch' and 'framecat' fusion both are
ported. ``forward`` (fusion, then the cacheless LLM) is the training
forward; gradients reach a tower or a projector whose parameters require
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from vita_tpu_torch.constants import IGNORE_INDEX
from vita_tpu_torch.models import clip, eva_clip, internvit, mixtral, projectors, siglip, whale

# the vision tower registry (the reference's build_vision_tower dispatch,
# applied to the fused model)
_TOWER_MODULES = {"internvit": internvit, "clip": clip, "siglip": siglip, "eva": eva_clip}

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VITAConfig:
    llm: mixtral.MixtralConfig = dataclasses.field(default_factory=mixtral.MixtralConfig)
    vision: Any = dataclasses.field(default_factory=internvit.InternViTConfig)
    audio: whale.WhaleConfig = dataclasses.field(default_factory=whale.WhaleConfig)
    audio_adapter_kernel: int = 5
    vision_tower: str = "internvit"  # key of _TOWER_MODULES
    vision_fusion: str = "patch"  # 'patch' | 'framecat'
    vision_projector: str = "mlp2x_gelu"  # one of projectors.PROJECTOR_KINDS

    @property
    def vision_proj_in_dim(self) -> int:
        return self.vision.out_dim * (5 if self.vision_fusion == "framecat" else 1)

    @property
    def image_tokens_per_group(self) -> int:
        """LLM tokens per <image> sentinel: tower tokens over the
        projector's reduction (SPP/LDP/vanilla/minigpt merge 4 into 1)."""
        return self.vision.out_tokens // projectors.projector_token_reduction(
            self.vision_projector)

    @property
    def image_group_tiles(self) -> int:
        """Tiles consumed per <image> sentinel group (5 for framecat)."""
        return 5 if self.vision_fusion == "framecat" else 1

    @property
    def tower_module(self):
        try:
            return _TOWER_MODULES[self.vision_tower]
        except KeyError:
            raise ValueError(f"unknown vision_tower {self.vision_tower!r}; "
                             f"known: {sorted(_TOWER_MODULES)}") from None

    @staticmethod
    def vita_8x7b(**kw) -> "VITAConfig":
        return VITAConfig(
            llm=mixtral.MixtralConfig.vita_8x7b(),
            vision=internvit.InternViTConfig.vita_300m(dtype=torch.bfloat16),
            audio=whale.WhaleConfig.vita(dtype=torch.bfloat16),
            **kw,
        )

    @staticmethod
    def tiny(**kw) -> "VITAConfig":
        """All three submodels tiny, dims consistent for fusion tests."""
        return VITAConfig(
            llm=mixtral.MixtralConfig.tiny(),
            vision=internvit.InternViTConfig.tiny(),
            audio=whale.WhaleConfig.tiny(),
            **kw,
        )


def init_params(cfg: VITAConfig, generator: torch.Generator, device=None) -> Params:
    """Random weights with the JAX init's scales, drawn on ``device``."""
    d_llm, dt = cfg.llm.d_model, cfg.llm.dtype
    return {
        "llm": mixtral.init_params(cfg.llm, generator, device),
        "vision": cfg.tower_module.init_params(cfg.vision, generator, device),
        "vision_proj": projectors.init_vision_projector_kind(
            cfg.vision_proj_in_dim, d_llm, generator, cfg.vision_projector, device, dt),
        "audio": whale.init_params(cfg.audio, generator, device),
        "audio_proj": projectors.init_audio_projector(
            cfg.audio.hidden, d_llm, generator, cfg.audio_adapter_kernel, device, dt),
    }


def encode_images(params: Params, cfg: VITAConfig, images: torch.Tensor) -> torch.Tensor:
    """images [N_tiles, H, W, 3] -> LLM-space features [N_groups, T, D];
    framecat channel-concatenates each 5-tuple [mosaic, f1..f4] after the
    tower."""
    feats = cfg.tower_module.forward(params["vision"], cfg.vision, images)
    if cfg.vision_fusion == "framecat":
        n, t, c = feats.shape
        if n % 5:
            raise ValueError(f"framecat needs tiles in 5-tuples, got {n}")
        feats = feats.reshape(n // 5, 5, t, c).transpose(1, 2).reshape(n // 5, t, 5 * c)
    return projectors.apply_vision_projector(params["vision_proj"], feats, cfg.vision_projector)


def encode_audio(
    params: Params, cfg: VITAConfig, speech: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """speech [B, T, 80], lengths [B] -> (features [B, T'', D], valid [B, T''])."""
    feats, valid = whale.forward(params["audio"], cfg.audio, speech, lengths)
    return projectors.audio_projector(params["audio_proj"], feats, valid)


def _gather_rows(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row cumsum(mask)-1 of ``feats`` for every position (clamped)."""
    idx = (torch.cumsum(mask.long(), dim=1) - 1).clamp(0, feats.shape[1] - 1)
    return feats.gather(1, idx[..., None].expand(-1, -1, feats.shape[-1]))


def merge_embeddings(
    token_embeds: torch.Tensor,  # [B, S, D]
    image_mask: torch.Tensor,  # [B, S] bool
    audio_mask: torch.Tensor,  # [B, S] bool
    image_feats: Optional[torch.Tensor] = None,  # [B, N_img, D]
    audio_feats: Optional[torch.Tensor] = None,  # [B, N_aud, D] or [n_clips, T'', D]
    audio_select: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Place media features at their placeholder slots. ``audio_select``
    (clip_idx, row_idx) addresses ``audio_feats`` per clip, for prompts
    with several audio clips."""
    out = token_embeds
    if image_feats is not None:
        gathered = _gather_rows(image_feats, image_mask).to(out.dtype)
        out = torch.where(image_mask[..., None], gathered, out)
    if audio_feats is not None:
        if audio_select is not None:
            clip_idx, row_idx = audio_select
            gathered = audio_feats[
                clip_idx.long().clamp(0, audio_feats.shape[0] - 1),
                row_idx.long().clamp(0, audio_feats.shape[1] - 1),
            ]
        else:
            gathered = _gather_rows(audio_feats, audio_mask)
        out = torch.where(audio_mask[..., None], gathered.to(out.dtype), out)
    return out


def fuse_embeddings(
    params: Params,
    cfg: VITAConfig,
    input_ids: torch.Tensor,  # [B, S] sentinel-free ids (0 at media slots)
    image_mask: Optional[torch.Tensor] = None,
    audio_mask: Optional[torch.Tensor] = None,
    images: Optional[torch.Tensor] = None,  # [N_tiles_total, H, W, 3], batch-major
    speech: Optional[torch.Tensor] = None,  # [B, T, 80] (or [n_clips, T, 80])
    speech_lengths: Optional[torch.Tensor] = None,
    audio_select: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    audio_encoded: Optional[torch.Tensor] = None,  # [n_clips, T', whale_hidden]
    audio_encoded_lengths: Optional[torch.Tensor] = None,  # [n_clips]
) -> torch.Tensor:
    """Token embeddings with media features merged in: [B, S, D].

    ``audio_encoded`` carries Whale features encoded ahead of time in
    place of ``speech``; only the audio adapter runs on them."""
    b, s = input_ids.shape
    embeds = params["llm"]["embed"][input_ids.long()]
    image_feats = audio_feats = None
    if images is not None:
        feats = encode_images(params, cfg, images)
        image_feats = feats.reshape(b, -1, feats.shape[-1])
    if speech is not None:
        audio_feats, _ = encode_audio(params, cfg, speech, speech_lengths)
    elif audio_encoded is not None:
        t = torch.arange(audio_encoded.shape[1], device=audio_encoded.device)
        valid = t[None, :] < audio_encoded_lengths[:, None]
        audio_feats, _ = projectors.audio_projector(
            params["audio_proj"], audio_encoded.to(cfg.audio.dtype), valid)
    none = torch.zeros(b, s, dtype=torch.bool, device=input_ids.device)
    return merge_embeddings(
        embeds,
        none if image_mask is None else image_mask,
        none if audio_mask is None else audio_mask,
        image_feats, audio_feats, audio_select=audio_select,
    )


def build_labels(
    input_ids: torch.Tensor,
    media_mask: torch.Tensor,
    answer_mask: torch.Tensor,
) -> torch.Tensor:
    """Next-token labels: IGNORE_INDEX at media slots and non-answer
    positions (prompt, padding), else the token id."""
    return torch.where(answer_mask & ~media_mask, input_ids, IGNORE_INDEX)


def forward(
    params: Params,
    cfg: VITAConfig,
    input_ids: torch.Tensor,  # [B, S] sentinel-free ids (0 at media slots)
    image_mask: Optional[torch.Tensor] = None,
    audio_mask: Optional[torch.Tensor] = None,
    images: Optional[torch.Tensor] = None,  # [N_tiles_total, H, W, 3], batch-major
    speech: Optional[torch.Tensor] = None,  # [B, T, 80]
    speech_lengths: Optional[torch.Tensor] = None,
    attn_valid: Optional[torch.Tensor] = None,  # [B, S]
    cache: Optional[Params] = None,
    token_mask: Optional[torch.Tensor] = None,
    audio_select: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Full multimodal forward. Returns (logits, new_cache, moe_aux)."""
    embeds = fuse_embeddings(
        params, cfg, input_ids, image_mask, audio_mask, images=images, speech=speech,
        speech_lengths=speech_lengths, audio_select=audio_select,
    )
    return mixtral.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds, attn_valid=attn_valid, cache=cache,
        token_mask=token_mask,
    )
