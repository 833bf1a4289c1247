"""LoRA: low-rank adapters over the LLM's linear weights (vita_tpu.train.lora).

Adapters on every attention and expert matrix and the router, trained
with the base frozen. LoRA parameters are a separate nested dict mirroring
a subset of the LLM's; ``apply_lora`` builds the merged view
W + (alpha / r) B A per stacked layer, so the model code is unchanged, and
``merge_lora`` folds the adapters into a full parameter dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

Params = Dict[str, Any]

# LLM weight leaves that receive adapters
LORA_TARGETS = (
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
    ("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down"),
    ("moe", "router"),
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora(generator: torch.Generator, llm_params: Params, cfg: LoRAConfig) -> Params:
    """A/B factors for each target leaf: A ~ N(0, 1/r), B = 0, so the
    adapted model starts equal to the base."""
    layers = llm_params["layers"]
    out: Params = {"layers": {"attn": {}, "moe": {}}}
    for grp, name in LORA_TARGETS:
        w = layers[grp][name]
        *lead, d_in, d_out = w.shape
        a = torch.randn((*lead, cfg.rank, d_out), generator=generator, device=w.device,
                        dtype=w.dtype) * cfg.rank ** -0.5
        b = torch.zeros((*lead, d_in, cfg.rank), device=w.device, dtype=w.dtype)
        out["layers"][grp][name] = {"a": a, "b": b}
    return out


def apply_lora(llm_params: Params, lora: Params, cfg: LoRAConfig) -> Params:
    """Merged-view params: W' = W + scale * B @ A (per stacked layer)."""
    layers = dict(llm_params["layers"])
    for grp, name in LORA_TARGETS:
        ad = lora["layers"][grp][name]
        w = layers[grp][name]
        delta = torch.einsum("...ir,...ro->...io", ad["b"], ad["a"]) * cfg.scale
        layers[grp] = {**layers[grp], name: w + delta.to(w.dtype)}
    return {**llm_params, "layers": layers}


def merge_lora(params: Params, lora: Params, cfg: LoRAConfig) -> Params:
    """Fold adapters into a full VITA parameter dict; only params['llm']
    changes."""
    return {**params, "llm": apply_lora(params["llm"], lora, cfg)}


def lora_loss_fn(base_params, lora, vita_cfg, lora_cfg, batch, aux_coef, loss_fn):
    """A loss over (frozen base, trainable lora)."""
    return loss_fn(merge_lora(base_params, lora, lora_cfg), vita_cfg, batch, aux_coef)
