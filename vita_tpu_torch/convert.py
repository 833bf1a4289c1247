"""Weight bridge from the JAX package's parameter pytree to the port's.

Both packages keep the same dict structure and layouts (stacked layers,
x @ w matrices, [L, E, D, F] experts, [D, V] lm_head, HWIO conv kernels),
so the bridge converts leaf by leaf and checks every shape and dtype
against what the port's ``init_params`` would build for ``cfg``. A pytree
whose experts were quantized for decode (``quantize_moe_for_decode``:
int8 or int4 weights with float32 ``*_scale`` leaves) is checked against
the same quantization of that layout. This module takes numpy arrays
(``jax.device_get`` of the pytree) and imports no jax.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vita_tpu_torch.models import mixtral, vita
from vita_tpu_torch.ops import moe_decode


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # an owned, writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree: Any, like: Any, device, path: str) -> Any:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: keys {got} != expected {sorted(like)}")
        return {k: _convert(tree[k], like[k], device, f"{path}.{k}" if path else k)
                for k in like}
    t = _to_tensor(tree, device)
    if t.shape != like.shape or t.dtype != like.dtype:
        raise ValueError(
            f"{path}: got {tuple(t.shape)} {t.dtype}, expected {tuple(like.shape)} {like.dtype}"
        )
    return t


def _quantized_like(moe_like: Any, moe_np: Any) -> Any:
    """The expert subtree as quantize_expert_weights[_int4] makes it from
    ``moe_like`` (meta tensors), with the bit width and the int4 group
    read off the numpy subtree: int4 gate weights hold D/2 rows."""
    d = moe_like["w_gate"].shape[-2]
    if np.shape(moe_np["w_gate"])[-2] * 2 != d:
        return moe_decode.quantize_expert_weights(moe_like)
    n_groups = np.shape(moe_np["w_gate_scale"])[-2]
    return moe_decode.quantize_expert_weights_int4(
        moe_like, group=d // n_groups if n_groups > 1 else 0)


def from_jax_params(params_np: Any, cfg, device=None) -> Any:
    """Port parameters from the numpy pytree of
    ``vita_tpu.models.vita.init_params`` (``cfg`` a VITAConfig) or of
    ``vita_tpu.models.mixtral.init_params`` (``cfg`` a MixtralConfig),
    either as initialised or with its experts quantized for decode."""
    if isinstance(cfg, vita.VITAConfig):
        like = vita.init_params(cfg, None, device="meta")
        llm_like, llm_np = like["llm"], params_np.get("llm", {})
    elif isinstance(cfg, mixtral.MixtralConfig):
        like = llm_like = mixtral.init_params(cfg, None, device="meta")
        llm_np = params_np
    else:
        raise TypeError(f"cfg must be a VITAConfig or MixtralConfig, got {type(cfg).__name__}")
    moe_np = llm_np.get("layers", {}).get("moe", {})
    if isinstance(moe_np, dict) and "w_gate_scale" in moe_np:
        llm_like["layers"]["moe"] = _quantized_like(llm_like["layers"]["moe"], moe_np)
    return _convert(params_np, like, device, "")
