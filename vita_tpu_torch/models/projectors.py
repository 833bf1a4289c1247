"""Modality projectors (vita_tpu.models.projectors): the vision projector
registry and the audio CNN-subsampling adapter.

Vision: the shipped mlp2x_gelu is Linear(in, D) -> exact GELU ->
Linear(D, D) (``init_vision_projector``, the round-1 leaf layout). The
registry (``PROJECTOR_KINDS``, ``init_vision_projector_kind``,
``apply_vision_projector``) adds linear, mlp3x_gelu, the SPP variants
(v1/v2/v3, matched by substring), vanilla and minigpt (4-token merges),
LDP (MobileNetV3 blocks over the token grid) and identity;
``projector_token_reduction`` is the token divisor of each.

Audio: padding frames zeroed, zero right-pad of k-1 frames, Conv1d(d, 2d,
k=5, stride 2), LayerNorm (eps 1e-3), exact GELU, Linear(2d, D); halves the
frame rate. The conv kernel keeps the JAX layout [k, in, out].
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from vita_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def _nrm(shape, scale, generator, device, dtype):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)


def init_vision_projector(in_dim: int, llm_dim: int, generator: torch.Generator,
                          device=None, dtype=torch.float32) -> Params:
    return {
        "fc1_w": _nrm((in_dim, llm_dim), in_dim ** -0.5, generator, device, dtype),
        "fc1_b": torch.zeros(llm_dim, dtype=dtype, device=device),
        "fc2_w": _nrm((llm_dim, llm_dim), llm_dim ** -0.5, generator, device, dtype),
        "fc2_b": torch.zeros(llm_dim, dtype=dtype, device=device),
    }


def vision_projector(params: Params, feats: torch.Tensor) -> torch.Tensor:
    h = F.gelu(feats @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]


def init_audio_projector(in_dim: int, llm_dim: int, generator: torch.Generator,
                         kernel: int = 5, device=None, dtype=torch.float32) -> Params:
    return {
        "conv_w": _nrm((kernel, in_dim, 2 * in_dim), (kernel * in_dim) ** -0.5,
                       generator, device, dtype),
        "conv_b": torch.zeros(2 * in_dim, dtype=dtype, device=device),
        "ln_w": torch.ones(2 * in_dim, dtype=dtype, device=device),
        "ln_b": torch.zeros(2 * in_dim, dtype=dtype, device=device),
        "proj_w": _nrm((2 * in_dim, llm_dim), (2 * in_dim) ** -0.5, generator, device, dtype),
        "proj_b": torch.zeros(llm_dim, dtype=dtype, device=device),
    }


def audio_projector(
    params: Params, feats: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, d], valid [B, T] -> ([B, (T-1)//2+1, D], new valid)."""
    w = params["conv_w"]  # [k, in, out]
    k = w.shape[0]
    x = torch.where(valid[..., None], feats, 0).to(w.dtype)
    x = F.pad(x.transpose(1, 2), (0, k - 1))  # [B, d, T + k - 1]
    x = F.conv1d(x, w.permute(2, 1, 0), params["conv_b"], stride=2).transpose(1, 2)
    x = F.gelu(layer_norm(x, params["ln_w"], params["ln_b"], eps=1e-3))
    return x @ params["proj_w"] + params["proj_b"], valid[:, 0::2]


# ---------------------------------------------------------------------------
# vision projector variants (the reference's multimodal projector registry)
# ---------------------------------------------------------------------------
PROJECTOR_KINDS = (
    "linear", "mlp2x_gelu", "mlp3x_gelu", "spp_v1", "spp_v2", "spp_v3",
    "vanilla", "minigpt", "ldp", "identity",
)


def projector_token_reduction(kind: str) -> int:
    """Tokens-per-group divisor: SPP/LDP pool the 2-D token grid 2x2;
    vanilla/minigpt merge 4 consecutive tokens."""
    return 4 if kind.startswith(("spp", "vanilla", "minigpt", "ldp")) else 1


def _hard_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _hard_swish(x):
    return x * _hard_sigmoid(x)


def _init_linear(din, dout, generator, device, dtype):
    return {"w": _nrm((din, dout), din ** -0.5, generator, device, dtype),
            "b": torch.zeros(dout, dtype=dtype, device=device)}


def _init_ldp_block(c, generator, device, dtype):
    sq = max(c // 4, 8)
    ones = lambda: torch.ones(c, dtype=dtype, device=device)
    zeros = lambda: torch.zeros(c, dtype=dtype, device=device)
    return {
        "dw_w": _nrm((3, 3, 1, c), 9 ** -0.5, generator, device, dtype),
        "ln1_w": ones(), "ln1_b": zeros(),
        "se_fc1": _init_linear(c, sq, generator, device, dtype),
        "se_fc2": _init_linear(sq, c, generator, device, dtype),
        "pw_w": _nrm((c, c), c ** -0.5, generator, device, dtype),
        "ln2_w": ones(), "ln2_b": zeros(),
    }


def _same_pad(n: int, stride: int, k: int = 3):
    """XLA's "SAME" padding of one spatial dim: (low, high), the odd pixel
    high (an even grid at stride 2 pads (0, 1))."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _ldp_block(p, x, stride: int):
    """MobileNetV3 inverted residual with expand == channels: depthwise 3x3
    ("SAME", as XLA pads) -> LayerNorm -> hard-swish -> SE (hard-sigmoid)
    -> 1x1 projection -> LayerNorm; residual at stride 1. x [B, H, W, C]."""
    b, h, w, c = x.shape
    (hl, hh), (wl, wh) = _same_pad(h, stride), _same_pad(w, stride)
    y = F.pad(x.permute(0, 3, 1, 2), (wl, wh, hl, hh))
    y = F.conv2d(y, p["dw_w"].permute(3, 2, 0, 1), stride=stride, groups=c).permute(0, 2, 3, 1)
    y = _hard_swish(layer_norm(y, p["ln1_w"], p["ln1_b"]))
    s = y.mean(dim=(1, 2))  # squeeze [B, C]
    s = torch.relu(s @ p["se_fc1"]["w"] + p["se_fc1"]["b"])
    s = _hard_sigmoid(s @ p["se_fc2"]["w"] + p["se_fc2"]["b"])
    y = layer_norm((y * s[:, None, None, :]) @ p["pw_w"], p["ln2_w"], p["ln2_b"])
    return y + x if stride == 1 else y


def _spp_variant(kind: str):
    """'v1'/'v2'/'v3' by substring ('spp_v1_big' is v1, as the reference
    matches it), or None."""
    for v in ("v1", "v2", "v3"):
        if v in kind:
            return v
    return None


def init_vision_projector_kind(in_dim: int, llm_dim: int, generator: torch.Generator,
                               kind: str = "mlp2x_gelu", device=None,
                               dtype=torch.float32) -> Params:
    """Parameters of any registered projector kind; 'mlp2x_gelu' keeps
    ``init_vision_projector``'s layout."""
    lin = lambda din, dout: _init_linear(din, dout, generator, device, dtype)
    if kind == "mlp2x_gelu":
        return init_vision_projector(in_dim, llm_dim, generator, device, dtype)
    if kind == "identity":
        return {}
    if kind == "linear":
        return {"lin": lin(in_dim, llm_dim)}
    if kind == "mlp3x_gelu":
        return {"fc1": lin(in_dim, llm_dim), "fc2": lin(llm_dim, llm_dim),
                "fc3": lin(llm_dim, llm_dim)}
    if kind.startswith("spp"):
        if _spp_variant(kind) is None:
            raise ValueError(f"unknown spp variant in {kind!r}: expected 'v1'/'v2'/'v3' "
                             "(substring match)")
        # all three linears exist whatever the variant
        return {"linear_0": lin(in_dim, in_dim), "linear_1": lin(in_dim, llm_dim),
                "linear_2": lin(llm_dim, llm_dim)}
    if kind in ("vanilla", "minigpt"):
        return {"lin": lin(in_dim * 4, llm_dim)}
    if kind == "ldp":
        return {"fc1": lin(in_dim, llm_dim), "fc2": lin(llm_dim, llm_dim),
                "block1": _init_ldp_block(llm_dim, generator, device, dtype),
                "block2": _init_ldp_block(llm_dim, generator, device, dtype)}
    raise ValueError(f"unknown projector kind {kind!r} (known: {PROJECTOR_KINDS})")


def _to_grid(x):
    b, n, c = x.shape
    h = int(round(n ** 0.5))
    if h * h != n:
        raise ValueError(f"projector needs a square token grid, got {n}")
    return x.reshape(b, h, h, c)


def _avg_pool2(x):
    """[B, H, W, C] -> [B, H//2, W//2, C]; an odd grid drops its last row
    and column, as nn.AvgPool2d(2) floors."""
    b, h, w, c = x.shape
    x = x[:, : (h // 2) * 2, : (w // 2) * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _pool_tokens(x):
    return _avg_pool2(_to_grid(x)).reshape(x.shape[0], -1, x.shape[-1])


def apply_vision_projector(params: Params, feats: torch.Tensor,
                           kind: str = "mlp2x_gelu") -> torch.Tensor:
    """feats [B_groups, T, C] -> [B_groups, T / reduction, llm_dim]."""
    lin = lambda p, x: x @ p["w"] + p["b"]
    if kind == "mlp2x_gelu":
        return vision_projector(params, feats)
    if kind == "identity":
        return feats
    if kind == "linear":
        return lin(params["lin"], feats)
    if kind == "mlp3x_gelu":
        h = F.gelu(lin(params["fc1"], feats))
        return lin(params["fc3"], F.gelu(lin(params["fc2"], h)))
    if kind.startswith("spp"):
        v = _spp_variant(kind)
        if v == "v1":
            return lin(params["linear_2"], _pool_tokens(lin(params["linear_1"], feats)))
        if v == "v2":
            return _pool_tokens(lin(params["linear_2"], lin(params["linear_1"], feats)))
        if v == "v3":
            x = _pool_tokens(lin(params["linear_0"], feats))
            return lin(params["linear_2"], lin(params["linear_1"], x))
        raise ValueError(f"unknown spp variant {kind!r}")
    if kind in ("minigpt", "vanilla"):
        b, n, c = feats.shape
        if n % 4:
            raise ValueError(f"{kind} merges 4-token groups; tokens % 4 != 0")
        if kind == "minigpt":
            return lin(params["lin"], feats.reshape(b, n // 4, 4 * c))
        x = feats.reshape(b, n // 4, 4, c).transpose(2, 3)
        return lin(params["lin"], x.reshape(b, n // 4, 4 * c))
    if kind == "ldp":
        h = lin(params["fc2"], F.gelu(lin(params["fc1"], feats)))
        g = _ldp_block(params["block1"], _to_grid(h), 1)
        g = _ldp_block(params["block2"], g, 2)
        return g.reshape(g.shape[0], -1, g.shape[-1])
    raise ValueError(f"unknown projector kind {kind!r}")
