"""Checkpoints of the PyTorch port (vita_tpu.checkpoint): the native layout
and the HF deploy layout, read and written.

Two formats, as in the JAX package:

- native: ``config.json`` (``"format": "vita_tpu"``, ``config_to_json``)
  and the parameters under ``ckpt/step_N/state.pt``, written by the
  trainer's ``save_state``. The JAX package writes this layout's weights
  with orbax, which the port cannot read; ``load_vita_checkpoint`` says so
  and names the way across, the HF export of the JAX package.
- HF deploy: the reference's released layout, a composite ``config.json``,
  ``*.safetensors`` shards with language_model / vision_tower /
  vision_projector / audio_model / audio_projector prefixes, and the Whale
  CMVN in ``feature_extractor/preprocessor_config.json``
  (``utils.hf_import``; the safetensors format through
  ``utils.safetensors_io``, without the safetensors package).

Stage chaining: an adapter overlay, LoRA on a base checkpoint, and the
Whale encoder from a standalone ``final.pt``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict

import torch

from vita_tpu_torch.models import internvit, mixtral, projectors, vita, whale
from vita_tpu_torch.parallel import fsdp
from vita_tpu_torch.parallel.mesh import PIPE, axis
from vita_tpu_torch.train.trainer import (  # noqa: F401  (load_adapter_into: stage chaining)
    STATE_FILE,
    committed_steps,
    load_adapter_into,
    load_state,
    save_state,
)
from vita_tpu_torch.utils import hf_import, safetensors_io

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# fields of the JAX package's configs that the port has no use for
# (positions, pipeline stages, the aux-loss coefficient: the port's
# TrainConfig carries its own), written at the JAX package's defaults so
# that either package reads the file; ignored on read
_JAX_ONLY = {
    "llm": {"max_position": 32768, "router_aux_loss_coef": 0.02, "pipe_stages": 1,
            "pipe_microbatches": 4},
}
# fields of a run, not of the weights: a checkpoint is written and read
# with the defaults (the pipeline's stages come from the run's mesh)
_RUN_ONLY = ("pipe_stages", "pipe_microbatches")


def load_vita_checkpoint(path: str, device="cuda", mesh=None, training: bool = False):
    """A VITA checkpoint directory -> (VITAConfig, params on ``device``):
    the native layout this module writes, or the HF deploy layout.

    Under a serving ``mesh`` the LLM's leaves are this rank's shards
    (mixtral.serving_specs) and every other component whole, as
    ``vita.shard_params`` gives them (pass them to ``Engine(...,
    sharded=True)``): each rank reads only its blocks of the mapped files
    (the HF layout's safetensors, the native state through torch.load's
    mmap), so no rank holds the whole model in host memory. Under a
    'pipe' axis that is this stage's layers only and, where the
    vocabulary is split over ('pipe', 'model'), its block of the
    vocabulary.

    With ``training`` the ``mesh`` is a training mesh and every
    component's leaves are this rank's blocks by ``vita.param_specs`` (the
    LLM's layers led by 'pipe' when the mesh has a 'pipe' axis > 1), as
    ``Trainer(..., mesh=, sharded=True)`` takes them; the LLM's blocks are
    read from the mapped files alone, the towers' and projectors' cut from
    whole leaves on the host."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    if raw.get("format") == "vita_tpu":
        cfg = _config_from_json(raw)
        if mesh is None:
            return cfg, _load_native(os.path.join(path, "ckpt"), device)
        params = _load_native(os.path.join(path, "ckpt"), "cpu", mmap=True)
        if training:
            return cfg, fsdp.shard_tree(params, _training_specs(cfg, mesh), mesh, device)
        return cfg, vita.shard_params(params, cfg, mesh, device)

    text = raw.get("text_config", raw)
    vis = raw.get("vision_config", {})
    aud = raw.get("audio_config", {})
    bf16 = torch.bfloat16
    cfg = vita.VITAConfig(
        llm=mixtral.MixtralConfig(
            vocab_size=text.get("vocab_size", 51760),
            d_model=text.get("hidden_size", 4096),
            n_layers=text.get("num_hidden_layers", 32),
            n_heads=text.get("num_attention_heads", 32),
            n_kv_heads=text.get("num_key_value_heads", 8),
            d_ff=text.get("intermediate_size", 14336),
            n_experts=text.get("num_local_experts", 8),
            top_k=text.get("num_experts_per_tok", 2),
            rope_theta=text.get("rope_theta", 1e6),
            rms_eps=text.get("rms_norm_eps", 1e-5),
            dtype=bf16,
        ),
        vision=internvit.InternViTConfig(
            image_size=vis.get("image_size", 448),
            patch_size=vis.get("patch_size", 14),
            hidden=vis.get("hidden_size", 1024),
            n_layers=vis.get("num_hidden_layers", 24),
            n_heads=vis.get("num_attention_heads", 16),
            mlp_dim=vis.get("intermediate_size", 4096),
            dtype=bf16,
        ),
        audio=whale.WhaleConfig(
            input_dim=aud.get("input_dim", 80),
            hidden=aud.get("hidden_size", 1024),
            n_layers=aud.get("num_hidden_layers", 24),
            n_heads=aud.get("num_attention_heads", 16),
            ffn_dim=aud.get("intermediate_size", 4096),
            dtype=bf16,
        ),
        vision_fusion=raw.get("vision_fusion", "patch"),
        vision_projector=raw.get("mm_projector_type", "mlp2x_gelu"),
    )
    specs = _training_specs(cfg, mesh) if training and mesh is not None else None
    return cfg, _load_hf_vita_weights(path, cfg, device, mesh, specs)


def _training_specs(cfg: vita.VITAConfig, mesh):
    """``vita.param_specs`` with the LLM's layers led by 'pipe' when the
    mesh has a 'pipe' axis > 1."""
    pp = axis(mesh, PIPE).size
    return vita.param_specs(dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, pipe_stages=pp)))


def _load_native(ckpt_dir: str, device, mmap: bool = False):
    steps = committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no step_N checkpoint under {ckpt_dir}")
    if not os.path.exists(os.path.join(ckpt_dir, f"step_{steps[-1]}", STATE_FILE)):
        raise ValueError(
            f"{ckpt_dir}/step_{steps[-1]} holds no {STATE_FILE}: it looks like the JAX "
            "package's orbax layout, which the port does not read. Export it with "
            "vita_tpu.checkpoint.export_hf_vita_checkpoint and load that directory.")
    return load_state(ckpt_dir, steps[-1], device, mmap=mmap)


def _config_from_json(raw: Dict[str, Any]) -> vita.VITAConfig:
    def build(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields and k not in _RUN_ONLY + ("dtype",)}
        return cls(dtype=_DTYPES.get(d.get("dtype"), torch.float32), **kw)

    return vita.VITAConfig(
        llm=build(mixtral.MixtralConfig, raw["llm"]),
        vision=build(internvit.InternViTConfig, raw["vision"]),
        audio=build(whale.WhaleConfig, raw["audio"]),
        vision_fusion=raw.get("vision_fusion", "patch"),
        vision_projector=raw.get("vision_projector", "mlp2x_gelu"),
    )


def config_to_json(cfg: vita.VITAConfig) -> Dict[str, Any]:
    def dump(c, part):
        d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c) if f.name != "dtype"}
        d.update(_JAX_ONLY.get(part, {}))
        d["dtype"] = "bfloat16" if c.dtype == torch.bfloat16 else "float32"
        return d

    return {
        "format": "vita_tpu",
        "llm": dump(cfg.llm, "llm"),
        "vision": dump(cfg.vision, "vision"),
        "audio": dump(cfg.audio, "audio"),
        "vision_fusion": cfg.vision_fusion,
        "vision_projector": cfg.vision_projector,
    }


def save_vita_checkpoint(path: str, cfg: vita.VITAConfig, params, step: int = 0) -> None:
    """The native layout: ``config.json`` and ``ckpt/step_N/state.pt``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_json(cfg), f, indent=1)
    save_state(os.path.join(path, "ckpt"), step, params)


def _load_hf_vita_weights(path: str, cfg: vita.VITAConfig, device, mesh=None, specs=None):
    """The deployed HF checkpoint's safetensors -> params, each leaf built
    in the config's dtype on ``device`` (the LLM's as this rank's shards
    under a ``mesh``; every component's blocks by the training ``specs``
    when given: the LLM's read alone, the rest cut from whole leaves built
    on the host). The Whale CMVN is rounded to that dtype, as the JAX
    package's import rounds every leaf, and kept in float32, the port's
    layout."""
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no safetensors under {path}")
    state = hf_import.load_safetensors_state(shards)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    dt = cfg.llm.dtype
    cmvn_mean = cmvn_istd = None
    fe_path = os.path.join(path, "feature_extractor", "preprocessor_config.json")
    if os.path.exists(fe_path):
        with open(fe_path) as f:
            fe = json.load(f)
        cmvn_mean, cmvn_istd = (torch.tensor(fe.get(k), dtype=torch.float32).to(dt).float()
                                for k in ("cmvn_means", "cmvn_istds"))
    rest_dev = device if specs is None else "cpu"
    rest = {
        "vision": hf_import.internvit_params_from_hf(sub("vision_tower."), cfg.vision.n_layers,
                                                     dtype=dt, device=rest_dev),
        "vision_proj": hf_import.vision_projector_from_hf(
            sub("vision_projector."), kind=cfg.vision_projector, dtype=dt, device=rest_dev,
            template=projectors.init_vision_projector_kind(
                cfg.vision_proj_in_dim, cfg.llm.d_model, None, cfg.vision_projector,
                device="meta")),
        "audio": hf_import.whale_params_from_hf(sub("audio_model."), cfg.audio.n_layers,
                                                cmvn_mean, cmvn_istd, dtype=dt, device=rest_dev),
        "audio_proj": hf_import.audio_projector_from_hf(sub("audio_projector."), dtype=dt,
                                                        device=rest_dev),
    }
    if specs is not None:
        rest = fsdp.shard_tree(rest, {k: specs[k] for k in rest}, mesh, device)
    llm = hf_import.mixtral_params_from_hf(sub("language_model."), cfg.llm, prefix="model.",
                                           dtype=dt, device=device, mesh=mesh,
                                           specs=None if specs is None else specs["llm"])
    return {"llm": llm, **rest}


# ---------------------------------------------------------------------------
# stage chaining (the reference's vita/model/builder.py:14-306 and
# vita/model/vita_arch.py:63-108); load_adapter_into is the trainer's
# ---------------------------------------------------------------------------
def load_lora_vita_checkpoint(base_path: str, lora_path: str, rank: int = 8,
                              alpha: float = 16.0, merge: bool = True, device="cuda"):
    """A base checkpoint and the LoRA adapters saved under ``lora_path``
    (``save_state``'s layout, the latest step): the adapters folded in
    (``merge``), or returned beside the base as (cfg, params, lora,
    LoRAConfig)."""
    from vita_tpu_torch.train.lora import LoRAConfig, merge_lora

    cfg, params = load_vita_checkpoint(base_path, device)
    lora = load_state(lora_path, device=device)
    lcfg = LoRAConfig(rank=rank, alpha=alpha)
    if merge:
        return cfg, merge_lora(params, lora, lcfg)
    return cfg, params, lora, lcfg


def _shape(v):
    return tuple(v.shape) if hasattr(v, "shape") else ()


@torch.no_grad()
def load_whale_torch_checkpoint(params, path: str, strict: bool = False):
    """The audio encoder from a standalone torch ``final.pt``
    (vita_arch.py:93-108): a state-dict entry whose name and shape match
    the expected layout loads, every other one is reported and the current
    weight kept. Returns a new dict whose ``audio`` is replaced."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    audio = params["audio"]
    n_layers = audio["layers"]["q_w"].shape[0]
    expected = hf_import.whale_params_to_hf(audio, n_layers)  # current values, HF names
    merged, loaded, skipped = {}, 0, []
    for k, ref in expected.items():
        v = sd.get(k)
        if v is not None and _shape(v) == tuple(ref.shape):
            merged[k] = v
            loaded += 1
        else:
            skipped.append(k)
            merged[k] = ref
    unknown = [k for k in sd if k not in expected]
    if skipped or unknown:
        msg = (f"[load] whale final.pt: {loaded} loaded, {len(skipped)} kept (first: "
               f"{skipped[:3]}), {len(unknown)} unknown keys ignored")
        if strict:
            raise ValueError(msg)
        print(msg)
    dev = audio["cmvn"]["mean"].device
    candidate = hf_import.whale_params_from_hf(merged, n_layers, audio["cmvn"]["mean"],
                                               audio["cmvn"]["istd"], device=dev)

    def cast(dst, src):
        if isinstance(dst, dict):
            return {k: cast(dst[k], src[k]) for k in dst}
        return src.to(device=dst.device, dtype=dst.dtype)

    return {**params, "audio": cast(audio, candidate)}


def export_hf_vita_checkpoint(path: str, cfg: vita.VITAConfig, params,
                              dtype=torch.float32) -> None:
    """The whole model in the deployed HF layout (safetensors in ``dtype``,
    float32 by default as the JAX package's export writes; the composite
    config and the feature extractor's CMVN): the reverse of
    load_vita_checkpoint's HF branch."""
    os.makedirs(path, exist_ok=True)
    state = hf_import.vita_params_to_hf(params, cfg)
    for k in state:  # leaf by leaf: the float32 tree and its copy never both whole
        state[k] = state[k].to(dtype)
    safetensors_io.save_file(state, os.path.join(path, "model.safetensors"))
    conf = {
        "architectures": ["MixtralForConditionalGeneration"],
        "model_type": "mixtral-multimodal",
        "vision_fusion": cfg.vision_fusion,
        "mm_projector_type": cfg.vision_projector,
        "image_token_index": 51000,
        "audio_token_index": 51001,
        "text_config": {
            "vocab_size": cfg.llm.vocab_size,
            "hidden_size": cfg.llm.d_model,
            "num_hidden_layers": cfg.llm.n_layers,
            "num_attention_heads": cfg.llm.n_heads,
            "num_key_value_heads": cfg.llm.n_kv_heads,
            "intermediate_size": cfg.llm.d_ff,
            "num_local_experts": cfg.llm.n_experts,
            "num_experts_per_tok": cfg.llm.top_k,
            "rope_theta": cfg.llm.rope_theta,
            "rms_norm_eps": cfg.llm.rms_eps,
        },
        "vision_config": {
            "image_size": cfg.vision.image_size,
            "patch_size": cfg.vision.patch_size,
            "hidden_size": cfg.vision.hidden,
            "num_hidden_layers": cfg.vision.n_layers,
            "num_attention_heads": cfg.vision.n_heads,
            "intermediate_size": cfg.vision.mlp_dim,
        },
        "audio_config": {
            "input_dim": cfg.audio.input_dim,
            "hidden_size": cfg.audio.hidden,
            "num_hidden_layers": cfg.audio.n_layers,
            "num_attention_heads": cfg.audio.n_heads,
            "intermediate_size": cfg.audio.ffn_dim,
        },
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f, indent=1)
    fe_dir = os.path.join(path, "feature_extractor")
    os.makedirs(fe_dir, exist_ok=True)
    cmvn = params["audio"]["cmvn"]
    with open(os.path.join(fe_dir, "preprocessor_config.json"), "w") as f:
        json.dump({
            "feature_extractor_type": "WhaleFeatureExtractor",
            "feature_size": 80, "sampling_rate": 16000,
            "cmvn_means": cmvn["mean"].float().cpu().tolist(),
            "cmvn_istds": cmvn["istd"].float().cpu().tolist(),
        }, f)
