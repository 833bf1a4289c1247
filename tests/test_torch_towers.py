"""PyTorch port: the alternative vision towers (models/clip.py, siglip.py,
eva_clip.py, towers.py) and the fused model over them, against the JAX
package on tiny configs in float32, with weights carried across by
``convert.from_jax_params``; CLIP and SigLIP also against live tiny
transformers models through the port's hf_import, EVA against the
original's golden; and the port's Engine streaming the JAX Engine's
greedy tokens with three tower and projector pairs."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_util  # noqa: F401  (pins torch threads)
from torch_port_util import F32_TOL, close, normal, t
from vita_tpu.models import clip as j_clip
from vita_tpu.models import eva_clip as j_eva
from vita_tpu.models import siglip as j_siglip
from vita_tpu.models import towers as j_towers
from vita_tpu import generate as j_gen
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch import generate, tokenization
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import clip, eva_clip, siglip, towers, vita
from vita_tpu_torch.serve import engine
from vita_tpu_torch.utils import hf_import

GOLDEN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_alt_towers.py's
TOWERS = {"clip": (j_clip.CLIPConfig, clip.CLIPConfig),
          "siglip": (j_siglip.SigLIPConfig, siglip.SigLIPConfig),
          "eva": (j_eva.EVAConfig, eva_clip.EVAConfig)}


def _pair(tower, projector, **jkw):
    """(JAX config, JAX params, port config, port params) of the tiny VITA
    with ``tower`` and ``projector``; the LLM keeps attn_backend 'xla'."""
    jv, tv = TOWERS[tower]
    jcfg = j_vita.VITAConfig.tiny(vision_tower=tower, vision_projector=projector)
    jcfg = dataclasses.replace(jcfg, vision=jv.tiny(), llm=dataclasses.replace(
        jcfg.llm, attn_backend="xla"), audio=dataclasses.replace(jcfg.audio, **jkw))
    tcfg = vita.VITAConfig.tiny(vision_tower=tower, vision_projector=projector)
    tcfg = dataclasses.replace(tcfg, vision=tv.tiny(),
                               audio=dataclasses.replace(tcfg.audio, **jkw))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, from_jax_params(jax.device_get(jp), tcfg)


@pytest.mark.parametrize("tower,projector", [("clip", "spp_v1"), ("siglip", "mlp3x_gelu"),
                                             ("eva", "ldp"), ("clip", "mlp2x_gelu")])
def test_tower_and_encode_images_match_jax(tower, projector):
    """The tower's forward and encode_images (tower, then the projector)
    at float32 tolerance 1e-4; the token count per group agrees."""
    jcfg, jp, tcfg, tp = _pair(tower, projector)
    assert tcfg.image_tokens_per_group == jcfg.image_tokens_per_group
    images = normal(np.random.default_rng(0), 3, 56, 56, 3)
    got = tcfg.tower_module.forward(tp["vision"], tcfg.vision, t(images))
    want = jcfg.tower_module.forward(jp["vision"], jcfg.vision, jnp.asarray(images))
    assert got.shape == want.shape
    close(got, want)
    got = vita.encode_images(tp, tcfg, t(images))
    want = j_vita.encode_images(jp, jcfg, jnp.asarray(images))
    assert got.shape == want.shape == (3, tcfg.image_tokens_per_group, tcfg.llm.d_model)
    close(got, want)


def test_clip_select_layer_and_bf16_match_jax():
    """select_layer -1 (every layer runs) and a bf16 tower, each against the
    JAX forward (bf16: 2e-2)."""
    rng = np.random.default_rng(1)
    images = normal(rng, 2, 56, 56, 3)
    for kw, tol in ((dict(select_layer=-1), F32_TOL), (dict(dtype=None), dict(atol=2e-2,
                                                                             rtol=2e-2))):
        bf16 = "dtype" in kw
        jcfg = j_clip.CLIPConfig.tiny(**({"dtype": jnp.bfloat16} if bf16 else kw))
        tcfg = clip.CLIPConfig.tiny(**({"dtype": torch.bfloat16} if bf16 else kw))
        jp = j_clip.init_params(jax.random.PRNGKey(2), jcfg)
        tp = jax.tree.map(lambda a: t(np.asarray(a, np.float32)).to(tcfg.dtype), jp)
        got = clip.forward(tp, tcfg, t(images))
        want = j_clip.forward(jp, jcfg, jnp.asarray(images))
        close(got.float(), np.asarray(want, np.float32), **tol)


def test_clip_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPVisionConfig(
        image_size=56, patch_size=14, hidden_size=32, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=64, hidden_act="quick_gelu",
        layer_norm_eps=1e-5)
    torch.manual_seed(0)
    m = transformers.CLIPVisionModel(hf_cfg).eval().float()
    cfg = clip.CLIPConfig.tiny(n_layers=3)
    params = hf_import.clip_params_from_hf(m.state_dict(), 3)
    img = np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32)
    with torch.no_grad():
        want = m(torch.tensor(img), output_hidden_states=True).hidden_states[-2][:, 1:]
    got = clip.forward(params, cfg, t(img.transpose(0, 2, 3, 1)))
    close(got, want.numpy(), **GOLDEN_TOL)


def test_siglip_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.SiglipVisionConfig(
        image_size=56, patch_size=14, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, hidden_act="gelu_pytorch_tanh",
        layer_norm_eps=1e-6)
    torch.manual_seed(1)
    m = transformers.SiglipVisionModel(hf_cfg).eval().float()
    params = hf_import.siglip_params_from_hf(m.state_dict(), 2)
    img = np.random.RandomState(1).randn(2, 3, 56, 56).astype(np.float32)
    with torch.no_grad():
        want = m(torch.tensor(img)).last_hidden_state
    got = siglip.forward(params, siglip.SigLIPConfig.tiny(), t(img.transpose(0, 2, 3, 1)))
    close(got, want.numpy(), **GOLDEN_TOL)


def test_partial_patch_is_dropped_as_transformers_conv():
    """A tile whose side is no multiple of the patch (SigLIP-so400m's 384
    with patch 14: 27 patches and 6 pixels) keeps the whole patches, as
    the stride-14 conv of transformers' SigLIP does (the JAX package's
    patchify cannot reshape such a tile)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.SiglipVisionConfig(
        image_size=62, patch_size=14, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, hidden_act="gelu_pytorch_tanh",
        layer_norm_eps=1e-6)
    torch.manual_seed(2)
    m = transformers.SiglipVisionModel(hf_cfg).eval().float()
    params = hf_import.siglip_params_from_hf(m.state_dict(), 2)
    img = np.random.RandomState(2).randn(1, 3, 62, 62).astype(np.float32)
    with torch.no_grad():
        want = m(torch.tensor(img)).last_hidden_state
    cfg = siglip.SigLIPConfig.tiny(image_size=62)
    got = siglip.forward(params, cfg, t(img.transpose(0, 2, 3, 1)))
    assert got.shape == (1, 16, 32) == tuple(want.shape)
    close(got, want.numpy(), **GOLDEN_TOL)


def test_hf_tower_imports_match_jax():
    """clip/siglip_params_from_hf and eva_params_from_reference give the
    JAX package's trees, leaf for leaf (the EVA import drops the dead last
    block)."""
    from vita_tpu.utils import hf_import as j_hf

    z = np.load(pathlib.Path(__file__).parent / "goldens" / "eva_tiny.npz")
    eva_state = {k[3:]: z[k] for k in z.files if k.startswith("sd_")}
    rng = np.random.default_rng(3)

    def vit_state(cls_and_pre):
        d, m = 32, 64
        st = {"vision_model.embeddings.patch_embedding.weight": normal(rng, d, 3, 14, 14),
              "vision_model.embeddings.patch_embedding.bias": normal(rng, d),
              "vision_model.embeddings.position_embedding.weight": normal(rng, 17, d),
              "vision_model.post_layernorm.weight": normal(rng, d),
              "vision_model.post_layernorm.bias": normal(rng, d)}
        if cls_and_pre:
            st.update({"vision_model.embeddings.class_embedding": normal(rng, d),
                       "vision_model.pre_layrnorm.weight": normal(rng, d),
                       "vision_model.pre_layrnorm.bias": normal(rng, d)})
        for l in range(2):
            for hf, _, tr in hf_import._HF_VIT_LAYER:
                shape = {"fc1": (m, d), "fc2": (d, m)}.get(hf.split(".")[1], (d, d))
                st[f"vision_model.encoder.layers.{l}.{hf}"] = (
                    normal(rng, *shape) if tr else normal(rng, shape[0]))
        return st

    cst, sst = vit_state(True), vit_state(False)
    pairs = ((hf_import.clip_params_from_hf(cst, 2), j_hf.clip_params_from_hf(cst, 2)),
             (hf_import.siglip_params_from_hf(sst, 2), j_hf.siglip_params_from_hf(sst, 2)),
             (hf_import.eva_params_from_reference(eva_state, 1),
              j_hf.eva_params_from_reference(eva_state, 1)))
    for got, want in pairs:
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, g), (_, w) in zip(flat_g, flat_w):
            assert g.dtype == torch.float32 and np.array_equal(g.numpy(), w), path


def test_eva_golden_and_rope_tables():
    """EVA through the port's import against the original's golden (the
    reference skips its last block: depth 2 runs 1), and the rope tables
    against its registered buffers."""
    z = np.load(pathlib.Path(__file__).parent / "goldens" / "eva_tiny.npz")
    state = {k[3:]: z[k] for k in z.files if k.startswith("sd_")}
    cfg = eva_clip.EVAConfig.tiny(n_layers=1)
    cos, sin = eva_clip.vision_rope_tables(cfg)
    np.testing.assert_allclose(cos, state["rope.freqs_cos"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin, state["rope.freqs_sin"], rtol=1e-6, atol=1e-6)
    jc, jsn = j_eva.vision_rope_tables(j_eva.EVAConfig.tiny(n_layers=1))
    assert np.array_equal(cos, jc) and np.array_equal(sin, jsn)
    params = hf_import.eva_params_from_reference(state, cfg.n_layers)
    out = eva_clip.forward(params, cfg, t(z["image"].transpose(0, 2, 3, 1)))
    close(out, z["expected"], **GOLDEN_TOL)


def test_s2_multiscale_forward_matches_jax():
    """s2_multiscale_forward at the factory's scales (base, 2 x base) from
    a 2 x base input, against JAX's (whose bilinear downscale
    antialiases)."""
    cfg, jcfg = siglip.SigLIPConfig.tiny(), j_siglip.SigLIPConfig.tiny()
    jp = j_siglip.init_params(jax.random.PRNGKey(4), jcfg)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    img = normal(np.random.default_rng(4), 2, 112, 112, 3)
    got = siglip.s2_multiscale_forward(lambda x: siglip.forward(tp, cfg, x), t(img),
                                       scales=(56, 112), base_size=56)
    want = j_siglip.s2_multiscale_forward(lambda x: j_siglip.forward(jp, jcfg, x),
                                          jnp.asarray(img), scales=(56, 112), base_size=56)
    assert got.shape == (2, cfg.num_patches, 2 * cfg.hidden)
    close(got, want)


@pytest.mark.parametrize("name", ["internvit", "InternViT-300M", "intern_vit", "clip",
                                  "openai/clip-vit-large-patch14-336", "siglip",
                                  "siglip-so400m", "siglip-s2", "eva-clip-l", "EVA02"])
def test_tower_factory_matches_jax(name):
    """build_vision_tower picks the JAX factory's tower for each name, with
    the same config fields and out_dim, and its forward matches."""
    tw, jtw = towers.build_vision_tower(name, tiny=True), j_towers.build_vision_tower(name,
                                                                                 tiny=True)
    assert (tw.name, tw.out_dim) == (jtw.name, jtw.out_dim)
    assert {k: v for k, v in dataclasses.asdict(tw.cfg).items() if k != "dtype"} == \
        {k: v for k, v in dataclasses.asdict(jtw.cfg).items() if k != "dtype"}
    jp = jtw.init(jax.random.PRNGKey(5))
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    sz = tw.cfg.image_size * (2 if tw.name == "siglip-s2" else 1)
    img = normal(np.random.default_rng(5), 1, sz, sz, 3)
    got = tw.forward(tp, t(img))
    assert got.shape[-1] == tw.out_dim
    close(got, jtw.forward(jp, jnp.asarray(img)))
    assert tw.init(torch.Generator().manual_seed(0)).keys() == jp.keys()


def test_tower_factory_unknown_name():
    with pytest.raises(ValueError, match="unknown vision tower 'resnet50'"):
        towers.build_vision_tower("resnet50")
    with pytest.raises(ValueError, match="unknown vision_tower 'resnet'"):
        vita.VITAConfig.tiny(vision_tower="resnet").tower_module


def _image_audio(cfg, rng, frames=60):
    """An image+audio prompt whose spans fit ``cfg``'s tower and projector."""
    n_img, n_aud = cfg.image_tokens_per_group, tokenization.audio_token_count(frames)
    s = n_img + n_aud + 10
    ids = rng.integers(3, 512, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[4:4 + n_img] = True
    am[4 + n_img:4 + n_img + n_aud] = True
    ids[im | am] = 0
    return dict(input_ids=ids, image_mask=im, audio_mask=am, images=normal(rng, 1, 56, 56, 3),
                speech=normal(rng, frames, 80), speech_length=frames)


@pytest.mark.parametrize("tower,projector", [("clip", "spp_v1"), ("siglip", "mlp2x_gelu"),
                                             ("eva", "ldp")])
def test_engine_streams_match_jax(tower, projector):
    """The port's Engine and the JAX Engine stream identical greedy tokens
    for an image+audio request beside two text requests."""
    jcfg, jp, tcfg, tp = _pair(tower, projector)
    rng = np.random.default_rng(6)
    kws = [dict(_image_audio(tcfg, rng), max_new_tokens=8)]
    kws += [dict(input_ids=rng.integers(3, 512, n).astype(np.int32), max_new_tokens=8)
            for n in (9, 23)]
    streams = []
    for mod, params, cfg in ((j_engine, jp, jcfg), (engine, tp, tcfg)):
        eng = mod.Engine(params, cfg, n_slots=4, max_len=128, decode_moe_mode="gather")
        reqs = [mod.Request(eos_id=-1, **kw) for kw in kws]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        streams.append([r.tokens for r in reqs])
    assert streams[1] == streams[0] and all(len(s) == 8 for s in streams[1])


def test_generator_streams_match_jax():
    """The port's Generator (gmm prefill, gather decode) and the JAX
    Generator stream identical greedy tokens for an image+audio prompt
    with clip + ldp and Whale flash (JAX's in interpret mode)."""
    jcfg, jp, tcfg, tp = _pair("clip", "ldp", attn_backend="flash")
    prompt = _image_audio(tcfg, np.random.default_rng(7))
    out = []
    with pltpu.force_tpu_interpret_mode():
        for mod, params, cfg in ((j_gen, jp, jcfg), (generate, tp, tcfg)):
            g = mod.Generator(params, cfg, max_len=96, chunk_len=4, prompt_buckets=(32, 64),
                              prefill_moe_mode="gmm", decode_moe_mode="gather")
            out.append(g.generate(gen=mod.GenerationConfig(max_new_tokens=9, eos_id=-1),
                                  **prompt))
    assert out[1] == out[0] and len(out[1]) == 9
