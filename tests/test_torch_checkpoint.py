"""PyTorch port: checkpoint import and export (checkpoint.py,
utils/hf_import.py, utils/safetensors_io.py, train/merge_lora.py) against
the JAX package on ``VITAConfig.tiny()``.

Files go both ways: what one package writes, the other loads, every leaf
bitwise equal (the HF layout stores float32, and bf16 -> f32 -> bf16 is
exact) and the configs equal field by field. The port's safetensors
reader and writer exchange files with the safetensors package. The Whale
``final.pt`` merge, LoRA on a base and the merge CLI give what the JAX
package gives; both Engines serve one exported directory with identical
greedy streams; the port's towers, from weights its own hf_import reads,
meet the original VITA's goldens at the JAX tests' tolerance."""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from torch_port_util import normal
from vita_tpu import checkpoint as j_ckpt
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu.train import lora as j_lora
from vita_tpu.utils import hf_import as j_hf
from vita_tpu_torch import checkpoint, tokenization
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import internvit, mixtral, projectors, vita, whale
from vita_tpu_torch.serve import engine
from vita_tpu_torch.train import lora
from vita_tpu_torch.train.step import tree_leaves
from vita_tpu_torch.train.trainer import save_state
from vita_tpu_torch.utils import hf_import, safetensors_io

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_encoders.py's


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX package's tiny model in bf16 with a non-trivial CMVN (its
    export writes it to the feature extractor's config)."""
    cfg = j_vita.VITAConfig.tiny()
    params = jax.device_get(jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                         j_vita.init_params(jax.random.PRNGKey(0), cfg)))
    rng = np.random.default_rng(0)
    params["audio"]["cmvn"] = {"mean": normal(rng, 80), "istd": 1 + 0.1 * normal(rng, 80)}
    return cfg, params


@pytest.fixture(scope="module")
def jax_export(jax_tiny, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_export"))
    j_ckpt.export_hf_vita_checkpoint(path, *jax_tiny)
    return path


def _bf16_tiny():
    """The port's tiny config with the three parts in bf16 (the HF
    import's dtype)."""
    bf16 = torch.bfloat16
    return vita.VITAConfig(llm=mixtral.MixtralConfig.tiny(dtype=bf16),
                           vision=internvit.InternViTConfig.tiny(dtype=bf16),
                           audio=whale.WhaleConfig.tiny(dtype=bf16))


def _port_params(jparams, cfg):
    """from_jax_params of a JAX tree as the JAX loader returns it: the
    loader rounds the CMVN to bf16 with every leaf, the port keeps those
    values in float32 (its layout)."""
    p = jax.device_get(jparams)
    p["audio"]["cmvn"] = {k: np.asarray(v, np.float32) for k, v in p["audio"]["cmvn"].items()}
    return from_jax_params(p, cfg)


def _assert_leaves_equal(got, want):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), path


def _assert_configs_equal(tcfg, jcfg):
    for part in ("llm", "vision", "audio"):
        t_part, j_part = getattr(tcfg, part), getattr(jcfg, part)
        for f in dataclasses.fields(t_part):
            tv, jv = getattr(t_part, f.name), getattr(j_part, f.name)
            if f.name == "dtype":
                assert str(tv).rsplit(".", 1)[-1] == jnp.dtype(jv).name, (part, f.name)
            else:
                assert tv == jv, (part, f.name, tv, jv)
    for f in ("vision_fusion", "vision_projector", "vision_tower", "audio_adapter_kernel"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------
ST_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int32, torch.int64]


def _st_tensors(dtype):
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dtype)
    else:
        make = lambda *s: torch.randint(-100, 100, s, generator=g, dtype=dtype)
    return {"matrix": make(5, 7), "transposed": make(6, 3).T, "scalar": make(),
            "empty": make(0, 4), "odd.name/with.dots": make(3), "i8": make(3).to(torch.int8)}


@pytest.mark.parametrize("dtype", ST_DTYPES, ids=str)
def test_safetensors_port_writes_package_reads(dtype, tmp_path):
    from safetensors.torch import load_file

    tensors = _st_tensors(dtype)
    safetensors_io.save_file(tensors, tmp_path / "x.safetensors")
    got = load_file(str(tmp_path / "x.safetensors"))
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", ST_DTYPES, ids=str)
def test_safetensors_package_writes_port_reads(dtype, tmp_path):
    from safetensors.torch import save_file

    tensors = _st_tensors(dtype)
    save_file({k: v.contiguous() for k, v in tensors.items()}, str(tmp_path / "x.safetensors"),
              metadata={"format": "pt"})
    got = safetensors_io.load_file(tmp_path / "x.safetensors")
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


def test_safetensors_rejects_what_it_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match="not supported"):
        safetensors_io.save_file({"b": torch.zeros(2, dtype=torch.bool)}, tmp_path / "b.st")
    safetensors_io.save_file({"x": torch.zeros(4)}, tmp_path / "x.st")
    raw = bytearray((tmp_path / "x.st").read_bytes())
    (tmp_path / "short.st").write_bytes(bytes(raw[:-4]))  # the data cut short
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(tmp_path / "short.st")


# ---------------------------------------------------------------------------
# the HF name tables
# ---------------------------------------------------------------------------
def test_hf_tables_match_jax(jax_tiny):
    """vita_params_to_hf gives the JAX package's names and float32 values,
    and each part's import gives back the JAX import of the same state."""
    jcfg, jp = jax_tiny
    tcfg = _bf16_tiny()
    tp = _port_params(jp, tcfg)
    want = j_hf.vita_params_to_hf(jp, jcfg)
    got = hf_import.vita_params_to_hf(tp, tcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in want.items() if k.startswith(prefix)}

    cmvn = (jp["audio"]["cmvn"]["mean"], jp["audio"]["cmvn"]["istd"])
    pairs = (
        (hf_import.mixtral_params_from_hf(sub("language_model."), tcfg.llm),
         j_hf.mixtral_params_from_hf(sub("language_model."), jcfg.llm)),
        (hf_import.internvit_params_from_hf(sub("vision_tower."), 2),
         j_hf.internvit_params_from_hf(sub("vision_tower."), 2)),
        (hf_import.whale_params_from_hf(sub("audio_model."), 2, *cmvn),
         j_hf.whale_params_from_hf(sub("audio_model."), 2, *cmvn)),
        (hf_import.vision_projector_from_hf(sub("vision_projector.")),
         j_hf.vision_projector_from_hf(sub("vision_projector."))),
        (hf_import.audio_projector_from_hf(sub("audio_projector.")),
         j_hf.audio_projector_from_hf(sub("audio_projector."))),
    )
    for got_part, want_part in pairs:
        _assert_leaves_equal(got_part, jax.tree.map(lambda a: torch.from_numpy(
            np.asarray(a, np.float32)), want_part))


def test_unported_towers_and_projectors_raise():
    """Every tower and projector kind is ported; what still raises is what
    the JAX package refuses too: a projector kind imported without a
    template, an unknown kind, and the HF deploy export of a tower other
    than InternViT."""
    with pytest.raises(ValueError, match="needs a template"):
        hf_import.vision_projector_from_hf({}, kind="linear")
    with pytest.raises(ValueError, match="unknown projector kind"):
        vita.init_params(vita.VITAConfig.tiny(vision_projector="resampler"), None, "meta")
    cfg = vita.VITAConfig.tiny(vision_tower="clip")
    for pkg_hf, c in ((hf_import, cfg), (j_hf, j_vita.VITAConfig.tiny(vision_tower="clip"))):
        with pytest.raises(ValueError, match="internvit"):
            pkg_hf.vita_params_to_hf({}, c)


def test_projector_kind_checkpoint_both_ways(tmp_path):
    """A tiny bf16 model with the spp_v1 projector: the port's HF export
    loads in the JAX package and the JAX package's in the port, config
    and every leaf equal (the projector under its native.<path> names)."""
    jcfg = j_vita.VITAConfig.tiny(vision_projector="spp_v1")
    jp = jax.device_get(jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                     j_vita.init_params(jax.random.PRNGKey(2), jcfg)))
    j_ckpt.export_hf_vita_checkpoint(str(tmp_path / "jax"), jcfg, jp)
    tcfg, tp = checkpoint.load_vita_checkpoint(str(tmp_path / "jax"), device="cpu")
    jcfg2, jp2 = j_ckpt.load_vita_checkpoint(str(tmp_path / "jax"))
    assert tcfg.vision_projector == "spp_v1" and set(tp["vision_proj"]) == {
        "linear_0", "linear_1", "linear_2"}
    _assert_configs_equal(tcfg, jcfg2)
    _assert_leaves_equal(tp, _port_params(jp2, tcfg))
    checkpoint.export_hf_vita_checkpoint(str(tmp_path / "port"), tcfg, tp)
    jcfg3, jp3 = j_ckpt.load_vita_checkpoint(str(tmp_path / "port"))
    assert jcfg3 == jcfg2
    la, lb = (jax.tree_util.tree_leaves_with_path(x) for x in (jp2, jp3))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), path


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------
def test_jax_export_loads_in_port(jax_export):
    jcfg, jparams = j_ckpt.load_vita_checkpoint(jax_export)
    tcfg, tparams = checkpoint.load_vita_checkpoint(jax_export, device="cpu")
    _assert_configs_equal(tcfg, jcfg)
    assert tcfg.llm.attn_backend == "xla" and tcfg.llm.dtype == torch.bfloat16
    _assert_leaves_equal(tparams, _port_params(jparams, tcfg))


def test_port_export_loads_in_jax(jax_export, tmp_path):
    """The port exports what it loaded; the JAX package loads that export
    equal to its own load of its own export, and so does the port; the
    JSON files are those the JAX package writes for what it loaded."""
    tcfg, tparams = checkpoint.load_vita_checkpoint(jax_export, device="cpu")
    checkpoint.export_hf_vita_checkpoint(str(tmp_path / "port"), tcfg, tparams)
    jcfg_a, ja = j_ckpt.load_vita_checkpoint(jax_export)
    j_ckpt.export_hf_vita_checkpoint(str(tmp_path / "jax"), jcfg_a, ja)
    jcfg_b, jb = j_ckpt.load_vita_checkpoint(str(tmp_path / "port"))
    assert jcfg_a == jcfg_b
    la, lb = jax.tree_util.tree_leaves_with_path(ja), jax.tree_util.tree_leaves_with_path(jb)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), path
    for name in ("config.json", "feature_extractor/preprocessor_config.json"):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text())), name
    tcfg2, tparams2 = checkpoint.load_vita_checkpoint(str(tmp_path / "port"), device="cpu")
    assert tcfg2 == tcfg
    _assert_leaves_equal(tparams2, tparams)


@pytest.mark.parametrize("name", ["tiny", "vita_8x7b"])
def test_config_to_json_matches_jax(name):
    got = checkpoint.config_to_json(getattr(vita.VITAConfig, name)())
    want = j_ckpt.config_to_json(getattr(j_vita.VITAConfig, name)())
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_native_checkpoint_round_trip(tmp_path):
    """save_vita_checkpoint / load_vita_checkpoint: the config (moe_chunk
    and the other training knobs included, as in the JAX package) and
    every leaf; the JAX package reads the same config.json, and the
    port's reader ignores the JAX-only fields."""
    cfg = vita.VITAConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, moe_chunk=16,
                                                           moe_mode="gmm", remat=True))
    params = vita.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    checkpoint.save_vita_checkpoint(str(tmp_path), cfg, params, step=7)
    assert (tmp_path / "ckpt" / "step_7" / "state.pt").exists()
    cfg2, params2 = checkpoint.load_vita_checkpoint(str(tmp_path), device="cpu")
    assert cfg2 == cfg and cfg2.llm.moe_chunk == 16
    _assert_leaves_equal(params2, params)
    raw = json.loads((tmp_path / "config.json").read_text())
    _assert_configs_equal(cfg2, j_ckpt._config_from_json(raw))
    raw["llm"]["pipe_stages"] = 2  # a JAX-only field: ignored
    assert checkpoint._config_from_json(raw) == cfg


def test_orbax_checkpoint_names_the_export(jax_tiny, tmp_path):
    j_ckpt.save_vita_checkpoint(str(tmp_path), *jax_tiny)
    j_ckpt.wait_for_checkpoints()
    with pytest.raises(ValueError, match="export_hf_vita_checkpoint"):
        checkpoint.load_vita_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.load_vita_checkpoint(str(tmp_path / "missing"), device="cpu")


# ---------------------------------------------------------------------------
# stage chaining
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["whole", "one_entry_misshapen", "strict"])
def test_whale_final_pt_matches_jax(case, tmp_path, capsys):
    """The cases of tests/test_stage_chaining.py: a final.pt of another
    encoder loads over the tiny model's audio tower; a misshapen entry
    keeps the current weight (reported, the rest loads); strict raises
    on it. Port and JAX give the same audio params."""
    jcfg = j_vita.VITAConfig.tiny()
    jp = jax.device_get(j_vita.init_params(jax.random.PRNGKey(0), jcfg))
    src = j_vita.init_params(jax.random.PRNGKey(7), jcfg)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in j_hf.whale_params_to_hf(src["audio"], jcfg.audio.n_layers).items()}
    if case != "whole":
        state["encoder.layers.0.feed_forward.w_1.weight"] = torch.zeros(3, 3)
        state["extra.unknown"] = torch.zeros(1)
    pt = str(tmp_path / "final.pt")
    torch.save({"model": state}, pt)
    tparams = from_jax_params(jp, vita.VITAConfig.tiny())
    if case == "strict":
        for load, p in ((j_ckpt.load_whale_torch_checkpoint, jp),
                        (checkpoint.load_whale_torch_checkpoint, tparams)):
            with pytest.raises(ValueError, match="1 kept"):
                load(p, pt, strict=True)
        return
    want = j_ckpt.load_whale_torch_checkpoint(jp, pt)
    jmsg = capsys.readouterr().out
    got = checkpoint.load_whale_torch_checkpoint(tparams, pt)
    assert capsys.readouterr().out == jmsg
    _assert_leaves_equal(got, from_jax_params(jax.device_get(want), vita.VITAConfig.tiny()))
    assert got["llm"] is tparams["llm"]
    kept = got["audio"]["layers"]["ffn1_w"][0]
    src_w = torch.from_numpy(np.array(src["audio"]["layers"]["ffn1_w"][0]))
    assert torch.equal(kept, tparams["audio"]["layers"]["ffn1_w"][0] if case != "whole"
                       else src_w)


@pytest.fixture(scope="module")
def adapters(jax_tiny, jax_export, tmp_path_factory):
    """One LoRA tree (rank 4, non-trivial values) saved by each package
    under its own layout."""
    jcfg, jp = jax_tiny
    jl = j_lora.LoRAConfig(rank=4)
    jad = jax.device_get(jax.tree.map(lambda x: (x + 0.01).astype(jnp.float32),
                                      j_lora.init_lora(jax.random.PRNGKey(1), jp["llm"], jl)))
    root = tmp_path_factory.mktemp("adapters")
    j_ckpt.save_checkpoint(str(root / "jax"), jad, block=True)
    save_state(str(root / "port"), 0, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jad))
    return str(root / "jax"), str(root / "port")


def _merged_close(got, jwant):
    want = _port_params(jwant, _bf16_tiny())
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        assert g.dtype == want[path].dtype, path
        # the adapters' einsum sums 4 products in another order; the bf16
        # merged weight is the same or one bf16 step away
        torch.testing.assert_close(g.float(), want[path].float(), atol=0, rtol=2 ** -7,
                                   msg=lambda m: f"{path}: {m}")


def test_lora_with_base_matches_jax(jax_export, adapters):
    jcfg, jmerged = j_ckpt.load_lora_vita_checkpoint(jax_export, adapters[0], rank=4)
    tcfg, merged = checkpoint.load_lora_vita_checkpoint(jax_export, adapters[1], rank=4,
                                                        device="cpu")
    _assert_configs_equal(tcfg, jcfg)
    _merged_close(merged, jmerged)
    _, base, ad, lcfg = checkpoint.load_lora_vita_checkpoint(jax_export, adapters[1], rank=4,
                                                             merge=False, device="cpu")
    assert lcfg == lora.LoRAConfig(rank=4)
    _assert_leaves_equal(lora.merge_lora(base, ad, lcfg), merged)


def test_merge_lora_cli_matches_jax(jax_export, adapters, tmp_path):
    from vita_tpu.train import merge_lora as j_merge
    from vita_tpu_torch.train import merge_lora

    assert j_merge.main(["--base", jax_export, "--lora", adapters[0], "--output",
                         str(tmp_path / "jax"), "--rank", "4"]) == 0
    j_ckpt.wait_for_checkpoints()
    assert merge_lora.main(["--base", jax_export, "--lora", adapters[1], "--output",
                            str(tmp_path / "port"), "--rank", "4", "--device", "cpu"]) == 0
    jcfg, jmerged = j_ckpt.load_vita_checkpoint(str(tmp_path / "jax"))
    tcfg, merged = checkpoint.load_vita_checkpoint(str(tmp_path / "port"), device="cpu")
    assert tcfg == checkpoint._config_from_json(json.loads(
        (tmp_path / "jax" / "config.json").read_text()))
    _assert_configs_equal(tcfg, jcfg)
    _merged_close(merged, jmerged)


# ---------------------------------------------------------------------------
# serving a loaded checkpoint
# ---------------------------------------------------------------------------
def test_engines_serve_exported_directory_identically(jax_export):
    """The JAX Engine and the port's, each on its own load of one exported
    directory (bf16, attn_backend 'xla'), stream the same greedy tokens for
    a text request and an image+audio request."""
    jcfg, jp = j_ckpt.load_vita_checkpoint(jax_export)
    tcfg, tp = checkpoint.load_vita_checkpoint(jax_export, device="cpu")
    rng = np.random.default_rng(5)
    frames = 60
    n_img, n_aud = tcfg.image_tokens_per_group, tokenization.audio_token_count(frames)
    s = n_img + n_aud + 10
    ids = rng.integers(3, 512, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[4:4 + n_img] = True
    am[4 + n_img:4 + n_img + n_aud] = True
    ids[im | am] = 0
    reqs = [dict(input_ids=rng.integers(3, 512, 11).astype(np.int32), max_new_tokens=8),
            dict(input_ids=ids, image_mask=im, audio_mask=am, max_new_tokens=8,
                 images=normal(rng, 1, 56, 56, 3), speech=normal(rng, frames, 80),
                 speech_length=frames)]
    streams = []
    for mod, params, cfg in ((j_engine, jp, jcfg), (engine, tp, tcfg)):
        eng = mod.Engine(params, cfg, n_slots=2, max_len=128, decode_chunk_len=2,
                         decode_moe_mode="gather")
        rs = [mod.Request(eos_id=-1, **kw) for kw in reqs]
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
        streams.append([r.tokens for r in rs])
    assert streams[1] == streams[0] and [len(s) for s in streams[1]] == [8, 8]


# ---------------------------------------------------------------------------
# the original VITA's goldens, through the port's own import
# ---------------------------------------------------------------------------
def _state(z, prefix):
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


def test_internvit_golden():
    z = np.load(GOLDEN_DIR / "internvit_tiny.npz")
    cfg = internvit.InternViTConfig.tiny()
    params = hf_import.internvit_params_from_hf(_state(z, "sd_"), cfg.n_layers)
    out = internvit.forward(params, cfg, torch.from_numpy(z["image"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(out.numpy(), z["expected"], **GOLDEN_TOL)


def test_whale_golden():
    z = np.load(GOLDEN_DIR / "whale_tiny.npz")
    cfg = whale.WhaleConfig.tiny()
    params = hf_import.whale_params_from_hf(_state(z, "sd_"), cfg.n_layers)
    out, valid = whale.forward(params, cfg, torch.from_numpy(z["feats"]),
                               torch.from_numpy(z["lengths"]))
    v = valid.numpy()
    np.testing.assert_array_equal(v, z["valid"])
    np.testing.assert_allclose(out.numpy() * v[..., None], z["expected"] * v[..., None],
                               **GOLDEN_TOL)


def test_projectors_golden():
    z = np.load(GOLDEN_DIR / "projectors_tiny.npz")
    vp = hf_import.vision_projector_from_hf(_state(z, "vsd_"))
    vout = projectors.vision_projector(vp, torch.from_numpy(z["vis_x"]))
    np.testing.assert_allclose(vout.numpy(), z["vis_expected"], **GOLDEN_TOL)
    ap = hf_import.audio_projector_from_hf(_state(z, "asd_"))
    aout, avalid = projectors.audio_projector(ap, torch.from_numpy(z["aud_x"]),
                                              torch.from_numpy(z["aud_mask"]).bool())
    np.testing.assert_allclose(aout.numpy(), z["aud_expected"], **GOLDEN_TOL)
    np.testing.assert_array_equal(avalid.numpy(), z["aud_mask"][:, 0::2].astype(bool))
