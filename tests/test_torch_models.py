"""PyTorch port: Mixtral forward on its three paths, the towers, the
projectors and the fusion, each against the JAX package with the same
weights (vita_tpu_torch.convert.from_jax_params)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.models import internvit as j_vit
from vita_tpu.models import mixtral as j_mix
from vita_tpu.models import projectors as j_proj
from vita_tpu.models import vita as j_vita
from vita_tpu.models import whale as j_whale
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import internvit, mixtral, projectors, vita, whale


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    jp = jax.device_get(j_vita.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, vita.VITAConfig.tiny(), from_jax_params(jp, vita.VITAConfig.tiny())


def _llm_cfgs(tiny, **kw):
    jcfg, _, tcfg, _ = tiny
    return dataclasses.replace(jcfg.llm, **kw), dataclasses.replace(tcfg.llm, **kw)


def test_convert_checks_structure_and_shapes(tiny):
    _, jp, tcfg, tp = tiny
    assert tp["llm"]["layers"]["moe"]["w_gate"].shape == (2, 4, 64, 128)
    bad = dict(jp, llm=dict(jp["llm"], lm_head=jp["llm"]["lm_head"][:, :10]))
    with pytest.raises(ValueError, match="lm_head"):
        from_jax_params(bad, tcfg)
    with pytest.raises(ValueError, match="keys"):
        from_jax_params({"llm": jp["llm"]}, tcfg)
    llm_only = from_jax_params(jp["llm"], tcfg.llm)
    assert torch.equal(llm_only["embed"], tp["llm"]["embed"])


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_mixtral_cacheless(tiny, backend):
    jcfg, jp, _, tp = tiny
    jc, tc = _llm_cfgs(tiny, attn_backend=backend)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 12)).astype(np.int32)
    tm = np.ones((2, 12), np.float32)
    tm[1, 9:] = 0
    got, cache, aux = mixtral.forward(tp["llm"], tc, input_ids=t(ids), token_mask=t(tm))
    with pltpu.force_tpu_interpret_mode():
        want, _, jaux = j_mix.forward(jp["llm"], jc, input_ids=jnp.asarray(ids),
                                      token_mask=jnp.asarray(tm))
    assert cache is None
    close(got, want)
    close(aux, jaux)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_mixtral_linear_scratch_prefill_chunk(tiny, backend):
    """A chunk at offset 8 of a 24-row scratch: writes its rows in place
    and attends over the whole scratch with kv_len offset+chunk."""
    jcfg, jp, _, tp = tiny
    jc, tc = _llm_cfgs(tiny, attn_backend=backend)
    rng = np.random.default_rng(1)
    shape = (jc.n_layers, 1, 24, jc.n_kv_heads, jc.head_dim)
    sk, sv = normal(rng, *shape), normal(rng, *shape)
    x = normal(rng, 1, 8, jc.d_model)
    off = 8
    pos = off + np.arange(8)[None]
    valid = np.arange(24)[None] < off + 8
    ck, cv = t(sk), t(sv)
    got, nc, _ = mixtral.forward(
        tp["llm"], tc, inputs_embeds=t(x), positions=t(pos), attn_valid=t(valid),
        cache={"k": ck, "v": cv, "pos": t([off], torch.int32)}, return_hidden=True)
    with pltpu.force_tpu_interpret_mode():
        want, jnc, _ = j_mix.forward(
            jp["llm"], jc, inputs_embeds=jnp.asarray(x), positions=jnp.asarray(pos),
            attn_valid=jnp.asarray(valid),
            cache={"k": jnp.asarray(sk), "v": jnp.asarray(sv),
                   "pos": jnp.asarray([off], jnp.int32)}, return_hidden=True)
    close(got, want)
    close(ck, jnc["k"])  # updated in place
    close(cv, jnc["v"])
    assert int(nc["pos"][0]) == off + 8


@pytest.mark.parametrize("moe_mode", ["dense", "gather"])
def test_mixtral_paged_decode(tiny, moe_mode):
    """One decode step over a page pool; slot 2 is inactive, slot 1 sits on
    a fresh page whose table entry follows the sentinel layout."""
    jcfg, jp, _, tp = tiny
    jc, tc = _llm_cfgs(tiny, moe_mode=moe_mode)
    rng = np.random.default_rng(2)
    n_pool, page = 6, 8
    pool_shape = (jc.n_layers, jc.n_kv_heads, n_pool, page, jc.head_dim)
    kp, vp = normal(rng, *pool_shape), normal(rng, *pool_shape)
    table = np.array([[0, 1, n_pool], [2, 3, n_pool], [4, n_pool, n_pool]], np.int32)
    pos = np.array([11, 8, 3], np.int32)
    active = np.array([True, True, False])
    ids = rng.integers(0, 512, (3, 1)).astype(np.int32)
    tk, tv = t(kp), t(vp)
    got, nc, _ = mixtral.forward(
        tp["llm"], tc, input_ids=t(ids), positions=t(pos[:, None]),
        cache={"k_pages": tk, "v_pages": tv, "table": t(table), "pos": t(pos),
               "active": t(active)})
    with pltpu.force_tpu_interpret_mode():
        want, jnc, _ = j_mix.forward(
            jp["llm"], jc, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos[:, None]),
            cache={"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp),
                   "table": jnp.asarray(table), "pos": jnp.asarray(pos),
                   "active": jnp.asarray(active)})
    close(got, want)
    close(tk, jnc["k_pages"])
    close(tv, jnc["v_pages"])
    np.testing.assert_array_equal(nc["pos"].numpy(), pos + 1)


@pytest.mark.parametrize("moe_mode", ["gather_q", "gather_q4"])
def test_mixtral_paged_decode_quantized(tiny, moe_mode):
    """One decode step over an int8 page pool with int8/int4 experts. Both
    sides run JAX's own quantized weights (carried over by
    from_jax_params); slot 2 is inactive. The pool's pages and scales are
    updated in place. The new k/v rows come from float32 matmuls whose last
    bits differ between the frameworks, so scales agree to float32
    tolerance and int8 values within one step (bit identity on equal
    inputs is test_torch_paged_attention_q.py's)."""
    jcfg, jp, tcfg, _ = tiny
    jc, tc = _llm_cfgs(tiny, moe_mode=moe_mode)
    jq = j_mix.quantize_moe_for_decode(jp["llm"], bits=4 if moe_mode == "gather_q4" else 8)
    tq = from_jax_params(jax.device_get(jq), tcfg.llm)
    assert tq["layers"]["moe"]["w_gate"].dtype == torch.int8
    rng = np.random.default_rng(3)
    n_pool, page = 6, 8
    shape = (jc.n_layers, jc.n_kv_heads, n_pool, page, jc.head_dim)
    sshape = (jc.n_layers, jc.n_kv_heads, n_pool, 1, page)
    pool = {"k_pages": rng.integers(-127, 128, shape).astype(np.int8),
            "v_pages": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": (rng.random(sshape) * 0.02).astype(np.float32),
            "v_scale": (rng.random(sshape) * 0.02).astype(np.float32)}
    table = np.array([[0, 1, n_pool], [2, 3, n_pool], [4, n_pool, n_pool]], np.int32)
    pos = np.array([11, 8, 3], np.int32)
    active = np.array([True, True, False])
    ids = rng.integers(0, 512, (3, 1)).astype(np.int32)
    tpool = {k: t(v) for k, v in pool.items()}
    got, nc, _ = mixtral.forward(
        tq, tc, input_ids=t(ids), positions=t(pos[:, None]),
        cache={**tpool, "table": t(table), "pos": t(pos), "active": t(active)})
    with pltpu.force_tpu_interpret_mode():
        want, jnc, _ = j_mix.forward(
            jq, jc, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos[:, None]),
            cache={**{k: jnp.asarray(v) for k, v in pool.items()}, "table": jnp.asarray(table),
                   "pos": jnp.asarray(pos), "active": jnp.asarray(active)})
    close(got, want)
    for name in pool:
        assert nc[name] is tpool[name]
        got_p, want_p = tpool[name].numpy(), np.asarray(jnc[name])
        if name.endswith("scale"):
            close(got_p, want_p, atol=1e-9, rtol=1e-6)
        else:
            assert np.abs(got_p.astype(np.int32) - want_p).max() <= 1
        assert (got_p != pool[name]).sum() == (want_p != pool[name]).sum() > 0


def test_convert_quantized_params_checks_shapes(tiny):
    _, jp, tcfg, _ = tiny
    jq = jax.device_get(j_mix.quantize_moe_for_decode(jp["llm"], bits=4))
    tq = from_jax_params(jq, tcfg.llm)
    assert tq["layers"]["moe"]["w_down"].shape == (2, 4, 128, 32)
    moe_bad = dict(jq["layers"]["moe"], w_up_scale=jq["layers"]["moe"]["w_up_scale"][..., :5])
    bad = dict(jq, layers=dict(jq["layers"], moe=moe_bad))
    with pytest.raises(ValueError, match="w_up_scale"):
        from_jax_params(bad, tcfg.llm)


def test_mixtral_unported_moe_mode_raises(tiny):
    _, tc = _llm_cfgs(tiny, moe_mode="gmm")
    with pytest.raises(NotImplementedError, match="gmm"):
        mixtral.forward(tiny[3]["llm"], tc, input_ids=torch.zeros(1, 2, dtype=torch.int32))


@pytest.mark.parametrize("side", [56, 84])
def test_internvit_forward(tiny, side):
    jcfg, jp, tcfg, tp = tiny
    img = normal(np.random.default_rng(3), 2, side, side, 3)
    got = internvit.forward(tp["vision"], tcfg.vision, t(img))
    want = j_vit.forward(jp["vision"], jcfg.vision, jnp.asarray(img))
    assert got.shape == want.shape
    close(got, want)


def test_internvit_helpers():
    x = normal(np.random.default_rng(4), 2, 4, 4, 8)
    np.testing.assert_array_equal(internvit.pixel_shuffle(t(x)).numpy(),
                                  np.asarray(j_vit.pixel_shuffle(jnp.asarray(x))))
    img = normal(np.random.default_rng(5), 1, 28, 28, 3)
    np.testing.assert_array_equal(internvit.patchify(t(img), 14).numpy(),
                                  np.asarray(j_vit.patchify(jnp.asarray(img), 14)))
    pos = normal(np.random.default_rng(6), 1, 17, 8)
    close(internvit.interpolate_pos_embed(t(pos), 4, 6),
          j_vit.interpolate_pos_embed(jnp.asarray(pos), 4, 6))


def test_whale_forward_with_padding(tiny):
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(7)
    speech = normal(rng, 2, 50, 80)
    lengths = np.array([50, 31], np.int32)
    got, valid = whale.forward(tp["audio"], tcfg.audio, t(speech), t(lengths))
    want, jvalid = j_whale.forward(jp["audio"], jcfg.audio, jnp.asarray(speech),
                                   jnp.asarray(lengths))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    close(got, want)
    assert whale.subsampled_length(50) == j_whale.subsampled_length(50)
    np.testing.assert_array_equal(whale.sinusoid_table(7, 16), j_whale.sinusoid_table(7, 16))


def test_projectors(tiny):
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(8)
    feats = normal(rng, 2, 4, tcfg.vision_proj_in_dim)
    close(projectors.vision_projector(tp["vision_proj"], t(feats)),
          j_proj.vision_projector(jp["vision_proj"], jnp.asarray(feats)))
    af = normal(rng, 2, 9, tcfg.audio.hidden)
    valid = np.arange(9)[None] < np.array([[9], [6]])
    got, gv = projectors.audio_projector(tp["audio_proj"], t(af), t(valid))
    want, wv = j_proj.audio_projector(jp["audio_proj"], jnp.asarray(af), jnp.asarray(valid))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    close(got, want)


def _media_inputs(cfg, rng, n_tiles, frames=(60,)):
    n_img = cfg.image_tokens_per_group * (n_tiles // cfg.image_group_tiles)
    counts = [((f - 1) // 2 - 1) // 2 for f in frames]
    counts = [(c - 1) // 2 + 1 for c in counts]
    s = 6 + n_img + sum(counts)
    ids = rng.integers(1, 512, (1, s)).astype(np.int32)
    im, am = np.zeros((1, s), bool), np.zeros((1, s), bool)
    im[0, 3:3 + n_img] = True
    am[0, 3 + n_img:3 + n_img + sum(counts)] = True
    ids[im | am] = 0
    sz = cfg.vision.image_size
    images = normal(rng, n_tiles, sz, sz, 3)
    speech = normal(rng, len(frames), max(frames), 80)
    return ids, im, am, images, speech, np.asarray(frames, np.int32), counts


@pytest.mark.parametrize("fusion", ["patch", "framecat"])
def test_fuse_embeddings(fusion):
    jcfg = j_vita.VITAConfig.tiny(vision_fusion=fusion)
    tcfg = vita.VITAConfig.tiny(vision_fusion=fusion)
    jp = jax.device_get(j_vita.init_params(jax.random.PRNGKey(1), jcfg))
    tp = from_jax_params(jp, tcfg)
    rng = np.random.default_rng(9)
    n_tiles = 5 if fusion == "framecat" else 2
    ids, im, am, images, speech, lens, _ = _media_inputs(tcfg, rng, n_tiles)
    got = vita.fuse_embeddings(tp, tcfg, t(ids), t(im), t(am), t(images), t(speech), t(lens))
    want = j_vita.fuse_embeddings(jp, jcfg, jnp.asarray(ids), jnp.asarray(im), jnp.asarray(am),
                                  jnp.asarray(images), speech=jnp.asarray(speech),
                                  speech_lengths=jnp.asarray(lens))
    close(got, want)


def test_fuse_embeddings_multi_clip_audio_select(tiny):
    jcfg, jp, tcfg, tp = tiny
    from vita_tpu.tokenization import audio_select_arrays

    rng = np.random.default_rng(10)
    ids, im, am, images, speech, lens, counts = _media_inputs(tcfg, rng, 1, frames=(60, 44))
    ci, ri = audio_select_arrays(am[0], counts)
    sel_t, sel_j = (t(ci)[None], t(ri)[None]), (jnp.asarray(ci)[None], jnp.asarray(ri)[None])
    got = vita.fuse_embeddings(tp, tcfg, t(ids), t(im), t(am), t(images), t(speech), t(lens),
                               audio_select=sel_t)
    want = j_vita.fuse_embeddings(jp, jcfg, jnp.asarray(ids), jnp.asarray(im), jnp.asarray(am),
                                  jnp.asarray(images), speech=jnp.asarray(speech),
                                  speech_lengths=jnp.asarray(lens), audio_select=sel_j)
    close(got, want)
    enc = normal(rng, 2, 14, tcfg.audio.hidden)
    elens = np.array([14, 10], np.int32)
    got = vita.fuse_embeddings(tp, tcfg, t(ids), audio_mask=t(am), audio_encoded=t(enc),
                               audio_encoded_lengths=t(elens), audio_select=sel_t)
    want = j_vita.fuse_embeddings(jp, jcfg, jnp.asarray(ids), audio_mask=jnp.asarray(am),
                                  audio_encoded=jnp.asarray(enc),
                                  audio_encoded_lengths=jnp.asarray(elens), audio_select=sel_j)
    close(got, want)


def test_unported_tower_and_projector_raise():
    cfg = vita.VITAConfig.tiny(vision_tower="siglip")
    with pytest.raises(NotImplementedError, match="siglip"):
        vita.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ldp"):
        vita.init_params(vita.VITAConfig.tiny(vision_projector="ldp"),
                         torch.Generator().manual_seed(0))


def test_init_params_follows_jax_scales(tiny):
    """Same structure, shapes and dtypes (the bridge checks them against the
    port's init), constant leaves equal, random leaves at the JAX std."""
    _, jp, tcfg, _ = tiny
    tp = vita.init_params(tcfg, torch.Generator().manual_seed(0))
    from_jax_params(jp, tcfg)  # raises on any structural difference

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
            return
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        if b.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=path)
        elif b.size >= 256:
            assert abs(a.std() / b.std() - 1) < 0.2, path

    walk(tp, jp)
