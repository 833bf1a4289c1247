"""PyTorch port: session KV-prefix reuse in the Engine against the JAX
Engine, same weights, greedy decoding. Each case serves the same turns
through both engines (each side building a turn from its own previous
streams): the streams, the prefill offsets, ``reused_prefix_rows`` and the
cached and free page counts must be identical, and a reused turn must
stream what a cold engine streams. The cases are those of the JAX serving
tests (text, image, a different image, eviction under page pressure, a
turn that ends on its first token, the true-position cache_full, preempt
and resume), plus int8 KV pages, whose JAX side runs in Pallas interpret
mode, and the page extraction itself on non-uniform int8 scales."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import normal, t
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.serve import engine


@pytest.fixture(scope="module")
def models():
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    return jcfg, jp, tcfg, from_jax_params(jax.device_get(jp), tcfg)


def _run_turns(mod, params, cfg, turns, **engine_kw):
    """Serve ``turns`` (functions of the earlier streams giving a request's
    keywords) one after another on one engine; returns (streams, the offset
    each prefill started at, engine)."""
    quant = engine_kw.get("decode_moe_mode") in ("gather_q", "gather_q4")
    ctx = (pltpu.force_tpu_interpret_mode() if mod is j_engine and quant
           else contextlib.nullcontext())
    with ctx:
        eng = mod.Engine(params, cfg, **engine_kw)
        offsets = []
        start = eng._start_prefill

        def spy(slot, req, pages):
            start(slot, req, pages)
            offsets.append(eng._prefill_jobs[-1].offset)

        eng._start_prefill = spy
        streams = []
        for make in turns:
            reqs = [mod.Request(eos_id=-1, **kw) for kw in make(streams)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            streams.extend(r.tokens for r in reqs)
    return streams, offsets, eng


def _cached_pages(eng) -> int:
    return sum(len(c.pages) for c in eng._prefix_cache.values())


def _both(models, turns, **engine_kw):
    """The turns on the JAX and the port engine; asserts equal streams,
    offsets, reuse counters and page counts; returns the port's (streams,
    offsets, engine)."""
    jcfg, jp, tcfg, tp = models
    engine_kw.setdefault("decode_moe_mode", "gather")
    js, jo, je = _run_turns(j_engine, jp, jcfg, turns, **engine_kw)
    ts, to, te = _run_turns(engine, tp, tcfg, turns, **engine_kw)
    assert ts == js
    assert to == jo
    for key in ("reused_prefix_rows", "cached_prefixes", "free_pages", "preemptions"):
        assert te.stats()[key] == je.stats()[key], key
    assert _cached_pages(te) == _cached_pages(je)
    return ts, to, te


def _cold(models, turns, **engine_kw):
    """The port's streams for the same turns with every session key
    dropped."""
    _, _, tcfg, tp = models
    engine_kw.setdefault("decode_moe_mode", "gather")

    def strip(make):
        return lambda streams: [{k: v for k, v in kw.items() if k != "session_key"}
                                for kw in make(streams)]

    return _run_turns(engine, tp, tcfg, [strip(m) for m in turns], **engine_kw)[0]


TEXT_KW = dict(n_slots=1, max_len=512, page_size=8, decode_chunk_len=2, prefill_chunk=16,
               prompt_buckets=(96, 256))
BASE = np.concatenate([[1], np.arange(10, 90, dtype=np.int32)])


def _text_turns(key="s"):
    def turn1(_):
        return [dict(input_ids=BASE, max_new_tokens=6, session_key=key)]

    def turn2(streams):
        ids = np.concatenate([BASE, np.asarray(streams[0], np.int32),
                              np.arange(100, 120, dtype=np.int32)])
        return [dict(input_ids=ids, max_new_tokens=6, session_key=key)]

    return [turn1, turn2]


def test_session_kv_prefix_reuse(models):
    """Turn 2 prefills only the suffix of the 87-row shared prefix (offset
    80, five chunks of 16) and streams what a cold engine streams."""
    streams, offsets, eng = _both(models, _text_turns(), **TEXT_KW)
    assert offsets == [0, 80]
    assert eng.stats()["reused_prefix_rows"] == 80 and eng.stats()["cached_prefixes"] == 1
    assert streams == _cold(models, _text_turns(), **TEXT_KW)


def test_session_kv_prefix_reuse_int8_pages(models):
    """int8 experts and int8 KV pages: the reused rows are the dequantized
    pages, as in JAX's _extract_fn_q (lossy by design, so no cold
    comparison)."""
    _, offsets, eng = _both(models, _text_turns(), kv_int8=True,
                            **{**TEXT_KW, "decode_moe_mode": "gather_q"})
    assert offsets == [0, 80]
    assert eng.cache["k_pages"].dtype == torch.int8


def _image_turns(cfg, tiles_per_turn, suffix=True, key="s"):
    """'text <image> text' turns; turn 2 extends turn 1 with its answer and
    12 new ids when ``suffix``, else repeats the prompt."""
    from vita_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vita_tpu_torch.tokenization import media_masks

    ids = [1, 7, 9] + [IMAGE_TOKEN_INDEX] * cfg.vision.out_tokens + [5, 11]
    safe, im, _ = media_masks(np.array(ids))

    def make(i):
        def turn(streams):
            ids, mask = safe, im
            if suffix and streams:
                ids = np.concatenate([safe, np.asarray(streams[0], np.int64),
                                      np.arange(100, 112, dtype=np.int64)])
                mask = np.zeros(len(ids), bool)
                mask[:len(safe)] = im
            return [dict(input_ids=ids, image_mask=mask, images=tiles_per_turn[i],
                         max_new_tokens=6, session_key=key)]
        return turn

    return [make(i) for i in range(len(tiles_per_turn))]


def _tiles(cfg, seed):
    sz = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal((1, sz, sz, 3)).astype(np.float32)


def test_session_kv_prefix_reuse_with_media(models):
    """Turn 1 carried an image: turn 2 reuses over it (prefill chunk 8;
    the tiny tower gives 4 image tokens, so the prefix is ~15 rows)."""
    cfg = models[2]
    kw = dict(TEXT_KW, prefill_chunk=8)
    tiles = _tiles(cfg, 0)
    turns = _image_turns(cfg, [tiles, tiles])
    streams, offsets, _ = _both(models, turns, **kw)
    assert offsets[0] == 0 and offsets[1] > 0
    assert streams == _cold(models, turns, **kw)


def test_session_media_prefix_rejected_on_different_image(models):
    """Same ids and masks, other tiles: the digest clamps the prefix to
    before the image (position 2 < one chunk), so nothing is reused."""
    cfg = models[2]
    turns = _image_turns(cfg, [_tiles(cfg, 0), _tiles(cfg, 1)], suffix=False)
    streams, offsets, eng = _both(models, turns, **TEXT_KW)
    assert offsets == [0, 0] and eng.stats()["reused_prefix_rows"] == 0
    assert streams[1] == _cold(models, turns[1:], **TEXT_KW)[0]


def test_media_digests_hash_tensors_as_their_host_bytes(models):
    """A request holding torch tensors digests like one holding the same
    numpy arrays (and so still reuses)."""
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=1, max_len=128)
    rng = np.random.default_rng(2)
    from vita_tpu_torch.tokenization import audio_token_count

    ids = np.arange(30, dtype=np.int32)
    im, am = np.zeros(30, bool), np.zeros(30, bool)
    im[2:2 + tcfg.image_tokens_per_group] = True
    am[10:10 + audio_token_count(60)] = True
    tiles, feats = normal(rng, 1, 56, 56, 3), normal(rng, 60, 80)
    kw = dict(input_ids=ids, image_mask=im, audio_mask=am, speech_length=60)
    a = eng._media_spans(engine.Request(images=tiles, speech=feats, **kw))
    b = eng._media_spans(engine.Request(images=t(tiles), speech=t(feats), **kw))
    c = eng._media_spans(engine.Request(images=tiles + 1, speech=feats, **kw))
    assert a == b and len(a) == 2 and a[0][2].startswith("img:") and a != c
    je = j_engine.Engine.__new__(j_engine.Engine)
    je.cfg = models[0]
    assert a == je._media_spans(j_engine.Request(images=tiles, speech=feats, **kw))


def test_session_cache_evicted_under_page_pressure(models):
    """A 3-page pool: a non-session request needs the cached pages."""
    kw = dict(n_slots=1, max_len=64, page_size=8, total_pages=3, decode_chunk_len=2,
              prompt_buckets=(8,))
    turns = [lambda _: [dict(input_ids=np.array([1, 5], np.int32), max_new_tokens=4,
                             session_key="a")],
             lambda _: [dict(input_ids=np.arange(1, 8, dtype=np.int32), max_new_tokens=10)]]
    streams, _, eng = _both(models, turns, **kw)
    assert len(streams[1]) == 10 and eng.stats()["cached_prefixes"] == 0


def test_eviction_takes_the_requesters_own_cache_last(models):
    """Two sessions cached (2 pages each) in a 5-page pool; session b's
    next turn needs 3 pages: a's prefix goes, b's is reused."""
    kw = dict(n_slots=1, max_len=64, page_size=8, total_pages=5, decode_chunk_len=2,
              prefill_chunk=8, prompt_buckets=(16, 32))
    first = np.arange(1, 12, dtype=np.int32)
    turns = [lambda _: [dict(input_ids=first, max_new_tokens=4, session_key="a")],
             lambda _: [dict(input_ids=first + 1, max_new_tokens=4, session_key="b")],
             lambda s: [dict(input_ids=np.concatenate([first + 1, np.asarray(s[1], np.int32),
                                                       np.arange(40, 44, dtype=np.int32)]),
                             max_new_tokens=4, session_key="b")]]
    _, offsets, eng = _both(models, turns, **kw)
    assert offsets == [0, 0, 8]
    assert list(eng._prefix_cache) == ["b"]


def test_session_prefix_after_early_finish_is_safe(models):
    """A turn that ends on prefill's first token (max_new_tokens 1) must
    not offer its unwritten last row: 15 prompt ids + that token would
    align the reuse to 16 and take row 15."""
    kw = dict(n_slots=1, max_len=512, page_size=8, decode_chunk_len=2, prefill_chunk=8,
              prompt_buckets=(16, 32, 96))
    base = np.concatenate([[1], np.arange(10, 24, dtype=np.int32)])
    turns = [lambda _: [dict(input_ids=base, max_new_tokens=1, session_key="s")],
             lambda s: [dict(input_ids=np.concatenate([base, np.asarray(s[0], np.int32),
                                                       np.arange(40, 60, dtype=np.int32)]),
                             max_new_tokens=6, session_key="s")]]
    streams, offsets, _ = _both(models, turns, **kw)
    assert offsets == [0, 8]
    assert streams == _cold(models, turns, **kw)


def test_cache_full_uses_true_position(models):
    """A request sized to fill max_len exactly gets all its tokens and
    finishes on 'length' (and so caches its pages)."""
    kw = dict(n_slots=1, max_len=64, page_size=8, decode_chunk_len=8, prefill_chunk=8,
              prompt_buckets=(32,))
    ids = np.concatenate([[1], np.arange(10, 41, dtype=np.int32)])
    streams, _, eng = _both(models, [lambda _: [dict(input_ids=ids, max_new_tokens=32,
                                                     session_key="s")]], **kw)
    assert len(streams[0]) == 32 and eng.stats()["cached_prefixes"] == 1


def test_preempt_resume_with_sessions_and_streaming(models):
    """Three session requests in a 9-page pool: preemption, resume and
    caching interleave; every stream has all its tokens."""
    kw = dict(n_slots=3, max_len=256, page_size=16, total_pages=9, decode_moe_mode="dense")
    turns = [lambda _: [dict(input_ids=np.arange(2 + i, 34 + i, dtype=np.int32),
                             max_new_tokens=30, session_key=f"s{i}") for i in range(3)],
             lambda s: [dict(input_ids=np.concatenate([np.arange(2, 34, dtype=np.int32),
                                                       np.asarray(s[0], np.int32)[:-1],
                                                       np.arange(60, 70, dtype=np.int32)]),
                             max_new_tokens=8, session_key="s0")]]
    streams, offsets, eng = _both(models, turns, **kw)
    assert eng.stats()["preemptions"] > 0
    assert [len(x) for x in streams] == [30, 30, 30, 8]


def test_extract_pages_matches_jax_on_real_scales():
    """The page gather and int8 dequantization against JAX's _extract_fn
    and _extract_fn_q, with per-(row, head) scales that differ everywhere
    (a transposed scale layout would fail here) and page ids past the pool
    (clipped)."""
    rng = np.random.default_rng(0)
    l, hkv, n_pool, page, hd = 2, 3, 5, 4, 8
    kp = rng.integers(-127, 128, (l, hkv, n_pool, page, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (l, hkv, n_pool, page, hd)).astype(np.int8)
    ks = rng.uniform(0.01, 2.0, (l, hkv, n_pool, 1, page)).astype(np.float32)
    vs = rng.uniform(0.01, 2.0, (l, hkv, n_pool, 1, page)).astype(np.float32)
    ids = np.array([3, 0, 4, 7], np.int32)  # 7 lies past the pool
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = engine._extract_pages({"k_pages": t(kp), "v_pages": t(vp), "k_scale": t(ks),
                                     "v_scale": t(vs)}, t(ids).long(), dtype)
        want = j_engine._extract_fn_q(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks),
                                      jnp.asarray(vs), jnp.asarray(ids), dtype=jdt)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == (l, 1, 4 * page, hkv, hd)
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w.astype(jnp.float32)))
    fk, fv = normal(rng, l, hkv, n_pool, page, hd), normal(rng, l, hkv, n_pool, page, hd)
    got = engine._extract_pages({"k_pages": t(fk), "v_pages": t(fv)}, t(ids).long(),
                                torch.float32)
    want = j_engine._extract_fn(jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
