"""PyTorch port: the serving Engine as a whole against the JAX Engine, same
weights, greedy decoding, selected-expert decode (bf16 experts, or int8 /
int4 experts with int8 KV pages) and the other MoE modes (prefill gmm,
sort, capacity; decode sort, capacity); the streamed tokens must be
identical. The JAX side keeps attn_backend='xla', the flash kernel's exact
twin on the CPU, and runs the quantized modes in Pallas interpret mode, so
its expert FFN computes what the TPU kernels compute. Also warmup and the
EngineThread loop."""

import contextlib
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import normal
from vita_tpu import generate as j_gen
from vita_tpu import tokenization as j_tok
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch import generate, tokenization
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.ops import moe_decode
from vita_tpu_torch.serve import engine


@pytest.fixture(scope="module")
def models():
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    return jcfg, jp, tcfg, from_jax_params(jax.device_get(jp), tcfg)


def _serve(models, req_kws, decode_moe_mode="gather", **engine_kw):
    """Run the same requests through both engines, checking that each
    stream's callbacks saw its tokens; returns (jax streams, port streams,
    jax engine, port engine). Quantized decode modes run the JAX engine in
    Pallas interpret mode."""
    jcfg, jp, tcfg, tp = models
    out = []
    for mod, params, cfg in ((j_engine, jp, jcfg), (engine, tp, tcfg)):
        ctx = (pltpu.force_tpu_interpret_mode()
               if mod is j_engine and decode_moe_mode in ("gather_q", "gather_q4")
               else contextlib.nullcontext())
        with ctx:
            eng = mod.Engine(params, cfg, decode_moe_mode=decode_moe_mode, **engine_kw)
            streamed = [[] for _ in req_kws]
            reqs = [mod.Request(eos_id=-1, on_token=streamed[i].append, **kw)
                    for i, kw in enumerate(req_kws)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
        assert streamed == [r.tokens for r in reqs]
        out.append(([r.tokens for r in reqs], eng))
    (jt, je), (tt, te) = out
    return jt, tt, je, te


def _text(rng, n, max_new_tokens):
    return dict(input_ids=rng.integers(3, 512, n).astype(np.int32),
                max_new_tokens=max_new_tokens)


def test_one_text_request(models):
    rng = np.random.default_rng(0)
    jt, tt, _, te = _serve(models, [_text(rng, 9, 12)], n_slots=2, max_len=64)
    assert tt == jt and len(tt[0]) == 12
    assert te.stats()["completed"] == 1.0


def test_one_image_audio_request(models):
    _, _, tcfg, _ = models
    rng = np.random.default_rng(1)
    frames = 60
    n_img, n_aud = tcfg.image_tokens_per_group, tokenization.audio_token_count(frames)
    s = n_img + n_aud + 10
    ids = rng.integers(3, 512, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[4:4 + n_img] = True
    am[4 + n_img:4 + n_img + n_aud] = True
    ids[im | am] = 0
    req = dict(input_ids=ids, image_mask=im, audio_mask=am, max_new_tokens=8,
               images=normal(rng, 1, 56, 56, 3), speech=normal(rng, frames, 80),
               speech_length=frames)
    jt, tt, _, _ = _serve(models, [req], n_slots=1, max_len=128, decode_chunk_len=2)
    assert tt == jt and len(tt[0]) == 8


def test_four_concurrent_requests_reach_batch_four(models, monkeypatch):
    """Chunked prefill (bucket 32 in chunks of 16), two prefills at once,
    decode batches of 1..4 (the masked-expert schedule at 4)."""
    batches = []
    real = engine.decode_chunk

    def spy(params, cache, tok, *a, **kw):
        batches.append(tok.shape[0])
        return real(params, cache, tok, *a, **kw)

    monkeypatch.setattr(engine, "decode_chunk", spy)
    rng = np.random.default_rng(2)
    reqs = [_text(rng, n, m) for n, m in ((20, 14), (5, 10), (31, 12), (12, 9))]
    jt, tt, _, _ = _serve(models, reqs, n_slots=4, max_len=64, page_size=8,
                          prefill_chunk=16, prompt_buckets=(16, 32, 64), decode_chunk_len=4)
    assert tt == jt
    assert max(batches) == 4 and min(batches) == 1


def test_preemption_keeps_streams(models):
    """A pool of 8 pages of 8 cannot hold both requests' growth: the newer
    one is preempted, re-prefills prompt+generated, and streams on."""
    rng = np.random.default_rng(3)
    reqs = [_text(rng, 10, 40), _text(rng, 12, 40)]
    jt, tt, je, te = _serve(models, reqs, n_slots=2, max_len=64, page_size=8,
                            total_pages=8, decode_chunk_len=4)
    assert tt == jt and all(len(x) == 40 for x in tt)
    assert te.stats()["preemptions"] > 0 and je.stats()["preemptions"] > 0
    assert te.alloc.free_count == 8


def test_sampled_request_plumbing(models):
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=2, max_len=64, decode_moe_mode="gather", seed=3)
    rng = np.random.default_rng(4)
    reqs = [engine.Request(eos_id=-1, temperature=0.8, top_k=k, top_p=p, **_text(rng, 7, 10))
            for k, p in ((0, 1.0), (20, 0.9))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        assert len(r.tokens) == 10 and all(0 <= x < 512 for x in r.tokens)


def test_cancellation_and_stats(models):
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=1, max_len=64, decode_chunk_len=2)
    finished = []
    req = engine.Request(input_ids=np.array([1, 5], np.int32), max_new_tokens=50, eos_id=-1,
                         on_finish=lambda toks, why: finished.append(why))
    req.on_token = lambda tok: req.cancel() if len(req.tokens) >= 3 else None
    eng.submit(req)
    eng.run_until_idle()
    assert finished == ["cancelled"] and 3 <= len(req.tokens) < 50
    stats = eng.stats()
    assert stats["completed"] == 1.0 and stats["free_pages"] == stats["total_pages"]
    assert stats["ttft_p50_s"] > 0 and eng.active_count() == 0


def test_eos_and_capacity_guard(models):
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="cache holds"):
        eng.submit(engine.Request(input_ids=np.arange(10, dtype=np.int32), max_new_tokens=10))
    probe = engine.Request(input_ids=np.array([1, 5], np.int32), max_new_tokens=5, eos_id=-1)
    eng.submit(probe)
    eng.run_until_idle()
    req = engine.Request(input_ids=np.array([1, 5], np.int32), max_new_tokens=5,
                         eos_id=probe.tokens[2])
    eng.submit(req)
    eng.run_until_idle()
    assert req.tokens == probe.tokens[:3]


class _AxisMesh:
    """Answers what a DeviceMesh answers about its axes, with one axis of
    ``size`` (a one-process world cannot build such a mesh)."""

    mesh_dim_names = ("data", "fsdp", "expert", "model", "pipe", "seq")

    def __init__(self, name, size=2):
        self.name, self.n = name, size

    def size(self, i):
        return self.n if self.mesh_dim_names[i] == self.name else 1

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=_AxisMesh("pipe", 3)), (ValueError, "2 layers not divisible by pipe axis 3")),
    (dict(mesh=_AxisMesh("seq")), (ValueError, "KV-cache decode/prefill needs seq axis 1")),
    (dict(mesh=_AxisMesh("fsdp")), (None, 2)),
    (dict(mesh=_AxisMesh("data")), (None, 1))],
    ids=["kw0-A11c", "kw1-A11b", "kw2-A11d", "kw3-A11d"])
def test_unported_options_raise(models, kw, item):
    """A 'seq' axis (ported as the cacheless ring, A11b) raises the JAX
    package's ValueError, for a KV cache holds whole sequences; a 'pipe'
    axis is ported (A11c): one that does not divide the layer stack raises
    the JAX package's ValueError. 'fsdp' and 'data' axes are ported too
    (A11d, refused until then; the cases keep their ids): the Engine holds
    this rank's 'fsdp' blocks of the LLM (the embedding's columns split
    over 'fsdp', whole over 'data') and builds its pool whole
    (tests/test_torch_dp_serving.py serves over them)."""
    _, _, tcfg, tp = models
    exc, match = item
    if exc is None:
        eng = engine.Engine(tp, tcfg, n_slots=1, max_len=64, **kw)
        assert eng.params["llm"]["embed"].shape == (tcfg.llm.vocab_size,
                                                    tcfg.llm.d_model // match)
        assert eng.cache["k_pages"].shape[1] == tcfg.llm.n_kv_heads
        return
    with pytest.raises(exc, match=match):
        engine.Engine(tp, tcfg, n_slots=1, max_len=64, **kw)


@pytest.mark.parametrize("prefill,decode", [
    ("gmm", "gather"), ("sort", "gather"), ("capacity", "gather"), ("gmm", "capacity"),
    ("dense", "sort"),
])
def test_moe_modes_match_jax_engine(models, prefill, decode):
    """Chunked prefill (bucket 32 in chunks of 16) in each prefill MoE mode,
    decode batches of 1-2 in each decode mode."""
    rng = np.random.default_rng(8)
    reqs = [_text(rng, n, m) for n, m in ((20, 10), (7, 9))]
    jt, tt, _, _ = _serve(models, reqs, decode_moe_mode=decode, prefill_moe_mode=prefill,
                          n_slots=2, max_len=64, page_size=8, prefill_chunk=16,
                          prompt_buckets=(16, 32, 64), decode_chunk_len=4)
    assert tt == jt and [len(x) for x in tt] == [10, 9]


def test_warmup_leaves_the_engine_idle(models):
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=2, max_len=256, page_size=8,
                        prompt_buckets=(16, 32, 256), prefill_moe_mode="gmm")
    assert eng.warmup(media=True, max_new_tokens=2) > 0
    stats = eng.stats()
    assert stats["completed"] == 3.0 and stats["active"] == 0 and stats["queued"] == 0
    assert stats["free_pages"] == stats["total_pages"] and not eng._prefill_jobs


def test_engine_thread_serves_and_stops(models):
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=1, max_len=64)
    done = threading.Event()
    finished = []
    req = engine.Request(input_ids=np.array([1, 5, 9], np.int32), max_new_tokens=6, eos_id=-1,
                         on_finish=lambda toks, why: (finished.append(why), done.set()))
    thread = engine.EngineThread(eng, tick_idle_s=0.001)
    thread.start()
    eng.submit(req)
    assert done.wait(120)
    thread.stop()
    thread.join(10)
    assert not thread.is_alive()
    assert finished == ["length"] and len(req.tokens) == 6


@pytest.mark.parametrize("mode", ["gather_q", "gather_q4"])
def test_quantized_engine_one_text_request(models, mode):
    """int8 / int4 experts with int8 KV pages: the reference's production
    serving pair."""
    rng = np.random.default_rng(6)
    jt, tt, je, te = _serve(models, [_text(rng, 9, 12)], decode_moe_mode=mode, kv_int8=True,
                            n_slots=2, max_len=64)
    assert tt == jt and len(tt[0]) == 12
    assert te.cache["k_pages"].dtype == torch.int8 and "k_scale" in te.cache
    moe = te._decode_llm["layers"]["moe"]
    assert moe["w_gate"].dtype == torch.int8 and "w_gate_scale" in moe


@pytest.mark.parametrize("mode", ["gather_q", "gather_q4"])
def test_quantized_engine_batch_of_eight(models, mode, monkeypatch):
    """Eight concurrent requests on eight slots: decode batches reach 8, so
    the masked schedule runs for int8 (T >= 4) and for int4 (T >= 8)."""
    batches, masked = [], []
    real_chunk, real_masked = engine.decode_chunk, moe_decode.masked_expert_ffn_q_plain

    def spy_chunk(params, cache, tok, *a, **kw):
        batches.append(tok.shape[0])
        return real_chunk(params, cache, tok, *a, **kw)

    def spy_masked(x, act, m, qparams, bits, *out_dtype):
        masked.append((x.shape[0], bits))
        return real_masked(x, act, m, qparams, bits, *out_dtype)

    monkeypatch.setattr(engine, "decode_chunk", spy_chunk)
    monkeypatch.setattr(moe_decode, "masked_expert_ffn_q_plain", spy_masked)
    rng = np.random.default_rng(7)
    reqs = [_text(rng, n, 16) for n in (9, 14, 5, 20, 11, 7, 16, 3)]
    jt, tt, _, _ = _serve(models, reqs, decode_moe_mode=mode, kv_int8=True, n_slots=8,
                          max_len=64, page_size=8, prompt_buckets=(16, 32),
                          decode_chunk_len=2, max_concurrent_prefills=4)
    assert tt == jt and all(len(x) == 16 for x in tt)
    assert max(batches) == 8
    assert (8, 4 if mode == "gather_q4" else 8) in masked


def test_session_key_and_bad_modes_raise(models):
    """session_key is served (tests/test_torch_session.py holds its reuse
    to JAX's); a bad decode mode raises."""
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=1, max_len=64)
    req = eng.submit(engine.Request(input_ids=np.array([1], np.int32), max_new_tokens=2,
                                    eos_id=-1, session_key="s"))
    eng.run_until_idle()
    assert len(req.tokens) == 2 and eng.stats()["cached_prefixes"] == 1
    with pytest.raises(ValueError, match="bad decode_moe_mode"):
        engine.Engine(tp, tcfg, n_slots=1, max_len=64, decode_moe_mode="nope")


def test_host_helpers_match_the_jax_package():
    for n in (1, 7, 400, 1601):
        assert tokenization.audio_token_count(n) == j_tok.audio_token_count(n)
    assert tokenization.pad_to_bucket([4, 5, 6], (2, 8), 0) == j_tok.pad_to_bucket([4, 5, 6], (2, 8), 0)
    with pytest.raises(ValueError):
        tokenization.pad_to_bucket([1] * 9, (2, 8), 0)
    mask = np.zeros(20, bool)
    mask[[2, 3, 4, 9, 10, 15]] = True
    for got, want in zip(tokenization.audio_select_arrays(mask, [3, 2, 1]),
                         j_tok.audio_select_arrays(mask, [3, 2, 1])):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(5)
    clips = [normal(rng, 300, 80), normal(rng, 500, 80)]
    for fn, jfn, src, lens in (
        (generate.stack_speech_clips, j_gen.stack_speech_clips, clips, [300, 450]),
        (generate.stack_encoded_clips, j_gen.stack_encoded_clips, [c[:70] for c in clips], [70, 60]),
    ):
        got, want = fn(src, lens, (400, 800)), jfn(src, lens, (400, 800))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    x = normal(rng, 3, 2)
    np.testing.assert_array_equal(generate.pad_axis0(x, (2, 5)), j_gen.pad_axis0(x, (2, 5)))
    assert generate.DEFAULT_PROMPT_BUCKETS == j_gen.DEFAULT_PROMPT_BUCKETS
