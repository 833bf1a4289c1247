"""PyTorch port: the Engine's asynchronous decode loop (``decode_inflight``
chunks dispatched before the oldest is read, decode operands kept on the
device under a state epoch) against the JAX Engine at the same depth, same
weights, greedy decoding, pages of 8 and decode chunks of 4. Every case's
token ids equal the JAX Engine's:

- the depth: 1, 2 and 3 chunks stay in flight after a tick, and the
  streams equal JAX's at that depth;
- the cached operands: a steady tick reuses the device table by identity,
  a free bumps the epoch, and a request crossing page boundaries keeps the
  device table equal to the host's after every tick;
- a preemption under a pool of 8 pages, a request cancelled with two
  chunks in flight, a two-turn session whose second turn reuses the first
  turn's rows, a request that ends exactly at ``max_len``, and a wave of
  four whose requests meet their eos in different chunks."""

import dataclasses

import jax
import numpy as np
import pytest

from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.serve import engine

KW = dict(n_slots=2, max_len=64, page_size=8, decode_chunk_len=4)


@pytest.fixture(scope="module")
def models():
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    return jcfg, jp, tcfg, from_jax_params(jax.device_get(jp), tcfg)


def _text(rng, n, max_new_tokens, **kw):
    return dict(input_ids=rng.integers(3, 512, n).astype(np.int32),
                max_new_tokens=max_new_tokens, **kw)


def _drive(eng, reqs, on_tick=None):
    """Submit ``reqs`` and tick until idle; returns the most chunks in
    flight after any tick. ``on_tick(eng)`` runs after each tick."""
    for r in reqs:
        eng.submit(r)
    peak = 0
    for _ in range(10000):
        n = eng.step()
        peak = max(peak, len(eng._inflight))
        if on_tick is not None:
            on_tick(eng)
        if n == 0 and eng.queue.empty() and not eng._pending:
            return peak
    raise AssertionError("the engine did not go idle")


def _both(models, req_kws, on_tick=None, **engine_kw):
    """The same requests through the JAX Engine and the port's, with the
    reasons each finished: (jax tokens, port tokens, jax reasons, port
    reasons, port peak in flight, jax engine, port engine)."""
    jcfg, jp, tcfg, tp = models
    out = []
    for mod, params, cfg in ((j_engine, jp, jcfg), (engine, tp, tcfg)):
        eng = mod.Engine(params, cfg, **engine_kw)
        why = [None] * len(req_kws)
        reqs = [mod.Request(on_finish=lambda toks, r, i=i: why.__setitem__(i, r),
                            **dict(dict(eos_id=-1), **kw))
                for i, kw in enumerate(req_kws)]
        peak = _drive(eng, reqs, on_tick if mod is engine else None)
        out.append(([r.tokens for r in reqs], why, peak, eng))
    (jt, jw, _, je), (tt, tw, peak, te) = out
    return jt, tt, jw, tw, peak, je, te


def _idle(eng):
    assert not eng._inflight and eng.active_count() == 0 and not eng._prefill_jobs
    assert eng.step() == 0
    cached = sum(len(c.pages) for c in eng._prefix_cache.values())
    assert eng.alloc.free_count + cached == eng.total_pages


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_decode_inflight_depth(models, depth, monkeypatch):
    """After each tick exactly ``depth`` chunks ride the stream at most,
    and the stream is JAX's at that depth (and the same at every depth).
    The 40 tokens take 10 chunks of 4 at every depth: no chunk is
    dispatched once the budget is in flight."""
    chunks = []
    real = engine.decode_chunk
    monkeypatch.setattr(engine, "decode_chunk",
                        lambda *a, **kw: chunks.append(1) or real(*a, **kw))
    rng = np.random.default_rng(0)
    jt, tt, _, tw, peak, je, te = _both(models, [_text(rng, 10, 40)], n_slots=2, max_len=128,
                                        page_size=8, decode_chunk_len=4, decode_ticks=1,
                                        decode_inflight=depth)
    assert te.decode_inflight == je.decode_inflight == depth
    assert tt == jt and len(tt[0]) == 40 and tw == ["length"]
    assert peak == depth and len(chunks) == 10
    _idle(te)


def test_decode_inflight_clamped_and_default(models):
    _, _, tcfg, tp = models
    assert engine.Engine(tp, tcfg, **KW).decode_inflight == 2
    assert engine.Engine(tp, tcfg, decode_inflight=0, **KW).decode_inflight == 1


def test_decode_tick_reuses_device_operands(models):
    """A steady tick reuses the cached operands by identity (the table,
    the slot index, the knobs) and advances pos on the device; freeing the
    slot bumps the epoch."""
    _, _, tcfg, tp = models
    eng = engine.Engine(tp, tcfg, n_slots=2, max_len=64, page_size=64, decode_chunk_len=4,
                        decode_ticks=1)
    req = engine.Request(input_ids=np.arange(2, 10, dtype=np.int32), max_new_tokens=30,
                         eos_id=-1)
    eng.submit(req)
    for _ in range(50):
        eng.step()
        if eng._dev_state is not None and eng.active_count() == 1:
            break
    assert eng._dev_state is not None
    state0 = eng._dev_state
    eng.step()
    state1 = eng._dev_state
    assert state1[0] == state0[0]
    for i in (1, 2, 4, 5, 6, 7):  # idx, table, active, temperature, top_k, top_p
        assert state1[i] is state0[i]
    assert state1[3] is not state0[3]
    assert int(state1[3][0]) == int(state0[3][0]) + 4 == eng.pos[0]
    epoch0 = eng._state_epoch
    eng.run_until_idle()
    assert len(req.tokens) == 30 and not eng._inflight
    assert eng._state_epoch > epoch0


def test_page_growth_refreshes_the_device_table(models):
    """A request crossing page boundaries at depth 2 (a prompt of 6 rows
    growing to 45, pages of 8): each growth bumps the epoch, so the device
    table equals the host's after every tick, and the stream is JAX's."""
    tables = []

    def check(eng):
        if eng._dev_state is not None and eng.active_count():
            key, idx, table = eng._dev_state[:3]
            if key[0] == eng._state_epoch:
                np.testing.assert_array_equal(table.numpy(), eng._table_np[idx.numpy()])
                if not tables or tables[-1] is not table:
                    tables.append(table)

    rng = np.random.default_rng(1)
    jt, tt, _, _, peak, _, te = _both(models, [_text(rng, 6, 40)], on_tick=check,
                                      decode_inflight=2, decode_ticks=1, **KW)
    assert tt == jt and len(tt[0]) == 40
    assert peak == 2 and len(tables) >= 4  # the first upload, then a growth a page
    _idle(te)


def test_preemption_at_depth_two(models):
    """A pool of 8 pages of 8 cannot hold both requests' growth: the newer
    one is preempted with chunks in flight, re-prefills from the tokens it
    emitted, and streams on; both streams equal JAX's and a large pool's."""
    rng = np.random.default_rng(3)
    reqs = [_text(rng, 10, 40), _text(rng, 12, 40)]
    jt, tt, _, tw, peak, je, te = _both(models, reqs, total_pages=8, decode_inflight=2, **KW)
    _, roomy, _, _, _, _, _ = _both(models, reqs, decode_inflight=2, **KW)
    assert tt == jt == roomy and all(len(x) == 40 for x in tt)
    assert tw == ["length", "length"]
    assert te.stats()["preemptions"] > 0 and je.stats()["preemptions"] > 0
    assert peak == 2
    _idle(te)
    assert te.alloc.free_count == 8


def test_preempted_request_back_in_its_slot_before_its_chunk_is_read(models):
    """Prompts of 16 and 5 rows, 24 new tokens each, a pool of 8 pages:
    the preempted request is admitted again into its own slot while a
    chunk dispatched before the preemption is still in flight. Its rows
    there are dropped, so the streams equal a large pool's and the JAX
    Engine's at depth 1 with the same pool. (The JAX Engine at depth 2
    streams those rows again after the re-prefill's first token,
    ROADMAP C5.)"""
    _, _, tcfg, tp = models
    rng = np.random.default_rng(8)
    reqs = [_text(rng, 16, 24), _text(rng, 5, 24)]
    back = []
    real = engine.Engine._finish_prefill

    def finish(eng, job):
        dropped = sum(r is None and s == job.slot for _, _, sl in eng._inflight for s, r in sl)
        back.append((job.req.tokens != [], dropped))
        real(eng, job)

    engine.Engine._finish_prefill = finish
    try:
        _, tt, _, tw, _, _, te = _both(models, reqs, total_pages=8, decode_inflight=2, **KW)
    finally:
        engine.Engine._finish_prefill = real
    _, roomy, _, _, _, _, _ = _both(models, reqs, decode_inflight=2, **KW)
    jt, _, _, _, _, je, _ = _both(models, reqs, total_pages=8, decode_inflight=1, **KW)
    assert tt == roomy == jt and all(len(x) == 24 for x in tt) and tw == ["length"] * 2
    assert any(resumed and n > 0 for resumed, n in back)
    assert te.stats()["preemptions"] > 0 and je.stats()["preemptions"] > 0
    _idle(te)


def test_cancel_with_two_chunks_in_flight(models):
    """cancel_all while two chunks are in flight: the request stops at the
    next token it would emit, the rest of its chunks are dropped, and after
    the drain every page is free. What it streamed is JAX's stream."""
    _, _, tcfg, tp = models
    rng = np.random.default_rng(4)
    kw = _text(rng, 9, 50)
    jt, _, _, _, _, _, _ = _both(models, [kw], decode_inflight=2, **KW)
    eng = engine.Engine(tp, tcfg, decode_inflight=2, decode_ticks=1, **KW)
    why = []
    req = eng.submit(engine.Request(eos_id=-1, on_finish=lambda toks, r: why.append(r), **kw))
    for _ in range(100):
        eng.step()
        if len(eng._inflight) == 2 and len(req.tokens) >= 4:
            break
    assert len(eng._inflight) == 2 and eng.active_count() == 1
    n = len(req.tokens)
    eng.cancel_all()
    eng.run_until_idle()
    assert why == ["cancelled"] and len(req.tokens) == n < 50
    assert req.tokens == jt[0][:n]
    _idle(eng)
    assert eng.stats()["free_pages"] == eng.stats()["total_pages"]


def test_session_reuse_at_depth_two(models):
    """Turn 1 ends with a chunk in flight whose rows land past the cached
    prefix; turn 2 reuses the prefix. The streams, the reused rows and the
    cached rows themselves equal the JAX Engine's."""
    jcfg, jp, tcfg, tp = models
    base = np.arange(3, 40, dtype=np.int32)
    out = []
    for mod, params, cfg in ((j_engine, jp, jcfg), (engine, tp, tcfg)):
        eng = mod.Engine(params, cfg, n_slots=2, max_len=128, page_size=8, decode_chunk_len=4,
                         prefill_chunk=16, prompt_buckets=(16, 32, 64, 128), decode_inflight=2)
        r1 = mod.Request(input_ids=base, max_new_tokens=10, eos_id=-1, session_key="s")
        _drive(eng, [r1])
        cached = eng._prefix_cache["s"]
        n = len(cached.ids)
        rows = [np.asarray(eng.cache[f"{x}_pages"])[:, :, cached.pages]
                for x in ("k", "v")]
        rows = [r.transpose(0, 2, 3, 1, 4).reshape(r.shape[0], -1, r.shape[1], r.shape[4])[:, :n]
                for r in rows]
        turn2 = np.concatenate([base, np.asarray(r1.tokens, np.int32), [5, 6, 7]]).astype(np.int32)
        r2 = mod.Request(input_ids=turn2, max_new_tokens=8, eos_id=-1, session_key="s")
        _drive(eng, [r2])
        out.append((r1.tokens, r2.tokens, eng._reused_prefix_rows, n, rows, eng))
    (j1, j2, jr, jn, jrows, _), (t1, t2, tr, tn, trows, te) = out
    assert (t1, t2) == (j1, j2) and len(t2) == 8
    assert tr == jr > 0 and tn == jn == len(base) + 9
    for got, want in zip(trows, jrows):
        np.testing.assert_allclose(got.astype(np.float32), np.asarray(want, np.float32),
                                   atol=1e-5, rtol=1e-5)
    _idle(te)


@pytest.mark.parametrize("depth", [2, 3])
def test_request_ending_at_max_len(models, depth):
    """prompt + max_new_tokens == max_len beside a request that decodes
    on: the first rides up to ``depth`` chunks of 4 rows past the table's
    width until its last chunk is read, whose writes drop; it ends on
    'length' with JAX's tokens, and so does the second."""
    rng = np.random.default_rng(5)
    reqs = [_text(rng, 24, 40), _text(rng, 5, 56)]
    jt, tt, jw, tw, _, _, te = _both(models, reqs, decode_inflight=depth, decode_ticks=1, **KW)
    assert tt == jt and [len(x) for x in tt] == [40, 56] and tw == jw == ["length"] * 2
    _idle(te)


def test_wave_of_four_finishing_on_eos_in_different_chunks(models):
    """Four requests at once whose eos ids are tokens of their own greedy
    streams at different chunks: each stops at its eos while the others'
    chunks stay in flight, as in the JAX Engine."""
    _, _, tcfg, tp = models
    rng = np.random.default_rng(6)
    reqs = [_text(rng, n, 24) for n in (7, 12, 5, 9)]
    probe = engine.Engine(tp, tcfg, decode_inflight=2, **dict(KW, n_slots=4))
    probe_reqs = [engine.Request(eos_id=-1, **kw) for kw in reqs]
    _drive(probe, probe_reqs)
    for kw, r, at in zip(reqs, probe_reqs, (2, 7, 13, 21)):
        kw["eos_id"] = r.tokens[at]
    jt, tt, jw, tw, peak, _, te = _both(models, reqs, decode_inflight=2,
                                        **dict(KW, n_slots=4))
    assert tt == jt and tw == jw
    ends = [len(t) for t, w in zip(tt, tw) if w == "eos"]
    assert len(ends) >= 3 and len({(n - 1) // 4 for n in ends}) == len(ends)
    assert all(t[-1] == kw["eos_id"] for t, w, kw in zip(tt, tw, reqs) if w == "eos")
    assert peak == 2
    _idle(te)
