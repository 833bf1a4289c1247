"""PyTorch port: the duplex controller (serve/duplex.py) against the JAX
package's on the protocol cases of tests/test_serving.py, with scripted
engines: both controllers must produce identical event traces (streamed
text, TTS flushes, finished turns, cancellations, role and counters). Then
the port's controller over two real tiny port Engines driven by their
EngineThreads, and the duplex demo's synthetic session; and the launch
counters, which the two engine threads share, under thread contention."""

import dataclasses
import sys
import threading
import time

import jax
import numpy as np
import pytest

from vita_tpu.serve import duplex as j_duplex
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch import kernels
from vita_tpu_torch.cli import ByteTokenizer
from vita_tpu_torch.models import vita
from vita_tpu_torch.serve import duplex, engine


class FakeEngine:
    """Engine stand-in: scripted token streams per request."""

    def __init__(self):
        self.pending = []
        self.cancelled_all = 0

    def submit(self, req):
        self.pending.append(req)
        return req

    def cancel_all(self):
        self.cancelled_all += 1
        for r in self.pending:
            r.cancel()
        self.pending = []

    def feed(self, req, tokens, finish="eos"):
        for tok in tokens:
            if req.cancelled:
                break
            req.on_token(tok)
        if req.on_finish:
            req.on_finish(tokens, "cancelled" if req.cancelled else finish)


def byte_decode(ids):
    return bytes(t - 3 for t in ids if 3 <= t < 259).decode(errors="ignore")


def enc(s):
    return [b + 3 for b in s.encode()]


# each scenario: a list of steps, ("submit", name) sends a query to the
# controller's monitor, ("feed", name, text, finish) feeds a request's
# tokens from the engine it was submitted to
SCENARIOS = {
    "noise_rejection": [("submit", "a"), ("feed", "a", "<2>background chatter", "eos")],
    "interrupt_and_role_swap": [
        ("submit", "a"), ("feed", "a", "<1>Hello there. More text", "eos"),
        ("submit", "b"), ("feed", "b", "<1>New answer here. Done.", "eos")],
    "flushes_tail_tts": [("submit", "a"), ("feed", "a", "<3>no punctuation tail", "eos")],
    "short_sentence_merges_forward": [
        ("submit", "a"), ("feed", "a", "<1>Hi. The weather is lovely today. Bye.", "eos")],
    "second_query_same_monitor_survives": [
        ("submit", "a"), ("submit", "b"), ("feed", "a", "<1>First answer. Padding.", "eos"),
        ("feed", "b", "<1>Second answer. Padding.", "eos")],
    "partial_utf8_not_streamed": [
        ("submit", "a"), ("feed", "a", "<1>喂。很高兴见到你。", "eos")],
    "interrupt_mid_answer": [
        ("submit", "a"), ("feed", "a", "<1>Long answer, part one. Part", "length"),
        ("submit", "b"), ("feed", "b", "<2>noise", "eos"),
        ("submit", "c"), ("feed", "c", "<3>Text answer.", "eos")],
}


def _trace(dmod, emod, steps):
    """Run one scenario on one package's controller; returns its events
    and the controller."""
    events = []
    engines = [FakeEngine(), FakeEngine()]
    ctl = dmod.DuplexController(
        engines, byte_decode, on_text=lambda s: events.append(("text", s)),
        on_tts=lambda s: events.append(("tts", s)),
        on_turn=lambda r, text: events.append(("turn", reqs_by_id[r.request_id], text)))
    reqs, reqs_by_id = {}, {}
    for step in steps:
        if step[0] == "submit":
            r = ctl.new_request(np.array([1]), max_new_tokens=99)
            reqs[step[1]], reqs_by_id[r.request_id] = r, step[1]
            host = engines.index(ctl.monitor)
            ctl.submit_query(r)
            events.append(("submitted", step[1], host))
        else:
            _, name, text, finish = step
            r = reqs[name]
            engines[r._duplex_engine_idx].feed(r, enc(text), finish)
        events.append(("state", ctl.generator_idx, ctl.interrupts, ctl.rejected_noise,
                       tuple(sorted(n for n, r in reqs.items() if r.cancelled)),
                       tuple(e.cancelled_all for e in engines)))
    return events, ctl


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_duplex_protocol_matches_jax(name):
    steps = SCENARIOS[name]
    got, ctl = _trace(duplex, engine, steps)
    want, _ = _trace(j_duplex, j_engine, steps)
    assert got == want
    text = "".join(e[1] for e in got if e[0] == "text")
    tts = [e[1] for e in got if e[0] == "tts"]
    if name == "noise_rejection":
        assert ctl.rejected_noise == 1 and ctl.generator_idx == 0 and not text and not tts
    elif name == "interrupt_and_role_swap":
        assert ctl.generator_idx == 0 and ctl.interrupts == 1
        assert tts[0].strip() == "Hello there." and "New answer here. Done." in text
    elif name == "flushes_tail_tts":
        assert tts == ["no punctuation tail"]
    elif name == "short_sentence_merges_forward":
        assert "".join(tts).replace(" ", "").startswith("Hi.Theweather") and len(tts) >= 2
    elif name == "second_query_same_monitor_survives":
        assert ctl.generator_idx == 1 and "Second answer." in text
    elif name == "partial_utf8_not_streamed":
        assert "�" not in text and "�" not in "".join(tts) and "很高兴见到你。" in text


@pytest.fixture(scope="module")
def tiny_port():
    cfg = vita.VITAConfig.tiny()
    import torch

    return cfg, vita.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_duplex_threaded_on_two_port_engines(tiny_port):
    """Two tiny port Engines under their EngineThreads, queries submitted
    while answers stream (a shortened switch interval): every request
    reaches an end, role swaps happen, pages are conserved on both engines
    (cached session prefixes included), and each turn's streamed text only
    grows."""
    cfg, params = tiny_port
    engines = [engine.Engine(params, cfg, n_slots=2, max_len=128, seed=i, decode_chunk_len=4,
                             prompt_buckets=(32, 64), page_size=32, decode_ticks=1)
               for i in range(2)]
    streams, lock = {}, threading.Lock()
    # a decode that maps every id to a letter, so the gate always decides
    ctl = duplex.DuplexController(engines, lambda ids: "".join(chr(97 + t % 26) for t in ids))

    def on_text(chunk):
        with lock:
            cur = ctl.current
            if cur is not None:
                s = streams.setdefault(cur.request_id, [""])
                s.append(s[-1] + chunk)

    ctl.on_text = on_text
    threads = [engine.EngineThread(e, tick_idle_s=0.001) for e in engines]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    rng = np.random.default_rng(0)
    submitted = []
    try:
        for th in threads:
            th.start()
        for i in range(10):
            ids = np.concatenate([[1], rng.integers(32, 120, int(rng.integers(4, 24)))])
            req = ctl.new_request(ids.astype(np.int32), max_new_tokens=int(rng.integers(8, 30)),
                                  eos_id=-1, session_key=f"s{i % 3}")
            submitted.append(req)
            ctl.submit_query(req)
            time.sleep(float(rng.uniform(0.02, 0.2)))
        deadline = time.time() + 60
        while time.time() < deadline and not all(r.finish_time > 0 or r.cancelled
                                                 for r in submitted):
            time.sleep(0.05)
    finally:
        for th in threads:
            th.stop()
        for th in threads:
            th.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    for e in engines:
        e.cancel_all()
        e.run_until_idle()
    assert not [r.request_id for r in submitted if r.finish_time == 0 and not r.cancelled]
    assert ctl.interrupts >= 3
    for e in engines:
        assert e.active_count() == 0 and not e._prefill_jobs
        cached = sum(len(c.pages) for c in e._prefix_cache.values())
        assert e.alloc.free_count + cached == e.total_pages
    for sid, snaps in streams.items():
        assert all(b.startswith(a) for a, b in zip(snaps, snaps[1:])), sid


def test_duplex_demo_simulated_session_on_the_cpu(capsys):
    """python -m vita_tpu_torch.serve.duplex_demo --simulate --device cpu:
    the VAD segments two utterances (the noise between them is rejected),
    the second interrupts the first answer and the roles swap."""
    from vita_tpu_torch.serve import duplex_demo

    assert duplex_demo.main(["--simulate", "--device", "cpu", "--settle-s", "0.5",
                             "--no-tts", "--max-new-tokens", "12"]) == 0
    out = capsys.readouterr().out
    assert "[demo] done: 2 queries, 1 interrupt(s)" in out
    assert "final generator: engine 0" in out


def test_synth_session_matches_jax():
    from vita_tpu.serve import duplex_demo as j_demo
    from vita_tpu_torch.serve import duplex_demo

    got, want = duplex_demo.synth_session(), j_demo.synth_session()
    assert len(got) == len(want)
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_launch_counts_survive_thread_contention():
    """count_launch from eight threads with a short switch interval loses
    no update."""
    before = kernels.launches["paged_attention"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count_launch("paged_attention")
                                                    for _ in range(5000)])
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert kernels.launches["paged_attention"] - before == 40000
    kernels.launches["paged_attention"] = before
