"""PyTorch port: the duplex replicas (``--mesh EXPERT MODEL`` of
duplex_http and duplex_demo; parallel.distributed.serving_replicas,
serve.replicas) on 4 gloo ranks at ``--mesh 1 2``: replica 0 on ranks 0-1,
replica 1 on ranks 2-3, each a model-parallel mesh of 2, rank 0 driving
both through the DuplexController.

- A fixed script through the controller (``chip_smoke.duplex_script``,
  phase 12(c)'s): query A, a noise query rejected by '<2>', query B
  interrupting A. Under a decode that reads a response as noise when its
  first token is the noise query's first greedy token, on tiny-random
  weights: the same script on two unsharded port Engines, on two JAX
  Engines (the same weights) and on the replicas must reject the noise,
  swap the roles (generator 0 -> 1 -> 0) and cancel A on its replica; B's
  token ids equal its greedy stream, and A's and the noise query's are a
  prefix of theirs, in each of the three runs (the greedy streams of the
  two packages equal).
- duplex_http over the replicas: the page, /stats and the event stream
  of the synthetic session (utterances, streamed text, an interrupt, TTS).
  Neither package's duplex server has a /health route.
- A rank of replica 1 whose Engine raises ends every rank of both
  replicas and rank 0's server within the join timeout; rank 0's request
  finishes as 'error'.
- duplex_demo --simulate over the replicas: the demo's summary line on
  rank 0, nothing printed on the others.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh_util as u
from chip_smoke import duplex_script
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import duplex as j_duplex
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.serve import duplex, engine

AXES = (1, 2)
WORLD = 4
ENGINE_KW = dict(n_slots=2, max_len=512, decode_ticks=1, decode_chunk_len=4)
TOKENS = {"A": (10, 300), "N": (7, 8), "B": (13, 12)}  # (prompt length, new tokens)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jax.numpy.array(np.array(tree.numpy(), copy=True))


@pytest.fixture(scope="module")
def tiny():
    tcfg = vita.VITAConfig.tiny()
    tp = vita.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    return tcfg, tp, jcfg, _to_jax(tp)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return {n: np.concatenate([[1], rng.integers(3, 259, k - 1)]).astype(np.int32)
            for n, (k, _) in TOKENS.items()}


def _streams(make_engine, request_cls, prompts):
    """Each prompt's whole greedy stream, alone on a fresh Engine."""
    out = {}
    for name, ids in prompts.items():
        eng = make_engine()
        req = request_cls(input_ids=ids, max_new_tokens=TOKENS[name][1], eos_id=-1)
        eng.submit(req)
        eng.run_until_idle()
        out[name] = list(req.tokens)
    return out


@pytest.fixture(scope="module")
def streams(tiny, prompts):
    tcfg, tp, jcfg, jp = tiny
    port = _streams(lambda: engine.Engine(tp, tcfg, device="cpu", **ENGINE_KW), engine.Request,
                    prompts)
    jax_ = _streams(lambda: j_engine.Engine(jp, jcfg, **ENGINE_KW), j_engine.Request, prompts)
    noise = port["N"][0]
    assert noise not in (port["A"][0], port["B"][0]), "the script needs distinct first tokens"
    return port, jax_, noise


def _threaded_script(controller_cls, engines, thread_cls, prompts, noise):
    threads = [thread_cls(e, tick_idle_s=0.001) for e in engines]
    for th in threads:
        th.start()
    try:
        return duplex_script(engines, prompts, TOKENS, noise, timeout=120,
                             controller_cls=controller_cls)
    finally:
        for th in threads:
            th.stop()
        for th in threads:
            th.join(timeout=30)


@pytest.fixture(scope="module")
def runs(tiny, prompts, streams, tmp_path_factory):
    tcfg, tp, jcfg, jp = tiny
    noise = streams[2]
    mesh = run_ranks(u.duplex_replicas_script, WORLD, AXES, prompts, noise, TOKENS,
                     ENGINE_KW, threads=1, timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("store")))
    port = _threaded_script(duplex.DuplexController,
                            [engine.Engine(tp, tcfg, seed=i, device="cpu", **ENGINE_KW)
                             for i in range(2)], engine.EngineThread, prompts, noise)
    jax_ = _threaded_script(j_duplex.DuplexController,
                            [j_engine.Engine(jp, jcfg, seed=i, **ENGINE_KW) for i in range(2)],
                            j_engine.EngineThread, prompts, noise)
    return {"replicas": mesh[0], "port": port, "jax": jax_}, mesh


def test_greedy_streams_match_jax(streams):
    port, jax_, _ = streams
    assert port == jax_


@pytest.mark.parametrize("run", ["replicas", "port", "jax"])
def test_duplex_script(runs, streams, run):
    out = runs[0][run]
    want = streams[0]
    assert out["generator"] == [0, 1, 1, 0]  # A promoted on 1, N rejected, B swaps back
    assert (out["engine_A"], out["engine_N"], out["engine_B"]) == (1, 0, 0)
    assert out["rejected"] == 1 and out["interrupts"] == 1
    assert out["cancelled"] == {"A": True, "N": True, "B": False}
    assert out["B"] == want["B"]
    for name in ("A", "N"):
        assert out[name] and out[name] == want[name][:len(out[name])], name
    assert len(out["A"]) < TOKENS["A"][1]


def test_replicas_ranks_end_cleanly(runs):
    _, mesh = runs
    assert mesh[0]["errors"] == ["None", "None"]
    assert [r["replica"] for r in mesh[1:]] == [0, 1, 1]
    assert all(r["error"] == "None" for r in mesh[1:])
    # replica 1 (ranks 2-3) served A; replica 0 served N and B
    assert mesh[2]["completed"] == mesh[3]["completed"] == 1
    assert mesh[1]["completed"] == 2


@pytest.fixture(scope="module")
def http_runs(tmp_path_factory):
    ok = run_ranks(u.duplex_http_replicas, WORLD, AXES, threads=1, timeout=300,
                   store_dir=str(tmp_path_factory.mktemp("store")))
    failed = run_ranks(u.duplex_http_replicas, WORLD, AXES, 3, threads=1, timeout=300,
                       store_dir=str(tmp_path_factory.mktemp("store")))
    return ok, failed


def test_duplex_http_over_replicas(http_runs):
    ok, _ = http_runs
    first = ok[0]
    assert first["page"] and first["errors"] == ["None", "None"]
    assert first["stats"]["utterances"] == 2 and len(first["stats"]["engines"]) == 2
    assert {"vad", "utterance", "text", "interrupt", "tts"} <= set(first["kinds"])
    assert [r["rc"] for r in ok[1:]] == [0, 0, 0]


def test_failing_rank_ends_both_replicas_and_the_server(http_runs):
    _, failed = http_runs
    first = failed[0]
    assert first["server_ended"] and first["finished"] == ["error"]
    assert all(e != "None" for e in first["errors"]) and not any(first["alive"])
    assert [r["rc"] for r in failed[1:]] == [1, 1, 1]


def test_duplex_demo_simulate_over_replicas(tmp_path):
    argv = ["--simulate", "--device", "cpu", "--mesh", *map(str, AXES), "--settle-s", "1",
            "--no-tts"]
    out = run_ranks(u.duplex_demo_run, WORLD, argv, threads=1, timeout=300,
                    store_dir=str(tmp_path))
    assert [r["rc"] for r in out] == [0] * WORLD
    assert "[demo] done: 2 queries, 1 interrupt(s)" in out[0]["stdout"]
    assert "final generator: engine 0" in out[0]["stdout"]
    assert all(r["stdout"] == "" for r in out[1:])
