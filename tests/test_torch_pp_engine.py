"""PyTorch port: the pipeline-parallel serving Engine (a 'pipe' axis:
layers and the page pool split by stage, prefill chunks through the stage
chain, the S-wave decode ring of parallel.pp_serving) on gloo ranks,
mirroring tests/test_pp_engine.py on VITAConfig.tiny() with 4 LLM layers.

Every case's greedy streams equal the port's unsharded Engine's and the
JAX package's single-device Engine's (its quantized decode in Pallas
interpret mode, what the TPU kernels compute); pipe 2 (dense), pipe 4
with 4 requests, pipe 2 x model 2 (gather) and pipe 2 x expert 2
(gather) also equal JAX's pipe Engine on its 8-device CPU mesh:

- pipe 2 with dense, gather and gather_q decode; pipe 4 with 4 requests
  over its 4 waves; an image+audio request; session prefix reuse;
  decode_ticks 4 against 1; decode_inflight 2 (two chunks of the ring in
  flight after a tick); gmm prefill under pipe 2 and under pipe 2 x
  expert 2 (no dense fallback: the grouped-matmul route runs); pipe x
  model and pipe x expert (dense and gather); pipe 2 x model 2 x expert 2
  with int8 experts (8 ranks);
- the vocabulary split over ('pipe', 'model'): each rank holds V/(S*M)
  embedding rows and head columns; a vocabulary of 511 stays whole over
  'pipe' and streams the same tokens;
- n_slots 3 rounds up to 4; a layer stack that does not divide the axis
  raises JAX's ValueError;
- the filtered sampling tier: the same seed gives the same stream on
  every rank and on a second Engine; cancellation mid-decode frees every
  rank's pages;
- ``cli.py --mesh 1 1 2`` and the HTTP server on 2 ranks; the checkpoint
  shards ``load_vita_checkpoint(..., mesh=)`` reads under a pipe axis.

Groups of 4 ranks (the pipe-2 cases as two replicas), of 8 (the
three-axis mesh) and of 2 (the CLI and the server) run the cases, the
first in a thread while this process runs the JAX Engines."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_pipe_util as u
from vita_tpu.models import vita as j_vita
from vita_tpu.parallel.mesh import make_mesh as j_make_mesh
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch import checkpoint
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.tokenization import audio_token_count

PIPE2, PIPE4 = (1, 1, 1, 1, 2), (1, 1, 1, 1, 4)
PP_TP, PP_EP = (1, 1, 1, 2, 2), (1, 1, 2, 1, 2)
PP_TP_EP = (1, 1, 2, 2, 2)
PROMPT = np.array([1, 50, 60, 70, 80, 90], np.int32)
KW = dict(n_slots=2, max_len=64)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.array(np.array(tree.numpy(), copy=True))


def _tiny4(**llm):
    tcfg = vita.VITAConfig.tiny()
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, n_layers=4, **llm))
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, n_layers=4,
                                                             attn_backend="xla", **llm))
    return tcfg, jcfg


def _media_request(cfg):
    n_audio = audio_token_count(50)
    n_img = cfg.image_tokens_per_group
    ids = np.array([1, 7] + [0] * n_img + [9] + [0] * n_audio + [5], np.int32)
    im, am = np.zeros(len(ids), bool), np.zeros(len(ids), bool)
    im[2:2 + n_img] = True
    am[3 + n_img:3 + n_img + n_audio] = True
    rng = np.random.default_rng(0)
    sz = cfg.vision.image_size
    return dict(input_ids=ids, image_mask=im, audio_mask=am,
                images=rng.standard_normal((1, sz, sz, 3), np.float32),
                speech=rng.standard_normal((50, 80), np.float32), speech_length=50,
                max_new_tokens=6)


def _text(n_new, prompt=PROMPT, **kw):
    return dict(input_ids=prompt, max_new_tokens=n_new, **kw)


def _engine_cases(tcfg):
    """name -> (mesh, requests, Engine options, engine_run extras, JAX pipe
    mesh shape or None)."""
    multi = [_text(10, np.array([1, 10 + i, 60, 70 + i, 80], np.int32)) for i in range(4)]
    long = (np.arange(1, 41, dtype=np.int32) % 90 + 1).astype(np.int32)
    pair = [_text(8), _text(8, np.array([1, 11, 61, 71, 81], np.int32), temperature=0.9,
                            top_k=8, top_p=0.9)]
    sampled = [_text(8, temperature=0.8, top_k=8, top_p=0.9)]
    return {
        "pp2_dense": (PIPE2, [_text(12)], dict(KW, decode_moe_mode="dense"), {}, PIPE2),
        "pp2_gather": (PIPE2, [_text(12)], dict(KW, decode_moe_mode="gather"), {}, None),
        "pp2_gather_q": (PIPE2, [_text(8)], dict(KW, decode_moe_mode="gather_q"), {}, None),
        "pp4_multi": (PIPE4, multi, dict(n_slots=4, max_len=64), {}, PIPE4),
        "pp2_media": (PIPE2, [_media_request(tcfg)], dict(n_slots=2, max_len=256), {}, None),
        "pp2_ticks4": (PIPE2, [_text(24)], dict(KW, decode_ticks=4), {}, None),
        "pp2_ticks1": (PIPE2, [_text(24)], dict(KW, decode_ticks=1), {}, None),
        "pp2_gmm": (PIPE2, [_text(8, long)],
                    dict(n_slots=2, max_len=96, prefill_moe_mode="gmm", prefill_chunk=16),
                    dict(count_gmm=True), None),
        "pp2tp2_dense": (PP_TP, [_text(10)], dict(KW, decode_moe_mode="dense"), {}, None),
        "pp2tp2_gather": (PP_TP, [_text(10)], dict(KW, decode_moe_mode="gather"), {}, PP_TP),
        "pp2ep2_dense": (PP_EP, [_text(10)], dict(KW, decode_moe_mode="dense"), {}, None),
        "pp2ep2_gather": (PP_EP, [_text(10)], dict(KW, decode_moe_mode="gather"), {}, PP_EP),
        "pp2ep2_gmm": (PP_EP, [_text(8)], dict(KW, prefill_moe_mode="gmm"),
                       dict(count_gmm=True), None),
        "pp2tp2_pair": (PP_TP, pair, dict(KW, seed=3), dict(runs=2), None),
        "pp2_sampled": (PIPE2, sampled, dict(KW, seed=7), dict(runs=2), None),
        "pp2_slots3": (PIPE2, [_text(8)], dict(n_slots=3, max_len=64), {}, None),
        "pp2_cancel": (PIPE2, [_text(40)], KW, dict(cancel_after=5), None),
        "pp2_inflight2": (PIPE2, [_text(16)], dict(KW, decode_inflight=2, decode_ticks=1), {},
                          PIPE2),
    }


SESSION_KW = dict(n_slots=2, max_len=512, page_size=8, prefill_chunk=16,
                  prompt_buckets=(96, 256))
SESSION_BASE = np.concatenate([[1], np.arange(10, 90, dtype=np.int32)]).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    tcfg, jcfg = _tiny4()
    tp = vita.init_params(tcfg, torch.Generator().manual_seed(0))
    t511, j511 = _tiny4(vocab_size=511)
    tp511 = vita.init_params(t511, torch.Generator().manual_seed(1))
    return {"main": (tcfg, jcfg, tp, _to_jax(tp)), "v511": (t511, j511, tp511, _to_jax(tp511))}


def _jax_engine(jcfg, jp, reqs, mesh, kw, interpret=False):
    eng = j_engine.Engine(jp, jcfg, mesh=mesh, **kw)
    rs = [j_engine.Request(eos_id=-1, **r) for r in reqs]
    for r in rs:
        eng.submit(r)
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            eng.run_until_idle()
    else:
        eng.run_until_idle()
    return [r.tokens for r in rs]


def _jax_side(models, cases):
    tcfg, jcfg, _, jp = models["main"]
    out = {"single": {}, "pipe": {}}
    for name, (_, reqs, kw, extra, jmesh) in cases.items():
        if "seed" in kw or extra.get("cancel_after"):
            continue  # sampled and cancelled streams are compared between ranks
        quant = kw.get("decode_moe_mode") == "gather_q"
        out["single"][name] = _jax_engine(jcfg, jp, reqs, None, kw, interpret=quant)
        if jmesh is not None:
            mesh = j_make_mesh(shape=jmesh + (1,), devices=jax.devices()[:int(np.prod(jmesh))])
            out["pipe"][name] = _jax_engine(jcfg, jp, reqs, mesh, kw)
    t511, j511, _, jp511 = models["v511"]
    out["single"]["pp2_v511"] = _jax_engine(j511, jp511, [_text(8)], None, KW)
    out["single"]["pp_tp_ep_q"] = _jax_engine(jcfg, jp, [_text(8)], None,
                                              dict(KW, decode_moe_mode="gather_q"),
                                              interpret=True)
    return out


@pytest.fixture(scope="module")
def results(models, tmp_path_factory):
    tcfg, _, tp, _ = models["main"]
    t511, _, tp511, _ = models["v511"]
    bad = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, n_layers=3))
    cases = _engine_cases(tcfg)
    shared = {"tp": tp, "cfg": tcfg, "tp511": tp511, "cfg511": t511, "bad": bad,
              "tp_bad": vita.init_params(bad, torch.Generator().manual_seed(0))}
    runs = []
    for name, (mesh, reqs, kw, extra, _) in cases.items():
        for tag, m in ((name, mesh), (name + "/unsharded", None)):
            runs.append((tag, "engine_run", dict(mesh=m, params="@tp", cfg="@cfg",
                                                 requests=reqs, engine_kw=kw, **extra)))
    runs.append(("pp2_v511", "engine_run", dict(mesh=PIPE2, params="@tp511", cfg="@cfg511",
                                                requests=[_text(8)], engine_kw=KW)))
    runs.append(("pp2_v511/unsharded", "engine_run", dict(
        mesh=None, params="@tp511", cfg="@cfg511", requests=[_text(8)], engine_kw=KW)))
    runs.append(("pp2_session", "engine_session", dict(mesh=PIPE2, params="@tp", cfg="@cfg",
                                                       base=SESSION_BASE,
                                                       engine_kw=SESSION_KW)))
    runs.append(("refuse3", "engine_refuses", dict(mesh=PIPE2, params="@tp_bad",
                                                   cfg="@bad")))
    store = str(tmp_path_factory.mktemp("pp_ranks"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, 4, runs, shared, threads=1, timeout=600,
                            store_dir=store)
        jax_out = _jax_side(models, cases)
        return ranks.result(), jax_out


def _check(results, name, pipe=False):
    ranks, jx = results
    want = jx["single"][name]
    for r in ranks:
        got, ref = r[name], r[name + "/unsharded"]
        assert got["tokens"][0] == want and ref["tokens"][0] == want, name
        assert got["free"] == got["total"]
        assert (got["prefill"], got["decode"]) == (ref["prefill"], ref["decode"])
    if pipe:
        assert ranks[0][name]["tokens"][0] == jx["pipe"][name]
    return ranks


@pytest.mark.parametrize("decode_moe_mode", ["dense", "gather"])
def test_pp_engine_token_identical(results, decode_moe_mode):
    ranks = _check(results, f"pp2_{decode_moe_mode}", pipe=decode_moe_mode == "dense")
    assert len(ranks[0][f"pp2_{decode_moe_mode}"]["tokens"][0][0]) == 12
    assert ranks[0]["pp2_dense"]["layers"] == ranks[0]["pp2_dense"]["pool_layers"] == 2


def test_pp_engine_quantized_decode(results):
    """int8 experts (gather_q) under pipe 2: JAX's single-device Engine in
    interpret mode and the unsharded port."""
    _check(results, "pp2_gather_q")


def test_pp_engine_pipe4_multi_request(results):
    """4 requests fill the 4 waves (one slot each) of pipe 4."""
    ranks = _check(results, "pp4_multi", pipe=True)
    assert all(len(t) == 10 for t in ranks[0]["pp4_multi"]["tokens"][0])
    assert ranks[0]["pp4_multi"]["layers"] == 1


def test_pp_engine_sampling_tier_deterministic(results, models):
    """The filtered tier through the ring's sampler: one seed gives one
    stream, on every rank and on a second Engine."""
    ranks, _ = results
    first = ranks[0]["pp2_sampled"]["tokens"]
    assert first[0] == first[1] and len(first[0][0]) == 8
    assert all(0 <= t < models["main"][0].llm.vocab_size for t in first[0][0])
    assert all(r["pp2_sampled"]["tokens"] == first for r in ranks)


def test_pp_engine_streaming_and_cancel(results):
    """Streaming fires in order and a cancel mid-decode frees every rank's
    pages."""
    ranks, _ = results
    for r in ranks:
        got = r["pp2_cancel"]
        assert len(got["seen"]) >= 5
        assert got["seen"] == got["tokens"][0][0][:len(got["seen"])]
        assert len(got["tokens"][0][0]) < 40
        assert got["free"] == got["total"]


def test_pp_engine_media_request(results):
    """Image+audio prefill (towers whole on every rank) into the
    pipe-split scratch."""
    _check(results, "pp2_media")


def test_pp_engine_session_prefix_reuse(results, models):
    """Turn 2 prefills only the suffix from each stage's own pages and
    streams the cold Engine's tokens, the unsharded port's and JAX's."""
    ranks, _ = results
    tcfg, jcfg, _, jp = models["main"]
    j_eng = j_engine.Engine(jp, jcfg, **SESSION_KW)
    r1 = j_engine.Request(input_ids=SESSION_BASE, max_new_tokens=6, eos_id=-1,
                          session_key="s")
    j_eng.submit(r1)
    j_eng.run_until_idle()
    for r in ranks:
        got = r["pp2_session"]
        assert got["reused"] > 0
        assert got["turn2"] == got["cold"]
        assert got["turn1"] == r1.tokens
    turn2 = np.concatenate([SESSION_BASE, np.asarray(r1.tokens, np.int32),
                            np.array([3, 4, 5], np.int32)])
    r2 = j_engine.Request(input_ids=turn2, max_new_tokens=6, eos_id=-1, session_key="s")
    j_eng.submit(r2)
    j_eng.run_until_idle()
    assert ranks[0]["pp2_session"]["turn2"] == r2.tokens


def test_pp_engine_validations(results):
    ranks, _ = results
    for r in ranks:
        assert "3 layers not divisible by pipe axis 2" in r["refuse3"]


@pytest.mark.parametrize("decode_moe_mode", ["dense", "gather"])
def test_pp_tp_composed_token_identical(results, decode_moe_mode):
    """pipe 2 x model 2: the pool split by layer and by kv head."""
    _check(results, f"pp2tp2_{decode_moe_mode}", pipe=decode_moe_mode == "gather")


@pytest.mark.parametrize("decode_moe_mode", ["dense", "gather"])
def test_pp_ep_composed_token_identical(results, decode_moe_mode):
    """pipe 2 x expert 2: each stage's experts split over 'expert'; the
    ring's gather FFN through sharded_gather_ffn."""
    _check(results, f"pp2ep2_{decode_moe_mode}", pipe=decode_moe_mode == "gather")


def test_pp_gmm_prefill_token_identical(results):
    """gmm prefill (a 40-token prompt in chunks of 16) through
    sharded_gmm_ffn in each stage."""
    ranks = _check(results, "pp2_gmm")
    for r in ranks:
        assert r["pp2_gmm"]["prefill"] == "gmm" and r["pp2_gmm"]["gmm_calls"] > 0


def test_pp_gmm_prefill_composed_runs_gmm(results):
    """On pipe 2 x expert 2 gmm prefill stays gmm (JAX falls back to
    dense there without a word, ROADMAP section C): the grouped-matmul
    route runs in each stage and the tokens equal the unsharded gmm
    Engine's and JAX's (gmm is exact)."""
    ranks = _check(results, "pp2ep2_gmm")
    for r in ranks:
        assert r["pp2ep2_gmm"]["prefill"] == "gmm" and r["pp2ep2_gmm"]["gmm_calls"] > 0
        assert r["pp2ep2_gmm/unsharded"]["prefill"] == "gmm"


def test_pp_tp_composed_multi_request_sampling(results):
    """A greedy and a sampled request through pipe 2 x model 2: the
    greedy stream equals the single-device ones, the sampled one repeats
    with the seed and is the same on every rank."""
    ranks, jx = results
    unsharded = _engine_single(results, "pp2tp2_pair")
    for r in ranks:
        got = r["pp2tp2_pair"]["tokens"]
        assert got[0] == got[1]
        assert got[0][0] == unsharded
        assert got == ranks[0]["pp2tp2_pair"]["tokens"]
        assert len(got[0][1]) == 8


def _engine_single(results, name):
    ranks, _ = results
    return ranks[0][name + "/unsharded"]["tokens"][0][0]


def test_pp_multi_tick_chain_token_identical(results):
    """decode_ticks 4 (chained rounds of the ring before one readback)
    streams what ticks 1 streams."""
    ranks = _check(results, "pp2_ticks4")
    _check(results, "pp2_ticks1")
    for r in ranks:
        assert r["pp2_ticks4"]["tokens"] == r["pp2_ticks1"]["tokens"]
        assert len(r["pp2_ticks4"]["tokens"][0][0]) == 24


def test_pp_decode_inflight_two(results):
    """decode_inflight 2 under pipe 2: two chunks of the ring ride the
    stream after a tick, on every rank alike, and the streams equal JAX's
    single-device Engine at depth 2, its pipe Engine and the unsharded
    port."""
    ranks = _check(results, "pp2_inflight2", pipe=True)
    for r in ranks:
        got = r["pp2_inflight2"]
        assert got["inflight"] == r["pp2_inflight2/unsharded"]["inflight"] == 2
        assert len(got["tokens"][0][0]) == 16


def test_pp_vocab_split_head_sharding(results, models):
    """With a vocabulary that divides the ('pipe', 'model') blocks each
    rank holds V/(S*M) embedding rows and head columns."""
    ranks, _ = results
    v = models["main"][0].llm.vocab_size
    for r in ranks:
        for name, blocks in (("pp2_dense", 2), ("pp2tp2_gather", 4), ("pp2ep2_gather", 2)):
            got = r[name]
            assert got["vocab_split"]
            assert got["embed_rows"] == got["head_cols"] == v // blocks, name


def test_pp_vocab_indivisible_falls_back(results):
    """A vocabulary of 511 keeps the whole head on every stage and streams
    the single-device tokens."""
    ranks, jx = results
    for r in ranks:
        got = r["pp2_v511"]
        assert not got["vocab_split"] and got["embed_rows"] == 511
        assert got["tokens"][0] == jx["single"]["pp2_v511"]
        assert r["pp2_v511/unsharded"]["tokens"][0] == jx["single"]["pp2_v511"]


def test_pp_slots_round_up_to_wave_grid(results):
    ranks = _check(results, "pp2_slots3")
    for r in ranks:
        assert r["pp2_slots3"]["n_slots"] == 4 and r["pp2_slots3/unsharded"]["n_slots"] == 3


def test_pp_tp_ep_composed_quantized(models, results, tmp_path_factory):
    """pipe 2 x model 2 x expert 2 (8 ranks) with int8 experts."""
    _, jx = results
    tcfg, _, tp, _ = models["main"]
    runs = [("q", "engine_run", dict(mesh=PP_TP_EP, params="@tp", cfg="@cfg",
                                     requests=[_text(8)],
                                     engine_kw=dict(KW, decode_moe_mode="gather_q")))]
    out = run_ranks(u.run_cases, 8, runs, {"tp": tp, "cfg": tcfg}, threads=1, timeout=300,
                    store_dir=str(tmp_path_factory.mktemp("pp8")))
    for r in out:
        assert r["q"]["tokens"][0] == jx["single"]["pp_tp_ep_q"]
        assert r["q"]["layers"] == 2 and r["q"]["free"] == r["q"]["total"]


# ---------------------------------------------------------------------------
# the CLI, the HTTP server and checkpoints under a pipe axis
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, models):
    argv = ["--model", "tiny-random", "--question", "Hello", "--device", "cpu",
            "--max-new-tokens", "6", "--mesh", "1", "1", "2"]
    body = {"prompt": "Hello there", "max_tokens": 8}
    root = tmp_path_factory.mktemp("pp_ckpt")
    tcfg, _, tp, _ = models["main"]
    paths = {"hf": str(root / "hf"), "native": str(root / "native")}
    checkpoint.export_hf_vita_checkpoint(paths["hf"], tcfg, tp, dtype=torch.bfloat16)
    checkpoint.save_vita_checkpoint(paths["native"], tcfg, tp)
    requests = [_text(6), _text(6, np.arange(3, 30, dtype=np.int32))]
    cases = [("cli", "cli_run", dict(argv=argv)),
             ("http", "http_run", dict(mesh=PIPE2, body=body))]
    cases += [(f"ckpt_{k}", "checkpoint_case", dict(mesh=PIPE2, path=p, requests=requests))
              for k, p in paths.items()]
    out = run_ranks(u.run_cases, 2, cases, {}, threads=1, timeout=300,
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return out, argv, body, paths, requests


def test_cli_pipe_two_ranks(two_ranks, capsys):
    """``cli.py --mesh 1 1 2`` on 2 ranks: rank 0 prints the unsharded
    run's answer, rank 1 prints nothing."""
    from vita_tpu_torch import cli

    out, argv, _, _, _ = two_ranks
    assert [r["cli"]["rc"] for r in out] == [0, 0]
    assert out[1]["cli"]["stdout"] == ""
    assert cli.main(argv[:-4] + ["--mesh", "1", "1"]) == 0
    want = capsys.readouterr().out

    def answer(text):
        return [x for x in text.splitlines() if not x.startswith(("[load]", "[TTFT]"))]

    assert answer(out[0]["cli"]["stdout"]) == answer(want)
    assert "[new tokens] 6" in want


def test_http_server_pipe_two_ranks(two_ranks):
    """The HTTP server over a pipe-2 mesh answers as the one-device server;
    rank 1 served the same request."""
    out, _, body, _, _ = two_ranks
    want = u.http_run(None, body)
    assert out[0]["http"]["text"] == want["text"] and len(want["text"]) > 0
    assert out[0]["http"]["stats"]["completed"] == 1.0
    assert out[1]["http"]["steps"] == 1.0


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("layout", ["hf", "native"])
def test_checkpoint_shards_under_pipe(two_ranks, models, layout):
    """load_vita_checkpoint(..., mesh=) under pipe 2 gives each rank
    vita.shard_params of the whole checkpoint bit for bit: its stage's 2
    layers and its half of the vocabulary (rows of embed, columns of
    lm_head); the Engine over them streams the unsharded tokens."""
    out, _, _, paths, requests = two_ranks
    lcfg, full = checkpoint.load_vita_checkpoint(paths[layout], "cpu")
    eng_tokens = u.engine_run(None, full, lcfg, requests, dict(KW))["tokens"][0]
    v = lcfg.llm.vocab_size
    for r in out:
        got = r[f"ckpt_{layout}"]
        want, have = dict(_leaf_items(got["want"])), dict(_leaf_items(got["shards"]))
        assert have.keys() == want.keys()
        for name, w in want.items():
            assert have[name].shape == w.shape and np.array_equal(have[name], w), name
        assert have["llm/layers/ln_attn"].shape[0] == 2
        assert have["llm/embed"].shape[0] == v // 2 and have["llm/lm_head"].shape[1] == v // 2
        assert got["tokens"] == eng_tokens
