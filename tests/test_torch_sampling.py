"""PyTorch port: sampled decoding held to the JAX package (ROADMAP C7, A15).

- C7: the filtered sampler ranks equal logits in token-id order, as
  ``jnp.argsort(-x)`` does (``vita_tpu/sampling.py:73-74``). On bf16 rows
  at VITA-8x7B's vocabulary of 51760 whose ties straddle the 40th place
  and the top-p 0.9 edge (``chip_smoke.sampler_rows``), no draw of the
  port's ``sample_tokens`` nor of JAX's falls outside the kept set of the
  JAX rule computed in float64 (``chip_smoke.kept_set``), and both
  packages' frequencies pass one chi-square bound against the exact
  renormalised distribution (``chip_smoke.chi_square_p``, p >=
  ``CHI2_P_FLOOR``). An unstable sort keeps other tokens of the tie.
- The Engine on ``VITAConfig.tiny()`` under phase 3's mixed sampled wave
  (``chip_smoke.SAMPLED_WAVE``): the greedy, top_k 1 and top_p 1e-6 rows
  equal the JAX Engine's greedy streams token for token, a second Engine
  of the same seed streams every request alike, and every sampled stream
  passes the teacher-forced nucleus check (``chip_smoke.nucleus_check``,
  which the smoke runs on the card).
- The serving mesh under expert 2 x model 2 and under pipe 4 with the
  vocabulary split over 'pipe' (4 gloo ranks, tests/torch_pipe_util.py):
  every rank streams the same sampled tokens, on a second Engine of the
  seed too, and the top_k 1 and top_p 1e-6 rows equal the JAX Engine's
  greedy streams on the same weights.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_pipe_util as u
from vita_tpu import sampling as j_sampling
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.serve import engine

N_PORT = 512  # the port's draws a case (the smoke takes 8192 on the card)
N_JAX = {"categorical": 1024, "filtered": 160}  # JAX's argsort of 51760 takes ~20 ms a row
ENGINE_KW = dict(n_slots=4, max_len=96, page_size=8, decode_chunk_len=4, seed=3)
EP2_TP2, PIPE4 = (1, 1, 2, 2), (1, 1, 1, 1, 4)


@pytest.fixture(scope="module")
def rows():
    return cs.sampler_rows()


def _jax_draws(row, case, n, seed=0):
    _, top_k, top_p, mode = case
    fn = jax.jit(j_sampling.sample_tokens, static_argnames=("mode",))
    logits = jnp.asarray(np.tile(row, (n, 1))).astype(jnp.bfloat16)
    tok = fn(logits, jax.random.PRNGKey(seed), jnp.full((n,), cs.SAMPLE_TEMP, jnp.float32),
             jnp.full((n,), top_k, jnp.int32), jnp.full((n,), top_p, jnp.float32), mode=mode)
    return np.bincount(np.asarray(tok), minlength=len(row))


@pytest.mark.parametrize("case", cs.SAMPLER_CASES, ids=lambda c: f"{c[0]}-k{c[1]}-p{c[2]}")
def test_draws_stay_in_the_jax_rules_kept_set(rows, case):
    """C7: at V 51760 on bf16 ties, neither package draws outside the JAX
    rule's kept set, and both pass the chi-square bound. The tie is real
    (the kept set or the top k ends inside it) and the top-p edge is not
    within float32 rounding of top_p."""
    x = np.float32(rows[case[0]]) / np.float32(cs.SAMPLE_TEMP)
    ids, _, margin = cs.kept_set(x, case[1], case[2])
    if case[3] == "filtered":
        order = np.argsort(-x, kind="stable")
        edges = [len(ids)] + ([case[1]] if case[1] > 0 else [])
        assert any(x[order[e - 1]] == x[order[e]] for e in edges), "no tie across the edge"
        assert margin > 1e-4
    port = cs.port_draws(rows, [case], torch.device("cpu"), N_PORT,
                         torch.Generator().manual_seed(0), per=128)[0]
    n_jax = N_JAX[case[3]]
    jx = _jax_draws(rows[case[0]], case, n_jax)
    for who, counts, n in (("port", port, N_PORT), ("jax", jx, n_jax)):
        outside, kept, stat, df, p = cs.check_draws(rows, case, counts, n)
        assert outside == 0, f"{who}: {outside} of {n} draws outside the {kept} kept tokens"
        assert p >= cs.CHI2_P_FLOOR, f"{who}: chi-square {stat:.1f} on {df} df, p {p:.3g}"


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    return jcfg, jp, tcfg, from_jax_params(jax.device_get(jp), tcfg)


def _wave(n_new=16, seed=5):
    rng = np.random.default_rng(seed)
    return [dict(input_ids=rng.integers(3, 512, int(rng.integers(5, 24))).astype(np.int32),
                 max_new_tokens=n_new, temperature=t, top_k=k, top_p=p)
            for t, k, p in cs.SAMPLED_WAVE]


def _serve(mod, params, cfg, reqs, **kw):
    eng = mod.Engine(params, cfg, **kw)
    out = [mod.Request(eos_id=-1, **r) for r in reqs]
    for r in out:
        eng.submit(r)
    eng.run_until_idle()
    return [r.tokens for r in out], eng


def test_engine_sampled_wave_matches_jax_greedy_and_stays_in_its_nucleus(tiny):
    jcfg, jp, tcfg, tp = tiny
    wave = _wave()
    greedy = [dict(r, temperature=0.0, top_k=0, top_p=1.0) for r in wave]
    want, _ = _serve(j_engine, jp, jcfg, greedy, **ENGINE_KW)
    got, eng = _serve(engine, tp, tcfg, wave, **ENGINE_KW)
    again, _ = _serve(engine, tp, tcfg, wave, **ENGINE_KW)
    assert got == again
    assert eng.alloc.free_count == eng.total_pages and not eng._inflight
    for i, (r, toks) in enumerate(zip(wave, got)):
        assert len(toks) == 16
        if r["temperature"] == 0.0 or r["top_k"] == 1 or r["top_p"] < 1e-3:
            assert toks == want[i], (i, r)
        else:
            cs.nucleus_check(tp, tcfg, r["input_ids"], toks, r["temperature"], r["top_k"],
                             r["top_p"])
    # the sampled rows did sample: not all of them follow the greedy stream
    assert any(got[i] != want[i] for i, r in enumerate(wave)
               if r["temperature"] > 0 and r["top_k"] != 1 and r["top_p"] > 1e-3)


def test_nucleus_check_catches_a_token_outside(tiny):
    """The check fails a stream whose token lies past the k-th place."""
    _, _, tcfg, tp = tiny
    r = _wave()[3]
    toks, _ = _serve(engine, tp, tcfg, [r], **ENGINE_KW)
    cs.nucleus_check(tp, tcfg, r["input_ids"], toks[0], r["temperature"], r["top_k"],
                     r["top_p"])
    ids = torch.as_tensor(np.concatenate([r["input_ids"], toks[0][:2]]).astype(np.int64))[None]
    from vita_tpu_torch.models import mixtral

    logits, _, _ = mixtral.forward(tp["llm"], tcfg.llm, input_ids=ids)
    bad = list(toks[0])
    bad[2] = int(torch.argsort(logits[0, -1], descending=True)[100])
    with pytest.raises(AssertionError, match="outside the nucleus"):
        cs.nucleus_check(tp, tcfg, r["input_ids"], bad, r["temperature"], r["top_k"],
                         r["top_p"])


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla",
                                                             n_layers=4))
    tcfg = vita.VITAConfig.tiny()
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, n_layers=4))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.device_get(jp), tcfg)
    reqs = [dict(r, max_new_tokens=10) for r in _wave()[2:]]
    kw = dict(n_slots=4, max_len=64, seed=11)
    cases = [(name, "engine_run", dict(mesh=m, params="@tp", cfg="@cfg", requests=reqs,
                                       engine_kw=kw, runs=2))
             for name, m in (("ep2tp2", EP2_TP2), ("pp4", PIPE4))]
    store = str(tmp_path_factory.mktemp("sampling_ranks"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, 4, cases, {"tp": tp, "cfg": tcfg},
                            threads=1, timeout=600, store_dir=store)
        greedy, _ = _serve(j_engine, jp, jcfg,
                           [dict(r, temperature=0.0, top_k=0, top_p=1.0) for r in reqs],
                           n_slots=4, max_len=64)
        return ranks.result(), reqs, greedy


@pytest.mark.parametrize("name", ["ep2tp2", "pp4"])
def test_mesh_ranks_draw_the_same_sampled_streams(mesh_results, name):
    """Every rank draws the same sampled streams, on a second Engine of
    the seed too, and the top_k 1 and top_p 1e-6 rows equal the JAX
    Engine's greedy streams on the same weights."""
    ranks, reqs, greedy = mesh_results
    first = ranks[0][name]["tokens"]
    assert first[0] == first[1]  # the seed's second Engine
    for r in ranks:
        assert r[name]["tokens"] == first
        assert r[name]["free"] == r[name]["total"]
    assert ranks[0]["pp4"]["vocab_split"] and ranks[0]["pp4"]["embed_rows"] == 512 // 4
    for i, r in enumerate(reqs):
        assert len(first[0][i]) == 10 and all(0 <= t < 512 for t in first[0][i])
        if r["top_k"] == 1 or r["top_p"] < 1e-3:
            assert first[0][i] == greedy[i], (name, i)
