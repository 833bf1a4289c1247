"""PyTorch port: tensor- and expert-parallel serving on gloo ranks
(vita_tpu_torch.parallel.sharded_ops, mixtral/Engine under a mesh),
mirroring tests/test_sharded_serving.py on the mesh (1, 1, 4, 2).

- each sharded_ops wrapper on this rank's shards, at float32 tolerance
  F32_TOL: paged attention (bf16-style and int8 pools) and the gather FFN
  against JAX's wrappers on its 8-device CPU mesh; the kv row writes,
  flash attention, the quantized gather FFN and the gmm FFN against the
  JAX function that each of JAX's shard_map islands runs, on the rank's
  block (JAX's shard_map refuses a Pallas call in interpret mode, which
  flash and the quantized FFN need on the CPU, and the rest keeps the file
  near a minute);
- decode_chunk (gather, gather_q, gather_q4), the Engine (dense and gather
  decode, an image+audio request, the inherited sort/gmm training modes,
  gmm prefill against dense): the greedy token ids of every rank equal
  both the JAX sharded run and the port's unsharded run;
- ``cli.py --mesh 2 1`` and the HTTP server on 2 ranks.

The quantized paths of JAX run in Pallas interpret mode (what the TPU
kernels compute), as in the port's other tests, so JAX's quantized
decode_chunk is its single-device run. Weights are drawn in the port from
a seed and handed to both packages (the trees are leaf for leaf the
same). The ranks are spawned
processes (FileStore rendezvous under tmp_path) running
tests/torch_mesh_util.py, which imports no jax; one group of 8 ranks runs
every case of the mesh, in a thread while this process computes JAX's
side, and one group of 2 ranks runs the CLI and the HTTP server."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_util as u
from torch_port_util import F32_TOL, close, normal
from vita_tpu.models import mixtral as j_mix
from vita_tpu.models import vita as j_vita
from vita_tpu.ops import flash_attention as j_flash
from vita_tpu.ops import moe_decode as j_md
from vita_tpu.ops import moe_gmm as j_gmm
from vita_tpu.ops import paged_attention as j_pa
from vita_tpu.ops.paged_attention import init_page_pool as j_init_page_pool
from vita_tpu.parallel import sharded_ops as j_ops
from vita_tpu.parallel.mesh import make_mesh as j_make_mesh
from vita_tpu.sampling import decode_chunk as j_decode_chunk
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch.models import mixtral, vita
from vita_tpu_torch.ops import moe_decode
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.tokenization import audio_token_count

SHAPE = (1, 1, 4, 2)
WORLD = 8
QUANT = ("gather_q", "gather_q4")


# ---------------------------------------------------------------------------
# the inputs, made once with numpy
# ---------------------------------------------------------------------------
def _op_inputs():
    rng = np.random.default_rng(0)
    b, hq, hkv, d, L, n_pool, page = 2, 4, 2, 32, 2, 8, 8
    ops = {
        "q": normal(rng, b, hq, d), "k_pages": normal(rng, L, hkv, n_pool, page, d),
        "v_pages": normal(rng, L, hkv, n_pool, page, d),
        "table": np.arange(8, dtype=np.int32).reshape(2, 4),
        "lengths": np.array([5, 27], np.int32), "layer": 1,
        "k_pages_q": rng.integers(-127, 128, (L, hkv, n_pool, page, d)).astype(np.int8),
        "v_pages_q": rng.integers(-127, 128, (L, hkv, n_pool, page, d)).astype(np.int8),
        "k_scale": (rng.random((L, hkv, n_pool, 1, page)) * 0.02 + 1e-3).astype(np.float32),
        "v_scale": (rng.random((L, hkv, n_pool, 1, page)) * 0.02 + 1e-3).astype(np.float32),
        "pos": np.array([3, 20], np.int32), "k_new": normal(rng, b, hkv, d),
        "v_new": normal(rng, b, hkv, d), "active": np.array([True, True]),
        "fq": normal(rng, 1, 16, 4, 128), "fk": normal(rng, 1, 16, 2, 128),
        "fv": normal(rng, 1, 16, 2, 128), "kv_len": np.array([13], np.int32),
        "q_offset": np.array([0], np.int32),
    }
    e, dm, f = 8, 64, 128
    moe = {"w_gate": normal(rng, L, e, dm, f, scale=dm ** -0.5),
           "w_up": normal(rng, L, e, dm, f, scale=dm ** -0.5),
           "w_down": normal(rng, L, e, f, dm, scale=f ** -0.5)}
    ops["moe"] = moe
    routed = {k: torch.as_tensor(v) for k, v in moe.items()}
    routed["router"] = torch.zeros(L, dm, e)
    for key, quantize in (("moe_q", moe_decode.quantize_expert_weights),
                          ("moe_q4", moe_decode.quantize_expert_weights_int4)):
        ops[key] = {k: v.numpy() for k, v in quantize(routed).items() if k != "router"}
    for t in (3, 8, 16):
        idx = np.stack([rng.choice(e, 2, replace=False) for _ in range(t)]).astype(np.int32)
        w = rng.random((t, 2)).astype(np.float32) + 0.1
        ops[f"x{t}"], ops[f"idx{t}"] = normal(rng, t, dm), idx
        ops[f"w{t}"] = w / w.sum(1, keepdims=True)
    return ops


def _tt(x):
    return torch.as_tensor(np.asarray(x))


def _ffn_case(ops, mode, t):
    moe = ops[{"gather": "moe", "gather_q": "moe_q", "gather_q4": "moe_q4"}[mode]]
    return ops[f"x{t}"], ops[f"w{t}"], ops[f"idx{t}"], moe


GATHER_CASES = [(m, t) for m in ("gather",) + QUANT for t in (3, 8)]


def _op_cases(ops):
    tt = {k: _tt(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()
          if not k.startswith("moe")}
    moes = {k: {n: _tt(a) for n, a in ops[k].items()} for k in ("moe", "moe_q", "moe_q4")}
    base = dict(table=tt["table"], lengths=tt["lengths"], layer=1)
    cases = [
        ("paged", "op_paged_attention", dict(mesh=SHAPE, q=tt["q"], k_pages=tt["k_pages"],
                                             v_pages=tt["v_pages"], **base)),
        ("paged_q", "op_paged_attention", dict(mesh=SHAPE, q=tt["q"], k_pages=tt["k_pages_q"],
                                               v_pages=tt["v_pages_q"], k_scale=tt["k_scale"],
                                               v_scale=tt["v_scale"], **base)),
        ("write", "op_write_kv_rows", dict(mesh=SHAPE, k_pages=tt["k_pages"],
                                           v_pages=tt["v_pages"], layer=1, table=tt["table"],
                                           pos=tt["pos"], k=tt["k_new"], v=tt["v_new"],
                                           active=tt["active"])),
        ("write_q", "op_write_kv_rows", dict(mesh=SHAPE, k_pages=tt["k_pages_q"],
                                             v_pages=tt["v_pages_q"], layer=1,
                                             table=tt["table"], pos=tt["pos"], k=tt["k_new"],
                                             v=tt["v_new"], active=tt["active"],
                                             k_scale=tt["k_scale"], v_scale=tt["v_scale"])),
        ("flash", "op_flash_mha", dict(mesh=SHAPE, q=tt["fq"], k=tt["fk"], v=tt["fv"],
                                       kv_len=tt["kv_len"], q_offset=tt["q_offset"])),
        ("gmm", "op_gmm_ffn", dict(mesh=SHAPE, x=tt["x16"], topk_w=tt["w16"],
                                   topk_idx=tt["idx16"], moe=moes["moe"], layer_idx=1,
                                   n_experts=8)),
    ]
    for mode, t in GATHER_CASES:
        x, w, idx, _ = _ffn_case(ops, mode, t)
        moe = moes[{"gather": "moe", "gather_q": "moe_q", "gather_q4": "moe_q4"}[mode]]
        cases.append((f"{mode}{t}", "op_gather_ffn", dict(
            mesh=SHAPE, x=_tt(x), topk_w=_tt(w), topk_idx=_tt(idx), moe=moe, layer_idx=1,
            n_experts=8, mode=mode)))
    return cases


def _llm_cfgs(mode):
    jc = j_mix.MixtralConfig.tiny(n_experts=8, n_kv_heads=2, n_heads=4, moe_mode=mode)
    tc = mixtral.MixtralConfig.tiny(n_experts=8, n_kv_heads=2, n_heads=4, moe_mode=mode)
    return jc, tc


def _to_jax(tree):
    """The port's params as the JAX package's pytree (the same keys and
    layout)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    # a copy: handing the tensors to the ranks moves them to shared memory,
    # and a zero-copy JAX array would keep reading the old storage
    return jnp.array(np.array(tree.numpy(), copy=True))


@pytest.fixture(scope="module")
def llm_params():
    _, tc = _llm_cfgs("gather")
    tp = mixtral.init_params(tc, torch.Generator().manual_seed(0))
    out = {"gather": (_to_jax(tp), tp)}
    for mode, bits in (("gather_q", 8), ("gather_q4", 4)):
        tq = mixtral.quantize_moe_for_decode(tp, bits=bits)
        out[mode] = (_to_jax(tq), tq)
    return out


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    tcfg = vita.VITAConfig.tiny()
    tp = vita.init_params(tcfg, torch.Generator().manual_seed(0))
    return jcfg, _to_jax(tp), tcfg, tp


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


TEXT = [dict(input_ids=np.array([1, 50, 60, 70, 80, 90], np.int32), max_new_tokens=8)]
GMM_TEXT = [dict(input_ids=np.array([1, 50, 60, 70, 21, 33, 47], np.int32), max_new_tokens=6)]


def _engine_cases(tcfg):
    """name -> (port cfg, requests, Engine options)."""
    def with_mode(mode):
        return dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, moe_mode=mode))

    return {
        "engine_dense": (tcfg, TEXT, dict(n_slots=2, max_len=64, decode_moe_mode="dense")),
        "engine_gather": (tcfg, TEXT, dict(n_slots=2, max_len=64, decode_moe_mode="gather")),
        "engine_media": (tcfg, [_media_request(tcfg)], dict(n_slots=2, max_len=256)),
        "inherit_sort": (with_mode("sort"), TEXT,
                         dict(n_slots=1, max_len=64, decode_moe_mode="gather")),
        "inherit_gmm": (with_mode("gmm"), TEXT,
                        dict(n_slots=1, max_len=64, decode_moe_mode="gather")),
        "prefill_gmm": (tcfg, GMM_TEXT, dict(n_slots=1, max_len=64, prefill_moe_mode="gmm")),
        "prefill_dense": (tcfg, GMM_TEXT, dict(n_slots=1, max_len=64,
                                               prefill_moe_mode="dense")),
    }


@pytest.fixture(scope="module")
def ops():
    return _op_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ops, llm_params, tiny):
    """Every case of the mesh on 8 gloo ranks, run in a thread: the
    future's result is each rank's {case: result}."""
    _, _, tcfg, tp = tiny
    cases = _op_cases(ops)
    shared = {"tp": tp}
    for mode in ("gather",) + QUANT:
        _, tc = _llm_cfgs(mode)
        shared[f"llm_{mode}"], shared[f"cfg_{mode}"] = llm_params[mode][1], tc
        cases.append((f"chunk_{mode}", "decode_chunk_tokens", dict(
            mesh=SHAPE, params=f"@llm_{mode}", cfg=f"@cfg_{mode}", b=2, page=8, pool=16,
            chunk_len=4)))
    for name, (cfg, reqs, kw) in _engine_cases(tcfg).items():
        shared[f"cfg_{name}"] = cfg
        cases.append((name, "engine_tokens", dict(mesh=SHAPE, params="@tp",
                                                  cfg=f"@cfg_{name}", requests=reqs,
                                                  engine_kw=kw)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, u.run_cases, WORLD, cases, shared, threads=1, timeout=600,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(shape=SHAPE, devices=jax.devices()[:8])


def _head_block(x, axis_, m, n):
    size = x.shape[axis_] // n
    return np.take(np.asarray(x), range(m * size, (m + 1) * size), axis=axis_)


def _per_rank(ranks, name):
    return [r[name] for r in ranks.result()]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True])
def test_sharded_paged_attention_matches_jax(ranks, ops, jmesh, quant):
    """bf16-style pool: JAX's sharded_paged_attention on its mesh; int8
    pool (pages of 8: JAX's twin): JAX's paged attention over all heads,
    each rank's block of it."""
    kp, vp = (ops["k_pages_q"], ops["v_pages_q"]) if quant else (ops["k_pages"], ops["v_pages"])
    args = (jnp.asarray(ops["q"]), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ops["table"]),
            jnp.asarray(ops["lengths"]), jnp.int32(1))
    if quant:
        want = j_pa.paged_attention(*args, k_scale=jnp.asarray(ops["k_scale"]),
                                    v_scale=jnp.asarray(ops["v_scale"]))
    else:
        want = j_ops.sharded_paged_attention(*args, mesh=jmesh)
    for res in _per_rank(ranks, "paged_q" if quant else "paged"):
        close(res["out"], _head_block(want, 1, res["coords"]["model"], 2), **F32_TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_sharded_write_kv_rows_matches_jax(ranks, ops, quant):
    """Each rank's pool after the write equals its kv-head block of JAX's
    write_kv_rows over the whole pool (the island runs it per block)."""
    kp, vp = (ops["k_pages_q"], ops["v_pages_q"]) if quant else (ops["k_pages"], ops["v_pages"])
    kw = dict(k_scale=jnp.asarray(ops["k_scale"]), v_scale=jnp.asarray(ops["v_scale"])) \
        if quant else {}
    want = j_pa.write_kv_rows(
        jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1), jnp.asarray(ops["table"]),
        jnp.asarray(ops["pos"]), jnp.asarray(ops["k_new"]), jnp.asarray(ops["v_new"]),
        active=jnp.asarray(ops["active"]), **kw)
    for res in _per_rank(ranks, "write_q" if quant else "write"):
        assert len(res["out"]) == len(want)
        for got, w in zip(res["out"], want):
            w = _head_block(w, 1, res["coords"]["model"], 2)
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, w)
            else:
                close(got, w, **F32_TOL)


def test_sharded_flash_mha_matches_jax(ranks, ops):
    """Each rank's q-head block equals JAX's flash kernel (interpret mode)
    on that block's q heads and the kv heads they read."""
    want = {}
    for m in range(2):
        with pltpu.force_tpu_interpret_mode():
            want[m] = j_flash.flash_mha(
                *(jnp.asarray(_head_block(ops[k], 2, m, 2)) for k in ("fq", "fk", "fv")),
                kv_len=jnp.asarray(ops["kv_len"]), q_offset=jnp.asarray(ops["q_offset"]),
                causal=True)
    for res in _per_rank(ranks, "flash"):
        close(res["out"], want[res["coords"]["model"]], **F32_TOL)


@pytest.mark.parametrize("mode,t", GATHER_CASES)
def test_sharded_gather_ffn_matches_jax(ranks, ops, jmesh, mode, t):
    """bf16-style experts: JAX's sharded_gather_ffn on its mesh; int8/int4
    experts: JAX's selected-expert kernel over all experts in interpret
    mode (flat layer*E+e ids), the sum of what its islands add."""
    x, w, idx, moe = _ffn_case(ops, mode, t)
    args = (jnp.asarray(x), jnp.asarray(w))
    if mode == "gather":
        want = j_ops.sharded_gather_ffn(*args, jnp.asarray(idx),
                                        {k: jnp.asarray(v) for k, v in moe.items()}, 1, 8,
                                        mode, mesh=jmesh)
    else:
        flat = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:])) for k, v in moe.items()}
        fn = j_md.masked_expert_ffn_q4 if mode == "gather_q4" else j_md.masked_expert_ffn_q
        with pltpu.force_tpu_interpret_mode():
            want = fn(*args, jnp.asarray(idx + 8), flat, n_experts=8)
    for got in _per_rank(ranks, f"{mode}{t}"):
        close(got, want, **F32_TOL)


def test_sharded_gmm_ffn_matches_jax(ranks, ops):
    """The sum over expert ranks equals JAX's grouped-matmul FFN over all
    experts of the layer (each pair's term comes from one rank)."""
    layer = {k: jnp.asarray(v[1]) for k, v in ops["moe"].items()}
    want = j_gmm.moe_ffn_gmm(layer, jnp.asarray(ops["x16"]), jnp.asarray(ops["w16"]),
                             jnp.asarray(ops["idx16"]))
    for got in _per_rank(ranks, "gmm"):
        close(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# decode_chunk and the Engine
# ---------------------------------------------------------------------------
def _jax_cache(cfg, b, page, pool, mesh):
    pa = j_init_page_pool(cfg.n_layers, cfg.n_kv_heads, pool, page, cfg.head_dim, cfg.dtype)
    put = (lambda x: x) if mesh is None else (lambda x: jax.device_put(
        x, NamedSharding(mesh, P(None, "model", None, None, None))))
    return {"k_pages": put(pa["k_pages"]), "v_pages": put(pa["v_pages"]),
            "table": jnp.arange(pool, dtype=jnp.int32).reshape(b, pool // b),
            "pos": jnp.asarray([3, 5], jnp.int32)}


@pytest.mark.parametrize("moe_mode", ["gather", "gather_q", "gather_q4"])
def test_sharded_decode_chunk_matches(ranks, llm_params, jmesh, moe_mode):
    """Greedy decode_chunk: JAX's sharded run for bf16-style experts; for
    int8/int4 experts JAX's single-device run in interpret mode (its
    shard_map refuses interpret-mode kernels, and its CPU twins round the
    dequantized weights to bf16)."""
    jc, tc = _llm_cfgs(moe_mode)
    jp, tp = llm_params[moe_mode]
    b, page, pool = 2, 8, 16
    args = (jnp.asarray([1, 2], jnp.int32), jnp.asarray([3, 5], jnp.int32),
            jnp.ones(b, bool), jnp.zeros(b), jnp.zeros(b, jnp.int32),
            jnp.ones(b), jax.random.PRNGKey(0))
    if moe_mode in QUANT:
        with pltpu.force_tpu_interpret_mode():
            _, want, _, _ = j_decode_chunk(jp, _jax_cache(jc, b, page, pool, None), *args,
                                           llm_cfg=jc, chunk_len=4, sampling_mode="greedy")
    else:
        put = lambda x, s: jax.device_put(x, NamedSharding(jmesh, s))  # noqa: E731
        sp = jax.tree.map(put, jp, j_mix.decode_param_specs(jc, jp))
        _, want, _, _ = j_decode_chunk(sp, _jax_cache(jc, b, page, pool, jmesh), *args,
                                       llm_cfg=jc, chunk_len=4, sampling_mode="greedy",
                                       mesh=jmesh)
    want = np.asarray(want).tolist()
    assert u.decode_chunk_tokens(None, tp, tc, b, page, pool, 4) == want
    for got in _per_rank(ranks, f"chunk_{moe_mode}"):
        assert got == want


def _jax_engine_tokens(jcfg, jp, reqs, mesh, engine_kw, llm_mode=None):
    if llm_mode is not None:
        jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, moe_mode=llm_mode))
    eng = j_engine.Engine(jp, jcfg, mesh=mesh, **engine_kw)
    rs = [j_engine.Request(eos_id=-1, **r) for r in reqs]
    for r in rs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.tokens for r in rs], eng


def _check_engine(ranks, tiny, jmesh, name, llm_mode=None):
    jcfg, jp, tcfg, tp = tiny
    cfg, reqs, kw = _engine_cases(tcfg)[name]
    want, jeng = _jax_engine_tokens(jcfg, jp, reqs, jmesh, kw, llm_mode)
    unsharded = u.engine_tokens(None, tp, cfg, reqs, kw)
    assert unsharded["tokens"] == want
    for res in _per_rank(ranks, name):
        assert res["tokens"] == want
        assert (res["prefill"], res["decode"]) == (unsharded["prefill"], unsharded["decode"])
    return res, jeng


@pytest.mark.parametrize("decode_moe_mode", ["dense", "gather"])
def test_engine_with_mesh_matches(ranks, tiny, jmesh, decode_moe_mode):
    _check_engine(ranks, tiny, jmesh, f"engine_{decode_moe_mode}")


def test_engine_with_mesh_multimodal(ranks, tiny, jmesh):
    """Image+audio request: the towers whole on every rank, the LLM
    sharded."""
    _check_engine(ranks, tiny, jmesh, "engine_media")


@pytest.mark.parametrize("mode", ["sort", "gmm"])
def test_mesh_engine_inherited_training_modes(ranks, tiny, jmesh, mode):
    """A config carrying a training dispatch mode serves sharded with the
    same prefill dispatch: sort through the local experts and an
    all_reduce, gmm through sharded_gmm_ffn."""
    res, jeng = _check_engine(ranks, tiny, jmesh, f"inherit_{mode}", llm_mode=mode)
    assert res["prefill"] == jeng._prefill_llm_cfg.moe_mode == mode


def test_engine_with_mesh_gmm_prefill_matches_dense(ranks, tiny, jmesh):
    """Sharded gmm prefill (sharded_gmm_ffn) equals sharded dense prefill,
    the unsharded gmm Engine and JAX's sharded gmm Engine."""
    res, _ = _check_engine(ranks, tiny, jmesh, "prefill_gmm")
    for gmm, dense in zip(_per_rank(ranks, "prefill_gmm"), _per_rank(ranks, "prefill_dense")):
        assert gmm["tokens"] == dense["tokens"]
        assert (gmm["prefill"], dense["prefill"]) == ("gmm", "dense")


# ---------------------------------------------------------------------------
# the CLI and the HTTP server on 2 ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    argv = ["--model", "tiny-random", "--question", "Hello", "--device", "cpu",
            "--max-new-tokens", "6", "--mesh", "2", "1"]
    body = {"prompt": "Hello there", "max_tokens": 8}
    cases = [("cli", "cli_run", dict(argv=argv)),
             ("http", "http_run", dict(mesh=(1, 1, 1, 2), body=body))]
    out = run_ranks(u.run_cases, 2, cases, {}, threads=1, timeout=300,
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return out, argv, body


def test_cli_mesh_two_ranks(two_ranks, capsys):
    """``cli.py --mesh 2 1`` on 2 ranks: rank 0 prints what the unsharded
    Engine run prints (``--kv-int8``-free Engine path, tokens equal), rank
    1 prints nothing."""
    from vita_tpu_torch import cli

    out, argv, _ = two_ranks
    assert [r["cli"]["rc"] for r in out] == [0, 0]
    assert out[1]["cli"]["stdout"] == ""
    assert cli.main(argv[:-3] + ["--mesh", "1", "1"]) == 0
    want = capsys.readouterr().out
    assert not torch.distributed.is_initialized()

    def answer(text):  # the lines after the timings: token counts and text
        lines = text.splitlines()
        return [lines[i] for i in range(len(lines)) if not lines[i].startswith(("[load]",
                                                                               "[TTFT]"))]

    assert answer(out[0]["cli"]["stdout"]) == answer(want)
    assert "[new tokens] 6" in want


def test_http_server_mesh_two_ranks(two_ranks):
    """The HTTP server over a (1, 2) model mesh answers one /v1/generate
    request with the one-device server's text; /stats comes from rank 0,
    and rank 1 served the same request."""
    out, _, body = two_ranks
    want = u.http_run(None, body)
    assert out[0]["http"]["text"] == want["text"] and len(want["text"]) > 0
    assert out[0]["http"]["stats"]["completed"] == want["stats"]["completed"] == 1.0
    assert out[1]["http"]["steps"] == 1.0
