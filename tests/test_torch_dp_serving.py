"""PyTorch port: the Engine over a serving mesh with 'data' and 'fsdp'
axes > 1 (A11d, serving over data/fsdp), on gloo ranks against the JAX
package's Engine and the port's unsharded Engine.

As the JAX package's Engine places its params by ``param_specs`` (fsdp
included) and gives its page pool no batch axis, each rank holds its
'fsdp' blocks of the LLM, every layer gathers its weights whole at its top
(without autograd), the embedding and the head are gathered where they
are used, and every rank of 'data' x 'fsdp' serves the whole batch. The
int8 and int4 decode copies are made one layer at a time from that
layer's experts gathered whole over 'fsdp'. Under (2,2,1,1), (1,2,1,2) (fsdp x model), (1,2,2,1) (fsdp x
expert) and (1,2,1,1,2) (fsdp x pipe): every rank's greedy tokens equal
the unsharded Engine's, exactly (float32 tiny model), for dense, gather,
gather_q and gather_q4 decode, gmm prefill and an image+audio request,
and JAX's Engine's over the same mesh on its 8-device CPU mesh (the
quantized modes: JAX's single-device Engine in Pallas interpret mode, what
the TPU kernels compute, since neither GSPMD nor shard_map takes an
interpret-mode Pallas call). Weights are drawn in the port from a seed and
handed to both packages (the trees are leaf for leaf the same).

One group of 4 ranks runs every case (the 2-rank meshes as two
replicas), in a thread while this process runs JAX's Engines."""

import concurrent.futures
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_fsdp_util as u
from torch_mesh_util import engine_tokens
from vita_tpu.models import vita as j_vita
from vita_tpu.parallel.mesh import make_mesh as j_make_mesh
from vita_tpu.serve import engine as j_engine
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.tokenization import audio_token_count

WORLD = 4
TEXT = [dict(input_ids=np.array([1, 50, 60, 70, 80, 90], np.int32), max_new_tokens=8),
        dict(input_ids=np.array([1, 21, 33, 47], np.int32), max_new_tokens=5)]


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


# name: (mesh, requests, Engine options)
CASES = {
    "dp2_fsdp2_dense": ((2, 2, 1, 1), "text", dict(decode_moe_mode="dense")),
    "dp2_fsdp2_gather": ((2, 2, 1, 1), "text", dict(decode_moe_mode="gather")),
    "fsdp2_tp2_gather_q": ((1, 2, 1, 2), "text", dict(decode_moe_mode="gather_q",
                                                      kv_int8=True)),
    "fsdp2_ep2_gather_q4": ((1, 2, 2, 1), "text", dict(decode_moe_mode="gather_q4")),
    "fsdp2_tp2_gmm": ((1, 2, 1, 2), "text", dict(prefill_moe_mode="gmm")),
    "fsdp2_pipe2": ((1, 2, 1, 1, 2), "text", dict(decode_moe_mode="gather")),
    "fsdp4_media": ((1, 4, 1, 1), "media", dict()),
}


QUANT = ("gather_q", "gather_q4")


def _to_jax(tree):
    """The port's params as the JAX package's pytree (a copy: handing the
    tensors to the ranks moves them to shared memory)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.array(np.array(tree.numpy(), copy=True))


@pytest.fixture(scope="module")
def setup():
    cfg = vita.VITAConfig.tiny()
    params = vita.init_params(cfg, torch.Generator().manual_seed(0))
    reqs = {"text": TEXT, "media": [_media_request(cfg)]}
    return cfg, params, reqs, _to_jax(params)


def _jax_tokens(jp, reqs, mesh, kw):
    """JAX's Engine over ``mesh`` (its single-device Engine in interpret
    mode for a quantized decode mode): each request's greedy tokens."""
    jcfg = j_vita.VITAConfig.tiny()
    quant = kw.get("decode_moe_mode") in QUANT
    jmesh = None if quant else j_make_mesh(shape=mesh, devices=jax.devices()[:math.prod(mesh)])
    with pltpu.force_tpu_interpret_mode() if quant else contextlib.nullcontext():
        eng = j_engine.Engine(jp, jcfg, mesh=jmesh, **kw)
        rs = [j_engine.Request(eos_id=-1, **r) for r in reqs]
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
    return [r.tokens for r in rs]


@pytest.fixture(scope="module")
def results(setup, tmp_path_factory):
    cfg, params, reqs, jp = setup
    cases = [(name, "engine_tokens", dict(mesh=mesh, params="@p", cfg="@cfg",
                                          requests=reqs[kind],
                                          engine_kw=dict(n_slots=2, max_len=256, **kw)))
             for name, (mesh, kind, kw) in CASES.items()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, u.run_cases, WORLD, cases, {"p": params, "cfg": cfg},
                            threads=1, timeout=600,
                            store_dir=str(tmp_path_factory.mktemp("dp_serving")))
        jax_out = {name: _jax_tokens(jp, reqs[kind], mesh, dict(n_slots=2, max_len=256, **kw))
                   for name, (mesh, kind, kw) in CASES.items()}
        return ranks.result(), jax_out


@pytest.mark.parametrize("name", list(CASES))
def test_engine_over_data_and_fsdp_matches_unsharded(results, setup, name):
    """Every rank's greedy tokens: JAX's Engine's over the same mesh and
    the port's unsharded Engine's."""
    cfg, params, reqs, _ = setup
    ranks, jax_out = results
    _, kind, kw = CASES[name]
    want = engine_tokens(None, params, cfg, reqs[kind], dict(n_slots=2, max_len=256, **kw))
    assert all(len(t) for t in want["tokens"])
    assert want["tokens"] == jax_out[name], name
    for r in ranks:
        got = r[name]
        assert got["tokens"] == jax_out[name], name
        assert (got["prefill"], got["decode"]) == (want["prefill"], want["decode"])
