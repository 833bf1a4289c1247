"""Rank functions for the pipeline-parallel tests of the PyTorch port
(tests/test_torch_pipeline.py, tests/test_torch_pp_engine.py).

As tests/torch_mesh_util.py: the tests start a group of gloo ranks with
``vita_tpu_torch.parallel.launch.run_ranks``; each rank imports this
module afresh (it imports neither jax nor the JAX package) and runs a
list of cases. A case's ``mesh`` is a mesh shape; one smaller than the
group is built once for each run of consecutive ranks it covers (every
rank builds them all, in order), so each such replica runs the case on
its own ranks and every rank returns its replica's result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from torch_mesh_util import _fresh, _tree_leaves, as_numpy, coords


def run_cases(rank: int, world: int, cases: Sequence[Tuple[str, str, Dict[str, Any]]],
              shared: Dict[str, Any]) -> Dict[str, Any]:
    """Each case (name, function of this module, kwargs) on this rank, in
    order. A kwarg value ``"@key"`` is ``shared[key]``; ``mesh`` is a
    mesh shape, built here over this rank's replica."""
    from vita_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    meshes = {}
    out = {}
    for name, fn, kw in cases:
        kw = {k: shared[v[1:]] if isinstance(v, str) and v.startswith("@") else v
              for k, v in kw.items()}
        if "mesh" in kw and kw["mesh"] is not None:
            shape = tuple(kw["mesh"])
            if shape not in meshes:
                per = math.prod(shape)
                built = [make_mesh(shape, ranks=range(i, i + per)) for i in range(0, world, per)]
                meshes[shape] = built[rank // per]
            kw["mesh"] = meshes[shape]
        out[name] = as_numpy(globals()[fn](**kw))
    return out


def _pipe(mesh) -> int:
    from vita_tpu_torch.parallel.mesh import PIPE, axis

    return axis(mesh, PIPE).rank


def _grads(tree):
    return {k: leaf.grad for k, leaf in _tree_leaves(tree) if leaf.grad is not None}


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------
def transform_case(mesh, w, x, scale, n_micro) -> Dict[str, Any]:
    """pipeline_layer_stack on a smooth body (tanh(x @ w) * scale, aux
    sum(x^2) a layer) over this stage's block of ``w``: the output, aux,
    the gradients of sum(out^2) for the block and for x, then those of aux
    alone."""
    from vita_tpu_torch.parallel.mesh import PIPE, axis
    from vita_tpu_torch.parallel.pipeline import pipeline_layer_stack, stage_reshape

    def body(lp, xm, c):
        return torch.tanh(xm @ lp) * c, (xm ** 2).sum()

    res = {"stage": _pipe(mesh)}
    n = axis(mesh, PIPE).size
    for key in ("", "aux_"):
        wl = stage_reshape(w, n)[res["stage"]].clone().requires_grad_()
        xx = x.clone().requires_grad_()
        out, aux = pipeline_layer_stack(mesh, body, wl, xx, scale, n, n_micro)
        (aux if key else (out ** 2).sum()).backward()
        res.update({key + "gw": wl.grad, key + "gx": xx.grad})
    res.update(out=out.detach(), aux=aux.detach())
    return res


def pp_forward_case(mesh, params, cfg, ids, stages, micro, remat=False,
                    objective="none") -> Dict[str, Any]:
    """mixtral.forward's GPipe path on this stage's shards (param_specs
    of the pipe config): logits, aux, and with ``objective`` 'nll' (next
    token NLL + 0.02 aux) or 'sq' (mean logits^2) the gradients of every
    leaf this rank holds."""
    from vita_tpu_torch.models import mixtral

    cp = dataclasses.replace(cfg, pipe_stages=stages, pipe_microbatches=micro, remat=remat)
    local = _fresh(mixtral.shard_params(params, cp, mesh, "cpu", specs=mixtral.param_specs(cp)))
    if objective == "none":
        with torch.no_grad():
            logits, _, aux = mixtral.forward(local, cp, input_ids=ids, mesh=mesh)
        return {"stage": _pipe(mesh), "logits": logits, "aux": aux}
    logits, _, aux = mixtral.forward(local, cp, input_ids=ids, mesh=mesh)
    if objective == "nll":
        labels = torch.roll(ids, -1, dims=1).long()
        logp = torch.log_softmax(logits.float(), -1)
        loss = -logp.gather(-1, labels[..., None]).mean() + 0.02 * aux
    else:
        loss = (logits.float() ** 2).mean()
    loss.backward()
    return {"stage": _pipe(mesh), "logits": logits.detach(), "aux": aux.detach(),
            "loss": loss.detach(), "grads": _grads(local)}


def pp_seq_case(mesh, params, cfg, ids) -> Dict[str, Any]:
    """Pipe x seq: the GPipe forward with the ring inside each stage on
    this rank's block of ``ids``: the block's logits, aux, and the
    gradients of its share of sum(logits^2) / (B S V)."""
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.ring_attention import shard_seq

    cp = dataclasses.replace(cfg, attn_backend="flash", pipe_stages=2, pipe_microbatches=2)
    local = _fresh(mixtral.shard_params(params, cp, mesh, "cpu", specs=mixtral.param_specs(cp)))
    b, s = ids.shape
    logits, _, aux = mixtral.forward(local, cp, input_ids=shard_seq(ids, mesh), mesh=mesh)
    share = (logits.float() ** 2).sum() / (b * s * logits.shape[-1])
    share.backward()
    return {"coords": coords(mesh), "logits": logits.detach(), "aux": aux.detach(),
            "grads": _grads(local)}


def pp_errors(mesh, params, cfg, ids) -> Dict[str, str]:
    """The message of each ValueError the pipe path raises."""
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.pipeline import (
        pipeline_decode_greedy,
        pipeline_layer_stack,
        stage_reshape,
    )

    out = {}

    def grab(name, fn):
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)

    cp = dataclasses.replace(cfg, pipe_stages=4)
    local = mixtral.shard_params(params, cp, mesh, "cpu", specs=mixtral.param_specs(cp))
    grab("no_mesh", lambda: mixtral.forward(params, cp, input_ids=ids))
    grab("stages", lambda: mixtral.forward(params, dataclasses.replace(cfg, pipe_stages=3),
                                           input_ids=ids, mesh=mesh))
    cache = mixtral.init_kv_cache(cfg, batch=ids.shape[0], max_len=32)
    grab("cache", lambda: mixtral.forward(local, cp, input_ids=ids, cache=cache, mesh=mesh))
    grab("gather", lambda: mixtral.forward(
        local, dataclasses.replace(cp, moe_mode="gather"), input_ids=ids, mesh=mesh))
    grab("gmm", lambda: mixtral.forward(local, dataclasses.replace(cp, moe_mode="gmm"),
                                        input_ids=ids, mesh=mesh))
    grab("unstacked", lambda: mixtral.forward(mixtral.unstack_layers(local), cp,
                                              input_ids=ids, mesh=mesh))
    grab("no_pipe_axis", lambda: pipeline_layer_stack(None, None, {}, ids, None, 4, 2))
    grab("batch", lambda: pipeline_layer_stack(mesh, None, local["layers"],
                                               torch.zeros(3, 2, 4), None, 4, 2))
    grab("reshape", lambda: stage_reshape(torch.zeros(6, 2), 4))
    kv = mixtral.init_pp_kv_cache(cfg, n_waves=2, batch=1, max_len=8, mesh=mesh)
    grab("waves", lambda: pipeline_decode_greedy(mesh, None, None, local["layers"], None,
                                                 kv["k"], kv["v"], torch.zeros(2, 1, 1, 4),
                                                 kv["pos"], 2))
    grab("engine_mesh", lambda: mixtral.forward(local, cfg, input_ids=ids, mesh=mesh))
    return out


def _wave_caches(params, cfg, prompts, max_len):
    """The unpipelined prefill of each wave (the whole model): the
    wave-major caches [L, W, B, T, Hkv, hd] and the first greedy tokens."""
    from vita_tpu_torch.models import mixtral

    ks, vs, first = [], [], []
    with torch.no_grad():
        for w in range(prompts.shape[0]):
            cache = mixtral.init_kv_cache(cfg, batch=prompts.shape[1], max_len=max_len)
            logits, cache, _ = mixtral.forward(params, cfg, input_ids=prompts[w], cache=cache)
            ks.append(cache["k"])
            vs.append(cache["v"])
            first.append(logits[:, -1].float().argmax(-1).to(torch.int32))
    return torch.stack(ks, 1), torch.stack(vs, 1), torch.stack(first)


def pp_decode_case(mesh, params, cfg, prompts, max_len, n_new) -> Dict[str, Any]:
    """pp_decode_greedy on this rank's shards from the unpipelined
    prefill's caches (this stage's layers), twice in a chain."""
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.mesh import local_shard

    k, v, first = _wave_caches(params, cfg, prompts, max_len)
    local = mixtral.shard_params(params, cfg, mesh, "cpu")
    specs = mixtral.pp_kv_cache_specs()
    cache = {"k": local_shard(k, specs["k"], mesh).clone(),
             "v": local_shard(v, specs["v"], mesh).clone(),
             "pos": torch.full(first.shape, prompts.shape[2], dtype=torch.int32)}
    toks1, cache = mixtral.pp_decode_greedy(local, cfg, mesh, cache, first, n_new)
    toks2, cache = mixtral.pp_decode_greedy(local, cfg, mesh, cache, toks1[:, -1], n_new)
    return {"first": first, "toks1": toks1, "toks2": toks2, "pos": cache["pos"],
            "vocab_rows": local["embed"].shape[0]}


def pp_generate_case(mesh, params, cfg, prompts, max_len, n_new) -> torch.Tensor:
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.mesh import PIPE, axis

    cp = dataclasses.replace(cfg, pipe_stages=axis(mesh, PIPE).size)
    local = mixtral.shard_params(params, cp, mesh, "cpu")
    return mixtral.pp_generate(local, cp, mesh, prompts, n_new, max_len)


def pp_train_step_case(mesh, params, cfg, batch) -> Dict[str, Any]:
    """One multimodal train step (train.step.make_train_step) with the
    LLM as a 2-stage GPipe: the loss, and the gradients of the towers'
    and projectors' leaves (replicated over 'pipe') and of the embedding."""
    from vita_tpu_torch.models import mixtral, vita
    from vita_tpu_torch.train.step import TrainConfig, loss_fn

    cp = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, pipe_stages=2,
                                                          pipe_microbatches=2))
    local = _fresh(vita.shard_params(params, cp, mesh, "cpu",
                                     llm_specs=mixtral.param_specs(cp.llm)))
    loss, _ = loss_fn(local, cp, batch, TrainConfig().aux_loss_coef, mesh)
    loss.backward()
    grads = _grads(local)
    keep = {k: g for k, g in grads.items()
            if not k.startswith("llm/layers") and not k.startswith("llm/lm_head")}
    return {"stage": _pipe(mesh), "loss": loss.detach(), "grads": keep}


# ---------------------------------------------------------------------------
# tests/test_torch_pp_engine.py
# ---------------------------------------------------------------------------
def engine_run(mesh, params, cfg, requests: List[Dict[str, Any]], engine_kw: Dict[str, Any],
               cancel_after: int = 0, runs: int = 1, count_gmm: bool = False) -> Dict[str, Any]:
    """The Engine over this rank's shards (``mesh`` None: unsharded):
    each request's tokens, the chosen MoE modes and slots, the pages free
    at the end; ``cancel_after`` > 0 cancels the first request once it
    streamed that many tokens; ``runs`` > 1 repeats on a fresh Engine;
    ``count_gmm`` counts the sharded grouped-matmul FFN's calls."""
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.serve.engine import Engine, Request

    calls = {"gmm": 0}
    real = mixtral.sharded_gmm_ffn
    if count_gmm:
        def counted(*a, **k):
            calls["gmm"] += 1
            return real(*a, **k)
        mixtral.sharded_gmm_ffn = counted
    out: Dict[str, Any] = {"tokens": []}
    try:
        for _ in range(runs):
            eng = Engine(params, cfg, mesh=mesh, device="cpu", **engine_kw)
            seen: List[int] = []
            reqs = [Request(eos_id=-1, **r) for r in requests]
            if cancel_after:
                reqs[0].on_token = seen.append
            for r in reqs:
                eng.submit(r)
            for _ in range(400):
                n = eng.step()
                if cancel_after and len(seen) >= cancel_after:
                    reqs[0].cancel()
                if n == 0 and eng.queue.empty() and not eng._pending:
                    break
            eng.run_until_idle()
            out["tokens"].append([r.tokens for r in reqs])
            out["seen"] = seen
    finally:
        mixtral.sharded_gmm_ffn = real
    llm = eng.params["llm"]
    out.update(prefill=eng._prefill_cfg.moe_mode, decode=eng._decode_cfg.moe_mode,
               n_slots=eng.n_slots, free=eng.alloc.free_count, total=eng.total_pages,
               vocab_split=eng._pp_vocab_split, embed_rows=llm["embed"].shape[0],
               head_cols=llm["lm_head"].shape[1], layers=llm["layers"]["ln_attn"].shape[0],
               pool_layers=eng.cache["k_pages"].shape[0], gmm_calls=calls["gmm"],
               reused=eng._reused_prefix_rows)
    return out


def engine_session(mesh, params, cfg, base, engine_kw) -> Dict[str, Any]:
    """Two turns of one session (the second extends the first with its
    answer and three ids) and the second turn on a fresh Engine."""
    from vita_tpu_torch.serve.engine import Engine, Request

    eng = Engine(params, cfg, mesh=mesh, device="cpu", **engine_kw)
    r1 = Request(input_ids=base, max_new_tokens=6, eos_id=-1, session_key="s")
    eng.submit(r1)
    eng.run_until_idle()
    turn2 = np.concatenate([base, np.asarray(r1.tokens, np.int32), np.array([3, 4, 5],
                                                                             np.int32)])
    r2 = Request(input_ids=turn2, max_new_tokens=6, eos_id=-1, session_key="s")
    eng.submit(r2)
    eng.run_until_idle()
    cold = Engine(params, cfg, mesh=mesh, device="cpu", **engine_kw)
    r3 = Request(input_ids=turn2, max_new_tokens=6, eos_id=-1)
    cold.submit(r3)
    cold.run_until_idle()
    return {"turn1": r1.tokens, "turn2": r2.tokens, "cold": r3.tokens,
            "reused": eng._reused_prefix_rows}


def engine_refuses(mesh, params, cfg) -> str:
    from vita_tpu_torch.serve.engine import Engine

    try:
        Engine(params, cfg, n_slots=2, max_len=64, mesh=mesh, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def cli_run(argv: List[str]) -> Dict[str, Any]:
    from vita_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return {"rc": rc, "stdout": buf.getvalue()}


def http_run(mesh, body: Dict[str, Any], slots: int = 2) -> Dict[str, Any]:
    from torch_mesh_util import http_run as run

    return run(mesh, body, slots)


def checkpoint_case(mesh, path: str, requests: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``load_vita_checkpoint(path, cpu, mesh=)`` under a pipe mesh, this
    rank's shards beside ``vita.shard_params`` of the whole checkpoint,
    and the Engine's tokens over the loaded shards."""
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.serve.engine import Engine, Request

    cfg, shards = load_vita_checkpoint(path, "cpu", mesh=mesh)
    _, full = load_vita_checkpoint(path, "cpu")
    want = vita.shard_params(full, cfg, mesh, torch.device("cpu"))
    eng = Engine(shards, cfg, n_slots=2, max_len=64, mesh=mesh, sharded=True, device="cpu")
    reqs = [Request(eos_id=-1, **r) for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"shards": shards, "want": want, "tokens": [r.tokens for r in reqs]}


def world_rank() -> int:
    return dist.get_rank()
