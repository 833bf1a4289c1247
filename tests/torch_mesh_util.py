"""Rank functions for the mesh tests of the PyTorch port
(tests/test_torch_mesh.py, tests/test_torch_sharded_serving.py).

The tests start a group of gloo ranks with
``vita_tpu_torch.parallel.launch.run_ranks`` (FileStore rendezvous under
the test's tmp_path); each rank imports this module afresh, so it imports
neither jax nor the JAX package (tests/conftest.py imports jax). A rank
runs a list of cases, each one a function of this module called with the
rank's mesh, and returns {case name: result}.
"""

from __future__ import annotations

import contextlib
import io
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


def run_cases(rank: int, world: int, cases: Sequence[Tuple[str, str, Dict[str, Any]]],
              shared: Dict[str, Any]) -> Dict[str, Any]:
    """Each case (name, function of this module, kwargs) on this rank, in
    order (every rank runs every case, so collectives line up). A kwarg
    value ``"@key"`` is ``shared[key]``; ``mesh`` is a mesh shape, built
    here over the group."""
    from vita_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    out = {}
    for name, fn, kw in cases:
        kw = {k: shared[v[1:]] if isinstance(v, str) and v.startswith("@") else v
              for k, v in kw.items()}
        if "mesh" in kw:
            kw["mesh"] = make_mesh(kw["mesh"])
        out[name] = as_numpy(globals()[fn](**kw))
    return out


def coords(mesh) -> Dict[str, int]:
    from vita_tpu_torch.parallel.mesh import AXES, axis

    return {a: axis(mesh, a).rank for a in AXES}


# ---------------------------------------------------------------------------
# tests/test_torch_mesh.py
# ---------------------------------------------------------------------------
def mesh_facts(mesh) -> Dict[str, Any]:
    from vita_tpu_torch.parallel.mesh import AXES, axis

    return {"world": dist.get_world_size(), "names": tuple(mesh.mesh_dim_names),
            "sizes": {a: axis(mesh, a).size for a in AXES}, "coords": coords(mesh)}


def sharded_matmul(mesh, x, w) -> Dict[str, Any]:
    """Rows of x over fsdp, columns of w over model: this rank's block of
    x @ w, and the whole product gathered over both axes."""
    from vita_tpu_torch.parallel.mesh import FSDP, MODEL, all_gather_cat, local_shard

    xs, ws = local_shard(x, ("fsdp", None), mesh), local_shard(w, (None, "model"), mesh)
    block = xs @ ws
    full = all_gather_cat(all_gather_cat(block, mesh, MODEL, dim=1), mesh, FSDP, dim=0)
    return {"coords": coords(mesh), "block": block, "full": full}


def moe_forward(mesh, params, cfg, ids) -> torch.Tensor:
    """mixtral.forward's logits on this rank's shards of ``params``."""
    from vita_tpu_torch.models import mixtral

    local = mixtral.shard_params(params, cfg, mesh, "cpu")
    with torch.no_grad():
        logits, _, _ = mixtral.forward(local, cfg, input_ids=ids, mesh=mesh)
    return logits


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_serving.py
# ---------------------------------------------------------------------------
def _heads(x, dim, mesh):
    from vita_tpu_torch.parallel.mesh import local_shard

    spec = [None] * x.dim()
    spec[dim] = "model"
    return local_shard(x, spec, mesh).contiguous()


def op_paged_attention(mesh, q, k_pages, v_pages, table, lengths, layer,
                       k_scale=None, v_scale=None) -> Dict[str, Any]:
    from vita_tpu_torch.parallel.sharded_ops import sharded_paged_attention

    ks = None if k_scale is None else _heads(k_scale, 1, mesh)
    vs = None if v_scale is None else _heads(v_scale, 1, mesh)
    out = sharded_paged_attention(_heads(q, 1, mesh), _heads(k_pages, 1, mesh),
                                  _heads(v_pages, 1, mesh), table, lengths, layer, mesh=mesh,
                                  k_scale=ks, v_scale=vs)
    return {"coords": coords(mesh), "out": out}


def op_write_kv_rows(mesh, k_pages, v_pages, layer, table, pos, k, v, active,
                     k_scale=None, v_scale=None) -> Dict[str, Any]:
    from vita_tpu_torch.parallel.sharded_ops import sharded_write_kv_rows

    kp, vp = _heads(k_pages, 1, mesh), _heads(v_pages, 1, mesh)
    scales = [] if k_scale is None else [_heads(k_scale, 1, mesh), _heads(v_scale, 1, mesh)]
    out = sharded_write_kv_rows(kp, vp, layer, table, pos, _heads(k, 1, mesh),
                                _heads(v, 1, mesh), active, mesh, *scales)
    return {"coords": coords(mesh), "out": list(out)}


def op_flash_mha(mesh, q, k, v, kv_len, q_offset) -> Dict[str, Any]:
    from vita_tpu_torch.parallel.sharded_ops import sharded_flash_mha

    out = sharded_flash_mha(_heads(q, 2, mesh), _heads(k, 2, mesh), _heads(v, 2, mesh),
                            kv_len, q_offset, True, mesh=mesh)
    return {"coords": coords(mesh), "out": out}


def op_gather_ffn(mesh, x, topk_w, topk_idx, moe, layer_idx, n_experts, mode) -> torch.Tensor:
    from vita_tpu_torch.parallel.mesh import local_shard
    from vita_tpu_torch.parallel.sharded_ops import sharded_gather_ffn

    local = {k: local_shard(v, (None, "expert"), mesh).contiguous() for k, v in moe.items()}
    return sharded_gather_ffn(x, topk_w, topk_idx, local, layer_idx, n_experts, mode,
                              mesh=mesh)


def op_gmm_ffn(mesh, x, topk_w, topk_idx, moe, layer_idx, n_experts) -> torch.Tensor:
    from vita_tpu_torch.parallel.mesh import local_shard
    from vita_tpu_torch.parallel.sharded_ops import sharded_gmm_ffn

    local = {k: local_shard(v, (None, "expert"), mesh).contiguous() for k, v in moe.items()}
    return sharded_gmm_ffn(x, topk_w, topk_idx, local, layer_idx, n_experts, mesh=mesh)


def decode_chunk_tokens(mesh, params, cfg, b, page, pool, chunk_len) -> List[List[int]]:
    """sampling.decode_chunk (greedy) over this rank's shards and a pool
    of Hkv/model heads; the same arguments as the JAX test's."""
    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.ops.paged_attention import init_page_pool
    from vita_tpu_torch.parallel.mesh import MODEL, axis
    from vita_tpu_torch.sampling import decode_chunk

    local = (mixtral.shard_params(params, cfg, mesh, "cpu") if mesh is not None else params)
    hkv = cfg.n_kv_heads // axis(mesh, MODEL).size
    cache = init_page_pool(cfg.n_layers, hkv, pool, page, cfg.head_dim, dtype=cfg.dtype)
    cache["table"] = torch.arange(pool, dtype=torch.int32).reshape(b, pool // b)
    _, toks, _ = decode_chunk(
        local, cache, torch.tensor([1, 2], dtype=torch.int32),
        torch.tensor([3, 5], dtype=torch.int32), torch.ones(b, dtype=torch.bool),
        torch.zeros(b), torch.zeros(b, dtype=torch.int32), torch.ones(b),
        torch.Generator().manual_seed(0), llm_cfg=cfg, chunk_len=chunk_len,
        sampling_mode="greedy", mesh=mesh)
    return toks.tolist()


def engine_tokens(mesh, params, cfg, requests: List[Dict[str, Any]],
                  engine_kw: Dict[str, Any]) -> Dict[str, Any]:
    """The Engine over this rank's shards: each request's greedy tokens,
    and the prefill and decode MoE modes it chose."""
    from vita_tpu_torch.serve.engine import Engine, Request

    eng = Engine(params, cfg, mesh=mesh, device="cpu", **engine_kw)
    reqs = [Request(eos_id=-1, **r) for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"tokens": [r.tokens for r in reqs], "prefill": eng._prefill_cfg.moe_mode,
            "decode": eng._decode_cfg.moe_mode}


def cli_run(argv: List[str]) -> Dict[str, Any]:
    """vita_tpu_torch.cli.main(argv) in this rank (the process group is
    already up, so the CLI builds its mesh over it): exit code and stdout."""
    from vita_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return {"rc": rc, "stdout": buf.getvalue()}


def http_run(mesh, body: Dict[str, Any], slots: int = 2) -> Dict[str, Any]:
    """The HTTP server over a mesh: every rank builds the tiny model's
    Engine and a MeshEngineThread; rank 0 serves on 127.0.0.1 (an
    ephemeral port), posts ``body`` to /v1/generate and reads /stats, then
    stops the loop on every rank. Without a mesh: the one-device server
    (EngineThread)."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from vita_tpu_torch.serve.engine import Engine, MeshEngineThread
    from vita_tpu_torch.serve.http_server import ServingApp, load_model, make_handler

    cfg, params, encode, decode, bos_id, eos_id = load_model("tiny-random", torch.device("cpu"),
                                                             eos=False)
    engine = Engine(params, cfg, n_slots=slots, max_len=1024, mesh=mesh, device="cpu")
    runner = MeshEngineThread(engine) if mesh is not None else None
    if mesh is not None and dist.get_rank() != 0:
        runner.run()
        return {"steps": engine.stats()["completed"]}
    app = ServingApp(engine, cfg, encode, decode, bos_id, eos_id,
                     image_size=cfg.vision.image_size, thread=runner)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(base + "/v1/generate", data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            text = r.read().decode()
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        app.thread.stop()
        app.thread.join(timeout=60)
    return {"text": text, "stats": stats}


def mesh_thread_fails(mesh, bad: int) -> Dict[str, Any]:
    """A MeshEngineThread over the tiny model whose Engine raises on rank
    ``bad`` alone, at the first step that has a request: every rank's loop
    must end with an error rather than wait in a collective, and rank 0's
    request must finish as 'error'."""
    import threading

    import numpy as np

    from vita_tpu_torch.serve.engine import Engine, MeshEngineThread, Request
    from vita_tpu_torch.serve.http_server import load_model

    cfg, params, *_ = load_model("tiny-random", torch.device("cpu"), eos=False)
    engine = Engine(params, cfg, n_slots=2, max_len=256, mesh=mesh, device="cpu")
    if dist.get_rank() == bad:
        real_step = engine.step

        def step():
            if not engine.queue.empty():
                raise RuntimeError(f"rank {bad} fails on purpose")
            return real_step()

        engine.step = step
    stopped = threading.Event()
    runner = MeshEngineThread(engine, on_error=stopped.set)
    if dist.get_rank() != 0:
        runner.run()
        return {"error": repr(runner.error), "stopped": stopped.is_set()}
    finished = []
    runner.start()
    runner.submit(Request(input_ids=np.arange(3, 20, dtype=np.int32), max_new_tokens=4,
                          eos_id=-1, on_finish=lambda toks, reason: finished.append(reason)))
    runner.join(timeout=60)
    return {"error": repr(runner.error), "stopped": stopped.is_set(),
            "alive": runner.is_alive(), "finished": finished}


def checkpoint_shards(mesh, path: str) -> Dict[str, Any]:
    """``load_vita_checkpoint(path, cpu, mesh=)``, this rank's shards, and
    ``vita.shard_params`` of the whole checkpoint to compare them with."""
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.models import vita

    cfg, shards = load_vita_checkpoint(path, "cpu", mesh=mesh)
    _, full = load_vita_checkpoint(path, "cpu")
    return {"shards": shards, "want": vita.shard_params(full, cfg, mesh, torch.device("cpu"))}


def checkpoint_engine_tokens(mesh, path: str, requests: List[Dict[str, Any]]) -> List[List[int]]:
    """The Engine over the shards ``load_vita_checkpoint(..., mesh=)``
    reads (``sharded=True``): each request's greedy tokens."""
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.serve.engine import Engine, Request

    cfg, shards = load_vita_checkpoint(path, "cpu", mesh=mesh)
    eng = Engine(shards, cfg, n_slots=2, max_len=256, mesh=mesh, sharded=True, device="cpu")
    reqs = [Request(eos_id=-1, **r) for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.tokens for r in reqs]


def as_numpy(tree):
    """Tensors of a nested result as numpy arrays (for the comparisons)."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()
    return tree


def fail_on_rank(rank: int, world: int, bad: int) -> int:
    """Rank ``bad`` raises; the others wait at a barrier it never reaches."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def gpu_sharded_ops(rank: int, world: int, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """On cuda:0 (every rank shares it, over gloo): sharded_gather_ffn over
    this rank's experts of an expert axis of ``world``, then
    sharded_paged_attention over its heads of a model axis of ``world``;
    the outputs (float32, on the host) and each wrapper's kernel launches."""
    from vita_tpu_torch import kernels
    from vita_tpu_torch.parallel.mesh import local_shard, make_mesh
    from vita_tpu_torch.parallel.sharded_ops import sharded_gather_ffn, sharded_paged_attention

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    on = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in inputs.items()}
    out: Dict[str, Any] = {"rank": rank}
    ep_mesh = make_mesh((1, 1, world, 1))
    moe = {k: local_shard(on[k], (None, "expert"), ep_mesh).contiguous()
           for k in ("w_gate", "w_up", "w_down")}
    for t in (3, 8):
        before = dict(kernels.launches)
        y = sharded_gather_ffn(on[f"x{t}"], on[f"w{t}"], on[f"idx{t}"], moe, 1, on["n_experts"],
                               "gather", mesh=ep_mesh)
        torch.cuda.synchronize()
        out[f"ffn{t}"] = y.float().cpu()
        out[f"ffn{t}_launches"] = {k: kernels.launches[k] - before[k] for k in before}
    tp_mesh = make_mesh((1, 1, 1, world))
    heads = lambda x: local_shard(x, (None, "model"), tp_mesh).contiguous()  # noqa: E731
    before = dict(kernels.launches)
    o = sharded_paged_attention(heads(on["q"]), heads(on["k_pages"]), heads(on["v_pages"]),
                                on["table"], on["lengths"], 1, mesh=tp_mesh)
    torch.cuda.synchronize()
    out["paged"] = o.float().cpu()
    out["paged_launches"] = {k: kernels.launches[k] - before[k] for k in before}
    return as_numpy(out)


def collectives(mesh, dtype) -> Dict[str, Any]:
    """all_gather_cat along each dim and all_reduce_sum over 'model' of a
    block that depends on the rank's coordinate, in ``dtype``."""
    from vita_tpu_torch.parallel.mesh import MODEL, all_gather_cat, all_reduce_sum, axis

    m = axis(mesh, MODEL).rank
    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * m).to(dtype)
    return {"last": all_gather_cat(x, mesh, MODEL).float(),
            "first": all_gather_cat(x, mesh, MODEL, dim=0).float(),
            "sum": all_reduce_sum(x, mesh, MODEL).float(), "dtype": str(
                all_reduce_sum(x, mesh, MODEL).dtype)}


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------
def _seq_heads(x, mesh):
    """This rank's block of [B, S, H, d]: its seq block, its model heads."""
    from vita_tpu_torch.parallel.mesh import local_shard
    from vita_tpu_torch.parallel.ring_attention import shard_seq

    return local_shard(shard_seq(x, mesh), (None, None, "model", None), mesh).contiguous()


def ring_case(mesh, q, k, v, g, lengths, causal) -> Dict[str, Any]:
    """ring_flash_mha on this rank's block, and the gradients of
    sum(o * g) (``g`` the whole cotangent, cut like o) for its blocks of
    q, k and v; the merged lse too."""
    from vita_tpu_torch.parallel.ring_attention import ring_flash_mha_with_lse

    leaves = [_seq_heads(x, mesh).requires_grad_() for x in (q, k, v)]
    o, lse = ring_flash_mha_with_lse(*leaves, lengths, causal=causal, mesh=mesh)
    (o * _seq_heads(g, mesh)).sum().backward()
    return {"coords": coords(mesh), "out": o.detach(), "lse": lse,
            "dq": leaves[0].grad, "dk": leaves[1].grad, "dv": leaves[2].grad}


def ring_bad_shapes(mesh, q, k, v) -> List[str]:
    """The two ValueErrors: a sequence that does not divide over 'seq',
    and q rows that are not the k rows."""
    from vita_tpu_torch.parallel.ring_attention import ring_flash_mha, shard_seq

    msgs = []
    s = q.shape[1]
    try:
        shard_seq(q[:, : s - 2], mesh)
    except ValueError as e:
        msgs.append(str(e))
    try:
        ring_flash_mha(shard_seq(q[:, : s // 2], mesh), shard_seq(k, mesh), shard_seq(v, mesh),
                       torch.tensor([s, s]), mesh=mesh)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def seq_mixtral_case(mesh, params, cfg, ids, valid, mode) -> Dict[str, Any]:
    """mixtral.forward seq-parallel on this rank's block of ``ids``: the
    block's share of mean((logits * valid)^2), the aux loss, and the
    gradients of share + 0.02 aux (each rank adds aux whole)."""
    import dataclasses

    from vita_tpu_torch.models import mixtral
    from vita_tpu_torch.parallel.ring_attention import shard_seq

    cfg = dataclasses.replace(cfg, attn_backend="flash", moe_mode=mode)
    params = _fresh(params)  # this case's own leaves and gradients
    local = dict(_tree_leaves(params))
    b, s = ids.shape
    vb = shard_seq(valid, mesh)
    logits, _, aux = mixtral.forward(params, cfg, input_ids=shard_seq(ids, mesh),
                                     attn_valid=vb, mesh=mesh)
    m = vb.float()[:, :, None]
    share = ((logits.float() * m) ** 2).sum() / (b * s * logits.shape[-1])
    (share + 0.02 * aux).backward()
    return {"share": share.detach(), "aux": aux.detach(),
            "grads": {k: leaf.grad for k, leaf in local.items()}}


def _fresh(tree):
    """A copy of a parameter tree whose leaves require gradients."""
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def _tree_leaves(tree):
    """(name, leaf) of a nested dict, names joined with '/'."""
    from vita_tpu_torch.train.step import tree_leaves

    return (("/".join(path), leaf) for path, leaf in tree_leaves(tree))


# ---------------------------------------------------------------------------
# tests/test_torch_duplex_mesh.py
# ---------------------------------------------------------------------------
def _replica_engine(reps, engine_kw):
    from vita_tpu_torch.serve.engine import Engine
    from vita_tpu_torch.serve.http_server import load_model

    cfg, params, *_ = load_model("tiny-random", torch.device("cpu"), eos=False, mesh=reps.mesh)
    return Engine(params, cfg, seed=reps.index, mesh=reps.mesh, device="cpu", **engine_kw)


def duplex_replicas_script(rank: int, world: int, axes, prompts, noise_tok, tokens,
                           engine_kw) -> Dict[str, Any]:
    """Two duplex replicas of ``axes`` (expert, model) over the 4 ranks;
    rank 0 runs chip_smoke.duplex_script (the fixed script) through
    RemoteReplica and replica 0's loop, then stops both replicas."""
    from chip_smoke import duplex_script
    from vita_tpu_torch.parallel.distributed import serving_replicas
    from vita_tpu_torch.serve.replicas import replica_loop, start_replicas

    reps = serving_replicas(axes, "gloo")
    loop = replica_loop(reps, _replica_engine(reps, engine_kw))
    if rank != 0:
        loop.run()
        return {"replica": reps.index, "error": repr(loop.error),
                "completed": loop.engine.stats().get("completed", 0)}
    engines = start_replicas(reps, loop)
    try:
        out = duplex_script(engines, prompts, tokens, noise_tok, timeout=120)
    finally:
        for e in engines:
            e.stop()
        for e in engines:
            e.join(timeout=60)
    out["errors"] = [repr(e.error) for e in engines]
    out["stats"] = [e.stats() for e in engines]
    return out


def duplex_http_replicas(rank: int, world: int, axes, fail_rank=None) -> Dict[str, Any]:
    """duplex_http's --mesh path (serve_replicas, DuplexWebApp, the
    handler) on an ephemeral 127.0.0.1 port: rank 0 reads the page and
    /stats, posts the synthetic session's PCM and collects the event
    stream. With ``fail_rank``, that rank's Engine raises at its first step
    with a request: every rank must end, and rank 0's server with them."""
    import argparse
    import json
    import threading
    import time
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from vita_tpu_torch.serve import duplex_http
    from vita_tpu_torch.serve.duplex_demo import synth_session
    from vita_tpu_torch.serve.vad import CHUNK_SAMPLES

    args = argparse.Namespace(model="tiny-random", mesh=list(axes), dist_backend="gloo",
                              max_len=1024)
    if fail_rank is not None and rank == fail_rank:
        from vita_tpu_torch.serve import engine as engine_mod

        real_step = engine_mod.Engine.step

        def step(self):
            if not self.queue.empty():
                raise RuntimeError(f"rank {rank} fails on purpose")
            return real_step(self)

        engine_mod.Engine.step = step
    served = duplex_http.serve_replicas(args, torch.device("cpu"))
    if isinstance(served, int):
        return {"rc": served}
    (cfg, params, encode, decode, bos_id, eos_id), engines = served
    app = duplex_http.DuplexWebApp(params, cfg, encode, decode, bos_id, eos_id,
                                   max_new_tokens=24, tts=fail_rank is None,
                                   warm=fail_rank is None, engines=engines)
    server = ThreadingHTTPServer(("127.0.0.1", 0), duplex_http.make_handler(app))
    for e in engines:
        e.on_error = server.shutdown
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out: Dict[str, Any] = {"rc": 0}
    try:
        if fail_rank is not None:
            req = app.ctl.new_request(np.arange(3, 20, dtype=np.int32), max_new_tokens=4,
                                      eos_id=-1)
            finished = []
            req.on_finish = lambda toks, reason: finished.append(reason)
            engines[1].submit(req)
            serving.join(timeout=120)
            out.update(server_ended=not serving.is_alive(), finished=finished,
                       errors=[repr(e.error) for e in engines])
            for e in engines:
                e.join(timeout=60)
            out["alive"] = [e.is_alive() for e in engines]
            return out
        events, stop = [], threading.Event()

        def sse_reader():
            resp = urllib.request.urlopen(base + "/events", timeout=60)
            while not stop.is_set():
                line = resp.readline()
                if not line:
                    break
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))

        threading.Thread(target=sse_reader, daemon=True).start()
        out["page"] = "EventSource" in urllib.request.urlopen(base + "/", timeout=10).read().decode()
        pcm = (np.clip(np.concatenate(synth_session()), -1, 1) * 32767).astype("<i2")
        for i in range(0, len(pcm), CHUNK_SAMPLES):
            urllib.request.urlopen(urllib.request.Request(
                base + "/audio", data=pcm[i:i + CHUNK_SAMPLES].tobytes(), method="POST"),
                timeout=30)
            if app.n_utterances == 1:
                time.sleep(0.02)  # let the first answer stream before the second query
        assert app.drain_audio(timeout=120)
        t0 = time.time()
        while time.time() - t0 < 120:
            if app.n_utterances >= 2 and {"interrupt", "tts"} <= {e["type"] for e in events}:
                break
            time.sleep(0.1)
        out["stats"] = json.loads(urllib.request.urlopen(base + "/stats", timeout=30).read())
        stop.set()
        out["kinds"] = sorted({e["type"] for e in events})
    finally:
        server.shutdown()
        app.close()
    out["errors"] = [repr(e.error) for e in engines]
    return out


def duplex_demo_run(rank: int, world: int, argv: List[str]) -> Dict[str, Any]:
    """vita_tpu_torch.serve.duplex_demo.main(argv) on this rank (the process
    group is up, so ``--mesh`` builds its replicas over it): exit code and
    stdout."""
    from vita_tpu_torch.serve import duplex_demo

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = duplex_demo.main(argv)
    return {"rc": rc, "stdout": buf.getvalue()}
