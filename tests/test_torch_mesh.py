"""PyTorch port: the mesh (vita_tpu_torch.parallel.mesh, distributed,
launch) on gloo ranks, mirroring tests/test_mesh.py: the world size, the
default all-fsdp mesh and its shape checks, a sharded matmul, capacity MoE
with experts on the 'expert' axis against the unsharded dense path (and
JAX's), and the spec trees leaf for leaf against JAX's.

The ranks are spawned processes (FileStore rendezvous under tmp_path)
running tests/torch_mesh_util.py, which imports no jax; one group runs
every case of this file. Also: a rank whose Engine step raises ends every
rank's MeshEngineThread, and checkpoints (HF and native layouts) load as
each rank's shards (load_vita_checkpoint(..., mesh=)), served by the
Engine with sharded=True."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_util as u
from torch_port_util import close
from vita_tpu.models import mixtral as j_mix
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import mixtral, vita
from vita_tpu_torch.parallel import distributed
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.parallel.mesh import AXES, make_mesh

WORLD = 8
MOE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_mesh.py's capacity-vs-dense tolerance


@pytest.fixture(scope="module")
def moe_case():
    jcfg = j_mix.MixtralConfig.tiny(n_experts=4)
    jp = jax.device_get(j_mix.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = mixtral.MixtralConfig.tiny(n_experts=4)
    ids = np.array([[1, 5, 9, 2]] * 2, np.int32)
    return jcfg, jp, tcfg, from_jax_params(jp, tcfg), ids


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, moe_case):
    _, _, tcfg, tp, ids = moe_case
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((8, 16)).astype(np.float32), rng.standard_normal(
        (16, 32)).astype(np.float32)
    cap = dataclasses.replace(tcfg, moe_mode="capacity", moe_capacity_factor=float(tcfg.n_experts))
    # a model axis of 4 needs 4 kv heads
    cap8 = dataclasses.replace(cap, n_heads=8, n_kv_heads=4)
    p8 = mixtral.init_params(cap8, torch.Generator().manual_seed(1))
    cases = [
        ("default", "mesh_facts", dict(mesh=None)),
        ("serving", "mesh_facts", dict(mesh=(1, 1, 4, 2))),
        ("matmul", "sharded_matmul", dict(mesh=(1, 2, 2, 2), x="@x", w="@w")),
        ("bf16", "collectives", dict(mesh=(1, 1, 4, 2), dtype=torch.bfloat16)),
        ("f32", "collectives", dict(mesh=(1, 1, 4, 2), dtype=torch.float32)),
        ("capacity", "moe_forward", dict(mesh=(1, 1, 4, 2), params="@p", cfg="@cap", ids="@ids")),
        ("capacity_ep2", "moe_forward", dict(mesh=(1, 1, 2, 4), params="@p8", cfg="@cap8",
                                             ids="@ids")),
    ]
    shared = {"x": torch.as_tensor(x), "w": torch.as_tensor(w), "p": tp, "cap": cap,
              "p8": p8, "cap8": cap8, "ids": torch.as_tensor(ids)}
    out = run_ranks(u.run_cases, WORLD, cases, shared, threads=1, timeout=300,
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return out, x, w, p8, cap8


def test_world_size_and_default_mesh_all_fsdp(ranks):
    out, *_ = ranks
    for r, res in enumerate(out):
        facts = res["default"]
        assert facts["world"] == WORLD and facts["names"] == AXES
        assert facts["sizes"] == {a: WORLD if a == "fsdp" else 1 for a in AXES}
        assert facts["coords"]["fsdp"] == r
        # (1, 1, 4, 2): rank = 2 * expert + model, as JAX reshapes its devices
        assert res["serving"]["coords"]["expert"] == r // 2
        assert res["serving"]["coords"]["model"] == r % 2


def test_mesh_shape_validation():
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(shape=(3, 1, 1, 1))
    with pytest.raises(ValueError, match="4-6 axes"):
        make_mesh(shape=(2, 2, 2))
    with pytest.raises(ValueError, match="4-6 axes"):
        make_mesh(shape=(1,) * 7)


def test_sharded_matmul_runs(ranks):
    out, x, w, *_ = ranks
    for res in out:
        c = res["matmul"]["coords"]
        f, m = c["fsdp"], c["model"]
        want = x[f * 4:(f + 1) * 4] @ w[:, m * 16:(m + 1) * 16]
        np.testing.assert_allclose(res["matmul"]["block"], want, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(res["matmul"]["full"], x @ w, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_collectives_over_the_model_axis(ranks, dtype):
    """all_gather_cat joins the 'model' blocks in rank order along either
    dim (bf16 as raw bytes), all_reduce_sum adds them in float32 and
    keeps the dtype."""
    out, *_ = ranks
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for res in out:
        got = res[dtype]
        np.testing.assert_array_equal(got["last"], np.concatenate([x, x + 10], 1))
        np.testing.assert_array_equal(got["first"], np.concatenate([x, x + 10], 0))
        np.testing.assert_array_equal(got["sum"], 2 * x + 10)
        assert got["dtype"] == {"bf16": "torch.bfloat16", "f32": "torch.float32"}[dtype]


def test_expert_parallel_capacity_moe_on_mesh(ranks, moe_case):
    """Capacity MoE (capacity factor E: nothing drops) with the experts on
    the 'expert' axis and heads and vocabulary on 'model' equals the
    unsharded dense forward of the port and of JAX."""
    out, _, _, p8, cfg8 = ranks
    jcfg, jp, tcfg, tp, ids = moe_case
    with torch.no_grad():
        dense, _, _ = mixtral.forward(tp, tcfg, input_ids=torch.as_tensor(ids))
    jdense, _, _ = j_mix.forward(jp, jcfg, input_ids=jnp.asarray(ids))
    close(dense, np.asarray(jdense), **MOE_TOL)
    with torch.no_grad():
        dense8, _, _ = mixtral.forward(p8, dataclasses.replace(cfg8, moe_mode="dense"),
                                       input_ids=torch.as_tensor(ids))
    for res in out:
        close(res["capacity"], dense.numpy(), **MOE_TOL)
        close(res["capacity_ep2"], dense8.numpy(), **MOE_TOL)


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_param_specs_equal_jax(moe_case):
    jcfg, jp, tcfg, tp, _ = moe_case
    assert mixtral.param_specs(tcfg) == _tuples(j_mix.param_specs(jcfg))
    for bits in (8, 4):
        jq = jax.device_get(j_mix.quantize_moe_for_decode(jp, bits=bits))
        tq = mixtral.quantize_moe_for_decode(tp, bits=bits)
        want = jax.tree.map(tuple, j_mix.decode_param_specs(jcfg, jq),
                            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert mixtral.decode_param_specs(tcfg, tq) == want
        served = mixtral.serving_specs(tcfg, tq)["layers"]["moe"]
        assert all("model" not in spec for spec in served.values())


def test_initialize_follows_torchrun_env(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK"):
        distributed.initialize("gloo")
    monkeypatch.setenv("WORLD_SIZE", "1")
    distributed.initialize("gloo")  # one process: nothing to start
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("mpi")


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(u.fail_on_rank, 2, 1, threads=1, timeout=120, store_dir=str(tmp_path))


def test_mesh_engine_thread_ends_the_mesh_when_one_rank_raises(tmp_path):
    """A step that raises on rank 1 alone ends both ranks' loops (rank 0's
    collective fails once rank 1 closes its group) instead of leaving
    rank 0 waiting; rank 0's request finishes as 'error' and each rank
    calls its on_error."""
    cases = [("fail", "mesh_thread_fails", dict(mesh=(1, 1, 1, 2), bad=1))]
    out = run_ranks(u.run_cases, 2, cases, {}, threads=1, timeout=180,
                    store_dir=str(tmp_path))
    first, second = out[0]["fail"], out[1]["fail"]
    assert "rank 1 fails on purpose" in second["error"] and second["stopped"]
    assert first["error"] != "None" and first["stopped"] and not first["alive"]
    assert first["finished"] == ["error"]


# ---------------------------------------------------------------------------
# checkpoints read as each rank's shards (load_vita_checkpoint(..., mesh=))
# ---------------------------------------------------------------------------
CKPT_MESHES = {"model": (1, 1, 1, 2), "expert": (1, 1, 2, 1)}


@pytest.fixture(scope="module")
def loaded_shards(tmp_path_factory):
    from vita_tpu_torch import checkpoint
    from vita_tpu_torch.serve.engine import Engine, Request

    root = tmp_path_factory.mktemp("ckpt")
    cfg = vita.VITAConfig.tiny()
    params = vita.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    paths = {"hf": str(root / "hf"), "native": str(root / "native")}
    checkpoint.export_hf_vita_checkpoint(paths["hf"], cfg, params, dtype=torch.bfloat16)
    checkpoint.save_vita_checkpoint(paths["native"], cfg, params)
    rng = np.random.default_rng(5)
    requests = [dict(input_ids=rng.integers(3, cfg.llm.vocab_size, n).astype(np.int32),
                     max_new_tokens=6) for n in (9, 40)]
    cases = [(f"{layout} {name}", "checkpoint_shards", dict(mesh=shape, path=path))
             for layout, path in paths.items() for name, shape in CKPT_MESHES.items()]
    cases += [(f"{layout} engine", "checkpoint_engine_tokens",
               dict(mesh=CKPT_MESHES["expert"], path=path, requests=requests))
              for layout, path in paths.items()]
    out = run_ranks(u.run_cases, 2, cases, {}, threads=1, timeout=300,
                    store_dir=str(tmp_path_factory.mktemp("store")))
    want = {}
    for layout, path in paths.items():
        lcfg, full = checkpoint.load_vita_checkpoint(path, "cpu")
        eng = Engine(full, lcfg, n_slots=2, max_len=256, device="cpu")
        reqs = [Request(eos_id=-1, **r) for r in requests]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        want[layout] = [r.tokens for r in reqs]
    return out, want


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("layout", ["hf", "native"])
@pytest.mark.parametrize("mesh_name", sorted(CKPT_MESHES))
def test_checkpoint_loads_as_rank_shards(loaded_shards, layout, mesh_name):
    """Each rank's leaves from load_vita_checkpoint(..., mesh=) equal
    vita.shard_params of the whole checkpoint, bit for bit: the HF layout
    cuts per-layer tensors of the mapped safetensors before it stacks
    them, the native one reads its mapped state."""
    out, _ = loaded_shards
    for rank in out:
        got = rank[f"{layout} {mesh_name}"]
        want = dict(_leaf_items(got["want"]))
        have = dict(_leaf_items(got["shards"]))
        assert have.keys() == want.keys()
        for name, w in want.items():
            assert have[name].shape == w.shape and np.array_equal(have[name], w), name


def test_engine_serves_loaded_shards(loaded_shards):
    """Engine(..., sharded=True) over those shards (expert 2) streams the
    unsharded Engine's greedy tokens on the whole checkpoint."""
    out, want = loaded_shards
    for layout in ("hf", "native"):
        for rank in out:
            assert rank[f"{layout} engine"] == want[layout], layout
