"""PyTorch port: VITA's three training stages against the JAX package on
``VITAConfig.tiny()``, same weights (convert.from_jax_params), same batches.

- Stage 1 (the vision projector alone trains) on batches whose loss
  reaches no trainable leaf: a text-only and an audio-only batch (Whale
  and the audio adapter are frozen there) beside an image+audio one. The
  JAX step takes a zero gradient and still updates (the count advances,
  the moments decay, weight decay applies); the port's step must do the
  same (ROADMAP C6: it raised in ``torch.autograd.grad``).
- The three-stage recipe of tests/test_stage_chaining.py: stage 1, its
  adapter-only checkpoint overlaid on a fresh base, stage 2, a full
  checkpoint, stage 3 from it, through each package's Trainer on one data
  mix of image, text-only and audio-only samples.
- Stage 1 over a training mesh on 2 gloo ranks, where only some ranks'
  share of the batch reaches the projector: under data 2 one rank's rows
  are text-only, under pipe 2 one microbatch is, and under seq 2 the
  image lies in the second sequence block only. Each rank must join every
  collective of the backward (a hang fails by the launcher's timeout) and
  its blocks must equal the unsharded step's.
- The Engine on inputs past the default buckets: 16 patch tiles (above
  the largest tile bucket, 13), a prompt longer than 4096 tokens at
  max_len 8192 (the appended prompt bucket), and the frameCat fusion (20
  tiles in 5-tuples, a projector over 5 x the tower's channels): greedy
  streams identical to the JAX Engine's.

Tolerances, float32, as tests/test_torch_train.py states them: the loss
1e-5 relative; parameters atol = rtol = 1e-4.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_fsdp_util as u
from test_torch_fsdp_train import _check_blocks, _mesh_cfg, _port_steps
from test_torch_train import PARAM_TOL, _at, _jax_steps, _stage, _torch_steps, media_batch
from torch_port_util import close, normal
from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu.train import step as j_step
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.parallel.launch import run_ranks
from vita_tpu_torch.serve import engine
from vita_tpu_torch.tokenization import AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX, audio_token_count
from vita_tpu_torch.train import step


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    jp = jax.device_get(jax.jit(j_vita.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, vita.VITAConfig.tiny()


def text_batch(cfg, seed, b=2, s=40):
    """Rows of text alone: no media keys at all, as the Collator gives a
    text batch."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.llm.vocab_size, (b, s)).astype(np.int32)
    valid = np.ones((b, s), bool)
    valid[-1, s - 5:] = False
    labels = np.where(valid, ids, -100).astype(np.int32)
    labels[:, :3] = -100
    return {"input_ids": ids, "labels": labels, "image_mask": np.zeros((b, s), bool),
            "audio_mask": np.zeros((b, s), bool), "attn_valid": valid}


def audio_batch(cfg, seed, b=2, s=40, frames=60):
    """Rows of one audio clip each and text: no image."""
    out = media_batch(cfg, seed, s, frames)
    out = {k: v for k, v in out.items() if k != "images"}
    out["image_mask"] = np.zeros_like(out["image_mask"])
    return out


def test_stage1_steps_over_text_and_audio_batches_match_jax(tiny):
    """C6: stage 1 over [text-only, image+audio, audio-only, text-only]:
    each step's loss and every leaf after the four updates against the
    JAX jitted steps; only the vision projector moves, on both sides."""
    jcfg, jp, tcfg = tiny
    jtc = _stage("stage1")
    tc = step.TrainConfig(**dataclasses.asdict(jtc))
    batches = [text_batch(tcfg, 0), media_batch(tcfg, 1), audio_batch(tcfg, 2),
               text_batch(tcfg, 3)]
    jout, jlosses = _jax_steps(jcfg, jp, jtc, batches)
    params, losses = _torch_steps(tcfg, from_jax_params(jp, tcfg), tc, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for path, w in step.tree_leaves(params):
        close(w.detach(), _at(jout, path), **PARAM_TOL)
        assert np.array_equal(_at(jout, path), _at(jp, path)) != w.requires_grad, path
    assert {p[0] for p, w in step.tree_leaves(params) if w.requires_grad} == {"vision_proj"}


def test_zero_gradient_step_keeps_the_update_rule(tiny):
    """A step whose loss reaches no trainable leaf decays the moments,
    advances the count and applies weight decay, as optax does."""
    _, jp, tcfg = tiny
    tc = dataclasses.replace(step.TrainConfig(**dataclasses.asdict(_stage("stage1"))),
                             weight_decay=0.5)
    params = from_jax_params(jp, tcfg)
    opt = step.make_optimizer(tc, params)
    state = opt.init(params)
    fn = step.make_train_step(tcfg, tc, opt)
    fn(params, state, media_batch(tcfg, 1))
    before = {k: v.clone() for k, v in state["mu"].items()}
    w0 = params["vision_proj"]["fc1_w"].detach().clone()
    _, state, m = fn(params, state, text_batch(tcfg, 0))
    assert state["count"] == 2 and np.isfinite(float(m["loss"]))
    for k, v in state["mu"].items():
        close(v, before[k] * tc.b1, atol=1e-12, rtol=1e-6)
    assert not np.array_equal(params["vision_proj"]["fc1_w"].detach().numpy(), w0.numpy())


# --------------------------------------------------------------------------
# the three-stage recipe through both Trainers
# --------------------------------------------------------------------------
def _recipe_data(cfg):
    """Four image samples, two audio-only and two text-only ones, without
    the dummy media a multimodal ConversationDataset adds (as
    DataArgs(is_multimodal=False) gives them), so that the audio and text
    batches reach no trainable leaf in stage 1; the image samples are the
    longest, so that modality grouping pairs them and the two audio
    samples share a batch."""
    rng = np.random.default_rng(7)
    sz, n_img, frames = cfg.vision.image_size, cfg.image_tokens_per_group, 60
    n_aud = audio_token_count(frames)
    out = []
    for i in range(4):
        ids = np.concatenate([[1], [IMAGE_TOKEN_INDEX] * n_img,
                              rng.integers(3, 512, 12 + i)]).astype(np.int64)
        labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids)
        labels[:4] = -100
        out.append({"input_ids": ids, "labels": labels, "modality": "image",
                    "images": normal(rng, 1, sz, sz, 3)})
    for i in range(2):
        ids = np.concatenate([[1], [AUDIO_TOKEN_INDEX] * n_aud,
                              rng.integers(3, 512, 6 + i)]).astype(np.int64)
        labels = np.where(ids == AUDIO_TOKEN_INDEX, -100, ids)
        labels[:2] = -100
        out.append({"input_ids": ids, "labels": labels, "modality": "audio",
                    "audio": normal(rng, frames, 80)})
    for i in range(2):
        ids = np.concatenate([[1], rng.integers(3, 512, 14 + i)]).astype(np.int64)
        labels = ids.copy()
        labels[:3] = -100
        out.append({"input_ids": ids, "labels": labels, "modality": "text"})
    return out


class _DS:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def modality_lengths(self):
        return [len(s["input_ids"]) * (-1 if s["modality"] == "text" else 1)
                for s in self.samples]


def _recipe_tcs(mod):
    return [dataclasses.replace(f(), warmup_steps=1, total_steps=4) for f in (
        mod.TrainConfig.stage1_pretrain_mlp, mod.TrainConfig.stage2_finetune,
        mod.TrainConfig.stage3_task)]


def _jax_recipe(tmp, jcfg, jp, data):
    """The recipe on the JAX package: (each stage's losses, params after
    each stage)."""
    from vita_tpu.checkpoint import (load_adapter_into, load_vita_checkpoint,
                                     save_vita_checkpoint, wait_for_checkpoints)
    from vita_tpu.data.dataset import Collator
    from vita_tpu.train.trainer import RunConfig, Trainer

    copy = lambda p: jax.tree.map(jnp.array, p)  # noqa: E731 - the Trainer donates
    tcs, col = _recipe_tcs(j_step), Collator(pad_id=0, buckets=(32,))
    run = lambda name: RunConfig(output_dir=str(tmp / name), batch_size=2,  # noqa: E731
                                 num_epochs=1, loader_workers=1, save_every_steps=10 ** 6)
    losses, states = [], []
    t1 = Trainer(jcfg, tcs[0], run("s1"), copy(jp))
    losses.append([m["loss"] for m in t1.train(_DS(data), col)])
    states.append(jax.device_get(t1.params))
    t1.save_trainable_only("adapters")
    wait_for_checkpoints()
    chained = load_adapter_into(copy(jp), str(tmp / "s1" / "adapters"))
    t2 = Trainer(jcfg, tcs[1], run("s2"), chained)
    losses.append([m["loss"] for m in t2.train(_DS(data), col)])
    states.append(jax.device_get(t2.params))
    save_vita_checkpoint(str(tmp / "s2full"), jcfg, t2.params)
    wait_for_checkpoints()
    cfg3, p3 = load_vita_checkpoint(str(tmp / "s2full"))
    t3 = Trainer(cfg3, tcs[2], run("s3"), p3)
    losses.append([m["loss"] for m in t3.train(_DS(data), col)])
    states.append(jax.device_get(t3.params))
    return losses, states


def _port_recipe(tmp, tcfg, jp, data):
    from vita_tpu_torch.checkpoint import (load_adapter_into, load_vita_checkpoint,
                                           save_vita_checkpoint)
    from vita_tpu_torch.data.dataset import Collator
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    tcs, col = _recipe_tcs(step), Collator(pad_id=0, buckets=(32,))
    run = lambda name: RunConfig(output_dir=str(tmp / name), batch_size=2,  # noqa: E731
                                 num_epochs=1, loader_workers=1, save_every_steps=10 ** 6)
    flat = lambda p: {k: v.detach().numpy().copy() for k, v in step.tree_leaves(p)}  # noqa: E731
    losses, states = [], []
    t1 = Trainer(tcfg, tcs[0], run("s1"), from_jax_params(jp, tcfg))
    losses.append([m["loss"] for m in t1.train(_DS(data), col)])
    states.append(flat(t1.params))
    t1.save_trainable_only("adapters")
    chained = load_adapter_into(from_jax_params(jp, tcfg), str(tmp / "s1" / "adapters"))
    t2 = Trainer(tcfg, tcs[1], run("s2"), chained)
    losses.append([m["loss"] for m in t2.train(_DS(data), col)])
    states.append(flat(t2.params))
    save_vita_checkpoint(str(tmp / "s2full"), tcfg, t2.params)
    cfg3, p3 = load_vita_checkpoint(str(tmp / "s2full"), "cpu")
    t3 = Trainer(cfg3, tcs[2], run("s3"), p3)
    losses.append([m["loss"] for m in t3.train(_DS(data), col)])
    states.append(flat(t3.params))
    return losses, states


def test_three_stage_recipe_matches_jax(tiny, tmp_path):
    """Stage 1 -> adapter-only checkpoint -> overlay onto a fresh base ->
    stage 2 -> full checkpoint -> load -> stage 3, four batches a stage
    (two of images, one audio-only, one text-only): every loss and every
    leaf after each stage against the JAX Trainers'."""
    jcfg, jp, tcfg = tiny
    data = _recipe_data(tcfg)
    jlosses, jstates = _jax_recipe(tmp_path / "jax", jcfg, jp, data)
    losses, states = _port_recipe(tmp_path / "port", tcfg, jp, data)
    assert [len(x) for x in losses] == [4, 4, 4]
    for i, (got, want, jst) in enumerate(zip(losses, jlosses, jstates)):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"stage {i + 1}")
        for path, w in states[i].items():
            close(w, _at(jst, path), **PARAM_TOL)
    # stage 1 moved the vision projector alone; stage 2 moved the LLM
    for path, w in states[0].items():
        assert (not np.array_equal(w, _at(jp, path))) == (path[0] == "vision_proj"), path
    assert not np.array_equal(states[1][("llm", "embed")], states[0][("llm", "embed")])


# --------------------------------------------------------------------------
# stage 1 over a training mesh
# --------------------------------------------------------------------------
# name: (mesh, GPipe microbatches, aux coefficient). Under pipe the aux
# loss is the microbatches' mean (the GPipe property), so that case drops
# it to be held to the unsharded step.
STAGE1_MESHES = {
    "data2": ((2, 1, 1, 1), 1, 0.02),
    "pipe2": ((1, 1, 1, 1, 2), 2, 0.0),
    "seq2": ((1, 1, 1, 1, 1, 2), 1, 0.02),
}


def split_media_batch(cfg, seed, b=4, s=40, frames=60):
    """Rows 0-1 text-only, rows 2-3 each with an image and an audio clip,
    all of them in the second half of the sequence: data 2's first rank,
    pipe 2's first microbatch and seq 2's first block reach no image."""
    rng = np.random.default_rng(seed)
    n_img, n_aud = cfg.image_tokens_per_group, audio_token_count(frames)
    ids = rng.integers(3, cfg.llm.vocab_size, (b, s)).astype(np.int32)
    im, am = np.zeros((b, s), bool), np.zeros((b, s), bool)
    im[2:, 22:22 + n_img] = True
    am[2:, 23 + n_img:23 + n_img + n_aud] = True
    valid = np.ones((b, s), bool)
    valid[1, s - 6:] = False
    valid[3, s - 3:] = False
    labels = np.where(im | am | ~valid, -100, ids).astype(np.int32)
    labels[:, :4] = -100
    sz = cfg.vision.image_size
    return {
        "input_ids": np.where(im | am, 0, ids).astype(np.int32), "labels": labels,
        "image_mask": im, "audio_mask": am, "attn_valid": valid,
        "images": rng.standard_normal((b, sz, sz, 3)).astype(np.float32),
        "speech": rng.standard_normal((b, frames, 80)).astype(np.float32),
        "speech_lengths": np.full(b, frames, np.int32),
    }


def _stage1_tc(aux):
    return dataclasses.replace(step.TrainConfig(**dataclasses.asdict(_stage("stage1"))),
                               aux_loss_coef=aux)


def test_stage1_over_a_mesh_matches_the_unsharded_step(tiny, tmp_path):
    """Three stage-1 updates over [split media, text-only, split media]
    under data 2, pipe 2 (2 microbatches) and seq 2 (flash, the ring) on 2
    gloo ranks: every rank returns within the timeout, its metrics equal
    the unsharded step's (loss 1e-5 relative, tokens exact) and its
    blocks the unsharded leaves (PARAM_TOL)."""
    _, jp, tcfg = tiny
    tp = from_jax_params(jp, tcfg)
    batches = [split_media_batch(tcfg, 0), text_batch(tcfg, 1, b=4),
               split_media_batch(tcfg, 2)]
    shared = {"p": tp, "cfg": tcfg, "b": batches}
    cases = []
    for name, (mesh, micro, aux) in STAGE1_MESHES.items():
        shared[f"tc_{name}"] = _stage1_tc(aux)
        cases.append((name, "train_steps_case", dict(mesh=mesh, params="@p", cfg="@cfg",
                                                     tc=f"@tc_{name}", batches="@b",
                                                     micro=micro)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, u.run_cases, 2, cases, shared, threads=1, timeout=300,
                          store_dir=str(tmp_path))
        want = {aux: _port_steps(tp, tcfg, _stage1_tc(aux), batches) for aux in (0.0, 0.02)}
        ranks = fut.result()
    for name, (mesh, micro, aux) in STAGE1_MESHES.items():
        cfg = _mesh_cfg(tcfg, mesh, micro)
        _check_blocks(ranks, name, mesh, cfg, want[aux], tol=PARAM_TOL)
        # under pipe the aux metric is the microbatches' mean
        keys = ("loss", "ce") if micro > 1 else ("loss", "ce", "aux")
        for r in ranks:
            for got, (w, _) in zip(r[name]["metrics"], want[aux]):
                for k in keys:
                    np.testing.assert_allclose(got[k], w[k], rtol=1e-5, err_msg=f"{name} {k}")
                assert got["tokens"] == w["tokens"]
            moved = r[name]["blocks"][-1]["vision_proj/fc1_w"]
            assert not np.array_equal(moved, tp["vision_proj"]["fc1_w"].detach().numpy())


# --------------------------------------------------------------------------
# the Engine past the default buckets: many tiles, long prompts, frameCat
# --------------------------------------------------------------------------
def _media_request(cfg, rng, n_tiles, n_text, frames=0, max_new_tokens=6):
    """``n_tiles`` tiles (groups of cfg.image_group_tiles, each
    image_tokens_per_group slots), an optional audio clip and ``n_text``
    text tokens in all."""
    n_img = n_tiles // cfg.image_group_tiles * cfg.image_tokens_per_group
    n_aud = audio_token_count(frames) if frames else 0
    s = n_img + n_aud + n_text
    ids = rng.integers(3, 512, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[5:5 + n_img] = True
    am[6 + n_img:6 + n_img + n_aud] = True
    ids[im | am] = 0
    sz = cfg.vision.image_size
    req = dict(input_ids=ids, image_mask=im, audio_mask=am, max_new_tokens=max_new_tokens,
               images=normal(rng, n_tiles, sz, sz, 3))
    if frames:
        req.update(speech=normal(rng, frames, 80), speech_length=frames)
    return req


@pytest.mark.parametrize("fusion", ["patch", "framecat"])
def test_engine_many_tiles_and_long_prompts_match_jax(fusion):
    """At max_len 8192: a request of 16 patch tiles (or 20 frameCat tiles)
    with an audio clip whose prompt runs past 4096 tokens (the appended
    8192 bucket), beside a short many-tile request and a text request:
    identical greedy streams to the JAX Engine's on the same weights."""
    jcfg = j_vita.VITAConfig.tiny(vision_fusion=fusion)
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = jax.device_get(j_vita.init_params(jax.random.PRNGKey(1), jcfg))
    tcfg = vita.VITAConfig.tiny(vision_fusion=fusion)
    tp = from_jax_params(jp, tcfg)
    tiles = 16 if fusion == "patch" else 20
    rng = np.random.default_rng(11)
    reqs = [_media_request(tcfg, rng, tiles, 4200, frames=60),
            _media_request(tcfg, rng, tiles, 40),
            dict(input_ids=rng.integers(3, 512, 30).astype(np.int32), max_new_tokens=6)]
    assert len(reqs[0]["input_ids"]) > 4096
    streams = []
    for mod, params, cfg in ((j_engine, jp, jcfg), (engine, tp, tcfg)):
        eng = mod.Engine(params, cfg, n_slots=2, max_len=8192, page_size=64,
                         prefill_chunk=1024, decode_moe_mode="gather")
        assert eng.prompt_buckets[-1] == 8192
        rs = [mod.Request(eos_id=-1, **kw) for kw in reqs]
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
        streams.append([r.tokens for r in rs])
    assert streams[1] == streams[0]
    assert all(len(s) == 6 for s in streams[1])
