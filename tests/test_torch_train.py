"""PyTorch port: the training slice (train/step.py, train/trainer.py,
train/lora.py, train/cli.py) against the JAX package on
``VITAConfig.tiny()``, same weights (convert.from_jax_params), same batch.

The JAX train step runs jitted, as its Trainer runs it; its gmm mode runs
the package's CPU twin of the kernels (the kernels themselves are held to
the port in test_torch_moe_backward.py). Tolerances, float32: the loss
1e-5 relative; parameters after 3 updates the port's float32 tolerance,
atol = rtol = 1e-4. The learning rates below move a weight by up to 1e-2
per update, and Adam's update m / (sqrt(nu) + 1e-8) is ill-conditioned
where a gradient is at the level of float32 rounding: there the two
frameworks' rounding gives updates that differ by up to a few 1e-3 of the
rate (largest difference seen, 8e-5 on 2 of 8192 elements).
"""

import dataclasses
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import close, t
from vita_tpu.models import vita as j_vita
from vita_tpu.train import lora as j_lora
from vita_tpu.train import step as j_step
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.tokenization import AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX, audio_token_count
from vita_tpu_torch.train import lora, step
from vita_tpu_torch.train.trainer import RunConfig, Trainer

PARAM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    init = jax.jit(j_vita.init_params, static_argnums=1)
    jp = jax.device_get(init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, vita.VITAConfig.tiny()


def media_batch(cfg, seed=0, s=40, frames=60):
    """Two rows, each one image tile and one audio clip; row 1 padded."""
    rng = np.random.default_rng(seed)
    n_img, n_aud = cfg.image_tokens_per_group, audio_token_count(frames)
    ids = rng.integers(3, cfg.llm.vocab_size, (2, s)).astype(np.int32)
    ids[:, 2:2 + n_img] = IMAGE_TOKEN_INDEX
    ids[:, 3 + n_img:3 + n_img + n_aud] = AUDIO_TOKEN_INDEX
    im, am = ids == IMAGE_TOKEN_INDEX, ids == AUDIO_TOKEN_INDEX
    valid = np.ones((2, s), bool)
    valid[1, s - 7:] = False
    labels = np.where(im | am | ~valid, -100, ids).astype(np.int32)
    labels[:, :4] = -100
    sz = cfg.vision.image_size
    return {
        "input_ids": np.where(im | am, 0, ids).astype(np.int32), "labels": labels,
        "image_mask": im, "audio_mask": am, "attn_valid": valid,
        "images": rng.standard_normal((2, sz, sz, 3)).astype(np.float32),
        "speech": rng.standard_normal((2, frames, 80)).astype(np.float32),
        "speech_lengths": np.array([frames, frames - 9], np.int32),
    }


def test_loss_fn_matches_jax(tiny):
    jcfg, jp, tcfg = tiny
    batch = media_batch(tcfg)
    loss = jax.jit(j_step.loss_fn, static_argnums=(1, 3))
    jtotal, jm = loss(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, 0.02)
    total, m = step.loss_fn(from_jax_params(jp, tcfg), tcfg, step.batch_to(batch, "cpu"), 0.02)
    for k in ("ce", "aux"):
        close(m[k], jm[k], atol=1e-6, rtol=1e-5)
    close(total, jtotal, atol=1e-6, rtol=1e-5)
    assert int(m["tokens"]) == int(jm["tokens"])


def test_build_labels_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, (3, 17)).astype(np.int32)
    media, answer = rng.random((3, 17)) < 0.3, rng.random((3, 17)) < 0.6
    got = vita.build_labels(t(ids), t(media), t(answer))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_vita.build_labels(jnp.asarray(ids), jnp.asarray(media), jnp.asarray(answer))))


def _stage(name, **kw):
    base = {"stage1": j_step.TrainConfig.stage1_pretrain_mlp(),
            "stage2": j_step.TrainConfig.stage2_finetune()}[name]
    # short warmup and large rates, so that 3 updates move every weight
    tc = dataclasses.replace(base, warmup_steps=1, total_steps=10, learning_rate=1e-2,
                             weight_decay=0.01, **kw)
    if tc.projector_lr is not None:
        tc = dataclasses.replace(tc, projector_lr=3e-2)
    return tc


def _jax_steps(jcfg, jp, jtc, batches):
    opt = j_step.make_optimizer(jtc, jp)
    state = opt.init(jp)
    fn = jax.jit(j_step.make_train_step(jcfg, jtc, opt))
    losses = []
    for b in batches:
        jp, state, m = fn(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return jax.device_get(jp), losses


def _torch_steps(tcfg, params, tc, batches):
    opt = step.make_optimizer(tc, params)
    state = opt.init(params)
    fn = step.make_train_step(tcfg, tc, opt)
    losses = []
    for b in batches:
        params, state, m = fn(params, state, b)
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.parametrize("stage,moe_mode", [("stage1", "dense"), ("stage2", "dense"),
                                            ("stage2", "gmm")])
def test_train_steps_match_jax(tiny, stage, moe_mode):
    """Three updates: the loss of each step and every parameter after.
    Stage 1 trains the vision projector alone; stage 2 everything but the
    towers, with the projectors in their own clip group at their own rate."""
    jcfg, jp, tcfg = tiny
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, moe_mode=moe_mode))
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, moe_mode=moe_mode))
    jtc = _stage(stage)
    tc = step.TrainConfig(**dataclasses.asdict(jtc))
    batches = [media_batch(tcfg, seed) for seed in range(3)]
    jout, jlosses = _jax_steps(jcfg, jp, jtc, batches)
    params, losses = _torch_steps(tcfg, from_jax_params(jp, tcfg), tc, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for path, w in step.tree_leaves(params):
        close(w.detach(), _at(jout, path), **PARAM_TOL)
        # exactly the trainable leaves moved, on both sides
        assert np.array_equal(_at(jout, path), _at(jp, path)) != w.requires_grad, path
    assert sum(w.requires_grad for _, w in step.tree_leaves(params)) == (
        4 if stage == "stage1" else 23)  # vision_proj; + the LLM's 13 and audio_proj's 6


def test_remat_and_flash_backend_agree(tiny):
    """Per-layer remat changes nothing, and the flash backend (the
    autograd Function with the plain backward on the CPU) trains as the
    plain attention does, to float32 rounding."""
    jcfg, jp, tcfg = tiny
    tc = step.TrainConfig(**dataclasses.asdict(_stage("stage2")))
    batches = [media_batch(tcfg, seed) for seed in range(2)]
    runs = []
    for remat, backend in ((False, "xla"), (True, "xla"), (True, "flash")):
        cfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, remat=remat,
                                                                attn_backend=backend))
        runs.append(_torch_steps(cfg, from_jax_params(jp, tcfg), tc, batches))
    (p0, l0), *others = runs
    for (p1, l1), tol in zip(others, (1e-6, 1e-4)):
        np.testing.assert_allclose(l0, l1, rtol=tol)
        for (_, a), (_, b) in zip(step.tree_leaves(p0), step.tree_leaves(p1)):
            close(a.detach(), b.detach(), atol=tol, rtol=tol)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_optimizer_matches_optax(tiny, stage):
    """The in-place AdamW against the JAX package's optax chain on the
    same gradients for 4 updates: frozen leaves untouched, the first update
    at lr 0, one global-norm clip per group (grad_clip 5 clips the base
    group's norm, about 30, and not the projectors', about 8 and 3)."""
    _, jp, tcfg = tiny
    jtc = _stage(stage, grad_clip=5.0)
    tc = step.TrainConfig(**dataclasses.asdict(jtc))
    params = from_jax_params(jp, tcfg)
    opt = step.make_optimizer(tc, params)
    state = opt.init(params)
    jopt = j_step.make_optimizer(jtc, jp)
    jstate, jparams = jopt.init(jp), jp
    rng = np.random.default_rng(0)
    for i in range(4):
        g = {p: (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
             for p, w in step.tree_leaves(params) if w.requires_grad}
        opt.update(params, {p: t(v) for p, v in g.items()}, state)
        jg = jax.tree_util.tree_map_with_path(
            lambda kp, x: g.get(tuple(k.key for k in kp), np.zeros_like(x)), jparams)
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for path, w in step.tree_leaves(params):
            close(w.detach(), _at(jparams, path), atol=1e-6, rtol=1e-6)
            if i == 0 or not w.requires_grad:
                assert np.array_equal(w.detach().numpy(), _at(jp, path)), path
    assert any(not w.requires_grad for _, w in step.tree_leaves(params))


def _write_wav(path, seconds=0.5, seed=0):
    rng = np.random.default_rng(seed)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((rng.standard_normal(int(16000 * seconds)) * 3000).astype(np.int16).tobytes())


def _chat(tmp_path, n=3):
    wav = tmp_path / "q.wav"
    _write_wav(wav)
    data = [
        {"conversations": [{"from": "human", "value": "<audio>\n"},
                           {"from": "gpt", "value": "a b c"}], "audio": str(wav)},
        {"conversations": [{"from": "human", "value": "hi there"},
                           {"from": "gpt", "value": "yo there"}]},
    ] * n
    path = tmp_path / "chat.json"
    path.write_text(json.dumps(data))
    return path


def _encode(s):
    # ids inside the tiny model's 512 vocab
    return [1] + [3 if w == "</s>" else 100 + (sum(map(ord, w)) % 400)
                  for w in s.replace("</s>", " </s> ").split()]


def _datasets(path, cfg):
    from vita_tpu.data import dataset as j_ds
    from vita_tpu_torch.data import dataset as t_ds

    kw = dict(image_size=cfg.vision.image_size, max_patches=1, use_thumbnail=False)
    return (t_ds.ConversationDataset([t_ds.DatasetSpec(str(path))], _encode, 1, 2, pad_id=0,
                                     args=t_ds.DataArgs(**kw)),
            j_ds.ConversationDataset([j_ds.DatasetSpec(str(path))], _encode, 1, 2, pad_id=0,
                                     args=j_ds.DataArgs(**kw)))


def test_trainer_end_to_end_with_resume(tiny, tmp_path):
    """Two runs over one output directory: the first trains 3 steps and
    checkpoints every 2 (step_2 and the final save of step_3 kept); the
    second resumes at step 3 and skips the 3 batches already trained."""
    from vita_tpu_torch.data.dataset import Collator

    _, jp, tcfg = tiny
    ds, _ = _datasets(_chat(tmp_path), tcfg)
    tc = step.TrainConfig(**dataclasses.asdict(_stage("stage2")))
    run = RunConfig(output_dir=str(tmp_path / "out"), batch_size=2, save_every_steps=2,
                    loader_workers=2)
    tr = Trainer(tcfg, tc, run, from_jax_params(jp, tcfg))
    log = tr.train(ds, Collator(pad_id=0))
    tr.save()
    assert [m["step"] for m in log] == [1, 2, 3] and all(np.isfinite(m["loss"]) for m in log)
    ckpt = tmp_path / "out" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_3"]
    lines = (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]

    tr2 = Trainer(tcfg, tc, run, from_jax_params(jp, tcfg))
    assert tr2.step == 3 and tr2.opt_state["count"] == 3
    for (_, a), (_, b) in zip(step.tree_leaves(tr.params), step.tree_leaves(tr2.params)):
        assert torch.equal(a, b)
    assert tr2.train(ds, Collator(pad_id=0)) == []

    tr.save_trainable_only("adapters")
    from vita_tpu_torch.train.trainer import load_adapter_into

    fresh = from_jax_params(jp, tcfg)
    load_adapter_into(fresh, str(tmp_path / "out" / "adapters"))
    assert torch.equal(fresh["vision_proj"]["fc1_w"], tr.params["vision_proj"]["fc1_w"])
    assert torch.equal(fresh["vision"]["cls"], tr.params["vision"]["cls"])  # frozen: not saved


def test_evaluate_matches_jax(tiny, tmp_path):
    from vita_tpu.data.dataset import Collator as JCollator
    from vita_tpu.train import trainer as j_trainer
    from vita_tpu_torch.data.dataset import Collator
    from vita_tpu_torch.train.trainer import evaluate

    jcfg, jp, tcfg = tiny
    tds, jds = _datasets(_chat(tmp_path, n=2), tcfg)
    got = evaluate(from_jax_params(jp, tcfg), tcfg, tds, Collator(pad_id=0), batch_size=3)
    want = j_trainer.evaluate(jp, jcfg, jds, JCollator(pad_id=0), batch_size=3)
    assert got["eval_tokens"] == want["eval_tokens"] > 0
    close(got["eval_ppl"], want["eval_ppl"], atol=0, rtol=1e-5)


def test_lora_matches_jax_and_trains_only_adapters(tiny):
    """apply_lora / merge_lora on the JAX package's adapters (non-trivial
    values), and lora_loss_fn's gradients: they reach the adapters alone
    and equal jax.grad's."""
    jcfg, jp, tcfg = tiny
    lcfg, jl = lora.LoRAConfig(rank=4), j_lora.LoRAConfig(rank=4)
    jad = jax.device_get(jax.tree.map(lambda x: x + 0.01,
                                      j_lora.init_lora(jax.random.PRNGKey(1), jp["llm"], jl)))
    ad = jax.tree.map(lambda x: t(x).requires_grad_(), jad)
    params = from_jax_params(jp, tcfg)
    merged = lora.merge_lora(params, ad, lcfg)
    jmerged = j_lora.merge_lora(jp, jad, jl)
    for path, w in step.tree_leaves(merged["llm"]):
        close(w.detach(), _at(jmerged["llm"], path), atol=1e-6, rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    init = lora.init_lora(g, params["llm"], lcfg)
    assert not any(init["layers"][grp][n]["b"].any() for grp, n in lora.LORA_TARGETS)

    batch = media_batch(tcfg)
    loss, _ = lora.lora_loss_fn(params, ad, tcfg, lcfg, step.batch_to(batch, "cpu"), 0.02,
                                step.loss_fn)
    loss.backward()
    assert all(w.grad is None and not w.requires_grad for _, w in step.tree_leaves(params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrad = jax.jit(jax.grad(lambda a: j_lora.lora_loss_fn(jp, a, jcfg, jl, jb, 0.02,
                                                           j_step.loss_fn)[0]))(jad)
    for path, w in step.tree_leaves(ad):
        close(w.grad, _at(jgrad, path), atol=1e-5, rtol=1e-4)


def test_train_cli_runs_then_resumes(tmp_path, capsys):
    from vita_tpu_torch.train import cli

    argv = ["--model", "tiny-random", "--data", str(_chat(tmp_path)), "--output-dir",
            str(tmp_path / "run"), "--batch-size", "2", "--save-every", "2", "--device", "cpu",
            "--moe-mode", "gmm"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[step 3]" in out and "[done] 3 steps" in out
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "[step" not in out
    with pytest.raises(NotImplementedError, match="A11"):
        cli.main(argv + ["--mesh", "1"])
    # checkpoint directories, --lora-from and --whale-init are loaded now
    # (A9): paths that hold nothing raise
    for bad in (["--lora-from", str(tmp_path / "x")], ["--whale-init", str(tmp_path / "x")]):
        with pytest.raises(FileNotFoundError):
            cli.main(argv + bad)
    with pytest.raises(FileNotFoundError):
        cli.main(["--model", str(tmp_path), *argv[2:]])


def test_train_cli_loads_checkpoint_whale_init_and_lora(tmp_path, monkeypatch, capsys):
    """--model <dir> (an exported checkpoint with its tokenizer),
    --whale-init (a final.pt with one unknown key) and --lora-from (this
    port's adapter layout): the Trainer starts from the loaded weights with
    the Whale encoder merged and the adapters folded in, and trains."""
    import huggingface_hub.constants
    import transformers.utils.hub

    from torch_port_util import write_tiny_tokenizer
    from vita_tpu_torch import checkpoint
    from vita_tpu_torch.train import cli, trainer
    from vita_tpu_torch.train.trainer import save_state
    from vita_tpu_torch.utils import hf_import

    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)
    cfg = vita.VITAConfig.tiny()
    ckpt = tmp_path / "ckpt"
    checkpoint.export_hf_vita_checkpoint(
        str(ckpt), cfg, vita.init_params(cfg, torch.Generator().manual_seed(5), "cpu"))
    write_tiny_tokenizer(ckpt)
    other = vita.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    state = hf_import.whale_params_to_hf(other["audio"], cfg.audio.n_layers)
    torch.save({**state, "extra.unknown": torch.zeros(1)}, tmp_path / "final.pt")
    base_cfg, base = checkpoint.load_vita_checkpoint(str(ckpt), device="cpu")
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0)
    ad = lora.init_lora(torch.Generator().manual_seed(7), base["llm"], lcfg)
    for grp, name in lora.LORA_TARGETS:
        ad["layers"][grp][name]["b"] += 0.05
    save_state(str(tmp_path / "adapters"), 3, ad)

    started = {}
    real_init = trainer.Trainer.__init__

    def init(self, cfg, tc, run, params):
        started["cfg"] = cfg
        started["params"] = {k: v.detach().clone() for k, v in step.tree_leaves(params)}
        real_init(self, cfg, tc, run, params)

    monkeypatch.setattr(trainer.Trainer, "__init__", init)
    argv = ["--model", str(ckpt), "--data", str(_chat(tmp_path)), "--output-dir",
            str(tmp_path / "run"), "--batch-size", "2", "--device", "cpu",
            "--whale-init", str(tmp_path / "final.pt"), "--lora-from", str(tmp_path / "adapters"),
            "--lora-rank", "4", "--lora-alpha", "8"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[load] whale final.pt: " in out and "1 unknown keys ignored" in out
    assert "[done] 3 steps" in out
    assert started["cfg"].llm.dtype == base_cfg.llm.dtype == torch.bfloat16
    want = lora.merge_lora(base, ad, lcfg)
    want["audio"] = checkpoint.load_whale_torch_checkpoint(base, str(tmp_path / "final.pt"))["audio"]
    for path, w in step.tree_leaves(want):
        assert torch.equal(started["params"][path], w), path
    assert not torch.equal(want["audio"]["layers"]["q_w"], base["audio"]["layers"]["q_w"])


def test_serving_records_no_autograd_graph(tiny):
    """Weights that require grad (as the Trainer leaves them) serve under
    no_grad: nothing the Engine or the Generator returns or caches
    requires grad."""
    from vita_tpu_torch.generate import GenerationConfig, Generator
    from vita_tpu_torch.serve.engine import Engine, Request

    _, jp, tcfg = tiny
    params = from_jax_params(jp, tcfg)
    step.make_optimizer(step.TrainConfig(), params)
    assert any(w.requires_grad for _, w in step.tree_leaves(params))
    batch = media_batch(tcfg)
    media = dict(input_ids=batch["input_ids"][0], image_mask=batch["image_mask"][0],
                 audio_mask=batch["audio_mask"][0], images=batch["images"][:1],
                 speech=batch["speech"][0], speech_length=60)
    eng = Engine(params, tcfg, n_slots=2, max_len=128, page_size=16)
    req = Request(max_new_tokens=4, eos_id=-1, **media)
    eng.submit(req)
    eng.run_until_idle()
    assert len(req.tokens) == 4

    def tensors(x):
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from tensors(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from tensors(v)

    state = [v for k, v in vars(eng).items() if k not in ("params", "_decode_llm")]
    assert not any(x.requires_grad for x in tensors(state))
    gen = Generator(params, tcfg, max_len=128)
    toks = gen.generate(gen=GenerationConfig(max_new_tokens=4, eos_id=-1), **media)
    assert len(toks) == 4
    knobs = (torch.zeros(1), torch.zeros(1, dtype=torch.int32), torch.ones(1))
    tok, cache = gen._prefill(params["llm"]["embed"][torch.zeros(1, 8, dtype=torch.long)], 8,
                              knobs, torch.Generator(), "greedy")
    assert not any(x.requires_grad for x in tensors([tok, cache]))
