"""PyTorch port: the LoRA chain (train/lora.py, train/merge_lora.py,
checkpoint.load_lora_vita_checkpoint) and the train CLI's three weight
overlays (--pretrain-mm-adapter, --whale-init, --lora-from) against the
JAX package on ``VITAConfig.tiny()``, same weights
(convert.from_jax_params), same inputs.

Tolerances, float32: losses 1e-5 relative; adapter gradients atol 1e-5,
rtol 1e-4 (the port's gmm and flash plain backwards against JAX's Pallas
kernels run in interpret mode, as tests/test_torch_moe_backward.py and
tests/test_torch_flash_backward.py run them). Greedy token ids and the
weights a Trainer starts from are compared exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_util  # noqa: F401  (pins torch threads)
from test_torch_train import _at, _write_wav, media_batch
from torch_port_util import close, normal, t
from vita_tpu import checkpoint as j_ckpt
from vita_tpu.models import vita as j_vita
from vita_tpu.train import lora as j_lora
from vita_tpu.train import step as j_step
from vita_tpu_torch import checkpoint
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.train import lora, step
from vita_tpu_torch.train.trainer import save_state

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    init = jax.jit(j_vita.init_params, static_argnums=1)
    jp = jax.device_get(init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, vita.VITAConfig.tiny()


def _llm_modes(cfg, **kw):
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **kw))


def _jax_adapters(jp, rank=4, seed=1, shift=0.01):
    """The JAX package's init_lora with every factor moved by ``shift``, so
    that B is nonzero."""
    jl = j_lora.LoRAConfig(rank=rank)
    return jax.device_get(jax.tree.map(lambda x: x + shift,
                                       j_lora.init_lora(jax.random.PRNGKey(seed), jp["llm"], jl)))


def _chat(tmp_path, n=1):
    """One audio sample and one text sample, ``n`` times: a batch of 2 a step."""
    wav = tmp_path / "q.wav"
    _write_wav(wav)
    data = [{"conversations": [{"from": "human", "value": "<audio>\n"},
                               {"from": "gpt", "value": "a b c"}], "audio": str(wav)},
            {"conversations": [{"from": "human", "value": "hi there"},
                               {"from": "gpt", "value": "yo there"}]}] * n
    path = tmp_path / "chat.json"
    path.write_text(json.dumps(data))
    return str(path)


def _recording_init(monkeypatch, trainer_cls, store, to_host):
    """Wrap ``trainer_cls.__init__``: each Trainer's starting params, by
    leaf path, on the host, appended to ``store``."""
    real = trainer_cls.__init__

    def init(self, cfg, tc, run, params, *a, **kw):
        store.append(to_host(params))
        real(self, cfg, tc, run, params, *a, **kw)

    monkeypatch.setattr(trainer_cls, "__init__", init)


def _port_host(params):
    return {p: w.detach().clone() for p, w in step.tree_leaves(params)}


def _jax_host(params):
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    return {tuple(k.key for k in path): np.asarray(x) for path, x in flat}


# ---------------------------------------------------------------------------
# lora_loss_fn
# ---------------------------------------------------------------------------
def test_identity_at_init(tiny):
    """init_lora's B is zero: every merged leaf is the base leaf bitwise,
    lora_loss_fn's loss is step.loss_fn's on the base bitwise, and both
    are within LOSS_RTOL of the JAX package's loss_fn."""
    jcfg, jp, tcfg = tiny
    params = from_jax_params(jp, tcfg)
    lcfg = lora.LoRAConfig(rank=4)
    ad = lora.init_lora(torch.Generator().manual_seed(3), params["llm"], lcfg)
    merged = lora.merge_lora(params, ad, lcfg)
    for path, w in step.tree_leaves(params):
        assert torch.equal(dict(step.tree_leaves(merged))[path], w), path
    batch = media_batch(tcfg)
    tb = step.batch_to(batch, "cpu")
    with torch.no_grad():
        got, _ = lora.lora_loss_fn(params, ad, tcfg, lcfg, tb, 0.02, step.loss_fn)
        base, _ = step.loss_fn(params, tcfg, tb, 0.02)
    assert torch.equal(got, base)
    jloss = jax.jit(j_step.loss_fn, static_argnums=(1, 3))
    want, _ = jloss(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, 0.02)
    close(got, want, atol=0, rtol=LOSS_RTOL)


def test_adapter_gradients_gmm_flash_match_jax(tiny):
    """lora_loss_fn's adapter gradients with gmm MoE and flash attention
    (the card's training mode) against jax.grad of the JAX package's
    lora_loss_fn on its Pallas kernels in interpret mode; nonzero B. The
    base gets no gradient."""
    jcfg, jp, tcfg = tiny
    jcfg = _llm_modes(jcfg, moe_mode="gmm", attn_backend="flash")
    tcfg = _llm_modes(tcfg, moe_mode="gmm", attn_backend="flash")
    jl, lcfg = j_lora.LoRAConfig(rank=4), lora.LoRAConfig(rank=4)
    jad = _jax_adapters(jp)
    ad = jax.tree.map(lambda x: t(x).requires_grad_(), jad)
    params = from_jax_params(jp, tcfg)
    batch = media_batch(tcfg, seed=2)
    loss, _ = lora.lora_loss_fn(params, ad, tcfg, lcfg, step.batch_to(batch, "cpu"), 0.02,
                                step.loss_fn)
    leaves = [w for _, w in step.tree_leaves(ad)]
    grads = torch.autograd.grad(loss, leaves)
    assert all(w.grad is None and not w.requires_grad for _, w in step.tree_leaves(params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(a):
        return j_lora.lora_loss_fn(jp, a, jcfg, jl, jb, 0.02, j_step.loss_fn)[0]

    with pltpu.force_tpu_interpret_mode():
        jval, jgrad = jax.value_and_grad(jloss)(jad)
    close(loss.detach(), jval, atol=0, rtol=LOSS_RTOL)
    for (path, _), g in zip(step.tree_leaves(ad), grads):
        assert g.abs().max() > 0, path
        close(g, _at(jgrad, path), **GRAD_TOL)


# ---------------------------------------------------------------------------
# the merge CLI, and serving what it wrote
# ---------------------------------------------------------------------------
def _requests(cfg, rng):
    frames = 60
    from vita_tpu_torch import tokenization

    n_img, n_aud = cfg.image_tokens_per_group, tokenization.audio_token_count(frames)
    s = n_img + n_aud + 10
    ids = rng.integers(3, 512, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[4:4 + n_img] = True
    am[4 + n_img:4 + n_img + n_aud] = True
    ids[im | am] = 0
    return [dict(input_ids=rng.integers(3, 512, 11).astype(np.int32), max_new_tokens=8),
            dict(input_ids=ids, image_mask=im, audio_mask=am, max_new_tokens=8,
                 images=normal(rng, 1, 56, 56, 3), speech=normal(rng, frames, 80),
                 speech_length=frames)]


def _jax_top2(params, cfg, req, tokens):
    """The JAX package's bf16 cacheless forward over ``req``'s prompt and
    ``tokens``: the top two (id, logit) pairs of the next token."""
    n = len(tokens)
    ids = np.concatenate([req["input_ids"], tokens]).astype(np.int32)[None]
    kw = {}
    if "image_mask" in req:
        pad = np.zeros(n, bool)
        kw = dict(image_mask=jnp.asarray(np.concatenate([req["image_mask"], pad])[None]),
                  audio_mask=jnp.asarray(np.concatenate([req["audio_mask"], pad])[None]),
                  images=jnp.asarray(req["images"], jnp.bfloat16),
                  speech=jnp.asarray(req["speech"], jnp.bfloat16)[None],
                  speech_lengths=jnp.asarray([req["speech_length"]], jnp.int32))
    logits = np.asarray(j_vita.forward(params, cfg, jnp.asarray(ids), **kw)[0][0, -1], np.float32)
    top = np.argsort(-logits, kind="stable")[:2]
    return [(int(i), float(logits[i])) for i in top]


# bf16 greedy streams of two frameworks may part where the top two logits
# are a tie or within a bf16 step or two of one: the JAX forward's top two
# must then be the two tokens, within NEAR_TIE_REL of the larger logit
NEAR_TIE_REL = 2.0 ** -6


def test_merge_clis_then_engines_serve_the_same_tokens(tiny, tmp_path):
    """One bf16 export and one adapter tree (rank 8, nonzero B), merged by
    each package's merge CLI (the port's at --device cpu): every merged
    leaf bitwise equal. Each package's Engine (bf16, attn 'xla') serves
    greedy from what its own CLI wrote a text request and an image+audio
    request: identical token ids up to a step where the JAX forward's top
    two logits are the two tokens and lie within NEAR_TIE_REL (there the
    request's comparison ends); the merged model's streams differ from the
    unmerged base's."""
    from vita_tpu.serve import engine as j_engine
    from vita_tpu.train import merge_lora as j_merge
    from vita_tpu_torch.serve import engine
    from vita_tpu_torch.train import merge_lora

    jcfg, jp, _ = tiny
    jbf = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), jp)
    export = str(tmp_path / "export")
    j_ckpt.export_hf_vita_checkpoint(export, jcfg, jbf)
    jad = jax.tree.map(lambda x: np.array(x, np.float32),
                       _jax_adapters(jp, rank=8, seed=4, shift=0.02))
    j_ckpt.save_checkpoint(str(tmp_path / "ad_jax"), jad, block=True)
    save_state(str(tmp_path / "ad_port"), 0, jax.tree.map(lambda a: torch.from_numpy(a), jad))
    assert j_merge.main(["--base", export, "--lora", str(tmp_path / "ad_jax"), "--output",
                         str(tmp_path / "m_jax")]) == 0
    j_ckpt.wait_for_checkpoints()
    assert merge_lora.main(["--base", export, "--lora", str(tmp_path / "ad_port"), "--output",
                            str(tmp_path / "m_port"), "--device", "cpu"]) == 0
    loaded = [j_ckpt.load_vita_checkpoint(str(tmp_path / "m_jax")),
              checkpoint.load_vita_checkpoint(str(tmp_path / "m_port"), device="cpu"),
              checkpoint.load_vita_checkpoint(export, device="cpu")]
    jmerged = jax.device_get(loaded[0][1])
    for path, w in step.tree_leaves(loaded[1][1]):
        np.testing.assert_array_equal(w.float().numpy(), _at(jmerged, path).astype(np.float32),
                                      err_msg="/".join(path))
    streams = []
    for mod, (cfg, params) in zip((j_engine, engine, engine), loaded):
        reqs = _requests(cfg, np.random.default_rng(7))
        eng = mod.Engine(params, cfg, n_slots=2, max_len=128, decode_chunk_len=2,
                         decode_moe_mode="gather")
        rs = [mod.Request(eos_id=-1, **kw) for kw in reqs]
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
        streams.append([list(map(int, r.tokens)) for r in rs])
    reqs = _requests(loaded[1][0], np.random.default_rng(7))
    for req, want, got in zip(reqs, streams[0], streams[1]):
        assert len(got) == len(want) == 8
        split = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if split is not None:
            top2 = _jax_top2(loaded[0][1], loaded[0][0], req, want[:split])
            assert {i for i, _ in top2} == {want[split], got[split]}, (split, top2, want, got)
            assert top2[0][1] - top2[1][1] <= NEAR_TIE_REL * abs(top2[0][1]), (split, top2)
    assert streams[1] != streams[2]  # the merge moved the served model


# ---------------------------------------------------------------------------
# the train CLIs' overlays
# ---------------------------------------------------------------------------
def _cli_argv(chat, out, *extra):
    return ["--model", "tiny-random", "--data", chat, "--output-dir", out, "--batch-size", "2",
            "--no-resume", *extra]


def test_pretrain_mm_adapter_through_both_train_clis(tiny, tmp_path, monkeypatch, capsys):
    """--pretrain-mm-adapter, one adapter's values saved in each package's
    layout (orbax for the JAX package, save_state for the port): both CLIs
    exit 0, and each Trainer starts with vision_proj equal to the adapter
    and every other leaf equal to its own tiny-random base. An adapter
    checkpoint with an unknown component raises in both."""
    from vita_tpu.train import cli as j_cli
    from vita_tpu.train import trainer as j_trainer
    from vita_tpu_torch.train import cli, trainer

    jcfg, jp, tcfg = tiny
    rng = np.random.default_rng(11)
    values = jax.tree.map(lambda x: normal(rng, *x.shape), jp["vision_proj"])
    j_ckpt.save_checkpoint(str(tmp_path / "mm_jax"), {"vision_proj": values}, block=True)
    save_state(str(tmp_path / "mm_port"), 0,
               {"vision_proj": jax.tree.map(lambda x: t(x), values)})
    chat = _chat(tmp_path)
    jstarts, starts = [], []
    _recording_init(monkeypatch, j_trainer.Trainer, jstarts, _jax_host)
    _recording_init(monkeypatch, trainer.Trainer, starts, _port_host)
    assert j_cli.main(_cli_argv(chat, str(tmp_path / "run_jax"), "--pretrain-mm-adapter",
                                str(tmp_path / "mm_jax"))) == 0
    j_ckpt.wait_for_checkpoints()
    assert cli.main(_cli_argv(chat, str(tmp_path / "run_port"), "--pretrain-mm-adapter",
                              str(tmp_path / "mm_port"), "--device", "cpu")) == 0
    assert "[done] 1 steps" in capsys.readouterr().out
    jbase = _jax_host(j_vita.init_params(jax.random.PRNGKey(0), jcfg))
    base = _port_host(vita.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    for got, want in ((jstarts[0], jbase), (starts[0], base)):
        assert got.keys() == want.keys()
        for path, w in got.items():
            ref = _at(values, path[1:]) if path[0] == "vision_proj" else want[path]
            np.testing.assert_array_equal(np.asarray(w, np.float32), np.asarray(ref, np.float32),
                                          err_msg="/".join(path))
    j_ckpt.save_checkpoint(str(tmp_path / "bad_jax"), {"bogus": {"w": values["fc1_w"]}}, block=True)
    save_state(str(tmp_path / "bad_port"), 0, {"bogus": {"w": t(values["fc1_w"])}})
    with pytest.raises(KeyError, match="unknown component 'bogus'"):
        j_cli.main(_cli_argv(chat, str(tmp_path / "bad_run_jax"), "--pretrain-mm-adapter",
                             str(tmp_path / "bad_jax")))
    with pytest.raises(KeyError, match="unknown component 'bogus'"):
        cli.main(_cli_argv(chat, str(tmp_path / "bad_run_port"), "--pretrain-mm-adapter",
                           str(tmp_path / "bad_port"), "--device", "cpu"))


def test_three_overlays_start_alike_with_and_without_a_mesh(tmp_path, monkeypatch, capsys):
    """The port's train CLI with --pretrain-mm-adapter, --whale-init (a
    final.pt with one unknown key) and --lora-from: under --mesh 1 1 1 1
    its Trainer starts from the same weights as without a mesh, bitwise,
    and those are the three overlays applied to the tiny-random base in
    the CLI's order."""
    from vita_tpu_torch.train import cli, trainer
    from vita_tpu_torch.utils import hf_import

    cfg = vita.VITAConfig.tiny()
    other = vita.init_params(cfg, torch.Generator().manual_seed(21), "cpu")
    save_state(str(tmp_path / "mm"), 0, {"vision_proj": other["vision_proj"]})
    state = hf_import.whale_params_to_hf(
        vita.init_params(cfg, torch.Generator().manual_seed(22), "cpu")["audio"],
        cfg.audio.n_layers)
    torch.save({**state, "extra.unknown": torch.zeros(1)}, tmp_path / "final.pt")
    base = vita.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0)
    ad = lora.init_lora(torch.Generator().manual_seed(23), base["llm"], lcfg)
    for grp, name in lora.LORA_TARGETS:
        ad["layers"][grp][name]["b"] += 0.05
    save_state(str(tmp_path / "ad"), 0, ad)
    overlays = ["--pretrain-mm-adapter", str(tmp_path / "mm"), "--whale-init",
                str(tmp_path / "final.pt"), "--lora-from", str(tmp_path / "ad"), "--lora-rank",
                "4", "--lora-alpha", "8", "--device", "cpu"]
    starts = []
    _recording_init(monkeypatch, trainer.Trainer, starts, _port_host)
    chat = _chat(tmp_path)
    assert cli.main(_cli_argv(chat, str(tmp_path / "run"), *overlays)) == 0
    assert cli.main(_cli_argv(chat, str(tmp_path / "run_mesh"), *overlays,
                              "--mesh", "1", "1", "1", "1")) == 0
    out = capsys.readouterr().out
    assert out.count("1 unknown keys ignored") == 2 and out.count("[done] 1 steps") == 2
    want = checkpoint.load_adapter_into(base, str(tmp_path / "mm"))
    want = checkpoint.load_whale_torch_checkpoint(want, str(tmp_path / "final.pt"))
    want = _port_host(lora.merge_lora(want, ad, lcfg))
    for got in starts:
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert torch.equal(got[path], w), path
    assert torch.equal(want[("vision_proj", "fc1_w")], other["vision_proj"]["fc1_w"])
