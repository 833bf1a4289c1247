"""PyTorch port: the Generator path against the JAX package, same weights
(vita_tpu_torch.convert.from_jax_params), greedy decoding: the linear-cache
decode_chunk, Generator token streams (text and image+audio, prefill dense
or gmm, decode dense or gather, a stop sequence) and the CLI's prompt
construction (its prompt builders against the reference's). The JAX side runs as its own suite runs it on the CPU
(attn_backend 'xla'; gmm and gather through their CPU paths)."""

import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import close, normal, t, write_tiny_tokenizer
from vita_tpu import cli as j_cli
from vita_tpu import generate as j_gen
from vita_tpu import sampling as j_sampling
from vita_tpu.models import mixtral as j_mix
from vita_tpu.models import vita as j_vita
from vita_tpu_torch import checkpoint, cli, generate, sampling, tokenization
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import mixtral, vita

BUCKETS = (32, 64)


@pytest.fixture(scope="module")
def models():
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    return jcfg, jp, tcfg, from_jax_params(jax.device_get(jp), tcfg)


def _text(rng, n):
    return dict(input_ids=rng.integers(3, 512, n).astype(np.int32))


def _image_audio(cfg, rng, frames=60):
    n_img, n_aud = cfg.image_tokens_per_group, tokenization.audio_token_count(frames)
    s = n_img + n_aud + 10
    ids = rng.integers(3, 512, s).astype(np.int32)
    im, am = np.zeros(s, bool), np.zeros(s, bool)
    im[4:4 + n_img] = True
    am[4 + n_img:4 + n_img + n_aud] = True
    ids[im | am] = 0
    return dict(input_ids=ids, image_mask=im, audio_mask=am, images=normal(rng, 1, 56, 56, 3),
                speech=normal(rng, frames, 80), speech_length=frames)


def _generate(models, prompt, gen_kw, **gen_opts):
    """(JAX tokens, port tokens) of the same prompt; each side's on_token
    stream must equal its result."""
    jcfg, jp, tcfg, tp = models
    out = []
    for mod, params, cfg in ((j_gen, jp, jcfg), (generate, tp, tcfg)):
        g = mod.Generator(params, cfg, max_len=96, chunk_len=4, prompt_buckets=BUCKETS,
                          **gen_opts)
        streamed = []
        toks = g.generate(gen=mod.GenerationConfig(**gen_kw), on_token=streamed.append,
                          **prompt)
        assert streamed == toks
        out.append(toks)
    return out


@pytest.mark.parametrize("media,prefill,decode", [
    ("text", "dense", "dense"), ("text", "gmm", "gather"), ("image_audio", "gmm", "dense"),
    ("image_audio", "dense", "gather"), ("text", "sort", "capacity"),
])
def test_generator_greedy_tokens_match_jax(models, media, prefill, decode):
    rng = np.random.default_rng(0)
    prompt = _text(rng, 21) if media == "text" else _image_audio(models[2], rng)
    want, got = _generate(models, prompt, dict(max_new_tokens=11, eos_id=-1),
                          prefill_moe_mode=prefill, decode_moe_mode=decode)
    assert got == want and len(got) == 11


def test_generator_stop_sequence_and_eos(models):
    rng = np.random.default_rng(1)
    prompt = _text(rng, 9)
    _, full = _generate(models, prompt, dict(max_new_tokens=12, eos_id=-1))
    stop = (tuple(full[3:5]),)
    want, got = _generate(models, prompt, dict(max_new_tokens=12, eos_id=-1,
                                               stop_sequences=stop))
    assert got == want == full[:5]
    want, got = _generate(models, prompt, dict(max_new_tokens=12, eos_id=full[6]))
    assert got == want == full[:full.index(full[6]) + 1]


def test_generator_buckets_and_guards(models):
    jcfg, jp, tcfg, tp = models
    for max_len in (300, 256, 100):
        assert (generate.Generator(tp, tcfg, max_len=max_len).prompt_buckets
                == j_gen.Generator(jp, jcfg, max_len=max_len).prompt_buckets)
    g = generate.Generator(tp, tcfg, max_len=64, prompt_buckets=BUCKETS)
    with pytest.raises(ValueError, match="cache capacity"):
        g.generate(np.arange(60, dtype=np.int32), gen=generate.GenerationConfig(max_new_tokens=8))
    for kw in (dict(decode_moe_mode="gmm"), dict(prefill_moe_mode="gather")):
        with pytest.raises(ValueError, match="bad"):
            generate.Generator(tp, tcfg, **kw)
    assert dataclasses.asdict(generate.GenerationConfig()) == dataclasses.asdict(
        j_gen.GenerationConfig())


def test_stop_helpers_match_jax():
    enc = j_cli.ByteTokenizer().encode
    kws = ["</s>", "Human:", "x"]
    assert (generate.stop_sequences_from_keywords(kws, enc, bos_id=1)
            == j_gen.stop_sequences_from_keywords(kws, enc, bos_id=1))
    for toks, seqs in (([1, 2, 3], ((2, 3),)), ([1, 2, 3], ((1, 2),)), ([3], ((2, 3),)),
                       ([4, 5], ((), (5,)))):
        assert generate.ends_with_stop(toks, seqs) == j_gen.ends_with_stop(toks, seqs)


@pytest.mark.parametrize("moe_mode", ["dense", "gather"])
def test_decode_chunk_linear_cache(models, moe_mode):
    """Three decode steps over a linear cache: slot 1 is inactive (writes
    at max_len, dropped; attends nothing), the returned cache carries the
    advanced positions, and the cache is updated in place."""
    jcfg, jp, _, tp = models
    jc = dataclasses.replace(jcfg.llm, moe_mode=moe_mode)
    tc = dataclasses.replace(vita.VITAConfig.tiny().llm, moe_mode=moe_mode)
    rng = np.random.default_rng(2)
    shape = (jc.n_layers, 2, 24, jc.n_kv_heads, jc.head_dim)
    k, v = normal(rng, *shape), normal(rng, *shape)
    tok = np.array([7, 9], np.int32)
    pos = np.array([10, 4], np.int32)
    active = np.array([True, False])
    knobs = (np.zeros(2, np.float32), np.zeros(2, np.int32), np.ones(2, np.float32))
    tk, tv = t(k), t(v)
    cache, toks, nxt = sampling.decode_chunk(
        tp["llm"], {"k": tk, "v": tv, "pos": t(pos)}, t(tok), t(pos), t(active),
        *map(t, knobs), torch.Generator().manual_seed(0), llm_cfg=tc, chunk_len=3,
        sampling_mode="greedy")
    jcache, jtoks, jnxt, _ = j_sampling.decode_chunk(
        jp["llm"], {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)},
        jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active), *map(jnp.asarray, knobs),
        jax.random.PRNGKey(0), llm_cfg=jc, chunk_len=3, sampling_mode="greedy")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(cache["pos"].numpy(), pos + 3)
    assert cache["k"] is tk
    close(tk, jcache["k"])
    close(tv, jcache["v"])
    np.testing.assert_array_equal(tk[:, 1].numpy(), k[:, 1])  # inactive: untouched


def test_linear_cache_init_matches_jax(models):
    jcfg, _, tcfg, _ = models
    got = mixtral.init_kv_cache(tcfg.llm, 2, 16)
    want = j_mix.init_kv_cache(jcfg.llm, 2, 16)
    for name in ("k", "v", "pos"):
        assert tuple(got[name].shape) == want[name].shape and not got[name].any()
    assert got["pos"].dtype == torch.int32 and got["k"].dtype == tcfg.llm.dtype


def _png(path):
    from PIL import Image

    rgb = (np.random.default_rng(3).random((40, 60, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(path)
    return str(path)


def _wav(path, seconds=0.5, rate=16000):
    pcm = (np.sin(np.arange(int(seconds * rate)) * 0.05) * 8000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    path.write_bytes(buf.getvalue())
    return str(path)


def _prompt_tokens(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("[prompt tokens]"))
    return int(line.split()[2])


@pytest.mark.parametrize("media", ["text", "image", "audio"])
def test_cli_prompt_tokens_match_jax(media, tmp_path, monkeypatch, capsys):
    """Both CLIs on the CPU, tiny-random: the same expanded prompt length."""
    from vita_tpu.parallel import distributed

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(distributed, "enable_compile_cache", lambda *a, **k: None)
    args = {"text": ["--question", "Hello there"],
            "image": ["--image", _png(tmp_path / "x.png"), "--question", "What is it?"],
            "audio": ["--audio", _wav(tmp_path / "q.wav")]}[media]
    common = ["--model", "tiny-random", "--max-new-tokens", "3", "--max-len", "1024",
              "--chunk-len", "2", *args]
    counts = []
    for main, extra in ((j_cli.main, []), (cli.main, ["--device", "cpu"])):
        assert main(common + extra) == 0
        counts.append(_prompt_tokens(capsys.readouterr().out))
    assert counts[0] == counts[1] > 10


@pytest.mark.parametrize("modality", ["lang", "image", "video"])
@pytest.mark.parametrize("has_audio", [False, True])
def test_cli_prompt_builders_match_jax(modality, has_audio):
    from vita_tpu import tokenization as j_tok

    tok = cli.ByteTokenizer()
    for question in ("Hello there", "", "two\nlines", "an <image> inside"):
        try:
            want = j_cli.build_prompt(question, modality, has_audio)
        except ValueError:
            with pytest.raises(ValueError):
                cli.build_prompt(question, modality, has_audio)
            continue
        assert cli.build_prompt(question, modality, has_audio) == want
        ids = tokenization.tokenize_multimodal(want, tok.encode, bos_id=tok.bos_id)
        assert ids == j_tok.tokenize_multimodal(want, tok.encode, bos_id=tok.bos_id)
        counts = ([3] * ids.count(tokenization.IMAGE_TOKEN_INDEX),
                  [5] * ids.count(tokenization.AUDIO_TOKEN_INDEX))
        expanded = tokenization.expand_media_sentinels(ids, *counts)
        assert expanded == j_tok.expand_media_sentinels(ids, *counts)
        for got, ref in zip(tokenization.media_masks(np.array(expanded)),
                            j_tok.media_masks(np.array(expanded))):
            np.testing.assert_array_equal(got, ref)
        if counts[0] or counts[1]:
            bad = (counts[0][1:], counts[1]) if counts[0] else (counts[0], counts[1] + [2])
            for fn in (tokenization.expand_media_sentinels, j_tok.expand_media_sentinels):
                with pytest.raises(ValueError, match="slot_counts"):
                    fn(ids, *bad)
    text = "h\u00e9llo"
    assert tok.encode(text) == j_cli.ByteTokenizer().encode(text)
    assert tok.decode(tok.encode(text)) == j_cli.ByteTokenizer().decode(tok.encode(text))


def test_cli_unported_options_raise(tmp_path):
    """A mesh larger than the one-process world raises, with two axes and
    with three (--mesh EXPERT MODEL PIPE is ported: A11c), as do a fourth
    axis and a size of 0. A directory is loaded now (A9): one without a
    checkpoint raises, and one with a checkpoint but no tokenizer raises
    rather than fall back to the byte tokenizer."""
    with pytest.raises(FileNotFoundError):
        cli.main(["--model", str(tmp_path), "--question", "hi", "--device", "cpu"])
    cfg = vita.VITAConfig.tiny()
    checkpoint.export_hf_vita_checkpoint(
        str(tmp_path), cfg, vita.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(FileNotFoundError, match="no tokenizer"):
        cli.main(["--model", str(tmp_path), "--question", "hi", "--device", "cpu"])
    with pytest.raises(ValueError, match="does not cover 1 ranks"):
        cli.main(["--model", "tiny-random", "--question", "hi", "--device", "cpu",
                  "--mesh", "1", "1", "2"])
    for bad in (["1", "1", "1", "1"], ["1", "0"]):
        with pytest.raises(ValueError, match="--mesh"):
            cli.main(["--model", "tiny-random", "--question", "hi", "--device", "cpu",
                      "--mesh", *bad])
    with pytest.raises(ValueError, match="does not cover 1 ranks"):
        cli.main(["--model", "tiny-random", "--question", "hi", "--device", "cpu",
                  "--mesh", "2", "2"])


@pytest.fixture()
def offline_hub(monkeypatch):
    """transformers and huggingface_hub in offline mode: a tokenizer comes
    from local files only."""
    import huggingface_hub.constants
    import transformers.utils.hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)


@pytest.mark.parametrize("media", ["text", "image"])
def test_cli_checkpoint_directory_matches_jax(media, tmp_path, monkeypatch, capsys, offline_hub):
    """Both CLIs on the CPU on one directory the port exported, with a
    tokenizer saved beside the weights: the same prompt ids reach the
    Generator, and it returns the same greedy tokens."""
    from vita_tpu.parallel import distributed

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(distributed, "enable_compile_cache", lambda *a, **k: None)
    cfg = vita.VITAConfig.tiny()
    ckpt = tmp_path / "ckpt"
    checkpoint.export_hf_vita_checkpoint(
        str(ckpt), cfg, vita.init_params(cfg, torch.Generator().manual_seed(4), "cpu"))
    write_tiny_tokenizer(ckpt)
    calls = {}
    for name, cls in (("jax", j_gen.Generator), ("port", generate.Generator)):
        def recording(self, ids, *a, _real=cls.generate, _name=name, **kw):
            out = _real(self, ids, *a, **kw)
            calls[_name] = (np.asarray(ids).tolist(), list(out))
            return out

        monkeypatch.setattr(cls, "generate", recording)
    args = {"text": ["--question", "Hello there What is it ?"],
            "image": ["--image", _png(tmp_path / "x.png"), "--question", "What is it ?",
                      "--max-patches", "2"]}[media]
    common = ["--model", str(ckpt), "--max-new-tokens", "6", "--max-len", "1024",
              "--chunk-len", "2", *args]
    outs = []
    for main, extra in ((j_cli.main, []), (cli.main, ["--device", "cpu"])):
        assert main(common + extra) == 0
        outs.append(capsys.readouterr().out)
    assert calls["port"] == calls["jax"]
    ids, tokens = calls["port"]
    assert len(tokens) == 6 and ids[0] == 1 and len(ids) == _prompt_tokens(outs[1])
    assert _prompt_tokens(outs[0]) == _prompt_tokens(outs[1])
    assert outs[1].split("=" * 40)[1] == outs[0].split("=" * 40)[1]  # the decoded text
