"""PyTorch port: Whale's streaming encoder (chunk_mask, streaming_step,
the forward with a chunk mask) and serve/streaming_audio against the JAX
package on VITAConfig.tiny(), same weights and numpy inputs from a seed:
the port's step, encoder and frontend equal JAX's in float32 at 1e-5; the
port's streaming output equals its own forward under the matching chunk
mask at the JAX test's 2e-3; StreamingFbank equals fbank exactly. Also the
cases of tests/test_whale_streaming.py and tests/test_streaming_audio.py
on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import close, normal, t
from vita_tpu.models import vita as j_vita
from vita_tpu.models import whale as j_whale
from vita_tpu.serve import streaming_audio as j_sa
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.data.audio import SAMPLE_RATE, fbank
from vita_tpu_torch.models import vita, whale
from vita_tpu_torch.serve.streaming_audio import (
    StreamingAudioFrontend,
    StreamingFbank,
    StreamingWhaleEncoder,
)
from vita_tpu_torch.serve.vad import CHUNK_SAMPLES, StreamingVAD, VADConfig, energy_vad_prob

STREAM_TOL = dict(atol=1e-5, rtol=1e-5)  # port vs JAX, float32
MASK_TOL = dict(atol=2e-3, rtol=2e-3)  # streaming vs forward (the JAX test's)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_vita.VITAConfig.tiny()
    jp = jax.device_get(j_vita.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = vita.VITAConfig.tiny()
    return jcfg, jp, tcfg, from_jax_params(jp, tcfg)


def test_chunk_mask_and_masked_forward_match_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    for args in ((10, 3), (10, 3, 1), (7, 2, 0)):
        np.testing.assert_array_equal(whale.chunk_mask(*args), j_whale.chunk_mask(*args))
    x = normal(np.random.default_rng(0), 2, 120, 80)
    lengths = np.array([120, 90], np.int32)
    mask = whale.chunk_mask(int(whale.subsampled_length(120)), 5, 2)
    got, valid = whale.forward(tp["audio"], tcfg.audio, t(x), t(lengths), t(mask))
    want, jvalid = j_whale.forward(jp["audio"], jcfg.audio, jnp.asarray(x),
                                   jnp.asarray(lengths), attn_chunk_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    m = np.asarray(jvalid)[..., None]
    close(got.numpy() * m, np.asarray(want) * m, **STREAM_TOL)


def test_streaming_step_matches_jax(tiny):
    """Six steps with a left context of 24 (the cache rolls), the last a
    partial flush of 37 frames: features, validity and every state leaf
    (the valid cache rows) equal JAX's."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(1)
    chunk, left = 64, 24
    js = j_whale.streaming_init(jcfg.audio, 1, chunk, left_context=left)
    ts = whale.streaming_init(tcfg.audio, 1, chunk, left_context=left)
    for i in range(6):
        seg = normal(rng, 1, chunk, 80)
        n = chunk if i < 5 else 37
        jf, jv, js = j_whale.streaming_step(jp["audio"], jcfg.audio, js, jnp.asarray(seg),
                                            jnp.int32(n))
        tf, tv, ts = whale.streaming_step(tp["audio"], tcfg.audio, ts, t(seg), n)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        m = np.asarray(jv)
        close(tf.numpy()[m], np.asarray(jf)[m], **STREAM_TOL)
        for k in ("raw_tail", "tail_len", "ctx_len", "pos_offset"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
        c = int(js["ctx_len"])
        for k in ("k", "v"):
            close(ts[k][:, :, :c].numpy(), np.asarray(js[k])[:, :, :c], **STREAM_TOL)
    assert all(isinstance(v, torch.Tensor) for v in ts.values())


def _plan(total, block):
    """Per-step output counts incl. the final partial flush."""
    tail, outs = 0, []
    n_full = total // block
    for i in range(n_full + (1 if total % block else 0)):
        n = block if i < n_full else total - n_full * block
        t_out = max(int(whale.subsampled_length(tail + n)), 0)
        outs.append(t_out)
        tail = min(tail + n - 4 * t_out, whale.TAIL_MAX)
    return outs


def _chunk_causal_mask(outs, full_t):
    bounds = np.cumsum(outs)
    mask = np.zeros((full_t, full_t), bool)
    for qi in range(full_t):
        ci = int(np.searchsorted(bounds, qi, side="right"))
        mask[qi, :bounds[min(ci, len(bounds) - 1)]] = True
    return mask


def test_streaming_encoder_matches_jax_and_its_own_masked_forward(tiny):
    """feed()/finish() over deliveries unaligned with the block: equal to
    JAX's StreamingWhaleEncoder (1e-5), and to the port's forward under the
    chunk-causal mask (2e-3), with the partial flush."""
    jcfg, jp, tcfg, tp = tiny
    block, total = 64, 3 * 64 + 37
    frames = normal(np.random.default_rng(2), total, 80)
    enc = StreamingWhaleEncoder(tp["audio"], tcfg.audio, frame_block=block, left_context=256)
    jenc = j_sa.StreamingWhaleEncoder(jp["audio"], jcfg.audio, frame_block=block,
                                      left_context=256)
    for lo, hi in [(0, 10), (10, 70), (70, 71), (71, 200), (200, total)]:
        enc.feed(frames[lo:hi])
        jenc.feed(frames[lo:hi])
    assert enc.flush_steps_remaining() == jenc.flush_steps_remaining() <= 1
    got = enc.finish()
    close(got, jenc.finish(), **STREAM_TOL)

    outs = _plan(total, block)
    full_t = int(whale.subsampled_length(total))
    mask = _chunk_causal_mask(outs, full_t)
    want, _ = whale.forward(tp["audio"], tcfg.audio, t(frames[None]),
                            torch.tensor([total]), t(mask))
    assert got.shape == (sum(outs), tcfg.audio.hidden)
    close(got, want[0, :sum(outs)].numpy(), **MASK_TOL)


def test_streaming_matches_full_with_chunk_mask(tiny):
    """Four whole blocks through streaming_step against forward with the
    equivalent mask (the JAX test's case)."""
    _, _, tcfg, tp = tiny
    chunk, n_chunks = 64, 4
    speech = normal(np.random.default_rng(3), 1, chunk * n_chunks, 80)
    state = whale.streaming_init(tcfg.audio, 1, chunk, left_context=256)
    outs, parts = [], []
    for i in range(n_chunks):
        feats, valid, state = whale.streaming_step(
            tp["audio"], tcfg.audio, state, t(speech[:, i * chunk:(i + 1) * chunk]))
        n = int(valid[0].sum())
        outs.append(n)
        parts.append(feats[:, :n])
    got = torch.cat(parts, dim=1)
    full_t = int(whale.subsampled_length(chunk * n_chunks))
    want, _ = whale.forward(tp["audio"], tcfg.audio, t(speech), torch.tensor([chunk * n_chunks]),
                            t(_chunk_causal_mask(outs, full_t)))
    close(got.numpy(), want[:, :sum(outs)].numpy(), **MASK_TOL)


def test_streaming_state_shapes_static(tiny):
    _, _, tcfg, tp = tiny
    state = whale.streaming_init(tcfg.audio, 1, 32, left_context=64)
    shapes0 = {k: tuple(v.shape) for k, v in state.items()}
    for i in range(3):
        _, _, state = whale.streaming_step(tp["audio"], tcfg.audio, state,
                                           torch.ones(1, 32, 80) * (i + 1))
    assert {k: tuple(v.shape) for k, v in state.items()} == shapes0


def test_streaming_bounded_context_limits_attention(tiny):
    """With a left context of 16, a perturbed first chunk stops reaching
    the last chunk's outputs."""
    _, _, tcfg, tp = tiny
    chunk, n_chunks = 64, 6
    segs = [normal(np.random.default_rng(10 + i), 1, chunk, 80) for i in range(n_chunks)]

    def run(scale):
        state = whale.streaming_init(tcfg.audio, 1, chunk, left_context=16)
        outs = []
        for i, seg in enumerate(segs):
            feats, valid, state = whale.streaming_step(
                tp["audio"], tcfg.audio, state, t(seg * (scale if i == 0 else 1.0)))
            outs.append(feats[:, :int(valid[0].sum())].numpy())
        return outs

    a, b = run(1.0), run(5.0)
    assert not np.allclose(a[0], b[0])
    np.testing.assert_allclose(a[-1], b[-1], rtol=1e-4, atol=1e-4)


def test_streaming_fbank_matches_batch():
    wav = (np.random.default_rng(0).standard_normal(int(1.7 * SAMPLE_RATE)) * 0.1).astype(
        np.float32)
    want = fbank(wav)
    sf, parts, pos = StreamingFbank(), [], 0
    for size in [3000, 117, 4000, 801, 2560, 10000]:
        parts.append(sf.feed(wav[pos:pos + size]))
        pos += size
    parts.append(sf.feed(wav[pos:]))
    got = np.concatenate(parts, axis=0)
    np.testing.assert_array_equal(got, want)
    assert sf.frames_emitted == want.shape[0]
    jf = j_sa.StreamingFbank()
    np.testing.assert_array_equal(np.concatenate([jf.feed(wav[:5000]), jf.feed(wav[5000:])]),
                                  want)


def test_streaming_encoder_emits_all_subsampled_frames(tiny):
    _, _, tcfg, tp = tiny
    for total in [3, 7, 64, 65, 100, 127, 128, 200]:
        enc = StreamingWhaleEncoder(tp["audio"], tcfg.audio, frame_block=64)
        enc.feed(np.zeros((total, 80), np.float32))
        assert enc.finish().shape[0] == max(int(whale.subsampled_length(total)), 0), total


def _speechlike(n_chunks, freq=180.0, level=0.25):
    tt = np.arange(n_chunks * CHUNK_SAMPLES) / SAMPLE_RATE
    return np.sin(2 * np.pi * freq * tt).astype(np.float32) * level


def _frontend_session(frontend_cls, vad_mod, audio_params, audio_cfg):
    """Silence, a 2.6 s tone, silence, a 2 s tone, silence through one
    frontend; returns (utterances, dispatches of each emitting call)."""
    vad = vad_mod.StreamingVAD(vad_mod.VADConfig(min_silence_ms=500, min_dialog_s=1.0),
                               prob_fn=vad_mod.energy_vad_prob)
    fe = frontend_cls(audio_params, audio_cfg, vad=vad, frame_block=64, left_context=256)
    dispatches = {"n": 0}
    orig = fe.encoder._dispatch

    def counting(block, n_valid):
        dispatches["n"] += 1
        return orig(block, n_valid)

    fe.encoder._dispatch = counting
    silence = [np.zeros(CHUNK_SAMPLES, np.float32)]
    chunks = (silence * 4 + np.split(_speechlike(10), 10) + silence * 6
              + np.split(_speechlike(8, freq=240.0), 8) + silence * 6)
    utts, last = [], []
    for c in chunks:
        before = dispatches["n"]
        out = fe.process(c)
        if out is not None:
            utts.append(out)
            last.append(dispatches["n"] - before)
    return utts, last


def test_frontend_end_to_end_matches_jax(tiny):
    """Two utterances through the VAD frontend: frame accounting is exact,
    end-of-speech owes at most two dispatches, the features equal a fresh
    encoder's over the segment's batch fbank, and JAX's frontend gives the
    same segments and (1e-5) features."""
    from vita_tpu.serve import vad as j_vad
    from vita_tpu_torch.serve import vad
    from vita_tpu_torch.tokenization import audio_token_count

    jcfg, jp, tcfg, tp = tiny
    utts, last = _frontend_session(StreamingAudioFrontend, vad, tp["audio"], tcfg.audio)
    jutts, _ = _frontend_session(j_sa.StreamingAudioFrontend, j_vad, jp["audio"], jcfg.audio)
    assert len(utts) == len(jutts) == 2 and all(n <= 2 for n in last)
    for u, ju in zip(utts, jutts):
        assert u.num_frames == fbank(u.wav).shape[0] == ju.num_frames
        assert u.token_count == audio_token_count(u.num_frames)
        np.testing.assert_array_equal(u.wav, ju.wav)
        close(u.features, ju.features, **STREAM_TOL)
    enc = StreamingWhaleEncoder(tp["audio"], tcfg.audio, frame_block=64, left_context=256)
    enc.feed(fbank(utts[0].wav))
    np.testing.assert_allclose(utts[0].features, enc.finish(), rtol=1e-6, atol=1e-6)


def test_frontend_short_utterance_dropped_resets(tiny):
    _, _, tcfg, tp = tiny
    vad = StreamingVAD(VADConfig(min_silence_ms=500, min_dialog_s=5.0), prob_fn=energy_vad_prob)
    fe = StreamingAudioFrontend(tp["audio"], tcfg.audio, vad=vad)
    chunks = [*np.split(_speechlike(4), 4), *[np.zeros(CHUNK_SAMPLES, np.float32)] * 6]
    assert all(fe.process(c) is None for c in chunks)
    assert fe.encoder.frames_fed == 0


def test_engine_audio_encoded_matches_speech_path(tiny):
    """Pre-encoded Whale features (the batch forward's) give the tokens of
    the raw-fbank speech path."""
    from vita_tpu_torch.constants import AUDIO_TOKEN_INDEX
    from vita_tpu_torch.serve.engine import Engine, Request
    from vita_tpu_torch.tokenization import audio_token_count, expand_media_sentinels, media_masks

    _, _, tcfg, tp = tiny
    t_raw = 95
    feats = normal(np.random.default_rng(7), t_raw, 80)
    expanded = expand_media_sentinels([1, 3, AUDIO_TOKEN_INDEX, 7], [],
                                      [audio_token_count(t_raw)])
    safe, _, am = media_masks(np.array(expanded))
    eng = Engine(tp, tcfg, n_slots=1, max_len=128, decode_chunk_len=2)
    r_speech = Request(input_ids=safe, audio_mask=am, speech=feats, speech_length=t_raw,
                       max_new_tokens=5, eos_id=-1)
    eng.submit(r_speech)
    eng.run_until_idle()
    enc, valid = whale.forward(tp["audio"], tcfg.audio, t(feats[None]), torch.tensor([t_raw]))
    t_sub = int(valid[0].sum())
    r_enc = Request(input_ids=safe, audio_mask=am, audio_encoded=enc[0, :t_sub].numpy(),
                    audio_encoded_length=t_sub, max_new_tokens=5, eos_id=-1)
    eng.submit(r_enc)
    eng.run_until_idle()
    assert r_enc.tokens == r_speech.tokens
