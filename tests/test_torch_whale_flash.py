"""PyTorch port: Whale's flash path (WhaleConfig.attn_backend='flash',
B1 at head dim hd + 1) and B1 below head dim 128. On the CPU the flash
branch runs B1's plain version; it is held against the JAX package's
flash branch in Pallas interpret mode and against the port's own 'xla'
branch, on the rows that see a key (float32, tolerance 1e-4). The
streaming step and chunk-masked forwards keep the softmax path. The
checkpoint writes the backend both ways. (On a card, B1 below head dim
128 is held by tests/test_torch_kernels.py.)"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_util  # noqa: F401  (pins torch threads)
from torch_port_util import close, normal, t
from vita_tpu import checkpoint as j_ckpt
from vita_tpu.models import vita as j_vita
from vita_tpu.models import whale as j_whale
from vita_tpu_torch import checkpoint
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita, whale
from vita_tpu_torch.ops import flash_attention as fa


def _whale(backend, **kw):
    jcfg = j_whale.WhaleConfig.tiny(attn_backend=backend, **kw)
    tcfg = whale.WhaleConfig.tiny(attn_backend=backend, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """JAX Whale tiny weights with nonzero biases (pos_bias_u/v already
    random), and the same as port tensors."""
    jcfg, _ = _whale("xla")
    jp = j_whale.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jp["layers"] = {k: (jnp.asarray(0.1 * normal(rng, *v.shape)) if k.endswith("_b") else v)
                    for k, v in jp["layers"].items()}
    return jp, jax.tree.map(lambda a: t(np.asarray(a)), jp)


def _inputs(seed, lengths=(200, 131), frames=200):
    rng = np.random.default_rng(seed)
    return normal(rng, len(lengths), frames, 80), np.asarray(lengths, np.int32)


def test_flash_matches_jax_flash_and_xla(weights):
    """Port flash vs JAX flash (interpret mode) and vs the port's xla
    branch, on valid rows; a padded batch row's invalid keys are masked."""
    jp, tp = weights
    speech, lens = _inputs(1)
    jcfg, tcfg = _whale("flash")
    got, valid = whale.forward(tp, tcfg, t(speech), t(lens))
    with pltpu.force_tpu_interpret_mode():
        want, jvalid = j_whale.forward(jp, jcfg, jnp.asarray(speech), jnp.asarray(lens))
    v = np.asarray(jvalid)
    assert np.array_equal(valid.numpy(), v) and not v.all()
    close(got.numpy() * v[..., None], np.asarray(want) * v[..., None])
    xla, _ = whale.forward(tp, _whale("xla")[1], t(speech), t(lens))
    close(got.numpy() * v[..., None], xla.numpy() * v[..., None])


def test_flash_bf16_matches_xla(weights):
    """bf16 weights and activations: flash vs xla on valid rows within
    bf16's 2e-2 (both round q, k, v and p to bf16, in other orders)."""
    _, tp = weights
    tpb = jax.tree.map(lambda x: x if x.dtype == torch.float32 and x.ndim == 1 and
                       x.shape[0] == 80 else x.to(torch.bfloat16), tp)
    speech, lens = _inputs(2)
    outs = [whale.forward(tpb, _whale(b, dtype=torch.bfloat16)[1], t(speech), t(lens))
            for b in ("flash", "xla")]
    v = outs[0][1].numpy()[..., None]
    close(outs[0][0].float().numpy() * v, outs[1][0].float().numpy() * v, atol=2e-2, rtol=2e-2)


def test_flash_leaves_chunk_masked_and_streaming_paths_alone(weights, monkeypatch):
    """With a chunk mask, or in streaming_step, the flash config runs the
    softmax path: the same output as 'xla', and flash_mha is never called."""
    _, tp = weights
    calls = []
    monkeypatch.setattr(whale, "flash_mha", lambda *a, **k: calls.append(1))
    speech, lens = _inputs(3, lengths=(120,), frames=120)
    mask = torch.as_tensor(whale.chunk_mask(whale.subsampled_length(120), 8))
    outs = [whale.forward(tp, _whale(b)[1], t(speech), t(lens), attn_chunk_mask=mask)[0]
            for b in ("flash", "xla")]
    assert torch.equal(outs[0], outs[1])
    steps = []
    for b in ("flash", "xla"):
        cfg = _whale(b)[1]
        state = whale.streaming_init(cfg, 1, 32, left_context=16)
        h, _, _ = whale.streaming_step(tp, cfg, state, t(speech[:, :32]))
        steps.append(h)
    assert torch.equal(steps[0], steps[1]) and not calls


def test_flash_gradients_match_xla(weights):
    """A Whale tower that trains under 'flash': gradients of every layer
    weight equal the xla branch's at 1e-4 (B1's backward plain versions on
    the CPU, with the head dim 9 sliced back)."""
    _, tp = weights
    speech, lens = _inputs(4, lengths=(100, 77), frames=100)
    grads = []
    for b in ("flash", "xla"):
        p = jax.tree.map(lambda x: x.clone().requires_grad_(), tp)
        out, valid = whale.forward(p, _whale(b)[1], t(speech), t(lens))
        (out * valid[..., None]).square().sum().backward()
        grads.append({k: v.grad for k, v in p["layers"].items()})
    for k in grads[1]:
        close(grads[0][k], grads[1][k], atol=1e-4, rtol=1e-3)


def test_vita_audio_encode_with_flash_matches_jax():
    """The fused model's audio encoder (Whale flash, then the adapter) on
    JAX's weights through convert.from_jax_params."""
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, audio=dataclasses.replace(jcfg.audio, attn_backend="flash"))
    tcfg = vita.VITAConfig.tiny()
    tcfg = dataclasses.replace(tcfg, audio=dataclasses.replace(tcfg.audio, attn_backend="flash"))
    jp = j_vita.init_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.device_get(jp), tcfg)
    speech, lens = _inputs(5, lengths=(160, 90), frames=160)
    got, gvalid = vita.encode_audio(tp, tcfg, t(speech), t(lens))
    with pltpu.force_tpu_interpret_mode():
        want, wvalid = j_vita.encode_audio(jp, jcfg, jnp.asarray(speech), jnp.asarray(lens))
    v = np.asarray(wvalid)
    assert np.array_equal(gvalid.numpy(), v)
    close(got.numpy() * v[..., None], np.asarray(want) * v[..., None])


@pytest.mark.parametrize("d", [9, 65, 100])
def test_plain_flash_below_128_matches_a_zero_padded_head(d):
    """What the CUDA wrappers compute at d < 128 (q, k, v zero-padded to
    128, o sliced back, the caller's scale) equals the plain version at d,
    forward and backward: the padding is exact."""
    rng = np.random.default_rng(d)
    q, k, v = (t(normal(rng, 2, 20, 4, d)) for _ in range(3))
    kv_len, q_off = torch.tensor([20, 13], dtype=torch.int32), torch.tensor([0, 4],
                                                                          dtype=torch.int32)
    scale = 0.125
    o, lse = fa.flash_fwd_plain(q, k, v, kv_len, q_off, True, scale)
    qp, kp, vp = fa._pad_d(q, k, v)
    assert qp.shape[-1] == fa.KERNEL_D
    op, lsep = fa.flash_fwd_plain(qp, kp, vp, kv_len, q_off, True, scale)
    close(op[..., :d], o, atol=1e-6, rtol=1e-6)
    assert bool((op[..., d:] == 0).all())
    close(lsep, lse, atol=1e-6, rtol=1e-6)
    do = t(normal(rng, 2, 20, 4, d))
    args = (lse, fa.flash_delta(do, o), kv_len, q_off, True, scale)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, *args)
    dqp = fa.flash_bwd_dq_plain(qp, kp, vp, *fa._pad_d(do), *args)
    close(dqp[..., :d], dq, atol=1e-6, rtol=1e-6)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, *args)
    dkp, dvp = fa.flash_bwd_dkv_plain(qp, kp, vp, *fa._pad_d(do), *args)
    close(dkp[..., :d], dk, atol=1e-6, rtol=1e-6)
    close(dvp[..., :d], dv, atol=1e-6, rtol=1e-6)


def test_checkpoint_writes_and_reads_the_backend(tmp_path):
    """config.json carries Whale's attn_backend and the projector kind:
    the port's file reads in the JAX package and the JAX package's in the
    port, fields intact."""
    tcfg = vita.VITAConfig.tiny(vision_projector="spp_v1")
    tcfg = dataclasses.replace(tcfg, audio=dataclasses.replace(tcfg.audio, attn_backend="flash"))
    raw = json.loads(json.dumps(checkpoint.config_to_json(tcfg)))
    assert raw["audio"]["attn_backend"] == "flash"
    jcfg = j_ckpt._config_from_json(raw)
    assert jcfg.audio.attn_backend == "flash" and jcfg.vision_projector == "spp_v1"
    back = checkpoint._config_from_json(json.loads(json.dumps(j_ckpt.config_to_json(jcfg))))
    assert back == tcfg

