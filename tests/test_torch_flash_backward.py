"""PyTorch port: flash_mha's gradients (the autograd Function's plain
backward on the CPU) against ``jax.grad`` of the JAX Pallas flash kernel
in interpret mode, which runs its backward kernels (_bwd_dq_kernel,
_bwd_dkv_kernel). The CUDA kernels against the plain versions are in
test_torch_kernels.py.

Every q row sees at least one key: JAX masks with a finite -1e30, so on a
row without keys its gradient differs by design (ROADMAP section C); the
port gives such rows zero gradient, checked here on its own.

Tolerance: float32, atol = rtol = 1e-4 (the sums run in another order);
bfloat16, atol = rtol = 2e-2, the bf16 tolerance of the kernel tests. In
bf16 both sides round p and ds to bf16 before the second products, as the
Pallas kernels do; the largest error over these cases is 1.56e-2 (dk),
one bf16 step at gradients of 2-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import flash_attention as j_flash
from vita_tpu_torch.ops import flash_attention as flash

# (B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal); blocks of 16 on the JAX
# side, so 20/30 rows make uneven last blocks
CASES = {
    "causal_gqa_per_row_offset": (2, 20, 30, 4, 2, [30, 25], [10, 5], True),
    "kv_len_padding": (2, 16, 32, 2, 2, [32, 19], [16, 3], True),
    "bidirectional_padding_uneven": (2, 20, 30, 4, 1, [30, 11], [0, 0], False),
    "causal_scalar_offset_0": (1, 24, 24, 4, 2, [24], [0], True),
}


DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
# the float32 cases keep their plain ids
GRAD_PARAMS = ([pytest.param(c, "float32", id=c) for c in sorted(CASES)]
               + [pytest.param(c, "bfloat16", id=f"bf16_{c}") for c in sorted(CASES)])


def _grads_jax(q, k, v, do, kv_len, q_off, causal, dtype=jnp.float32):
    do = jnp.asarray(do, dtype)

    def f(q, k, v):
        o = j_flash.flash_mha(q, k, v, kv_len=jnp.asarray(kv_len, jnp.int32),
                              q_offset=jnp.asarray(q_off, jnp.int32), causal=causal,
                              block_q=16, block_k=16)
        return jnp.sum(o * do)

    with pltpu.force_tpu_interpret_mode():
        return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x, dtype) for x in (q, k, v)))


def _grads_torch(q, k, v, do, kv_len, q_off, causal, dtype=torch.float32):
    leaves = [t(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = flash.flash_mha(*leaves, kv_len=t(kv_len, torch.int32), q_offset=t(q_off, torch.int32),
                        causal=causal)
    (o * t(do).to(dtype)).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("case,dtype", GRAD_PARAMS)
def test_flash_grads_match_jax_kernels(case, dtype):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = CASES[case]
    t_dtype, j_dtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, do = normal(rng, b, sq, hq, 128), normal(rng, b, sq, hq, 128)
    k, v = normal(rng, b, skv, hkv, 128), normal(rng, b, skv, hkv, 128)
    got = _grads_torch(q, k, v, do, kv_len, q_off, causal, t_dtype)
    want = _grads_jax(q, k, v, do, kv_len, q_off, causal, j_dtype)
    for g, w in zip(got, want):
        assert g.dtype == t_dtype
        close(g.float(), np.asarray(w, np.float32), atol=tol, rtol=tol)


def test_flash_backward_runs_plain_versions_and_no_autograd_graph():
    """On CPU tensors the Function runs flash_fwd_plain and the plain
    backward: its gradients equal those of autograd through the einsums of
    a plain masked softmax, and lse matches logsumexp."""
    rng = np.random.default_rng(1)
    q, k, v = normal(rng, 1, 9, 4, 16), normal(rng, 1, 13, 2, 16), normal(rng, 1, 13, 2, 16)
    lens, offs = t([11], torch.int32), t([3], torch.int32)
    o, lse = flash.flash_fwd_plain(t(q), t(k), t(v), lens, offs, True, 0.25)
    s, mask = flash._scores(t(q), t(k), lens, offs, True, 0.25)
    close(lse, torch.logsumexp(s, -1).reshape(1, 4, 9), atol=1e-5, rtol=1e-5)

    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    flash.flash_mha(*leaves, kv_len=lens, q_offset=offs, causal=True, scale=0.25).sum().backward()
    ref = [t(x).requires_grad_() for x in (q, k, v)]
    s, _ = flash._scores(ref[0], ref[1], lens, offs, True, 0.25)
    p = torch.softmax(s, -1)
    torch.einsum("bgrqk,bkgd->bqgrd", p, ref[2]).sum().backward()
    for g, w in zip(leaves, ref):
        close(g.grad, w.grad, atol=1e-5, rtol=1e-5)


def test_flash_rows_without_keys_get_no_gradient():
    rng = np.random.default_rng(2)
    q, k, v = normal(rng, 1, 6, 2, 128), normal(rng, 1, 8, 2, 128), normal(rng, 1, 8, 2, 128)
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = flash.flash_mha(*leaves, q_offset=t([-2], torch.int32), causal=True)
    _, lse = flash.flash_fwd_plain(*[t(x) for x in (q, k, v)], t([8], torch.int32),
                                   t([-2], torch.int32), True, 128 ** -0.5)
    assert torch.isinf(lse[0, :, :2]).all() and torch.isfinite(lse[0, :, 2:]).all()
    o.sum().backward()
    assert not leaves[0].grad[:, :2].any() and leaves[0].grad[:, 2:].any()
    assert torch.isfinite(leaves[1].grad).all() and torch.isfinite(leaves[2].grad).all()
