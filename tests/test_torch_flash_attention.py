"""PyTorch port: flash_mha (plain version on the CPU) against the JAX Pallas
flash kernel in interpret mode. The CUDA kernel against the plain version
is in test_torch_kernels.py.

Tolerance: float32, atol = rtol = 1e-4 (sums in another order); bfloat16,
atol = rtol = 2e-2, the bf16 tolerance of the kernel tests. In bf16 both
sides round p to bf16 before the PV product. The JAX side then runs one
key block of 1024, so that Pallas rounds p against the row's max over all
its keys, as the plain version does (with smaller blocks it rounds against
each block's running max, which moves p by up to one bf16 step)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import close, normal, t
from vita_tpu.ops import flash_attention as j_flash
from vita_tpu_torch.ops import flash_attention as flash

# (B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal): every q row sees at least
# one key (the TPU kernel leaves rows with no valid key undefined)
CASES = {
    "causal_gqa_per_row_offset": (2, 24, 40, 8, 2, [40, 33], [16, 9], True),
    "kv_len_padding": (2, 32, 64, 4, 4, [64, 37], [32, 5], True),
    "ragged_sq_skv": (1, 19, 45, 4, 1, [45], [26], True),
    "bidirectional_padding": (2, 20, 30, 4, 2, [30, 11], [0, 0], False),
    "prefill_chunk_over_bucket": (1, 16, 48, 4, 2, [32], [16], True),
}


# bf16 only (the float32 kernel's 16-key blocks would take 100 grid steps
# per row block): keys past one Pallas key block of 1024, where Pallas
# rounds p against each block's running max and the plain version against
# the row's, so the two agree within the tolerance, not exactly; and the
# Generator's decode call, one q row at the end of the cache
BF16_CASES = {
    "keys_past_one_block": (1, 64, 1500, 4, 2, [1500], [1436], True),
    "decode_one_row": (2, 1, 300, 4, 2, [300, 211], [299, 210], True),
}

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4, 16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 1024)}
# the float32 cases keep their plain ids
FWD_PARAMS = ([pytest.param(c, "float32", id=c) for c in sorted(CASES)]
              + [pytest.param(c, "bfloat16", id=f"bf16_{c}")
                 for c in sorted(CASES) + sorted(BF16_CASES)])


@pytest.mark.parametrize("case,dtype", FWD_PARAMS)
def test_flash_plain_matches_jax_kernel(case, dtype):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = {**CASES, **BF16_CASES}[case]
    tdt, jdt, tol, block = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v = normal(rng, b, sq, hq, 128), normal(rng, b, skv, hkv, 128), normal(rng, b, skv, hkv, 128)
    got = flash.flash_mha(t(q).to(tdt), t(k).to(tdt), t(v).to(tdt), kv_len=t(kv_len, torch.int32),
                          q_offset=t(q_off, torch.int32), causal=causal)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash.flash_mha(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            kv_len=jnp.asarray(kv_len, jnp.int32), q_offset=jnp.asarray(q_off, jnp.int32),
            causal=causal, block_q=block, block_k=block,
        )
    assert got.dtype == tdt
    close(got.float(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_flash_scalar_offset_and_defaults():
    rng = np.random.default_rng(1)
    q, k, v = normal(rng, 1, 8, 2, 128), normal(rng, 1, 8, 2, 128), normal(rng, 1, 8, 2, 128)
    got = flash.flash_mha(t(q), t(k), t(v), causal=True, q_offset=0, scale=0.3)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=True, scale=0.3, block_q=8, block_k=8)
    close(got, want)


def test_flash_rows_without_keys_are_zero():
    rng = np.random.default_rng(2)
    q, k, v = normal(rng, 1, 4, 2, 128), normal(rng, 1, 8, 2, 128), normal(rng, 1, 8, 2, 128)
    out = flash.flash_mha(t(q), t(k), t(v), kv_len=t([0], torch.int32), causal=False)
    assert torch.count_nonzero(out) == 0
    out = flash.flash_mha(t(q), t(k), t(v), q_offset=t([-2], torch.int32), causal=True)
    assert torch.count_nonzero(out[:, :2]) == 0 and bool((out[:, 2:] != 0).any())


def test_flash_rejects_bad_gqa():
    x = torch.zeros(1, 4, 3, 128)
    with pytest.raises(ValueError, match="multiple"):
        flash.flash_mha(torch.zeros(1, 4, 4, 128), x, x)
