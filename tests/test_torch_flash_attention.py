"""PyTorch port: flash_mha (plain version on the CPU) against the JAX Pallas
flash kernel in interpret mode. The CUDA kernel against the plain version
is in test_torch_kernels.py."""

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


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_plain_matches_jax_kernel(case):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = normal(rng, b, sq, hq, 128), normal(rng, b, skv, hkv, 128), normal(rng, b, skv, hkv, 128)
    got = flash.flash_mha(t(q), t(k), t(v), kv_len=t(kv_len, torch.int32),
                          q_offset=t(q_off, torch.int32), causal=causal)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash.flash_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_len=jnp.asarray(kv_len, jnp.int32), q_offset=jnp.asarray(q_off, jnp.int32),
            causal=causal, block_q=16, block_k=16,
        )
    close(got, want)


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
