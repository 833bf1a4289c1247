"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs come from numpy and go to both packages; the JAX side stays on the
CPU. Tests that need a CUDA card carry the ``gpu`` marker and call
``cuda_or_skip()`` first, so whether there is a card is decided inside the
test, never while the module is imported.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs several pytest workers

F32_TOL = dict(atol=1e-4, rtol=1e-4)


def t(x, dtype=None):
    """numpy (or jax) array -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def close(got, want, **tol):
    """Assert a torch tensor matches a numpy/jax array (f32 tolerance
    unless stated)."""
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or F32_TOL))


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)
