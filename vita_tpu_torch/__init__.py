"""vita_tpu_torch: the VITA serving path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``vita_tpu`` is the reference; this package keeps its
module names and public layouts so the two can be held against each
other. It imports torch and never jax, and loads no module of
``vita_tpu``: prompt building and tokenization stay there and run before
a Request is built (see ``vita_tpu_torch.tokenization``).
"""
