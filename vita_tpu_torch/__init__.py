"""vita_tpu_torch: VITA in PyTorch (serving and the three-stage trainer),
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``vita_tpu`` is the reference; this package keeps its
module names and public layouts so the two can be held against each
other. It imports torch and never jax, and loads no module of
``vita_tpu``: the framework-free host code it needs (constants, the
mixtral_two template, tokenization helpers, the data pipeline) is copied
into it, and the tests hold the copies equal to the originals.
"""
