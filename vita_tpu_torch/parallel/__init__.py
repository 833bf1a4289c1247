"""Multi-rank serving over torch.distributed (vita_tpu.parallel).

SPMD in PyTorch's idiom: one process per rank, each holding only its
local shards, with explicit collectives over the ``DeviceMesh`` subgroup
of each axis (``mesh``). ``distributed`` starts the process group and
splits it into serving replicas, ``sharded_ops`` runs the kernels per
shard, ``ring_attention`` runs exact attention over a ``seq`` axis,
``launch`` starts a group of ranks on one host. Tensor (``model``),
expert (``expert``) and sequence (``seq``, cacheless) parallelism are
ported; pipeline (A11c) and data/fsdp (A11d) parallelism raise
NotImplementedError naming their ROADMAP item.
"""
