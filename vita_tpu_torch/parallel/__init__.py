"""Multi-rank serving over torch.distributed (vita_tpu.parallel).

SPMD in PyTorch's idiom: one process per rank, each holding only its
local shards, with explicit collectives over the ``DeviceMesh`` subgroup
of each axis (``mesh``). ``distributed`` starts the process group,
``sharded_ops`` runs the kernels per shard, ``launch`` starts a group of
ranks on one host. Tensor (``model``) and expert (``expert``) parallel
serving is ported; sequence (A11b), pipeline (A11c) and data/fsdp (A11d)
parallelism raise NotImplementedError naming their ROADMAP item.
"""
