"""Multi-rank serving over torch.distributed (vita_tpu.parallel).

SPMD in PyTorch's idiom: one process per rank, each holding only its
local shards, with explicit collectives over the ``DeviceMesh`` subgroup
of each axis (``mesh``). ``distributed`` starts the process group and
splits it into serving replicas, ``sharded_ops`` runs the kernels per
shard, ``ring_attention`` runs exact attention over a ``seq`` axis,
``pipeline`` runs the layer stack as stages over a ``pipe`` axis (GPipe,
pipelined prefill and the decode ring) and ``pp_serving`` the Engine's
pipeline programs, ``launch`` starts a group of ranks on one host.
Tensor (``model``), expert (``expert``), sequence (``seq``, cacheless)
and pipeline (``pipe``) parallelism are ported; data/fsdp (A11d)
parallelism raises NotImplementedError naming its ROADMAP item.
"""
