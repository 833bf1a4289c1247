"""Multi-rank serving and training over torch.distributed
(vita_tpu.parallel).

SPMD in PyTorch's idiom: one process per rank, each holding only its
local shards, with explicit collectives over the ``DeviceMesh`` subgroup
of each axis (``mesh``). ``distributed`` starts the process group and
splits it into serving replicas, ``sharded_ops`` runs the kernels per
shard, ``ring_attention`` runs exact attention over a ``seq`` axis,
``pipeline`` runs the layer stack as stages over a ``pipe`` axis (GPipe,
pipelined prefill and the decode ring) and ``pp_serving`` the Engine's
pipeline programs, ``fsdp`` shards training over the ``data`` and
``fsdp`` axes (ZeRO-3), ``launch`` starts a group of ranks on one host.
Training takes every axis (data, fsdp, expert, model, pipe and sequence,
``seq``, cacheless); serving every axis but ``seq`` (a KV cache holds
whole sequences), with the batch whole on every rank of ``data`` and
``fsdp``.
"""
