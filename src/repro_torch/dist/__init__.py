"""Distribution of the port: activation sharding, the cluster-sharded
JUNO index, checkpointing, fault tolerance and gradient compression.

Ports of ``repro/dist``: the distributed index (``distributed_index.py``:
the cluster dimension split over shards, one ``torch.device`` a shard,
searched shard by shard in one process and merged exactly),
``checkpoint`` (step-numbered atomic checkpoints in the reference's
on-disk layout), ``fault_tolerance`` (the step watchdog and the
crash-restart loop), ``compression`` (bf16 cast-through, int8 with
error feedback) and ``sharding`` (the process-global registry of a
``DeviceMesh`` and the batch/SP policy: data, tensor, sequence and expert
parallelism of the model's train step, every helper an identity while
no mesh is registered; checkpoints of its DTensor state restore onto
another mesh).

Mesh axes convention (shared with ``launch/mesh.py``): "pod" the
outermost data-parallel axis (multi-pod meshes only), "data" data
parallel / FSDP, "model" tensor/expert/sequence parallel.
"""
from . import (checkpoint, compression, fault_tolerance,  # noqa: F401
               sharding)
from .distributed_index import (DistributedMutableIndex,  # noqa: F401
                                make_distributed_search, shard_index)
