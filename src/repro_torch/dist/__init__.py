"""Distribution of the port: the cluster-sharded JUNO index,
checkpointing, fault tolerance and gradient compression.

Ports of ``repro/dist``: the distributed index (``distributed_index.py``:
the cluster dimension split over shards, one ``torch.device`` a shard,
searched shard by shard in one process and merged exactly),
``checkpoint`` (step-numbered atomic checkpoints in the reference's
on-disk layout), ``fault_tolerance`` (the step watchdog and the
crash-restart loop) and ``compression`` (bf16 cast-through, int8 with
error feedback). The activation sharding of ``repro/dist/sharding.py`` is
ROADMAP queue 1 item 2.4.
"""
from . import checkpoint, compression, fault_tolerance  # noqa: F401
from .distributed_index import (DistributedMutableIndex,  # noqa: F401
                                make_distributed_search, shard_index)
