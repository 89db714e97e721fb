"""Distribution of the port: the cluster-sharded JUNO index.

Port of ``repro/dist``'s distributed index (``distributed_index.py``):
the cluster dimension split over shards, one ``torch.device`` a shard,
searched shard by shard in one process and merged exactly.
"""
from .distributed_index import (DistributedMutableIndex,  # noqa: F401
                                make_distributed_search, shard_index)
