"""Online serving of the port: the engine over a resident index (``ann``),
over a memory-mapped artifact (``paged``), the replica fleet with
routing, admission and failover (``fleet``), and the LM's continuous
batching decode engine (``engine``)."""
from .ann import AnnRequest, AnnServeEngine  # noqa: F401
from .engine import Request, ServeEngine  # noqa: F401
from .fleet import (AnnServeFleet, FleetRequest,  # noqa: F401
                    LatencyHistogram, Rejection)
from .paged import (ClusterCache, PagedAnnServeEngine,  # noqa: F401
                    PagedIndexData, PagedJunoIndex)
