"""Online serving of the port: the engine over a resident index (``ann``),
over a memory-mapped artifact (``paged``) and the replica fleet with
routing, admission and failover (``fleet``)."""
from .ann import AnnRequest, AnnServeEngine  # noqa: F401
from .fleet import (AnnServeFleet, FleetRequest,  # noqa: F401
                    LatencyHistogram, Rejection)
from .paged import (ClusterCache, PagedAnnServeEngine,  # noqa: F401
                    PagedIndexData, PagedJunoIndex)
