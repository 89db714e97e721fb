"""Online serving of the port: the engine over a resident index (``ann``)
and over a memory-mapped artifact (``paged``)."""
from .ann import AnnRequest, AnnServeEngine  # noqa: F401
from .paged import (ClusterCache, PagedAnnServeEngine,  # noqa: F401
                    PagedIndexData, PagedJunoIndex)
