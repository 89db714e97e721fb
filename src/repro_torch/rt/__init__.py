"""The RT prefilter of the port (``repro.rt``): the centroid cell grid,
the query radius, the survivor mask, the router's probe budget and the
reach update after inserts. The sphere test itself is the
``sphere_hits`` kernel (``kernels/``)."""
from .grid import (CentroidGrid, build_grid, grid_from_arrays,  # noqa: F401
                   grid_to, load_grid, probe_budget, query_radius,
                   routing_state, save_grid, survivor_mask,
                   update_radii)
