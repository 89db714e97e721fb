"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the wrappers that dispatch between them (``ops``): ``selective_lut``
(stage B), ``fused_two_stage`` (fused H2), ``pq_scan`` (tier H),
``hit_count`` (tiers M/L, composed H2), ``sphere_hits`` (the RT
prefilter: the search's probe mask, and the dense table),
``fused_three_stage`` (fused H2 under the RT prefilter) and
``ivf_filter`` (stage A, and the owning cluster of each inserted point);
``autotune`` picks the two fused scans' launch shapes by measurement."""
