"""Synthetic centroid grids for the RT prefilter's kernel tests (numpy only,
so the card tests can use them on a machine without JAX).

The grids keep the build's invariants (slot centroids inside their cell's
box, ``cell_reach`` = max slot reach, ``-inf`` reach at pad slots, empty
cells) and every query batch carries the adversarial radii: 0 (point
queries), 1e6 (cover-all), and radii placed on the boundary of a slot's
disc, where ``|qp - cp|^2`` and ``(R + reach)^2`` meet within an ulp, so
the sphere test's rounding decides the hit.
"""
import numpy as np


def synth_grid(seed, g, cap, q, n_probe=1, *, radii="mixed"):
    """A random (g×g)-cell grid with ``cap`` slots a cell and ``q`` queries.

    ``radii`` is "mixed" (a quarter each: 0, cover-all 1e6, the boundary
    of a random real slot, uniform in [0, 0.5]), "full" (every radius
    1e6) or "none" (every radius -1: only probe 0 survives the
    three-stage scan). Returns numpy arrays ``(q0, q1, radius, boxes,
    cell_reach, c0, c1, reach, slot_idx)``; ``slot_idx`` (q, n_probe)
    int32 draws random real slots, as probed clusters' slots are.
    """
    rng = np.random.default_rng(seed)
    n_cells = g * g
    lo = np.stack(np.meshgrid(np.arange(g), np.arange(g), indexing="ij"),
                  -1).reshape(-1, 2) / g
    boxes = np.concatenate([lo, lo + 1.0 / g], 1).astype(np.float32)
    counts = rng.integers(0, cap + 1, n_cells)
    counts[0] = 0                                  # an empty cell
    counts[-1] = cap                               # a full one
    c0 = np.zeros((n_cells, cap), np.float32)
    c1 = np.zeros((n_cells, cap), np.float32)
    reach = np.full((n_cells, cap), -np.inf, np.float32)
    for cell in range(n_cells):
        k = counts[cell]
        u = rng.random((k, 2)).astype(np.float32)
        c0[cell, :k] = boxes[cell, 0] + u[:, 0] / g
        c1[cell, :k] = boxes[cell, 1] + u[:, 1] / g
        reach[cell, :k] = np.abs(rng.normal(0, 0.2, k)).astype(np.float32)
    cell_reach = reach.max(1)
    real = np.flatnonzero(np.isfinite(reach.reshape(-1)))
    q0 = rng.uniform(-0.3, 1.3, q).astype(np.float32)
    q1 = rng.uniform(-0.3, 1.3, q).astype(np.float32)
    if radii == "full":
        radius = np.full(q, 1e6, np.float32)
    elif radii == "none":
        radius = np.full(q, -1.0, np.float32)
    else:
        radius = rng.uniform(0, 0.5, q).astype(np.float32)
        a, b = q // 4, 2 * (q // 4)
        radius[:a] = 0.0
        radius[a:b] = 1e6
        for i in range(b, 3 * (q // 4)):
            j = rng.choice(real)
            d = np.hypot(np.float64(q0[i]) - c0.reshape(-1)[j],
                         np.float64(q1[i]) - c1.reshape(-1)[j])
            radius[i] = np.float32(d - reach.reshape(-1)[j])
    slot_idx = rng.choice(real, (q, n_probe)).astype(np.int32)
    return q0, q1, radius, boxes, cell_reach, c0, c1, reach, slot_idx


def query_radius_spec(tau, scale, radius_scale, radius_bias):
    """The rt search's query radius in numpy, step by step as specified:
    the squares of τ (Q, S) and their sum in float64 in s order, rounded
    once to float32; the square root correctly rounded; then ``scale ·
    radius_scale · root + radius_bias`` in float32, left to right."""
    t = np.asarray(tau, np.float64)
    acc = np.zeros(t.shape[:-1])
    for s in range(t.shape[-1]):
        acc = acc + t[..., s] * t[..., s]
    root = np.sqrt(acc.astype(np.float32).astype(np.float64)).astype(np.float32)
    return (np.float32(scale) * np.float32(radius_scale) * root
            + np.float32(radius_bias)).astype(np.float32)


def probe_inputs(seed, q, n_probe, s, g, cap, *, scale=1.0, boundary=False):
    """Inputs of the rt probe mask over a :func:`synth_grid` grid (pads, an
    empty and a full cell): every real slot one cluster's (``slot_of``),
    random probed clusters, τ (q, n_probe + 1, S) whose probe-0 row the
    search reads. ``boundary`` puts a quarter of the queries' probe 1 on
    its disc's boundary: that slot's reach is the float64 gap from the
    query disc (radius :func:`query_radius_spec`), rounded to float32.
    Returns numpy ``(qp (q, 2), tau, cids (q, n_probe) int64, slot_of (C,)
    int32, c0, c1, reach, radius_scale, radius_bias)``.
    """
    q0, q1, _, _, _, c0, c1, reach, _ = synth_grid(seed, g, cap, q)
    rng = np.random.default_rng(seed + 1)
    real = np.flatnonzero(np.isfinite(reach.reshape(-1)))
    slot_of = rng.permutation(real).astype(np.int32)
    cids = rng.integers(0, real.size, (q, n_probe))
    tau = (np.abs(rng.standard_normal((q, n_probe + 1, s))) * 0.05
           ).astype(np.float32)
    rs, rb = np.float32(0.4), np.float32(-0.02)
    if boundary and n_probe > 1:
        n_b = min(q, real.size) // 4
        cids[:n_b, 1] = rng.permutation(real.size)[:n_b]
        r = query_radius_spec(tau[:, 0], scale, rs, rb)
        flat = reach.reshape(-1)
        for i in range(n_b):
            j = slot_of[cids[i, 1]]
            d = np.hypot(np.float64(q0[i]) - c0.reshape(-1)[j],
                         np.float64(q1[i]) - c1.reshape(-1)[j])
            flat[j] = np.float32(d - np.float64(r[i]))
    return (np.stack([q0, q1], 1), tau, cids, slot_of, c0, c1, reach,
            np.asarray(rs), np.asarray(rb))
