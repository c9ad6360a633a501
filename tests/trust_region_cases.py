"""Trust-region inputs made with numpy from a seed, shared by the CPU
tests (tests/test_torch_trust_region_search.py) and the card's
(tests/test_torch_cuda.py): the cases of the f32 exact solve and the
cases whose every sum is exact in f32."""

import numpy as np

CASES = ["mixed", "radius_zero", "g_zero", "all_frozen", "infinite_bounds",
         "beyond_every_knot", "duplicate_knots", "negative_zero_tau"]
BOUNDS = ["shared", "rows"]  # bounds and weights (N,) or (B, N)


def case_inputs(case, bounds="shared", rows=3, n=400, seed=0):
    """(c, g, lower, upper, weight, radius) as f32 numpy arrays: c, g
    (rows, n), the bounds and weights (n,) or (rows, n), radius
    (rows,)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if bounds == "shared" else (rows, n)
    lower = np.where(rng.random(shape) < 0.2, -np.inf, -rng.random(shape))
    upper = np.where(rng.random(shape) < 0.2, np.inf, rng.random(shape))
    weight = rng.uniform(0.5, 2.0, shape)
    lo, hi = np.broadcast_to(lower, (rows, n)), np.broadcast_to(upper,
                                                               (rows, n))
    c = np.clip(rng.normal(size=(rows, n)) * 0.5, lo, hi)
    # some components at a finite bound
    c[:, :5] = np.where(np.isfinite(lo[:, :5]), lo[:, :5], c[:, :5])
    g = rng.normal(size=(rows, n))
    radius = np.array([0.05, 0.7, 5.0][:rows] + [1.0] * max(0, rows - 3))
    if case == "radius_zero":
        radius[:] = 0.0
        radius[-1] = -1.0
    elif case == "g_zero":
        g[0] = 0.0
        g[1, ::2] = 0.0
    elif case == "all_frozen":
        at_upper = rng.random((rows, n)) < 0.5
        lower = np.broadcast_to(np.where(np.isinf(lower), -1.0, lower),
                                shape).copy()
        upper = np.broadcast_to(np.where(np.isinf(upper), 1.0, upper),
                                shape).copy()
        lo, hi = np.broadcast_to(lower, (rows, n)), np.broadcast_to(
            upper, (rows, n))
        c = np.where(at_upper, hi, lo)
        g = np.where(at_upper, -np.abs(g), np.abs(g))
    elif case == "infinite_bounds":
        lower = np.broadcast_to(lower, shape).copy()
        upper = np.broadcast_to(upper, shape).copy()
        lower[..., ::2] = -np.inf
        upper[..., ::2] = np.inf
        c = np.clip(c, np.broadcast_to(lower, (rows, n)),
                    np.broadcast_to(upper, (rows, n)))
        radius = np.array([50.0, 500.0, 0.5][:rows] + [1.0] * max(0, rows - 3))
    elif case == "beyond_every_knot":
        lower = np.broadcast_to(np.where(np.isinf(lower), -2.0, lower),
                                shape).copy()
        upper = np.broadcast_to(np.where(np.isinf(upper), 2.0, upper),
                                shape).copy()
        c = np.clip(c, np.broadcast_to(lower, (rows, n)),
                    np.broadcast_to(upper, (rows, n)))
        radius[:] = 1e6
    elif case == "duplicate_knots":
        # every moving component of a row meets its bound at t = 1, 2
        # or 4: (u - c) / d with d = -g / w
        weight = np.ones(shape)
        lower, upper = -np.ones(shape), np.ones(shape)
        c = np.zeros((rows, n))
        step = rng.choice([1.0, 0.5, 0.25], size=(rows, n))
        g = np.where(rng.random((rows, n)) < 0.5, step, -step)
        radius = np.array([3.0, 9.0, 14.0][:rows] + [1.0] * max(0, rows - 3))
    elif case == "negative_zero_tau":
        # a component at its lower bound moving down under a negative
        # weight meets it at (l - c) / d = +0 / d < 0: a -0.0 knot
        weight = np.broadcast_to(weight, shape).copy()
        lower = np.broadcast_to(np.where(np.isinf(lower), -1.0, lower),
                                shape).copy()
        weight[..., 7] = -1.0
        upper = np.broadcast_to(upper, shape).copy()
        upper[..., 7] = 1.0
        c[:, 7] = np.broadcast_to(lower, (rows, n))[:, 7]
        g[:, 7] = -1.0
    as32 = [np.asarray(v, np.float32) for v in (c, g, lower, upper, weight,
                                                radius)]
    return as32


def exact_inputs(case, bounds="shared", rows=3, n=400, seed=0):
    """Inputs whose every sum is exact in f32 (see the module's note):
    w = 1, c, l, u integers in [-8, 8], g = -d with d in {+-1, +-2, +-4}
    (a = d^2, a tau^2 = (u - c)^2 or (l - c)^2)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if bounds == "shared" else (rows, n)
    lower = -rng.integers(0, 9, shape).astype(np.float64)
    upper = rng.integers(0, 9, shape).astype(np.float64)
    if case == "infinite_bounds":
        lower[..., ::3] = -np.inf
        upper[..., 1::3] = np.inf
    lo, hi = np.broadcast_to(lower, (rows, n)), np.broadcast_to(upper,
                                                               (rows, n))
    c = np.clip(rng.integers(-8, 9, (rows, n)).astype(np.float64), lo, hi)
    d = rng.choice([-4.0, -2.0, -1.0, 1.0, 2.0, 4.0], (rows, n))
    g = -d
    weight = np.ones(shape)
    radius = np.array([2.0, 20.0, 60.0][:rows] + [1.0] * max(0, rows - 3))
    if case == "radius_zero":
        radius[:] = 0.0
    elif case == "g_zero":
        g[0] = 0.0
    elif case == "all_frozen":
        at_upper = rng.random((rows, n)) < 0.5
        c = np.where(at_upper, np.where(np.isinf(hi), 0.0, hi),
                     np.where(np.isinf(lo), 0.0, lo))
        lower = np.broadcast_to(np.where(np.isinf(lower), 0.0, lower),
                                shape).copy()
        upper = np.broadcast_to(np.where(np.isinf(upper), 0.0, upper),
                                shape).copy()
        c = np.clip(c, np.broadcast_to(lower, (rows, n)),
                    np.broadcast_to(upper, (rows, n)))
        g = np.where(c >= np.broadcast_to(upper, (rows, n)),
                     -np.abs(g), np.abs(g))
    elif case == "infinite_bounds":
        radius = np.array([30.0, 300.0, 3000.0][:rows]
                          + [1.0] * max(0, rows - 3))
    elif case == "beyond_every_knot":
        radius[:] = 1e5
    elif case == "duplicate_knots":
        lower, upper = -4.0 * np.ones(shape), 4.0 * np.ones(shape)
        c = np.zeros((rows, n))
    return [np.asarray(v, np.float32) for v in (c, g, lower, upper, weight,
                                                radius)]


EXACT_CASES = ["mixed", "radius_zero", "g_zero", "all_frozen",
               "infinite_bounds", "beyond_every_knot", "duplicate_knots"]


def edge_inputs(n=300):
    """Input sets of 5 rows (bounds (B, N)) at the whole-card path's
    edges, as f32 numpy arrays: every knot infinite (no bounds), every
    knot +0 (each component at a bound that the objective pushes
    outward), a NaN in c, a NaN in g, a NaN weight; then the same rows
    with radius 0, and with g = 0."""
    rng = np.random.default_rng(11)
    rows = 5
    lower = -rng.random((rows, n))
    upper = rng.random((rows, n))
    c = rng.normal(size=(rows, n)) * 0.3
    g = rng.normal(size=(rows, n))
    weight = rng.uniform(0.5, 2.0, (rows, n))
    lower[0], upper[0] = -np.inf, np.inf
    at_upper = rng.random(n) < 0.5
    c[1] = np.where(at_upper, upper[1], lower[1])
    g[1] = np.where(at_upper, -np.abs(g[1]), np.abs(g[1]))
    c = np.clip(c, lower, upper)
    c[2, 7] = np.nan
    g[3, 11] = np.nan
    weight[4, 13] = np.nan
    radius = np.array([0.5, 2.0, 0.7, 0.7, 0.7])
    return [[np.asarray(v, np.float32) for v in (c, gg, lower, upper,
                                                 weight, r)]
            for r, gg in ((radius, g), (np.zeros(rows), g),
                          (radius, np.zeros_like(g)))]


def lp_inputs(nodes, rows=3, seed=0):
    """A trust-region batch with the PageRank LP's bound pattern over
    N = 2 nodes + 1 entries (x >= 0; the dual's one equality row free,
    its other rows >= 0; no upper bounds), bounds (N,), as f32 numpy
    arrays: c inside the bounds (a tenth at 0), g normal, weights
    uniform in [0.5, 2], radii 0.05, 0.7 and 5."""
    rng = np.random.default_rng(seed)
    n = 2 * nodes + 1
    lower = np.zeros(n)
    lower[nodes] = -np.inf
    upper = np.full(n, np.inf)
    c = np.clip(rng.standard_normal((rows, n)), lower, upper)
    c = np.where(rng.random((rows, n)) < 0.1, np.maximum(lower, 0.0), c)
    g = rng.standard_normal((rows, n))
    weight = rng.uniform(0.5, 2.0, n)
    radius = np.resize([0.05, 0.7, 5.0], rows)
    return [np.asarray(v, np.float32) for v in (c, g, lower, upper, weight,
                                                radius)]
