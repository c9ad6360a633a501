"""Inputs of the evaluation's statistics kernels (ops/eval_stats.py:
F2d stats_point, F2e stats_primal, F2f stats_dual), made with numpy from
a seed: the cases that tests/test_torch_eval_stats.py holds on the CPU
and tests/test_torch_cuda.py holds on the card (each kernel against its
plain version). No JAX here: the card's tests import this module too.

The products A x, A'y and A ray are stand-ins (normal vectors): the
kernels' contracts take them as given. Cases:
- mixed: an average to evaluate, bounds of every kind, a third of the
  rows equalities;
- empty_average: counts and weights 0, so the current iterate;
- numerical_error: the flag set, so the current iterate and reason 7;
- non_finite: an infinite entry in the average (objectives NaN);
- zero: every entry 0 (the ray's norm 0);
- no_ray: both infeasibility tolerances 0;
- optimal_linf: the l_inf norm and tolerances every point meets;
- limits: the iteration past its limit (reason 5).
"""

import numpy as np
import torch

from firstorderlp_torch.ops import eval_stats
from firstorderlp_torch.termination import OptimalityNorm, TerminationCriteria

KERNEL_CASES = ("mixed", "empty_average", "numerical_error", "non_finite",
                "zero", "no_ray", "optimal_linf", "limits")


def criteria(case: str) -> TerminationCriteria:
    """The case's termination criteria."""
    if case == "no_ray":
        return TerminationCriteria(eps_optimal_absolute=1e-4,
                                   eps_optimal_relative=1e-4,
                                   eps_primal_infeasible=0.0,
                                   eps_dual_infeasible=0.0)
    if case == "optimal_linf":
        return TerminationCriteria(optimality_norm=OptimalityNorm.L_INF,
                                   eps_optimal_absolute=1e9,
                                   eps_optimal_relative=0.0)
    if case == "limits":
        return TerminationCriteria(iteration_limit=3)
    return TerminationCriteria(eps_optimal_absolute=1e-4,
                               eps_optimal_relative=1e-4)


def kernel_inputs(n: int, m: int, case: str, seed: int = 0, device="cpu"):
    """{name: tensor} of the three kernels' inputs on `device`, and the
    case's eval_stats.Criteria under "criteria"."""
    rng = np.random.default_rng(seed)
    lower = np.where(rng.random(n) < 0.5, 0.0,
                     np.where(rng.random(n) < 0.5, -1.0 - rng.random(n),
                              -np.inf))
    upper = np.where(rng.random(n) < 0.4, 1.0 + rng.random(n), np.inf)
    x = rng.normal(size=n)
    y = rng.normal(size=m)
    weight_x, weight_y = 3.7, 2.9
    sum_x = rng.normal(size=n) * weight_x
    sum_y = rng.normal(size=m) * weight_y
    counts = 5
    if case == "empty_average":
        sum_x, sum_y = np.zeros(n), np.zeros(m)
        weight_x = weight_y = 0.0
        counts = 0
    elif case == "non_finite":
        sum_x[n // 3] = np.inf
    elif case == "zero":
        x, y, sum_x, sum_y = np.zeros(n), np.zeros(m), np.zeros(n), np.zeros(m)
    c = rng.normal(size=n)
    b = rng.normal(size=m)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    c32, b32 = np.float32(c), np.float32(b)
    return {
        "x": f32(x), "y": f32(y),
        "average": eval_stats.Average(
            f32(sum_x), f32(sum_y), scalar(counts, torch.int64),
            scalar(counts, torch.int64), scalar(weight_x, torch.float32),
            scalar(weight_y, torch.float32),
            scalar(case == "numerical_error", torch.bool)),
        "variable_rescaling": f32(rng.uniform(0.5, 2.0, n)),
        "constraint_rescaling": f32(rng.uniform(0.5, 2.0, m)),
        "objective": f32(c), "lower": f32(lower), "upper": f32(upper),
        "rhs": f32(b),
        "is_equality": torch.as_tensor(np.arange(m) < m // 3,
                                       device=device),
        "ax": f32(10.0 * rng.normal(size=m)),
        "aty": f32(10.0 * rng.normal(size=n)),
        "aray": f32(rng.normal(size=m)),
        "scalars": eval_stats.Scalars(
            objective_constant=scalar(0.25, torch.float32),
            norm_c_inf=scalar(float(np.max(np.abs(c32))), torch.float32),
            norm_b_inf=scalar(float(np.max(np.abs(b32))), torch.float32),
            norm_c_2=scalar(float(np.linalg.norm(c)), torch.float32),
            norm_b_2=scalar(float(np.linalg.norm(b)), torch.float32),
            numerical_error=scalar(case == "numerical_error", torch.bool),
            iteration=scalar(7, torch.int64),
            kkt_passes=scalar(12.0, torch.float64),
            elapsed=scalar(0.5, torch.float64)),
        "criteria": eval_stats.criteria_of(criteria(case)),
    }


def sum_bound(terms: torch.Tensor) -> float:
    """How far two f64 sums of `terms` in orders with chains of at most
    2^12 additions each may lie apart: 2^13 2^-53 sum|t| = 2^-40 sum|t|
    (the kernels' chains: a thread's entries, 5 + 3 tree levels a block,
    the blocks a thread of the last block adds, 5 + 3 levels again; the
    plain version's: torch.sum's, a few hundred at these sizes)."""
    return 2.0 ** -40 * float(torch.sum(torch.abs(terms.double())))


def assert_totals_match(got, want, sums, names, label):
    """Kernel totals `got` against the plain `want` (f64, `names`' order):
    each sum within sum_bound of its terms (`sums`: name -> terms), the
    maxima and flags bitwise (a NaN against a NaN)."""
    got = got.double().cpu()
    want = want.double().cpu()
    for i, name in enumerate(names):
        g, w = float(got[i]), float(want[i])
        if name in sums:
            bound = sum_bound(sums[name])
            assert g == w or abs(g - w) <= bound or (
                np.isnan(g) and np.isnan(w)), (
                f"{label} {name}: {g!r} against {w!r} (bound {bound})")
        else:
            assert g == w or (np.isnan(g) and np.isnan(w)), (
                f"{label} {name}: {g!r} against {w!r}")
