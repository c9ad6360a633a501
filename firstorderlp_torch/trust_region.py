"""Bound-constrained trust-region subproblem, solved without a
data-dependent loop.

Solves
    argmin_x  g' x
    s.t.      l <= x <= u,  ||x - center||_w <= r            (1)
where ||v||_w = sqrt(sum_i w_i v_i^2), by parameterizing
x(t) = clamp(center - t * g / w, l, u) and finding the t at which the
weighted radius equals r:

  radius^2(t) = sum_i a_i * min(t, tau_i)^2,   a_i = w_i d_i^2,

with d_i the (masked) movement direction and tau_i the breakpoint at
which component i hits its bound; radius^2 is nondecreasing in t and
piecewise quadratic with knots at the tau. Two exact knot searches, by
dtype, as in the JAX package's trust_region.py:

- f32: 31 bisection steps on the float bit pattern of t, two masked
  sums each, every per-row sum accumulated in f64 and rounded once to
  f32 (ops/trust_region_search.py: two kernels on CUDA, F2b tr_search
  and F2c tr_solution, their plain versions on the CPU);
- f64: a sort, prefix sums and a first-true search.

Every function takes a batch: vectors are (B, N) and radii (B,).
Reference: src/trust_region_utils.jl:68-192.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ops import trust_region_search


def _scalar_tensor(value, like: torch.Tensor) -> torch.Tensor:
    """`value` as a tensor on `like`'s device; a Python number is filled
    in on the device (no host-to-device copy, so no stream sync)."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype)
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


class TrustRegionResult(NamedTuple):
    solution: torch.Tensor
    value: torch.Tensor  # g' (solution - center)
    # (B, 2): g' (solution - center) over the columns [0, split) and
    # [split, N), when a split was asked for
    parts: Optional[torch.Tensor] = None


def solve_bound_constrained_trust_region(
    center_point,
    objective_vector,
    variable_lower_bounds,
    variable_upper_bounds,
    norm_weights,
    target_radius,
    solve_approximately: bool = False,
    split: Optional[int] = None,
) -> TrustRegionResult:
    """1-D vectors with a scalar radius, or (B, N) with radii (B,); the
    bounds and weights may be (N,) for a batch. With `split`, every
    route also returns the value's two parts (`parts`)."""
    single = center_point.dim() == 1
    if single:
        center_point = center_point[None]
        objective_vector = objective_vector[None]
    radius = _scalar_tensor(target_radius, center_point).reshape(-1)
    if solve_approximately:
        result = _approximate_trust_region(
            center_point, objective_vector, variable_lower_bounds,
            variable_upper_bounds, norm_weights, radius, split,
        )
    else:
        result = _exact_trust_region(
            center_point, objective_vector, variable_lower_bounds,
            variable_upper_bounds, norm_weights, radius, split,
        )
    if single:
        return TrustRegionResult(
            result.solution[0], result.value[0],
            None if result.parts is None else result.parts[0])
    return result


def _exact_trust_region(c, g, lb, ub, w, target_radius,
                        split=None) -> TrustRegionResult:
    if all(v.dtype == torch.float32 for v in (c, g, lb, ub, w)):
        # The knot search and the solution (F2b, F2c on CUDA).
        t_star = trust_region_search.tr_search(c, g, lb, ub, w,
                                               target_radius)
        solution, parts, value = trust_region_search.tr_solution(
            c, g, lb, ub, w, t_star, c.shape[-1] if split is None else split)
        return TrustRegionResult(solution=solution, value=value,
                                 parts=None if split is None else parts)
    # Components already at a bound with the objective pushing outward do
    # not move (reference l.95-102).
    frozen = ((c >= ub) & (g <= 0.0)) | ((c <= lb) & (g >= 0.0))
    direction = torch.where(frozen, 0.0, -g / w)

    # Breakpoint at which each component hits its bound; 0 for components
    # that don't move (reference l.105-116).
    tau = torch.where(
        direction > 0,
        (ub - c) / torch.where(direction > 0, direction, 1.0),
        torch.where(
            direction < 0,
            (lb - c) / torch.where(direction < 0, direction, 1.0),
            0.0,
        ),
    )
    a = w * direction * direction
    target_r2 = target_radius * target_radius
    t_star = _t_star_sorted(tau, a, target_r2)

    # Degenerate cases: zero radius or zero objective -> stay at center
    # (reference l.88-91).
    degenerate = (target_radius <= 0.0) | (torch.sum(g * g, dim=-1) == 0.0)
    t_star = torch.where(degenerate, 0.0, t_star)

    solution = torch.clamp(c + t_star[:, None] * direction, lb, ub)
    terms = g * (solution - c)
    return TrustRegionResult(solution=solution,
                             value=torch.sum(terms, dim=-1),
                             parts=_split_sums(terms, split))


def _split_sums(terms, split):
    """(B, 2) sums of `terms` over the columns [0, split) and [split, N),
    or None without a split."""
    if split is None:
        return None
    return torch.stack([torch.sum(terms[:, :split], dim=-1),
                        torch.sum(terms[:, split:], dim=-1)], dim=-1)


def _t_star_sorted(tau, a, target_r2):
    """Exact knot search by sort + prefix sums + first-true search."""
    tau_s, order = torch.sort(tau, dim=-1, stable=True)
    a_s = torch.gather(a, -1, order)
    finite = torch.isfinite(tau_s)
    n = tau_s.shape[-1]
    zero = torch.zeros(tau_s.shape[0], dtype=tau.dtype, device=tau.device)
    if n == 0:
        return zero

    # Prefix sums: S_k = sum_{j<=k, finite} a_j tau_j^2 (clamped part),
    # H_k = sum_{j>k} a_j (still-moving part, incl. infinite-tau comps).
    clamped_contrib = torch.where(finite, a_s * tau_s * tau_s, 0.0)
    s_cum = torch.cumsum(clamped_contrib, dim=-1)
    a_cum = torch.cumsum(a_s, dim=-1)
    a_total = a_cum[:, -1]
    h_after = a_total[:, None] - a_cum

    r2_at_knot = torch.where(
        finite, s_cum + tau_s * tau_s * h_after, torch.inf
    )
    hit = r2_at_knot >= target_r2[:, None]
    any_hit = torch.any(hit & finite, dim=-1)
    k = torch.argmax(hit.to(torch.uint8), dim=-1)  # first True

    prev = torch.clamp_min(k - 1, 0)[:, None]
    low_before = torch.where(k > 0, s_cum.gather(-1, prev)[:, 0], 0.0)
    high_before = torch.where(
        k > 0, h_after.gather(-1, prev)[:, 0], a_total
    )
    t_interior = torch.sqrt(
        torch.clamp_min(target_r2 - low_before, 0.0)
        / torch.where(high_before > 0, high_before, 1.0)
    )

    a_finite_total = torch.sum(torch.where(finite, a_s, 0.0), dim=-1)
    s_total = s_cum[:, -1]
    h_infinite = a_total - a_finite_total
    t_beyond = torch.where(
        h_infinite > 0,
        torch.sqrt(
            torch.clamp_min(target_r2 - s_total, 0.0)
            / torch.where(h_infinite > 0, h_infinite, 1.0)
        ),
        torch.clamp_min(
            torch.amax(torch.where(finite, tau_s, 0.0), dim=-1), 0.0
        ),
    )
    return torch.where(any_hit, t_interior, t_beyond)


def _approximate_trust_region(c, g, lb, ub, w, target_radius, split=None):
    """Scaled projected-gradient approximation (reference l.194-224)."""
    frozen = ((c >= ub) & (g <= 0.0)) | ((c <= lb) & (g >= 0.0))
    direction = torch.where(frozen, 0.0, -g / w)
    norm = torch.sqrt(torch.sum(w * direction * direction, dim=-1))
    scale = target_radius / torch.where(norm > 0, norm, 1.0)
    direction = torch.where(
        (norm > 0)[:, None], direction * scale[:, None], direction
    )
    solution = c + direction
    return TrustRegionResult(
        solution=solution, value=torch.sum(g * direction, dim=-1),
        parts=_split_sums(g * (solution - c), split),
    )


class ObjectiveBound(NamedTuple):
    """Scalar results of bound_optimal_objective."""

    lagrangian_value: torch.Tensor
    lower_bound_value: torch.Tensor
    upper_bound_value: torch.Tensor

    @property
    def gap(self):
        return self.upper_bound_value - self.lower_bound_value


def bound_optimal_objective(
    problem,
    primal_solution,
    dual_solution,
    primal_norm_weights,
    dual_norm_weights,
    distance_to_optimality,
    use_max_norm: bool = False,
    solve_approximately: bool = False,
) -> ObjectiveBound:
    """Localized duality gap: bounds the optimal objective within a ball.

    Reference: src/trust_region_utils.jl:240-360. `problem` is a DeviceQp.
    With use_max_norm the primal and dual subproblems split; otherwise the
    ball is Euclidean in the joint (x, y) space.
    """
    if not use_max_norm:
        bounds = bound_optimal_objective_euclidean_batched(
            problem,
            primal_solution[None],
            dual_solution[None],
            primal_norm_weights,
            dual_norm_weights,
            _scalar_tensor(distance_to_optimality, primal_solution).reshape(
                1
            ),
            solve_approximately,
        )
        return ObjectiveBound(*(v[0] for v in bounds))

    qx = problem.qx(primal_solution)
    aty = problem.aty(dual_solution)
    ax = problem.ax(primal_solution)
    primal_gradient = qx + problem.objective_vector - aty
    dual_gradient = problem.right_hand_side - ax
    lagrangian_value = (
        0.5 * torch.sum(primal_solution * qx)
        + torch.sum(primal_solution * problem.objective_vector)
        - torch.sum(primal_solution * aty)
        + torch.sum(dual_solution * problem.right_hand_side)
        + problem.objective_constant
    )
    dual_lb = torch.where(problem.is_equality, -torch.inf, 0.0).to(
        dual_solution.dtype
    )
    dual_ub = torch.full_like(dual_solution, torch.inf)

    # The primal (n) and dual (m) subproblems are independent; solve them
    # as one batch of two, padded to max(n, m). Padded slots use
    # c=l=u=0, g=0, w=1: frozen, no contribution.
    n = primal_solution.shape[0]
    m = dual_solution.shape[0]
    size = max(n, m)

    def pad(v, fill=0.0):
        return torch.nn.functional.pad(v, (0, size - v.shape[0]), value=fill)

    radius = _scalar_tensor(distance_to_optimality, primal_solution).reshape(
        ()
    )
    result = solve_bound_constrained_trust_region(
        torch.stack([pad(primal_solution), pad(dual_solution)]),
        torch.stack([pad(primal_gradient), pad(-dual_gradient)]),
        torch.stack([pad(problem.variable_lower_bound), pad(dual_lb)]),
        torch.stack([pad(problem.variable_upper_bound), pad(dual_ub)]),
        torch.stack(
            [pad(primal_norm_weights, 1.0), pad(dual_norm_weights, 1.0)]
        ),
        torch.stack([radius, radius]),
        solve_approximately,
    )
    return ObjectiveBound(
        lagrangian_value=lagrangian_value,
        lower_bound_value=lagrangian_value + result.value[0],
        upper_bound_value=lagrangian_value - result.value[1],
    )


def bound_optimal_objective_euclidean_batched(
    problem,
    primal_solutions,  # (B, n)
    dual_solutions,  # (B, m)
    primal_norm_weights,  # (n,)
    dual_norm_weights,  # (m,)
    radii,  # (B,)
    solve_approximately: bool = False,
) -> ObjectiveBound:
    """Euclidean-ball localized gaps at B points in one batched solve
    (reference trust_region_utils.jl:271-360). Used by the restart
    scheme, which needs the gap at 2-3 points per evaluation."""
    qx = torch.stack([problem.qx(x) for x in primal_solutions])
    aty = torch.stack([problem.aty(y) for y in dual_solutions])
    ax = torch.stack([problem.ax(x) for x in primal_solutions])

    primal_gradient = qx + problem.objective_vector[None, :] - aty
    dual_gradient = problem.right_hand_side[None, :] - ax
    lagrangian_value = (
        0.5 * torch.sum(primal_solutions * qx, dim=1)
        + primal_solutions @ problem.objective_vector
        - torch.sum(primal_solutions * aty, dim=1)
        + dual_solutions @ problem.right_hand_side
        + problem.objective_constant
    )

    dual_lb = torch.where(problem.is_equality, -torch.inf, 0.0).to(
        dual_solutions.dtype
    )
    dual_ub = torch.full_like(dual_solutions[0], torch.inf)

    z = torch.cat([primal_solutions, dual_solutions], dim=1)
    z_gradient = torch.cat([primal_gradient, -dual_gradient], dim=1)
    z_lb = torch.cat([problem.variable_lower_bound, dual_lb])
    z_ub = torch.cat([problem.variable_upper_bound, dual_ub])
    weights = torch.cat([primal_norm_weights, dual_norm_weights])

    n = primal_solutions.shape[1]
    result = solve_bound_constrained_trust_region(
        z, z_gradient, z_lb, z_ub, weights, radii, solve_approximately,
        split=n,
    )
    # the dual part's terms are the negation of the dual bound's
    return ObjectiveBound(
        lagrangian_value=lagrangian_value,
        lower_bound_value=lagrangian_value + result.parts[:, 0],
        upper_bound_value=lagrangian_value - result.parts[:, 1],
    )
