"""Device mirror of the host problem: dataclasses holding tensors.

A DeviceScaledQp bundles the scaled problem (solver iterations) with the
original problem and the cumulative rescaling vectors: termination
stats are always evaluated on the unscaled original problem (reference
src/iteration_stats_utils.jl:413-451).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..problem import QuadraticProgrammingProblem, ScaledQpProblem
from .device import resolve_device
from .linops import LinOp, build_linop, matvec, rmatvec


class DeviceQpCache(NamedTuple):
    """Norms of c and b of the original problem, cached once per solve
    (reference src/termination.jl:140-158)."""

    l_inf_norm_primal_linear_objective: torch.Tensor
    l_inf_norm_primal_right_hand_side: torch.Tensor
    l2_norm_primal_linear_objective: torch.Tensor
    l2_norm_primal_right_hand_side: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DeviceQp:
    variable_lower_bound: torch.Tensor  # (n,)
    variable_upper_bound: torch.Tensor  # (n,)
    objective_vector: torch.Tensor  # (n,)
    objective_constant: torch.Tensor  # scalar
    right_hand_side: torch.Tensor  # (m,)
    # (m,) bool. Ingest puts equality rows first, but a shifted
    # refinement problem promotes rows in the middle: every device code
    # path reads this as a mask, never as a prefix length.
    is_equality: torch.Tensor
    is_equality_f32: torch.Tensor  # (m,) f32 copy for the dual-step kernel
    constraint_matrix: LinOp
    objective_matrix: Optional[LinOp]  # None for LPs

    @property
    def num_variables(self) -> int:
        return self.variable_lower_bound.shape[-1]

    @property
    def num_constraints(self) -> int:
        return self.right_hand_side.shape[-1]

    @property
    def is_lp(self) -> bool:
        return self.objective_matrix is None

    def ax(self, x: torch.Tensor) -> torch.Tensor:
        return matvec(self.constraint_matrix, x)

    def aty(self, y: torch.Tensor) -> torch.Tensor:
        return rmatvec(self.constraint_matrix, y)

    def qx(self, x: torch.Tensor) -> torch.Tensor:
        if self.objective_matrix is None:
            return torch.zeros_like(x)
        return matvec(self.objective_matrix, x)


@dataclasses.dataclass(frozen=True)
class DeviceScaledQp:
    scaled: DeviceQp
    original: DeviceQp
    constraint_rescaling: torch.Tensor  # (m,)
    variable_rescaling: torch.Tensor  # (n,)
    qp_cache: DeviceQpCache
    # CUDA graphs of the solvers' steps on this bundle's tensors
    # (ops/graphs.py); a bundle made by dataclasses.replace starts with
    # none.
    graphs: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )


def to_device(
    problem: QuadraticProgrammingProblem,
    dtype=torch.float64,
    format: str = "auto",
    device=None,
    share_from: Optional[DeviceQp] = None,
    shard_plan=None,
) -> DeviceQp:
    """`device`: CUDA when None (raises without a GPU), the CPU only
    when asked. `share_from`: a DeviceQp over the same sparsity pattern
    (the scaled copy); a kernel operator built here reuses its index
    tensors (build_linop's share_plan_with). `shard_plan`: a
    RoutedShardPlan (ops/routed_sharded.py); the constraint matrix is
    built block-partitioned over its mesh, everything else whole on
    `device`."""
    device = resolve_device(device)
    m = problem.num_constraints
    is_equality = np.zeros(m, dtype=bool)
    is_equality[: problem.num_equalities] = True
    objective_matrix = (
        None
        if problem.objective_matrix.nnz == 0
        else build_linop(problem.objective_matrix, dtype, format, device)
    )

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=device).to(
            dtype
        )

    return DeviceQp(
        variable_lower_bound=vec(problem.variable_lower_bound),
        variable_upper_bound=vec(problem.variable_upper_bound),
        objective_vector=vec(problem.objective_vector),
        objective_constant=vec(problem.objective_constant),
        right_hand_side=vec(problem.right_hand_side),
        is_equality=torch.as_tensor(is_equality, device=device),
        is_equality_f32=torch.as_tensor(
            is_equality.astype(np.float32), device=device
        ),
        constraint_matrix=build_linop(
            problem.constraint_matrix, dtype, format, device,
            share_plan_with=(
                None if share_from is None else share_from.constraint_matrix
            ),
            shard_plan=shard_plan,
        ),
        objective_matrix=objective_matrix,
    )


def to_device_scaled(
    scaled_problem: ScaledQpProblem,
    dtype=torch.float64,
    format: str = "auto",
    device=None,
    stats_dtype=None,
    stats_format=None,
    shard_plan=None,
) -> DeviceScaledQp:
    """`stats_dtype` (default: `dtype`) is the precision of the ORIGINAL
    problem copy, the rescaling vectors and the norm cache, i.e. of the
    termination/stats evaluation. `stats_format` (default: `format`) is
    the matrix layout of the original copy. `device`: CUDA when None
    (raises without a GPU), the CPU only when asked. `shard_plan`: both
    copies' constraint matrices block-partitioned over its mesh (see
    to_device); the original copy's blocks share the scaled copy's index
    tensors."""
    device = resolve_device(device)
    if stats_dtype is None:
        stats_dtype = dtype
    if stats_format is None:
        stats_format = format
    c = np.asarray(scaled_problem.original_qp.objective_vector, np.float64)
    b = np.asarray(scaled_problem.original_qp.right_hand_side, np.float64)

    def scalar(v):
        return torch.tensor(float(v), dtype=stats_dtype, device=device)

    qp_cache = DeviceQpCache(
        l_inf_norm_primal_linear_objective=scalar(
            np.max(np.abs(c)) if c.size else 0.0
        ),
        l_inf_norm_primal_right_hand_side=scalar(
            np.max(np.abs(b)) if b.size else 0.0
        ),
        l2_norm_primal_linear_objective=scalar(np.linalg.norm(c)),
        l2_norm_primal_right_hand_side=scalar(np.linalg.norm(b)),
    )

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=device).to(
            stats_dtype
        )

    scaled = to_device(scaled_problem.scaled_qp, dtype, format, device,
                       shard_plan=shard_plan)
    return DeviceScaledQp(
        scaled=scaled,
        original=to_device(
            scaled_problem.original_qp, stats_dtype, stats_format, device,
            share_from=scaled, shard_plan=shard_plan,
        ),
        constraint_rescaling=vec(scaled_problem.constraint_rescaling),
        variable_rescaling=vec(scaled_problem.variable_rescaling),
        qp_cache=qp_cache,
    )
