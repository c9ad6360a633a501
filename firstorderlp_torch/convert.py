"""Carries problems and solver states across from arrays.

Both packages describe a problem with the same fields and a PDHG or
Mirror Prox state with the same leaves, so a test can start the port from
the exact point the JAX package reached: it hands the fields over as numpy / scipy
objects, and nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch

from .models.mirror_prox import MirrorProxState
from .models.pdhg import PdhgState
from .problem import QuadraticProgrammingProblem
from .saddle_point import RestartInfo, SolutionWeightedAverage


def problem_from_arrays(
    variable_lower_bound,
    variable_upper_bound,
    objective_matrix,
    objective_vector,
    objective_constant,
    constraint_matrix,
    right_hand_side,
    num_equalities,
) -> QuadraticProgrammingProblem:
    """The port's problem from the JAX package's problem fields."""
    return QuadraticProgrammingProblem(
        variable_lower_bound=np.array(variable_lower_bound, np.float64),
        variable_upper_bound=np.array(variable_upper_bound, np.float64),
        objective_matrix=sp.csc_matrix(objective_matrix, dtype=np.float64),
        objective_vector=np.array(objective_vector, np.float64),
        objective_constant=float(objective_constant),
        constraint_matrix=sp.csc_matrix(constraint_matrix, dtype=np.float64),
        right_hand_side=np.array(right_hand_side, np.float64),
        num_equalities=int(num_equalities),
    )


def _tensor(leaves, key, device) -> torch.Tensor:
    return torch.as_tensor(np.array(leaves[key]), device=device)


def _int(leaves, key) -> int:
    return int(np.asarray(leaves[key]))


def _bool(leaves, key) -> bool:
    return bool(np.asarray(leaves[key]))


def _avg_and_restart_info(leaves: Dict[str, np.ndarray], device):
    """The two nested dataclasses both solvers' states share; the
    average's counts and the restart info's flag and length become
    Python values."""
    def tensor(key):
        return _tensor(leaves, key, device)

    avg = SolutionWeightedAverage(
        sum_primal_solutions=tensor("avg.sum_primal_solutions"),
        sum_dual_solutions=tensor("avg.sum_dual_solutions"),
        sum_primal_solutions_count=_int(
            leaves, "avg.sum_primal_solutions_count"
        ),
        sum_dual_solutions_count=_int(leaves, "avg.sum_dual_solutions_count"),
        sum_primal_solution_weights=tensor(
            "avg.sum_primal_solution_weights"
        ),
        sum_dual_solution_weights=tensor("avg.sum_dual_solution_weights"),
    )
    info = RestartInfo(
        primal_solution=tensor("restart_info.primal_solution"),
        dual_solution=tensor("restart_info.dual_solution"),
        has_gap=_bool(leaves, "restart_info.has_gap"),
        gap=tensor("restart_info.gap"),
        last_restart_length=_int(leaves, "restart_info.last_restart_length"),
        primal_distance_moved_last_restart_period=tensor(
            "restart_info.primal_distance_moved_last_restart_period"
        ),
        dual_distance_moved_last_restart_period=tensor(
            "restart_info.dual_distance_moved_last_restart_period"
        ),
        gap_reduction_ratio_last_trial=tensor(
            "restart_info.gap_reduction_ratio_last_trial"
        ),
    )
    return avg, info


def state_from_arrays(
    leaves: Dict[str, np.ndarray], device="cpu"
) -> PdhgState:
    """The port's PdhgState from the leaves of a JAX PdhgState, given as
    {field: array}; nested `avg` and `restart_info` fields use dotted
    keys ("avg.sum_primal_solutions"). Floating leaves keep their dtype;
    counters and flags become Python values."""
    device = torch.device(device)
    avg, info = _avg_and_restart_info(leaves, device)

    def tensor(key):
        return _tensor(leaves, key, device)

    return PdhgState(
        current_primal_solution=tensor("current_primal_solution"),
        current_dual_solution=tensor("current_dual_solution"),
        delta_primal=tensor("delta_primal"),
        delta_dual=tensor("delta_dual"),
        current_dual_product=tensor("current_dual_product"),
        avg=avg,
        restart_info=info,
        step_size=tensor("step_size"),
        primal_weight=tensor("primal_weight"),
        numerical_error=_bool(leaves, "numerical_error"),
        cumulative_kkt_passes=float(np.asarray(leaves["cumulative_kkt_passes"])),
        total_number_iterations=_int(leaves, "total_number_iterations"),
        ratio_step_sizes=tensor("ratio_step_sizes"),
        iteration=_int(leaves, "iteration"),
        termination_reason=_int(leaves, "termination_reason"),
        avg_primal_out=tensor("avg_primal_out"),
        avg_dual_out=tensor("avg_dual_out"),
    )


def mp_state_from_arrays(
    leaves: Dict[str, np.ndarray], device="cpu", dtype=None
) -> MirrorProxState:
    """The port's MirrorProxState from the leaves of a JAX
    MirrorProxState, keyed as for state_from_arrays. Floating leaves
    keep their dtype, or take `dtype` when given; the flag, the KKT
    passes and the counters stay 0-d tensors (bool, float64, int64), as
    a step needs them; the termination reason becomes a Python int."""
    device = torch.device(device)
    avg, info = _avg_and_restart_info(leaves, device)

    def tensor(key, kind=None):
        value = _tensor(leaves, key, device)
        return value if kind is None else value.to(kind)

    def floating(key):
        return tensor(key, dtype)

    def with_dtype(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(dtype)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        })

    if dtype is not None:
        avg, info = with_dtype(avg), with_dtype(info)
    return MirrorProxState(
        current_primal=floating("current_primal"),
        current_dual=floating("current_dual"),
        primal_scaling=floating("primal_scaling"),
        dual_scaling=floating("dual_scaling"),
        avg=avg,
        restart_info=info,
        step_size=floating("step_size"),
        primal_weight=floating("primal_weight"),
        numerical_error=tensor("numerical_error", torch.bool),
        cumulative_kkt_passes=tensor("cumulative_kkt_passes", torch.float64),
        iteration=tensor("iteration", torch.int64),
        iterations_completed=tensor("iterations_completed", torch.int64),
        accepted_iterations=tensor("accepted_iterations", torch.int64),
        termination_reason=_int(leaves, "termination_reason"),
        avg_primal_out=floating("avg_primal_out"),
        avg_dual_out=floating("avg_dual_out"),
    )


def _lane_leaves(cls, leaves: Dict[str, np.ndarray], device, prefix=""):
    """`cls` with every leaf a tensor of the array under its dotted key
    (the nested average and restart info walked by field name)."""
    nested = {"avg": SolutionWeightedAverage, "restart_info": RestartInfo}
    values = {}
    for f in dataclasses.fields(cls):
        if f.name in nested:
            values[f.name] = _lane_leaves(nested[f.name], leaves, device,
                                          prefix + f.name + ".")
        else:
            values[f.name] = _tensor(leaves, prefix + f.name, device)
    return cls(**values)


def fleet_state_from_arrays(
    leaves: Dict[str, np.ndarray], device="cpu"
) -> PdhgState:
    """The fleet's PdhgState (batch.py: every leaf a lane tensor) from
    the leaves of the JAX package's batched PdhgState, minor-stacked
    ((dim, B) vectors, (B,) scalars), keyed as for state_from_arrays.
    Every leaf keeps its dtype."""
    return _lane_leaves(PdhgState, leaves, torch.device(device))


def mp_fleet_state_from_arrays(
    leaves: Dict[str, np.ndarray], device="cpu"
) -> MirrorProxState:
    """The fleet's MirrorProxState from the leaves of the JAX package's
    batched MirrorProxState, as fleet_state_from_arrays."""
    return _lane_leaves(MirrorProxState, leaves, torch.device(device))
