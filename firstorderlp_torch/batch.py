"""Shared-pattern fleets: many LPs with one sparsity pattern, solved
together on one device by PDHG (adaptive steps) or Mirror Prox.

The port of the JAX package's ``solve_batch_shared_pattern``
(firstorderlp_tpu/batch.py:209-258, 303-922, 1037-1245). Semantics: B
independent ``optimize`` calls (scenario sweeps: damping factors, rhs,
objective or regularization paths). Layout, the JAX package's minor
batch axis written out: every lane vector is (dim, B), contiguous in B;
every per-lane scalar is a (B,) tensor; the pattern's index tensors are
held once (ops/lanes.py), and the products run through the lane kernel
L1 (csrc/lanes_spmv.cu). The states are the solvers' own dataclasses
(pdhg.PdhgState, mirror_prox.MirrorProxState, with the same leaf names
as the JAX package's) whose every leaf is a lane tensor: counters
(B,) int64, flags (B,) bool, reasons (B,) int32.

The JAX package vmaps its single-instance segment. The port's
single-instance loop decides on the host, so the fleet has its own
lane-wise core, written from the JAX functions that already select on
the device (pdhg._take_step_adaptive, _eval_block, _segment_core;
mirror_prox._take_step, _eval_block, _segment_core;
saddle_point.run_restart_scheme) and kept to a vmapped while_loop's
semantics:

- each trial computes every lane; only a lane whose own condition holds
  (reason 0, no numerical error, and at the segment's start or not at
  an evaluation iteration) takes the result, so a frozen lane's
  iterates and counters do not move and each lane's counters are those
  of its own solve;
- the host reads back nothing per lane inside a segment: after the
  evaluation one read-back (whether any lane runs, and the running
  lanes' iteration), then trials with no read-back up to the fewest
  the segment can take (the accepted steps to the next evaluation
  iteration), then one "any lane active" flag a trial. Extra trials
  would be exact too, since frozen lanes do not change;
- restarts are chosen per lane (no restart, restart to average,
  weighted-average reset); A' y of the restart point is one lane
  product for all lanes, selected where a lane restarts to the average.

LP fleets only, on the adaptive step rule or Mirror Prox. Not ported yet
(A13b in ROADMAP.md): heterogeneous fleets (``solve_batch``) and the
JAX package's per-instance ingest (QP fleets, constant steps,
bound-width rescaling); those raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .iteration_stats import (
    DeviceConvergenceInfo,
    DeviceInfeasibilityInfo,
    to_host_stats,
)
from .models import mirror_prox as _mp
from .models import pdhg as _pdhg
from .models.common import EvalResult, evaluate_unscaled_stats, torch_dtype
from .ops.device import resolve_device
from .ops.device_problem import DeviceQp, DeviceQpCache, DeviceScaledQp
from .ops.lanes import LanesPattern, build_lanes_pattern, lanes_op, lanes_spmv
from .ops.routed import pattern_hash
from .problem import QuadraticProgrammingProblem, ScaledQpProblem, validate
from .saddle_point import (
    RestartInfo,
    RestartScheme,
    SaddlePointOutput,
    SolutionWeightedAverage,
    add_to_solution_weighted_average,
    compute_new_primal_weight,
    project_dual,
    project_primal,
    should_reset_to_average,
    unscaled_saddle_point_output,
    weighted_norm,
)
from .solve_log import PointType, RestartChoice, TerminationReason
from .termination import validate_termination_criteria
from .trust_region import ObjectiveBound, solve_bound_constrained_trust_region

_NOT_PORTED = (
    "{what} are not ported yet (A13b in ROADMAP.md): the shared-pattern "
    "fleet takes LP fleets with the adaptive step rule or Mirror Prox"
)


# ---------------------------------------------------------------------------
# Fleets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetSpec:
    """A parameterized shared-pattern fleet generated on the device.

    The JAX package's FleetSpec contract, per lane: every generated
    instance has the base problem's sparsity pattern, shapes and
    num_equalities. `matrix_values(theta)` returns the (nnz,) constraint
    values in the BASE problem's canonical CSR entry order
    (scipy.sparse.csr_matrix(base.constraint_matrix) after
    sum_duplicates()); a vector generator returns the whole vector of
    one lane. An omitted generator reuses the base problem's data in
    every lane. Generators are torch functions of one lane's theta (a
    tensor on the solve's device), vmapped over `thetas` with
    torch.func.vmap; they close over host (numpy) constants.
    """

    base_problem: QuadraticProgrammingProblem
    thetas: np.ndarray  # (B,) or (B, k)
    matrix_values: Callable  # theta -> (nnz,)
    right_hand_side: Optional[Callable] = None  # theta -> (m,)
    objective_vector: Optional[Callable] = None  # theta -> (n,)
    variable_lower_bound: Optional[Callable] = None  # theta -> (n,)
    variable_upper_bound: Optional[Callable] = None  # theta -> (n,)
    objective_constant: Optional[Callable] = None  # theta -> scalar
    # index tensors built for this spec, keyed by the pattern's hash and
    # the device (a base problem replaced later gets its own entry)
    _patterns: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def num_instances(self) -> int:
        return int(np.asarray(self.thetas).shape[0])


@dataclasses.dataclass
class SharedPatternFleet:
    """A prepared fleet on its device (prepare_shared_pattern_fleet)."""

    bundle: DeviceScaledQp  # lane tensors; the operators are LanesOps
    initial_state: object  # PdhgState or MirrorProxState of lane tensors
    scaled_problems: List[ScaledQpProblem]  # per lane: rescaling vectors
    device: torch.device

    @property
    def num_instances(self) -> int:
        return len(self.scaled_problems)


def _is_mp(params) -> bool:
    return isinstance(params, _mp.MirrorProxParameters)


def _select(cond, a, b):
    """Per lane: `a` where `cond` (B,), else `b`, leaf by leaf (nested
    dataclasses and named tuples walked). A (B,) condition broadcasts
    over a (dim, B) leaf's trailing axis."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _select(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    if isinstance(a, tuple):
        return type(a)(*(_select(cond, u, v) for u, v in zip(a, b)))
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Ingest: lanes, rescaling and the lane bundle, on the device
# ---------------------------------------------------------------------------


def _row_sums(pattern: LanesPattern, values: torch.Tensor) -> torch.Tensor:
    """(m, B) row sums of an (nnz, B) plane in A's entry order: the lane
    product with x = 1, so they are added in a fixed order."""
    ones = torch.ones((pattern.fwd.num_cols, values.shape[1]),
                      dtype=values.dtype, device=values.device)
    return lanes_spmv(pattern.fwd, values.contiguous(), ones)


def _col_sums(pattern: LanesPattern, values: torch.Tensor) -> torch.Tensor:
    """(n, B) column sums: the transposed lane product with y = 1."""
    ones = torch.ones((pattern.bwd.num_cols, values.shape[1]),
                      dtype=values.dtype, device=values.device)
    return lanes_spmv(pattern.bwd, values[pattern.perm_t].contiguous(), ones)


def _seg_max(values, index, num):
    """(num, B) per-lane max of |values| (>= 0) over the entries with
    each index; 0 where there is none. Max is exact in any order."""
    out = torch.zeros((num, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.scatter_reduce_(
        0, index[:, None].expand_as(values), values, "amax"
    )


class _Rescaled(NamedTuple):
    v: torch.Tensor  # (nnz, B) scaled values, A's entry order
    cum_con: torch.Tensor  # (m, B)
    cum_var: torch.Tensor  # (n, B)
    vectors: dict  # scaled c, b, lo, hi, each (dim, B)
    step_size: torch.Tensor  # (B,) 1 / max |v|
    norm_c: torch.Tensor  # (B,) ||scaled c||
    norm_b: torch.Tensor  # (B,) ||scaled b||


def fleet_rescale(pattern: LanesPattern, v_orig: torch.Tensor, vectors,
                  ruiz_iterations: int, l2_norm_rescaling: bool,
                  pock_chambolle_alpha: Optional[float]) -> _Rescaled:
    """Rescales every lane on the device: `ruiz_iterations` l_inf Ruiz
    steps, the optional l2 step and the optional Pock-Chambolle step, in
    the value dtype (the JAX package's _device_fleet_build,
    batch.py:303-397 there; reference preprocess.jl:626-687). Row and
    column maxima are scatter maxima; row and column sums run through
    the lane product, in a fixed order."""
    m, n = pattern.shape
    rows, cols = pattern.fwd.rows, pattern.fwd.indices.long()
    lanes = v_orig.shape[1]
    like = dict(dtype=v_orig.dtype, device=v_orig.device)
    cum_con = torch.ones((m, lanes), **like)
    cum_var = torch.ones((n, lanes), **like)
    v = v_orig

    def fix(s):
        return torch.where(s > 0, s, 1.0)

    def apply(v, con, var, cum_con, cum_var):
        # (E^-1 A) D^-1: rows first, then columns
        v = v / con[rows]
        v = v / var[cols]
        return v, cum_con * con, cum_var * var

    for _ in range(ruiz_iterations):
        absv = torch.abs(v)
        var = fix(torch.sqrt(_seg_max(absv, cols, n)))
        con = fix(torch.sqrt(_seg_max(absv, rows, m)))
        v, cum_con, cum_var = apply(v, con, var, cum_con, cum_var)
    if l2_norm_rescaling:
        con = fix(torch.sqrt(torch.sqrt(_row_sums(pattern, v * v))))
        var = fix(torch.sqrt(torch.sqrt(_col_sums(pattern, v * v))))
        v, cum_con, cum_var = apply(v, con, var, cum_con, cum_var)
    if pock_chambolle_alpha is not None:
        alpha = float(pock_chambolle_alpha)
        absv = torch.abs(v)
        var = fix(torch.sqrt(_col_sums(pattern, absv ** (2.0 - alpha))))
        con = fix(torch.sqrt(_row_sums(pattern, absv ** alpha)))
        v, cum_con, cum_var = apply(v, con, var, cum_con, cum_var)

    scaled = {
        "c": vectors["c"] / cum_var,
        "b": vectors["b"] / cum_con,
        "lo": vectors["lo"] * cum_var,
        "hi": vectors["hi"] * cum_var,
    }
    inf_norm = torch.amax(torch.abs(v), dim=0)
    return _Rescaled(
        v=v, cum_con=cum_con, cum_var=cum_var, vectors=scaled,
        step_size=torch.where(inf_norm > 0, 1.0 / inf_norm, 1.0),
        norm_c=torch.linalg.vector_norm(scaled["c"], dim=0),
        norm_b=torch.linalg.vector_norm(scaled["b"], dim=0),
    )


def _lane_qp(pattern, values, vectors, const, is_equality) -> DeviceQp:
    return DeviceQp(
        variable_lower_bound=vectors["lo"],
        variable_upper_bound=vectors["hi"],
        objective_vector=vectors["c"],
        objective_constant=const,
        right_hand_side=vectors["b"],
        is_equality=is_equality,  # (m, 1): broadcasts over the lanes
        is_equality_f32=is_equality.to(torch.float32),
        constraint_matrix=lanes_op(pattern, values),
        objective_matrix=None,
    )


def _lane_zeros(size, lanes, dtype, device):
    return torch.zeros((size, lanes), dtype=dtype, device=device)


def _initial_average(n, m, lanes, dtype, device) -> SolutionWeightedAverage:
    return SolutionWeightedAverage(
        sum_primal_solutions=_lane_zeros(n, lanes, dtype, device),
        sum_dual_solutions=_lane_zeros(m, lanes, dtype, device),
        sum_primal_solutions_count=torch.zeros(lanes, dtype=torch.int64,
                                               device=device),
        sum_dual_solutions_count=torch.zeros(lanes, dtype=torch.int64,
                                             device=device),
        sum_primal_solution_weights=torch.zeros(lanes, dtype=dtype,
                                                device=device),
        sum_dual_solution_weights=torch.zeros(lanes, dtype=dtype,
                                              device=device),
    )


def _initial_restart_info(n, m, lanes, dtype, device) -> RestartInfo:
    def scalar(v):
        return torch.full((lanes,), v, dtype=dtype, device=device)

    return RestartInfo(
        primal_solution=_lane_zeros(n, lanes, dtype, device),
        dual_solution=_lane_zeros(m, lanes, dtype, device),
        has_gap=torch.zeros(lanes, dtype=torch.bool, device=device),
        gap=scalar(0.0),
        last_restart_length=torch.ones(lanes, dtype=torch.int64,
                                       device=device),
        primal_distance_moved_last_restart_period=scalar(0.0),
        dual_distance_moved_last_restart_period=scalar(0.0),
        gap_reduction_ratio_last_trial=scalar(1.0),
    )


def _initial_pdhg_state(params, n, m, lanes, dtype, device, rescaled):
    """The zero state with 1 / max|A_scaled| as the step size, the
    initial primal weight and half a KKT pass per lane."""
    pi = float(params.primal_importance)
    if params.scale_invariant_initial_primal_weight:
        nc, nb = rescaled.norm_c, rescaled.norm_b
        primal_weight = torch.where(
            (nc > 0) & (nb > 0), pi * nc / torch.where(nb > 0, nb, 1.0), pi
        )
    else:
        primal_weight = torch.full((lanes,), pi, dtype=dtype, device=device)

    def zeros(size):
        return _lane_zeros(size, lanes, dtype, device)

    def scalar(v, kind=dtype):
        return torch.full((lanes,), v, dtype=kind, device=device)

    return _pdhg.PdhgState(
        current_primal_solution=zeros(n),
        current_dual_solution=zeros(m),
        delta_primal=zeros(n),
        delta_dual=zeros(m),
        current_dual_product=zeros(n),
        avg=_initial_average(n, m, lanes, dtype, device),
        restart_info=_initial_restart_info(n, m, lanes, dtype, device),
        step_size=rescaled.step_size.to(dtype),
        primal_weight=primal_weight.to(dtype),
        numerical_error=scalar(False, torch.bool),
        cumulative_kkt_passes=scalar(0.5, torch.float64),
        total_number_iterations=scalar(0, torch.int64),
        ratio_step_sizes=scalar(1.0),
        iteration=scalar(1, torch.int64),
        termination_reason=scalar(0, torch.int32),
        avg_primal_out=zeros(n),
        avg_dual_out=zeros(m),
    )


def _initial_mp_state(params, pattern, v_orig, n, m, lanes, dtype, device,
                      rescaled):
    """The zero state with the mirror-map scalings of
    mirror_prox.initial_mp_scalings per lane (LP: Q = 0), computed on the
    device from v_orig over the cumulative scalings (the JAX package's
    fleet build, batch.py:798-858 there); an empty row or column gets
    scaling 1, as in the single-instance solver."""
    v = v_orig / (rescaled.cum_con[pattern.fwd.rows]
                  * rescaled.cum_var[pattern.fwd.indices.long()])
    pi = float(params.primal_importance)
    if params.diagonal_scaling == "l2":
        px = torch.sqrt(_col_sums(pattern, v ** 2))
        py = torch.sqrt(_row_sums(pattern, v ** 2))
        pw0 = pi
    elif params.diagonal_scaling == "l1":
        px = _col_sums(pattern, torch.abs(v))
        py = _row_sums(pattern, torch.abs(v))
        pw0 = 1.0
    elif params.diagonal_scaling == "off":
        px = torch.full((n, lanes), pi, dtype=dtype, device=device)
        py = torch.full((m, lanes), 1.0 / pi, dtype=dtype, device=device)
        pw0 = 1.0
    else:
        raise ValueError(
            f"Unknown diagonal_scaling: {params.diagonal_scaling!r}"
        )
    px = torch.where(px > 0, px, 1.0)
    py = torch.where(py > 0, py, 1.0)
    if params.scale_invariant_initial_primal_weight:
        obj = torch.sqrt(torch.sum(px * rescaled.vectors["c"] ** 2, dim=0))
        rhs = torch.sqrt(torch.sum(py * rescaled.vectors["b"] ** 2, dim=0))
        new_pw = torch.where(
            (obj > 0) & (rhs > 0),
            pi * obj / torch.where(rhs > 0, rhs, 1.0), pi,
        ).to(dtype)
    else:
        new_pw = torch.full((lanes,), pi, dtype=dtype, device=device)
    ratio = new_pw / pw0

    def scalar(v, kind):
        return torch.full((lanes,), v, dtype=kind, device=device)

    return _mp.MirrorProxState(
        current_primal=_lane_zeros(n, lanes, dtype, device),
        current_dual=_lane_zeros(m, lanes, dtype, device),
        primal_scaling=(px * ratio).to(dtype),
        dual_scaling=(py / ratio).to(dtype),
        avg=_initial_average(n, m, lanes, dtype, device),
        restart_info=_initial_restart_info(n, m, lanes, dtype, device),
        step_size=rescaled.step_size.to(dtype),
        primal_weight=new_pw,
        numerical_error=scalar(False, torch.bool),
        cumulative_kkt_passes=scalar(0.0, torch.float64),
        iteration=scalar(1, torch.int64),
        iterations_completed=scalar(0, torch.int64),
        accepted_iterations=scalar(0, torch.int64),
        termination_reason=scalar(0, torch.int32),
        avg_primal_out=_lane_zeros(n, lanes, dtype, device),
        avg_dual_out=_lane_zeros(m, lanes, dtype, device),
    )


def _finish_fleet(params, pattern: LanesPattern, k_eq: int, v_orig,
                  vectors, const, originals, device) -> SharedPatternFleet:
    """The device build shared by both ingests: rescaling, the scaled and
    the original lane operators, the norm cache of the original c and b,
    and the initial state."""
    dtype = v_orig.dtype
    m, n = pattern.shape
    lanes = int(v_orig.shape[1])
    rescaled = fleet_rescale(
        pattern, v_orig, vectors, int(params.l_inf_ruiz_iterations),
        bool(params.l2_norm_rescaling), params.pock_chambolle_alpha,
    )
    is_equality = (torch.arange(m, device=device) < k_eq)[:, None]

    def linf(v):
        if v.shape[0] == 0:
            return torch.zeros(lanes, dtype=dtype, device=device)
        return torch.amax(torch.abs(v), dim=0)

    bundle = DeviceScaledQp(
        scaled=_lane_qp(pattern, rescaled.v, rescaled.vectors, const,
                        is_equality),
        original=_lane_qp(pattern, v_orig, vectors, const, is_equality),
        constraint_rescaling=rescaled.cum_con,
        variable_rescaling=rescaled.cum_var,
        # norms of the ORIGINAL c and b (reference termination.jl:140-158)
        qp_cache=DeviceQpCache(
            l_inf_norm_primal_linear_objective=linf(vectors["c"]),
            l_inf_norm_primal_right_hand_side=linf(vectors["b"]),
            l2_norm_primal_linear_objective=torch.linalg.vector_norm(
                vectors["c"], dim=0),
            l2_norm_primal_right_hand_side=torch.linalg.vector_norm(
                vectors["b"], dim=0),
        ),
    )
    if _is_mp(params):
        state = _initial_mp_state(params, pattern, v_orig, n, m, lanes,
                                  dtype, device, rescaled)
    else:
        state = _initial_pdhg_state(params, n, m, lanes, dtype, device,
                                    rescaled)
    # one read-back for the host-side unscaling vectors
    cum_con = rescaled.cum_con.double().cpu().numpy()
    cum_var = rescaled.cum_var.double().cpu().numpy()
    scaled_problems = [
        ScaledQpProblem(
            original_qp=originals[i],
            # the scaled host copy is not built; only the rescaling
            # vectors are used downstream
            scaled_qp=originals[i],
            constraint_rescaling=np.ascontiguousarray(cum_con[:, i]),
            variable_rescaling=np.ascontiguousarray(cum_var[:, i]),
        )
        for i in range(lanes)
    ]
    return SharedPatternFleet(bundle=bundle, initial_state=state,
                              scaled_problems=scaled_problems, device=device)


def _canonical_csr(matrix) -> sp.csr_matrix:
    csr = sp.csr_matrix(matrix, dtype=np.float64)
    csr.sum_duplicates()
    csr.sort_indices()
    return csr


def _prepare_fleet_fast(params, problems, device) -> SharedPatternFleet:
    """A list of problems: one (nnz, B) host stack, moved once."""
    dtype = torch_dtype(params.dtype)
    for p in problems:
        validate(p)
    mats = [_canonical_csr(p.constraint_matrix) for p in problems]
    pat = mats[0]
    k_eq = problems[0].num_equalities
    for p, a in zip(problems, mats):
        if (
            a.shape != pat.shape
            or a.nnz != pat.nnz
            or p.num_equalities != k_eq
            or not np.array_equal(a.indptr, pat.indptr)
            or not np.array_equal(a.indices, pat.indices)
        ):
            raise ValueError(
                "shared-pattern batching requires identical sparsity "
                "patterns (heterogeneous fleets are not ported yet: A13b "
                "in ROADMAP.md)"
            )

    def lanes(arrays):
        stacked = np.stack([np.asarray(a, np.float64) for a in arrays],
                           axis=1)
        return torch.as_tensor(stacked, device=device).to(dtype).contiguous()

    v_orig = lanes([a.data for a in mats])
    vectors = {
        "c": lanes([p.objective_vector for p in problems]),
        "b": lanes([p.right_hand_side for p in problems]),
        "lo": lanes([p.variable_lower_bound for p in problems]),
        "hi": lanes([p.variable_upper_bound for p in problems]),
    }
    const = torch.as_tensor(
        np.array([float(p.objective_constant) for p in problems]),
        device=device,
    ).to(dtype)
    pattern = build_lanes_pattern(pat, device)
    return _finish_fleet(params, pattern, k_eq, v_orig, vectors, const,
                         list(problems), device)


def _spec_lanes(spec: FleetSpec, dtype, device, shape):
    """(v_orig, vectors, const) of every lane, generated on the device in
    one vmapped call per generator."""
    m, n, nnz = shape
    base = spec.base_problem
    thetas = torch.as_tensor(np.asarray(spec.thetas), device=device)
    b = int(thetas.shape[0])

    def lanes(gen, base_vec, dim):
        if gen is None:
            vec = torch.as_tensor(np.asarray(base_vec, np.float64),
                                  device=device).to(dtype)
            return vec[:, None].expand(dim, b).contiguous()
        out = torch.func.vmap(gen)(thetas)
        if tuple(out.shape) != (b, dim):
            raise ValueError(
                f"generator returned {tuple(out.shape)}, expected "
                f"({b}, {dim})"
            )
        return out.T.to(dtype).contiguous()

    v_orig = lanes(spec.matrix_values, None, nnz)
    vectors = {
        "c": lanes(spec.objective_vector, base.objective_vector, n),
        "b": lanes(spec.right_hand_side, base.right_hand_side, m),
        "lo": lanes(spec.variable_lower_bound, base.variable_lower_bound, n),
        "hi": lanes(spec.variable_upper_bound, base.variable_upper_bound, n),
    }
    if spec.objective_constant is None:
        const = torch.full((b,), float(base.objective_constant),
                           dtype=dtype, device=device)
    else:
        const = torch.func.vmap(spec.objective_constant)(thetas).to(dtype)
    return v_orig, vectors, const


def _prepare_fleet_from_spec(params, spec: FleetSpec,
                             device) -> SharedPatternFleet:
    """A FleetSpec: the base problem and the thetas go to the device, the
    lanes are generated there. The index tensors are kept on the spec,
    keyed by the pattern's hash and the device."""
    base = spec.base_problem
    validate(base)
    if base.objective_matrix is not None and base.objective_matrix.nnz > 0:
        raise NotImplementedError(_NOT_PORTED.format(what="QP fleets"))
    if spec.matrix_values is None:
        raise ValueError("FleetSpec.matrix_values is required")
    dtype = torch_dtype(params.dtype)
    pat = _canonical_csr(base.constraint_matrix)
    m, n = pat.shape
    key = (pattern_hash(pat), str(device))
    pattern = spec._patterns.get(key)
    if pattern is None:
        pattern = build_lanes_pattern(pat, device)
        spec._patterns.clear()
        spec._patterns[key] = pattern
    v_orig, vectors, const = _spec_lanes(spec, dtype, device,
                                         (m, n, pat.nnz))
    return _finish_fleet(params, pattern, base.num_equalities, v_orig,
                         vectors, const, [base] * spec.num_instances, device)


def _check_fleet_params(params) -> None:
    if not _is_mp(params):
        policy = params.step_size_policy_params
        if isinstance(policy, _pdhg.ConstantStepsizeParams):
            raise NotImplementedError(
                _NOT_PORTED.format(what="constant-step fleets"))
        if not isinstance(policy, _pdhg.AdaptiveStepsizeParams):
            raise ValueError(
                "batched solves support adaptive or constant step sizes")
        _pdhg._check_ported(params)
    if params.bound_width_rescaling:
        raise NotImplementedError(
            _NOT_PORTED.format(what="fleets with bound-width rescaling"))


def prepare_shared_pattern_fleet(params, problems, device=None
                                 ) -> SharedPatternFleet:
    """Rescales the fleet, builds the shared lane operators and the
    initial lane state on `device` (CUDA when None; raises without a
    GPU, the CPU only when asked). `problems`: a list of LPs with one
    sparsity pattern (ValueError otherwise), or a FleetSpec. Separate
    from the solve, so that repeated solves skip ingest."""
    device = resolve_device(device)
    _check_fleet_params(params)
    if isinstance(problems, FleetSpec):
        return _prepare_fleet_from_spec(params, problems, device)
    if len(problems) == 0:
        raise ValueError("an empty fleet has nothing to prepare")
    if any(p.objective_matrix is not None and p.objective_matrix.nnz > 0
           for p in problems):
        raise NotImplementedError(_NOT_PORTED.format(what="QP fleets"))
    return _prepare_fleet_fast(params, problems, device)


# ---------------------------------------------------------------------------
# Lane-wise evaluation: stats, localized gaps, restarts
# ---------------------------------------------------------------------------


def _lane_stats(bundle, criteria, avg_primal, avg_dual, numerical_error,
                iteration_number, kkt, elapsed_time):
    """evaluate_unscaled_stats per lane; a lane with a numerical error
    and no other reason ends with NUMERICAL_ERROR."""
    conv, infeas, reason = evaluate_unscaled_stats(
        bundle, criteria, avg_primal, avg_dual, False, iteration_number,
        kkt, elapsed_time,
    )
    reason = torch.where(
        numerical_error & (reason == 0),
        int(TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR), reason,
    ).to(torch.int32).expand(numerical_error.shape)
    return conv, infeas, reason


def _lp_parts(problem, x, y):
    """(A'y, A x, primal gradient c - A'y, Lagrangian) per lane of an LP
    (the objective matrix is zero, so the JAX package's Qx terms add
    exact zeros)."""
    aty = problem.aty(y)
    ax = problem.ax(x)
    lagrangian = (
        torch.sum(x * problem.objective_vector, dim=0)
        - torch.sum(x * aty, dim=0)
        + torch.sum(y * problem.right_hand_side, dim=0)
        + problem.objective_constant
    )
    return aty, ax, problem.objective_vector - aty, lagrangian


def _dual_bounds(problem, lanes):
    """(B, m) lower and upper bounds of the dual variables."""
    like = problem.right_hand_side
    lb = torch.where(problem.is_equality, -torch.inf, 0.0).to(like.dtype)
    return (lb.expand(like.shape).T,
            torch.full((lanes, like.shape[0]), torch.inf, dtype=like.dtype,
                       device=like.device))


def lane_euclidean_bounds(problem, points, primal_norm_weights,
                          dual_norm_weights, solve_approximately=False):
    """Euclidean-ball localized gaps at k points of every lane, in one
    trust-region solve of k B rows (the JAX package's
    bound_optimal_objective_euclidean_batched, one point and one lane a
    row). `points`: (primal (n, B), dual (m, B), radius (B,)) each; the
    weights are (n, B) and (m, B). Returns one ObjectiveBound of (B,)
    tensors per point."""
    n = problem.objective_vector.shape[0]
    lanes = problem.objective_vector.shape[1]
    k = len(points)
    parts = [_lp_parts(problem, x, y) for x, y, _ in points]
    dual_lb, dual_ub = _dual_bounds(problem, lanes)
    lb = torch.cat([problem.variable_lower_bound.T, dual_lb], dim=1)
    ub = torch.cat([problem.variable_upper_bound.T, dual_ub], dim=1)
    weights = torch.cat([primal_norm_weights.T, dual_norm_weights.T], dim=1)
    result = solve_bound_constrained_trust_region(
        torch.cat([torch.cat([x.T, y.T], dim=1) for x, y, _ in points]),
        torch.cat([
            torch.cat([pg.T, (ax - problem.right_hand_side).T], dim=1)
            for (_, ax, pg, _) in parts
        ]),
        lb.repeat(k, 1), ub.repeat(k, 1), weights.repeat(k, 1),
        torch.cat([r for _, _, r in points]),
        solve_approximately,
    )
    bounds = []
    for i, ((x, y, _), (_, ax, pg, lagrangian)) in enumerate(
            zip(points, parts)):
        sol = result.solution[i * lanes:(i + 1) * lanes]
        dual_gradient = problem.right_hand_side - ax
        bounds.append(ObjectiveBound(
            lagrangian_value=lagrangian,
            lower_bound_value=lagrangian + torch.sum(
                (sol[:, :n] - x.T) * pg.T, dim=1),
            upper_bound_value=lagrangian + torch.sum(
                (sol[:, n:] - y.T) * dual_gradient.T, dim=1),
        ))
    return bounds


def lane_bound_estimates(problem, primal, dual, primal_norm_weights,
                         dual_norm_weights):
    """update_objective_bound_estimates per lane: the MAX_NORM localized
    gap (reference saddle_point.jl:1015-1047); the primal and the dual
    subproblem each one trust-region solve of B rows."""
    lanes = primal.shape[1]
    est_p = torch.clamp_min(weighted_norm(primal, primal_norm_weights), 1e-8)
    est_d = torch.clamp_min(weighted_norm(dual, dual_norm_weights), 1e-8)
    _, ax, pg, lagrangian = _lp_parts(problem, primal, dual)
    radius = torch.ones(lanes, dtype=primal.dtype, device=primal.device)
    rp = solve_bound_constrained_trust_region(
        primal.T, pg.T, problem.variable_lower_bound.T,
        problem.variable_upper_bound.T, (primal_norm_weights / est_p ** 2).T,
        radius,
    )
    dual_lb, dual_ub = _dual_bounds(problem, lanes)
    rd = solve_bound_constrained_trust_region(
        dual.T, (ax - problem.right_hand_side).T, dual_lb, dual_ub,
        (dual_norm_weights / est_d ** 2).T, radius,
    )
    return lagrangian, lagrangian + rp.value, lagrangian - rd.value


class LaneRestart(NamedTuple):
    restart_choice: torch.Tensor  # (B,) int32 RestartChoice code
    primal_solution: torch.Tensor
    dual_solution: torch.Tensor
    avg: SolutionWeightedAverage
    restart_info: RestartInfo


def _reset_average(avg: SolutionWeightedAverage) -> SolutionWeightedAverage:
    return SolutionWeightedAverage(*(
        torch.zeros_like(getattr(avg, f.name))
        for f in dataclasses.fields(SolutionWeightedAverage)
    ))


def _distance_last_restart(restart_info, primal_weight):
    return torch.sqrt(
        restart_info.primal_distance_moved_last_restart_period ** 2
        * primal_weight
        + restart_info.dual_distance_moved_last_restart_period ** 2
        / primal_weight
    )


def lane_restart_scheme(problem, avg, current_primal, current_dual,
                        restart_info, iterations_completed,
                        primal_norm_params, dual_norm_params, primal_weight,
                        restart_params) -> LaneRestart:
    """run_restart_scheme per lane, every decision a device select (the
    JAX package's saddle_point.run_restart_scheme, saddle_point.py:423
    there; reference saddle_point.jl:651-846)."""
    lanes = primal_weight.shape[0]
    device = primal_weight.device
    has_average = ((avg.sum_primal_solutions_count > 0)
                   & (avg.sum_dual_solutions_count > 0))
    safe_avg_primal = avg.sum_primal_solutions / torch.where(
        avg.sum_primal_solution_weights > 0,
        avg.sum_primal_solution_weights, 1.0,
    )
    safe_avg_dual = avg.sum_dual_solutions / torch.where(
        avg.sum_dual_solution_weights > 0, avg.sum_dual_solution_weights, 1.0
    )
    restart_length = avg.sum_primal_solutions_count
    do_restart = restart_length.to(torch.float64) >= (
        restart_params.artificial_restart_threshold
        * iterations_completed.to(torch.float64)
    )
    false = torch.zeros(lanes, dtype=torch.bool, device=device)
    zero = torch.zeros_like(primal_weight)

    scheme = restart_params.restart_scheme
    if scheme == RestartScheme.NO_RESTARTS:
        reset_to_average = false
        candidate_gap = ObjectiveBound(zero, zero, zero)
        candidate_distance = zero
    else:
        def distance(primal, dual):
            return torch.sqrt(
                weighted_norm(primal - restart_info.primal_solution,
                              primal_norm_params) ** 2
                + weighted_norm(dual - restart_info.dual_solution,
                                dual_norm_params) ** 2
            )

        dist_avg = distance(safe_avg_primal, safe_avg_dual)
        dist_cur = distance(current_primal, current_dual)
        points = [(safe_avg_primal, safe_avg_dual, dist_avg),
                  (current_primal, current_dual, dist_cur)]
        if scheme == RestartScheme.ADAPTIVE_NORMALIZED:
            dist_last_restart = _distance_last_restart(restart_info,
                                                       primal_weight)
            points.append((restart_info.primal_solution,
                           restart_info.dual_solution, dist_last_restart))
        bounds = lane_euclidean_bounds(
            problem, points, primal_norm_params, dual_norm_params,
            restart_params.use_approximate_localized_duality_gap,
        )
        gap_avg, gap_cur = bounds[0], bounds[1]
        reset_to_average = should_reset_to_average(
            gap_cur, dist_cur, gap_avg, dist_avg,
            restart_params.restart_to_current_metric,
        ).expand(lanes)
        candidate_gap = ObjectiveBound(*(
            torch.where(reset_to_average, a, c)
            for a, c in zip(gap_avg, gap_cur)
        ))
        candidate_distance = torch.where(reset_to_average, dist_avg,
                                         dist_cur)

    gap_ratio_update = restart_info.gap_reduction_ratio_last_trial
    if scheme == RestartScheme.ADAPTIVE_NORMALIZED:
        normalized_candidate = candidate_gap.gap / candidate_distance
        normalized_last = bounds[2].gap / dist_last_restart
        gap_reduction_ratio = normalized_candidate / normalized_last
        do_restart = do_restart | (
            (gap_reduction_ratio
             < restart_params.necessary_reduction_for_restart)
            & ((gap_reduction_ratio
                < restart_params.sufficient_reduction_for_restart)
               | (gap_reduction_ratio
                  > restart_info.gap_reduction_ratio_last_trial))
        )
        gap_ratio_update = gap_reduction_ratio
    elif scheme in (RestartScheme.ADAPTIVE_LOCALIZED,
                    RestartScheme.ADAPTIVE_DISTANCE):
        if scheme == RestartScheme.ADAPTIVE_LOCALIZED:
            new_potential = candidate_gap.gap / restart_length
            old_potential = (restart_info.gap
                             / restart_info.last_restart_length)
        else:
            new_potential = candidate_distance / restart_length
            old_potential = (
                _distance_last_restart(restart_info, primal_weight)
                / restart_info.last_restart_length)
        scheme_restart = (new_potential / old_potential
                          < restart_params.necessary_reduction_for_restart)
        # automatically restart if no restart has occurred yet
        do_restart = do_restart | torch.where(
            restart_info.has_gap, scheme_restart, True)
    elif scheme == RestartScheme.FIXED_FREQUENCY:
        do_restart = do_restart | (
            restart_params.restart_frequency_if_fixed <= restart_length)
    do_restart = do_restart & has_average

    to_average = do_restart & reset_to_average
    new_primal = torch.where(to_average, safe_avg_primal, current_primal)
    new_dual = torch.where(to_average, safe_avg_dual, current_dual)
    sqrt_weight = torch.sqrt(primal_weight)
    updated_info = RestartInfo(
        primal_solution=new_primal,
        dual_solution=new_dual,
        has_gap=torch.full((lanes,), scheme != RestartScheme.NO_RESTARTS,
                           device=device),
        gap=candidate_gap.gap,
        last_restart_length=restart_length,
        primal_distance_moved_last_restart_period=weighted_norm(
            safe_avg_primal - restart_info.primal_solution,
            primal_norm_params,
        ) / sqrt_weight,
        dual_distance_moved_last_restart_period=weighted_norm(
            safe_avg_dual - restart_info.dual_solution, dual_norm_params
        ) * sqrt_weight,
        gap_reduction_ratio_last_trial=gap_ratio_update,
    )
    # gap_reduction_ratio_last_trial moves on every ADAPTIVE_NORMALIZED
    # trial, restart or not (reference l.590)
    kept_info = dataclasses.replace(
        restart_info, gap_reduction_ratio_last_trial=gap_ratio_update)
    choice = torch.where(
        ~do_restart, int(RestartChoice.RESTART_CHOICE_NO_RESTART),
        torch.where(
            reset_to_average,
            int(RestartChoice.RESTART_CHOICE_RESTART_TO_AVERAGE),
            int(RestartChoice.RESTART_CHOICE_WEIGHTED_AVERAGE_RESET),
        ),
    ).to(torch.int32)
    result = LaneRestart(
        restart_choice=choice,
        primal_solution=new_primal,
        dual_solution=new_dual,
        avg=_select(do_restart, _reset_average(avg), avg),
        restart_info=_select(do_restart, updated_info, kept_info),
    )
    # no average at all: nothing happens (reference l.703-709)
    no_restart = LaneRestart(
        restart_choice=torch.full_like(
            choice, int(RestartChoice.RESTART_CHOICE_NO_RESTART)),
        primal_solution=current_primal,
        dual_solution=current_dual,
        avg=avg,
        restart_info=restart_info,
    )
    return _select(has_average, result, no_restart)


def _averages(state, primal, dual):
    """The evaluation's candidate per lane: the weighted average where
    there is one (and no numerical error), else the current iterate."""
    avg = state.avg
    has_avg = (~state.numerical_error
               & (avg.sum_primal_solutions_count > 0)
               & (avg.sum_dual_solutions_count > 0))
    avg_primal = torch.where(
        has_avg,
        avg.sum_primal_solutions / torch.where(
            avg.sum_primal_solution_weights > 0,
            avg.sum_primal_solution_weights, 1.0),
        primal,
    )
    avg_dual = torch.where(
        has_avg,
        avg.sum_dual_solutions / torch.where(
            avg.sum_dual_solution_weights > 0,
            avg.sum_dual_solution_weights, 1.0),
        dual,
    )
    return avg_primal, avg_dual


def _bound_estimates(config, problem, avg_primal, avg_dual, primal_norm,
                     dual_norm):
    if config.need_bound_estimates:
        return lane_bound_estimates(problem, avg_primal, avg_dual,
                                    primal_norm, dual_norm)
    zero = torch.zeros(avg_primal.shape[1], dtype=avg_primal.dtype,
                       device=avg_primal.device)
    return zero, zero, zero


def _frozen_result(state, entry, already, reason, terminated, restart,
                   kkt, avg_primal, avg_dual, stats, bounds):
    """The evaluation's closing selects (the JAX package's _eval_block):
    a lane that terminates now keeps its pre-restart state; a lane that
    had terminated before keeps its entry state whole."""
    new_state = dataclasses.replace(
        state,
        cumulative_kkt_passes=kkt,
        termination_reason=reason,
        avg_primal_out=avg_primal,
        avg_dual_out=avg_dual,
    )
    new_state = _select(already, entry, new_state)
    conv, infeas = stats
    lagrangian, est_lb, est_ub = bounds
    result = EvalResult(
        conv=conv,
        infeas=infeas,
        lagrangian_value=lagrangian,
        estimated_lower_bound=est_lb,
        estimated_upper_bound=est_ub,
        termination_reason=new_state.termination_reason,
        restart_used=torch.where(
            terminated | already,
            int(RestartChoice.RESTART_CHOICE_UNSPECIFIED),
            restart.restart_choice,
        ).to(torch.int32),
        iteration=entry.iteration - 1,
        cumulative_kkt_passes=new_state.cumulative_kkt_passes,
        step_size=entry.step_size,
        primal_weight=entry.primal_weight,
    )
    return new_state, result


# ---------------------------------------------------------------------------
# PDHG lanes
# ---------------------------------------------------------------------------


def _pdhg_step_size_factors(total, policy, dtype):
    """(1 - (total + 1)^-reduction, 1 + (total + 1)^-growth) per lane, on
    the device in the working precision."""
    t1 = total.to(dtype) + 1.0
    return (1 - t1 ** (-policy.reduction_exponent),
            1 + t1 ** (-policy.growth_exponent))


def pdhg_lane_step(problem, state, active, policy):
    """One accept/reject trial of the adaptive step rule in every lane
    (the JAX package's _take_step_adaptive, pdhg.py:303-410 there);
    lanes where `active` is false stay bitwise as they were."""
    step = state.step_size
    pw = state.primal_weight
    x = state.current_primal_solution
    y = state.current_dual_solution
    aty = state.current_dual_product
    total = state.total_number_iterations + 1
    next_x = project_primal(
        x - (step / pw) * (problem.objective_vector - aty), problem)
    extrapolated = next_x + (next_x - x)
    next_y = project_dual(
        y + (pw * step) * (problem.right_hand_side - problem.ax(extrapolated)),
        problem,
    )
    next_aty = problem.aty(next_y)
    dx = next_x - x
    dy = next_y - y
    interaction = torch.abs(torch.sum(dx * (next_aty - aty), dim=0))
    movement = (0.5 * pw * torch.sum(dx * dx, dim=0)
                + (0.5 / pw) * torch.sum(dy * dy, dim=0))
    numerical_error = movement == 0.0
    step_size_limit = torch.where(
        interaction > 0,
        movement / torch.where(interaction > 0, interaction, 1.0),
        torch.inf,
    )
    accept = (step <= step_size_limit) & ~numerical_error
    shrink, grow = _pdhg_step_size_factors(total, policy, step.dtype)
    new_step = torch.where(
        numerical_error, step,
        torch.minimum(shrink * step_size_limit, grow * step),
    )
    take = active & accept
    return dataclasses.replace(
        state,
        delta_primal=torch.where(take, dx, state.delta_primal),
        delta_dual=torch.where(take, dy, state.delta_dual),
        current_primal_solution=torch.where(take, next_x, x),
        current_dual_solution=torch.where(take, next_y, y),
        current_dual_product=torch.where(take, next_aty, aty),
        avg=_select(
            take,
            add_to_solution_weighted_average(state.avg, next_x, next_y, step),
            state.avg,
        ),
        iteration=torch.where(take, state.iteration + 1, state.iteration),
        step_size=torch.where(active, new_step, step),
        numerical_error=torch.where(active, numerical_error,
                                    state.numerical_error),
        total_number_iterations=torch.where(
            active, total, state.total_number_iterations),
        cumulative_kkt_passes=torch.where(
            active, state.cumulative_kkt_passes + 1.0,
            state.cumulative_kkt_passes),
    )


def pdhg_eval_block(bundle, state, elapsed_time, config):
    """One evaluation and restart decision in every lane (the JAX
    package's pdhg._eval_block with its already_terminated freeze,
    pdhg.py:577-722 there)."""
    entry = state
    already = state.termination_reason != 0
    kkt = state.cumulative_kkt_passes + _pdhg.KKT_PASSES_PER_TERMINATION_EVALUATION
    x, y = state.current_primal_solution, state.current_dual_solution
    avg_primal, avg_dual = _averages(state, x, y)
    conv, infeas, reason = _lane_stats(
        bundle, config.criteria, avg_primal, avg_dual, state.numerical_error,
        state.iteration - 1, kkt, elapsed_time,
    )
    scale = (1.0 / state.step_size) * state.primal_weight
    primal_norm = scale * torch.ones_like(x)
    dual_norm = (1.0 / state.step_size) / state.primal_weight * (
        torch.ones_like(y))
    bounds = _bound_estimates(config, bundle.scaled, avg_primal, avg_dual,
                              primal_norm, dual_norm)
    terminated = reason != 0
    restart = lane_restart_scheme(
        bundle.scaled, state.avg, x, y, state.restart_info,
        state.iteration - 1, primal_norm, dual_norm, state.primal_weight,
        config.restart_params,
    )
    restarted = restart.restart_choice != int(
        RestartChoice.RESTART_CHOICE_NO_RESTART)
    new_primal_weight = torch.where(
        restarted,
        compute_new_primal_weight(
            restart.restart_info, state.primal_weight,
            config.restart_params.primal_weight_update_smoothing,
        ),
        state.primal_weight,
    )
    to_average = restart.restart_choice == int(
        RestartChoice.RESTART_CHOICE_RESTART_TO_AVERAGE)
    post_restart = dataclasses.replace(
        state,
        current_primal_solution=restart.primal_solution,
        current_dual_solution=restart.dual_solution,
        avg=restart.avg,
        restart_info=restart.restart_info,
        primal_weight=new_primal_weight,
        ratio_step_sizes=torch.where(restarted, 1.0, state.ratio_step_sizes),
        # one lane product for all lanes, kept where a lane restarted to
        # the average
        current_dual_product=torch.where(
            to_average, bundle.scaled.aty(restart.dual_solution),
            state.current_dual_product,
        ),
    )
    state = _select(terminated, state, post_restart)
    return _frozen_result(state, entry, already, reason, terminated,
                          restart, kkt, avg_primal, avg_dual,
                          (conv, infeas), bounds)


# ---------------------------------------------------------------------------
# Mirror Prox lanes
# ---------------------------------------------------------------------------


def _mp_step_size_factors(iteration, dtype):
    """(1 - (iteration + 1)^-0.3, 1 + (iteration + 1)^-0.6) per lane, on
    the device in the working precision."""
    it1 = iteration.to(dtype) + 1.0
    return 1 - it1 ** (-0.3), 1 + it1 ** (-0.6)


def mp_lane_step(problem, state, active):
    """One extragradient iteration in every lane (the JAX package's
    mirror_prox._take_step, mirror_prox.py:163 there) plus the segment
    loop's iteration count; lanes where `active` is false stay bitwise
    as they were. Four lane products."""
    x, y = state.current_primal, state.current_dual
    ps, ds, step = state.primal_scaling, state.dual_scaling, state.step_size
    c, b = problem.objective_vector, problem.right_hand_side

    def prox(gx, gy):
        return (project_primal(x - step * gx / ps, problem),
                project_dual(y - step * gy / ds, problem))

    gx, gy = c - problem.aty(y), problem.ax(x) - b
    test_x, test_y = prox(gx, gy)
    tgx, tgy = c - problem.aty(test_y), problem.ax(test_x) - b
    cand_x, cand_y = prox(tgx, tgy)

    def bregman(dx, dy):
        return 0.5 * (torch.sum(ps * dx * dx, dim=0)
                      + torch.sum(ds * dy * dy, dim=0))

    nonlinearity = (torch.sum((tgx - gx) * (test_x - cand_x), dim=0)
                    + torch.sum((tgy - gy) * (test_y - cand_y), dim=0))
    movement = (bregman(cand_x - test_x, cand_y - test_y)
                + bregman(test_x - x, test_y - y))
    numerical_error = movement == 0.0
    inv_stepsize_required = nonlinearity / torch.where(
        numerical_error, 1.0, movement)
    accept = (inv_stepsize_required <= 1.0 / step) & ~numerical_error
    shrink, grow = _mp_step_size_factors(state.iteration, step.dtype)
    new_step = torch.minimum(shrink / torch.abs(inv_stepsize_required),
                             grow * step)
    # on movement == 0 nothing but the flag moves (mirror_prox.jl:872-878)
    moved = active & ~numerical_error
    take = moved & accept
    return dataclasses.replace(
        state,
        current_primal=torch.where(take, cand_x, x),
        current_dual=torch.where(take, cand_y, y),
        avg=_select(
            take,
            add_to_solution_weighted_average(state.avg, test_x, test_y, step),
            state.avg,
        ),
        step_size=torch.where(moved, new_step, step),
        accepted_iterations=torch.where(
            take, state.accepted_iterations + 1, state.accepted_iterations),
        iterations_completed=torch.where(
            moved, state.iterations_completed + 1,
            state.iterations_completed),
        cumulative_kkt_passes=torch.where(
            moved, state.cumulative_kkt_passes + _mp.KKT_PASSES_PER_ITERATION,
            state.cumulative_kkt_passes),
        numerical_error=torch.where(active, numerical_error,
                                    state.numerical_error),
        iteration=torch.where(active, state.iteration + 1, state.iteration),
    )


def mp_eval_block(bundle, state, elapsed_time, config):
    """One evaluation and restart decision in every lane (the JAX
    package's mirror_prox._eval_block with its freeze, mirror_prox.py:238
    there)."""
    entry = state
    already = state.termination_reason != 0
    kkt = state.cumulative_kkt_passes + _mp.KKT_PASSES_PER_TERMINATION_EVALUATION
    x, y = state.current_primal, state.current_dual
    avg_primal, avg_dual = _averages(state, x, y)
    conv, infeas, reason = _lane_stats(
        bundle, config.criteria, avg_primal, avg_dual, state.numerical_error,
        state.iteration - 1, kkt, elapsed_time,
    )
    bounds = _bound_estimates(config, bundle.scaled, avg_primal, avg_dual,
                              state.primal_scaling, state.dual_scaling)
    terminated = reason != 0
    restart = lane_restart_scheme(
        bundle.scaled, state.avg, x, y, state.restart_info,
        state.iterations_completed, state.primal_scaling,
        state.dual_scaling, state.primal_weight, config.restart_params,
    )
    restarted = restart.restart_choice != int(
        RestartChoice.RESTART_CHOICE_NO_RESTART)
    new_primal_weight = torch.where(
        restarted,
        compute_new_primal_weight(
            restart.restart_info, state.primal_weight,
            config.restart_params.primal_weight_update_smoothing,
        ),
        state.primal_weight,
    )
    # update_mirror_prox_norms (reference mirror_prox.jl:552-571)
    ratio = new_primal_weight / state.primal_weight
    post_restart = dataclasses.replace(
        state,
        current_primal=restart.primal_solution,
        current_dual=restart.dual_solution,
        avg=restart.avg,
        restart_info=restart.restart_info,
        primal_weight=new_primal_weight,
        primal_scaling=state.primal_scaling * ratio,
        dual_scaling=state.dual_scaling / ratio,
    )
    state = _select(terminated, state, post_restart)
    return _frozen_result(state, entry, already, reason, terminated,
                          restart, kkt, avg_primal, avg_dual,
                          (conv, infeas), bounds)


# ---------------------------------------------------------------------------
# Segments and the host loop
# ---------------------------------------------------------------------------


def _is_eval_iteration(iteration, config):
    """Per lane: is `iteration` an evaluation iteration."""
    freq = config.termination_evaluation_frequency
    return ((torch.remainder(iteration - 1, freq) == 0)
            | (iteration == config.criteria.iteration_limit + 1)
            | (iteration <= 10))


def next_eval_iteration(iteration: int, config) -> int:
    """The first evaluation iteration after `iteration` (host ints)."""
    if iteration + 1 <= 10:
        return iteration + 1
    freq = config.termination_evaluation_frequency
    following = iteration + freq - (iteration - 1) % freq
    limit = int(config.criteria.iteration_limit) + 1
    return min(following, limit) if limit > iteration else following


class SegmentCounts(NamedTuple):
    running: bool  # some lane runs after the evaluation
    trials: int  # step trials launched
    read_backs: int  # host waits for the device


def run_segment(bundle, state, elapsed_time, config):
    """One evaluation, then the step trials up to every lane's next
    evaluation iteration: trials with no read-back up to the fewest the
    segment can take, then one read-back a trial of whether any lane is
    active. Returns (state, result, SegmentCounts)."""
    mp = isinstance(config, _mp._MpConfig)
    eval_block = mp_eval_block if mp else pdhg_eval_block
    state, result = eval_block(bundle, state, elapsed_time, config)
    running = state.termination_reason == 0
    any_running, it0 = torch.stack([
        running.any().to(torch.int64),
        torch.where(running, state.iteration, 0).amax(),
    ]).tolist()
    if not any_running:
        return state, result, SegmentCounts(False, 0, 1)
    start = state.iteration
    floor = next_eval_iteration(int(it0), config) - int(it0)
    trials, read_backs = 0, 1
    while True:
        active = (
            (state.termination_reason == 0)
            & ~state.numerical_error
            & ((state.iteration == start)
               | ~_is_eval_iteration(state.iteration, config))
        )
        if trials >= floor:
            read_backs += 1
            if not bool(active.any()):
                break
        if mp:
            state = mp_lane_step(bundle.scaled, state, active)
        else:
            state = pdhg_lane_step(bundle.scaled, state, active,
                                   config.step_policy)
        trials += 1
    return state, result, SegmentCounts(True, trials, read_backs)


def _config(params):
    need = bool(params.record_iteration_stats or params.verbosity > 0)
    if _is_mp(params):
        return _mp._MpConfig(
            criteria=params.termination_criteria,
            restart_params=params.restart_params,
            termination_evaluation_frequency=int(
                params.termination_evaluation_frequency),
            need_bound_estimates=need,
        )
    return _pdhg._make_config(params)


def fleet_fingerprint(problems) -> str:
    """Binds a fleet checkpoint to its fleet. A list: the JAX package's
    fingerprint (sha256 over each problem's fingerprint), so either
    package resumes the other's file. A FleetSpec: its base problem and
    its thetas (the generators themselves cannot be hashed)."""
    from .checkpoint import problem_fingerprint

    h = hashlib.sha256()
    if isinstance(problems, FleetSpec):
        thetas = np.ascontiguousarray(problems.thetas, dtype=np.float64)
        h.update(problem_fingerprint(problems.base_problem).encode())
        h.update(repr(thetas.shape).encode())
        h.update(thetas.tobytes())
        return "fleet-spec:" + h.hexdigest()
    for p in problems:
        h.update(problem_fingerprint(p).encode())
    return "fleet:" + h.hexdigest()


_LIMIT_REASONS = (
    TerminationReason.TERMINATION_REASON_TIME_LIMIT,
    TerminationReason.TERMINATION_REASON_ITERATION_LIMIT,
    TerminationReason.TERMINATION_REASON_KKT_MATRIX_PASS_LIMIT,
)


@dataclasses.dataclass
class FleetRunStats:
    """What a solve_batch_shared_pattern call did on the host:
    dispatches, evaluations (segments), step trials and read-backs
    (host waits for the device, the reasons of each dispatch included).
    Read by chip_smoke.py."""

    dispatches: int = 0
    segments: int = 0
    trials: int = 0
    read_backs: int = 0


def solve_batch_shared_pattern(
    params, problems, fleet: Optional[SharedPatternFleet] = None,
    device=None, run_stats: Optional[FleetRunStats] = None,
) -> List[SaddlePointOutput]:
    """Solves a fleet of same-pattern LPs, one output per lane (the JAX
    package's solve_batch_shared_pattern, batch.py:1037-1245 there).

    `problems`: a list (identical shapes, num_equalities and sparsity
    patterns; ValueError otherwise) or a FleetSpec. `params`:
    PdhgParameters with the adaptive step rule, or MirrorProxParameters.
    `fleet` (from prepare_shared_pattern_fleet) skips ingest. `device`:
    CUDA when None (raises without a GPU), the CPU only when asked.
    Per dispatch (`evaluations_per_dispatch` evaluations) the host reads
    the (B,) reasons once; a lane's solve time is the end of the
    dispatch where it ended. Checkpoints (`checkpoint_path`,
    `resume_from_checkpoint`) hold the whole lane state; on resume, lanes
    that had ended on a limit run again."""
    if (not isinstance(problems, FleetSpec) and len(problems) == 0
            and fleet is None):
        return []
    validate_termination_criteria(params.termination_criteria)
    if fleet is None:
        fleet = prepare_shared_pattern_fleet(params, problems, device=device)
    bundle, state = fleet.bundle, fleet.initial_state
    scaled_problems = fleet.scaled_problems
    lanes = fleet.num_instances
    config = _config(params)
    if run_stats is None:
        run_stats = FleetRunStats()

    fingerprint = None
    if params.checkpoint_path or params.resume_from_checkpoint:
        fingerprint = fleet_fingerprint(problems)
    elapsed_offset = 0.0
    if params.resume_from_checkpoint:
        from .checkpoint import load_state

        state, elapsed_offset, _ = load_state(
            params.resume_from_checkpoint, state, fingerprint=fingerprint)
        # A limit of the previous run does not apply to this run's
        # criteria: those lanes run again. A lane that ended converged or
        # infeasible keeps its reason, frozen by the evaluation's guard.
        reasons = state.termination_reason
        limit_based = torch.zeros_like(reasons, dtype=torch.bool)
        for code in _LIMIT_REASONS:
            limit_based |= reasons == int(code)
        state = dataclasses.replace(
            state, termination_reason=torch.where(limit_based, 0, reasons))

    start_time = time.time() - elapsed_offset
    evals_per_dispatch = max(1, int(params.evaluations_per_dispatch))
    checkpoint_every = max(1, int(params.checkpoint_every_n_dispatches))
    lane_time = [None] * lanes
    while True:
        elapsed = time.time() - start_time
        for _ in range(evals_per_dispatch):
            state, result, counts = run_segment(bundle, state, elapsed,
                                                config)
            run_stats.segments += 1
            run_stats.trials += counts.trials
            run_stats.read_backs += counts.read_backs
            if not counts.running:
                break
        reasons = result.termination_reason.cpu().numpy()
        dispatch_elapsed = time.time() - start_time
        run_stats.dispatches += 1
        run_stats.read_backs += 1
        if params.checkpoint_path and (
                run_stats.dispatches % checkpoint_every == 0):
            from .checkpoint import save_state

            save_state(params.checkpoint_path, state,
                       elapsed_time=dispatch_elapsed,
                       metadata={"dispatches": run_stats.dispatches},
                       fingerprint=fingerprint)
        for i in range(lanes):
            if lane_time[i] is None and reasons[i] != 0:
                lane_time[i] = dispatch_elapsed
        if all(t is not None for t in lane_time):
            break
    return _outputs(result, state, scaled_problems, lane_time)


def _outputs(result, state, scaled_problems, lane_time):
    """One SaddlePointOutput per lane from the last evaluation (frozen
    lanes re-report their own values), fetched in one transfer."""
    lanes = len(scaled_problems)
    floats = [*result.conv, *result.infeas, result.lagrangian_value,
              result.estimated_lower_bound, result.estimated_upper_bound,
              result.cumulative_kkt_passes, result.step_size,
              result.primal_weight]
    host = torch.stack([
        torch.as_tensor(v).to(torch.float64).expand(lanes) for v in floats
    ]).cpu().numpy()
    reasons = result.termination_reason.cpu().numpy()
    iterations = result.iteration.cpu().numpy()
    nc, ni = len(result.conv), len(result.infeas)
    avg_primal = state.avg_primal_out.cpu()
    avg_dual = state.avg_dual_out.cpu()
    outputs = []
    for i, scaled in enumerate(scaled_problems):
        col = host[:, i]
        stats = to_host_stats(
            DeviceConvergenceInfo(*col[:nc]),
            DeviceInfeasibilityInfo(*col[nc:nc + ni]),
            int(iterations[i]),
            float(col[nc + ni + 3]),
            lane_time[i],
            RestartChoice.RESTART_CHOICE_UNSPECIFIED,
            float(col[nc + ni + 4]),
            float(col[nc + ni + 5]),
            {
                "lagrangian_value": float(col[nc + ni]),
                "estimated_lower_bound": float(col[nc + ni + 1]),
                "estimated_upper_bound": float(col[nc + ni + 2]),
            },
            PointType.POINT_TYPE_AVERAGE_ITERATE,
        )
        outputs.append(unscaled_saddle_point_output(
            scaled,
            avg_primal[:, i].contiguous(),
            avg_dual[:, i].contiguous(),
            TerminationReason(int(reasons[i])),
            int(iterations[i]),
            [stats],
        ))
    return outputs
