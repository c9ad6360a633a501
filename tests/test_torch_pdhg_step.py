"""The port's PDLP step trial on the f32 kernel operator (models/pdhg.
_fused_trial: F1a primal_step, B3/B6, B4/B7, F1b trial_epilogue of
ops/pdhg_step.py) on the CPU, where the wrappers take the plain
versions.

- Against the JAX package's _take_step_adaptive and _take_step_constant
  (its RoutedOp in Pallas interpret mode, as tests/test_torch_ops.py
  runs it) from the same state, made with numpy from a seed
  (tests/trial_cases.py), on a 1,000-node PageRank LP and on a bounded
  LP, for every case: accept, reject, numerical error, interaction 0,
  the first step with an empty average (an inactive trial has no JAX
  counterpart: the port's must change no bit). Counters and flags
  exactly; f32 values in the rounding class, |d| <= 1e-5 max|want| +
  1e-7 for vectors and rtol 1e-5 for scalars (the two sum B3/B4's
  products in different orders, and XLA may contract multiply-adds).
- The plain versions composed give bitwise the eager trial of the
  previous release (held here as `eager_trial`), on CSR and the tile
  plan, adaptive and constant, with the mask off for every reason.
- The wrappers' contracts: F1a's mask against pdhg._trial_active, the
  pow routes, the argument structures against the C source, F1a's
  output buffer (each vector 16-byte aligned for every n mod 4) and its
  grid (every entry one thread's, sigma and the mask a thread's of the
  last block) under each plan, devices other than the CPU and CUDA
  refused, and which problems take the fused trial.
"""

import ctypes
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu.models import pdhg as jx_pdhg

from firstorderlp_torch.models import pdhg as tx_pdhg
from firstorderlp_torch.ops import kernels_build, pdhg_step
from firstorderlp_torch.saddle_point import (
    compute_dual_gradient,
    project_dual,
)

import trial_cases as tc

INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32}


def assert_same_bits(got, want, path="state"):
    """Every field equal: tensors bitwise, dtype and shape too."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same_bits(getattr(got, f.name), getattr(want, f.name),
                             f"{path}.{f.name}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    if want.dtype in INT_OF:
        got, want = got.view(INT_OF[got.dtype]), want.view(INT_OF[want.dtype])
    assert torch.equal(got, want), path


# ---------------------------------------------------------------------------
# The port's trial against the JAX package's
# ---------------------------------------------------------------------------


def jax_params(rule):
    """tc.params(rule) in the JAX package's types."""
    policy = (jx_pdhg.ConstantStepsizeParams() if rule == "constant"
              else jx_pdhg.AdaptiveStepsizeParams(0.3, 0.6))
    return jx.PdhgParameters(
        l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0, primal_importance=1.0,
        scale_invariant_initial_primal_weight=True, verbosity=0,
        record_iteration_stats=False,
        termination_evaluation_frequency=tc.FREQUENCY,
        termination_criteria=jx.TerminationCriteria(
            eps_optimal_absolute=1e-4, eps_optimal_relative=1e-4,
            iteration_limit=2000),
        restart_params=jx.construct_restart_parameters(
            restart_scheme=jx.RestartScheme.ADAPTIVE_NORMALIZED,
            restart_to_current_metric=(
                jx.RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED),
            restart_frequency_if_fixed=100,
            artificial_restart_threshold=0.5,
            sufficient_reduction_for_restart=0.1,
            necessary_reduction_for_restart=0.9,
            primal_weight_update_smoothing=0.5,
            use_approximate_localized_duality_gap=False),
        step_size_policy_params=policy, dtype="float32",
        matrix_format="routed")


def jax_problem(name):
    p = tc.PROBLEMS[name]()
    return jx.linear_programming_problem(
        p.variable_lower_bound, p.variable_upper_bound, p.objective_vector,
        p.objective_constant, sp.csr_matrix(p.constraint_matrix),
        p.right_hand_side, p.num_equalities)


def jax_state(template, state):
    """The JAX PdhgState `template` with every leaf taken from the port's
    state of the same field names, in the template's dtypes."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: jax_state(getattr(template, f.name),
                              getattr(state, f.name))
            for f in dataclasses.fields(template)
        })
    return jnp.asarray(np.asarray(state.cpu()),
                       dtype=jnp.asarray(template).dtype)


def assert_rounding_class(got, want, name, scalar=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if scalar:
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        return
    bound = 1e-5 * float(np.max(np.abs(want), initial=0.0)) + 1e-7
    assert float(np.max(np.abs(got - want), initial=0.0)) <= bound, name


EXACT = ("iteration", "total_number_iterations", "cumulative_kkt_passes",
         "numerical_error", "avg.sum_primal_solutions_count",
         "avg.sum_dual_solutions_count")
VECTORS = ("current_primal_solution", "current_dual_solution",
           "delta_primal", "delta_dual", "current_dual_product",
           "avg.sum_primal_solutions", "avg.sum_dual_solutions")
SCALARS = ("step_size", "avg.sum_primal_solution_weights",
           "avg.sum_dual_solution_weights")


def field(state, name):
    for part in name.split("."):
        state = getattr(state, part)
    return state


@pytest.mark.parametrize("rule", ["adaptive", "constant"])
@pytest.mark.parametrize("problem,case", [
    pc for pc in tc.PROBLEM_CASES if pc[1] != "inactive"])
def test_trial_matches_the_jax_trial(problem, case, rule):
    prep, config = tc.prepared(problem, rule, "cpu")
    state, start = tc.case_state(prep, case)
    got = tx_pdhg._masked_trial(prep.bundle.scaled, config, state, start)

    jparams = jax_params(rule)
    jprep = jx_pdhg.prepare_problem(jparams, jax_problem(problem))
    take = (jx_pdhg._take_step_constant if rule == "constant"
            else jx_pdhg._take_step_adaptive)
    want = take(jprep.bundle.scaled, jax_state(jprep.initial_state, state),
                jparams.step_size_policy_params)

    for name in EXACT:
        assert np.asarray(field(got, name)) == np.asarray(
            field(want, name)), name
    for name in VECTORS:
        assert_rounding_class(field(got, name), field(want, name), name)
    for name in SCALARS:
        assert_rounding_class(field(got, name), field(want, name), name,
                              scalar=True)
    moved = int(got.iteration) - int(state.iteration)
    expected = {"reject": 0, "numerical_error": 0}.get(case, 1)
    assert moved == (1 if rule == "constant" else expected)
    assert bool(got.numerical_error) == (
        rule == "adaptive" and case == "numerical_error")
    if rule == "adaptive" and case == "interaction_zero":
        # an infinite limit: the step grows by 1 + (total + 2)^-0.6
        assert float(got.step_size) > float(state.step_size)


# ---------------------------------------------------------------------------
# The plain versions composed are the eager trial, bit for bit
# ---------------------------------------------------------------------------


def eager_trial(problem, config, state, start):
    """The previous release's eager trial on the f32 kernel operator
    (_take_step_adaptive's fused branch and _take_step_constant under
    _trial_active's mask), written out: the bits the fused trial
    keeps."""
    policy = config.step_policy
    active = tx_pdhg._trial_active(state, start, config)
    x, y = state.current_primal_solution, state.current_dual_solution
    step, weight = state.step_size, state.primal_weight
    total = state.total_number_iterations + 1
    next_x = torch.clamp(
        x - (step / weight) * (problem.objective_vector
                               - state.current_dual_product),
        problem.variable_lower_bound, problem.variable_upper_bound)
    if isinstance(policy, tx_pdhg.ConstantStepsizeParams):
        extrapolated = next_x + (next_x - x)
        next_y = project_dual(
            y + (weight * step) * compute_dual_gradient(problem,
                                                        extrapolated),
            problem)
        next_aty = problem.aty(next_y)
        take = active
    else:
        op = problem.constraint_matrix
        next_y, layout, dy2 = op.mv_dual_step(
            2.0 * next_x - x, y, problem.right_hand_side,
            problem.is_equality_f32, weight * step)
        next_aty, interaction, dx2 = op.rmv_stats(
            layout, next_x - x, state.current_dual_product)
        interaction = torch.abs(interaction)
        movement = 0.5 * weight * dx2 + (0.5 / weight) * dy2
        numerical_error = movement == 0.0
        limit = torch.where(
            interaction > 0,
            movement / torch.where(interaction > 0, interaction, 1.0),
            torch.inf)
        accept = (step <= limit) & ~numerical_error
        t1 = total.to(x.dtype) + 1.0
        shrink = 1 - t1 ** (-policy.reduction_exponent)
        grow = 1 + t1 ** (-policy.growth_exponent)
        new_step = torch.where(numerical_error, step,
                               torch.minimum(shrink * limit, grow * step))
        take = active & accept
    avg = state.avg
    moved = dataclasses.replace(
        state,
        delta_primal=next_x - x, delta_dual=next_y - y,
        current_primal_solution=next_x, current_dual_solution=next_y,
        current_dual_product=next_aty,
        avg=dataclasses.replace(
            avg,
            sum_primal_solutions=avg.sum_primal_solutions + next_x * step,
            sum_primal_solutions_count=avg.sum_primal_solutions_count + 1,
            sum_primal_solution_weights=(
                avg.sum_primal_solution_weights + step),
            sum_dual_solutions=avg.sum_dual_solutions + next_y * step,
            sum_dual_solutions_count=avg.sum_dual_solutions_count + 1,
            sum_dual_solution_weights=avg.sum_dual_solution_weights + step),
        iteration=state.iteration + 1,
    )
    out = dataclasses.replace(
        state,
        **{name: torch.where(take, getattr(moved, name), getattr(state, name))
           for name in ("delta_primal", "delta_dual",
                        "current_primal_solution", "current_dual_solution",
                        "current_dual_product", "iteration")},
        avg=type(avg)(*(
            torch.where(take, getattr(moved.avg, f.name),
                        getattr(avg, f.name))
            for f in dataclasses.fields(avg))),
        total_number_iterations=torch.where(
            active, total, state.total_number_iterations),
        cumulative_kkt_passes=torch.where(
            active, state.cumulative_kkt_passes + 1.0,
            state.cumulative_kkt_passes),
    )
    if isinstance(policy, tx_pdhg.ConstantStepsizeParams):
        return out
    return dataclasses.replace(
        out, step_size=torch.where(active, new_step, step),
        numerical_error=torch.where(active, numerical_error,
                                    state.numerical_error))


MASKS = {
    "terminated": dict(termination_reason=torch.tensor(2, dtype=torch.int32)),
    "numerical_error": dict(numerical_error=torch.tensor(True)),
}


@pytest.mark.parametrize("layout", ["csr", "tiled"])
@pytest.mark.parametrize("rule", ["adaptive", "constant"])
@pytest.mark.parametrize("problem", sorted(tc.PROBLEMS))
def test_plain_trial_is_bitwise_the_eager_trial(problem, rule, layout):
    prep, config = tc.prepared(problem, rule, "cpu",
                               tile_aligned=layout == "tiled")
    scaled = prep.bundle.scaled
    assert tx_pdhg._fused(scaled, prep.initial_state)
    for case in tc.CASES:
        if (problem, case) not in tc.PROBLEM_CASES:
            continue
        state, start = tc.case_state(prep, case)
        variants = {case: state}
        variants.update({f"{case}+{k}": dataclasses.replace(state, **v)
                         for k, v in MASKS.items()})
        for label, s in variants.items():
            got = tx_pdhg._masked_trial(scaled, config, s, start)
            assert_same_bits(got, eager_trial(scaled, config, s, start),
                             label)
            if label != case or case == "inactive":
                assert_same_bits(got, s, f"{label} (masked)")


# ---------------------------------------------------------------------------
# The wrappers' contracts
# ---------------------------------------------------------------------------


def test_primal_step_mask_is_trial_active():
    """F1a's mask against pdhg._trial_active, over iterations 1-130 about
    an iteration limit of 100, every start and flag."""
    prep, config = tc.prepared("bounded", "adaptive", "cpu")
    config = dataclasses.replace(config, criteria=dataclasses.replace(
        config.criteria, iteration_limit=100))
    state = tx_pdhg._device_counters(prep.initial_state)
    p = prep.bundle.scaled
    for iteration in range(1, 131):
        for start in (iteration, iteration - 1, 41):
            for reason, flag in ((0, False), (0, True), (3, False)):
                s = dataclasses.replace(
                    state, iteration=torch.tensor(iteration),
                    termination_reason=torch.tensor(reason,
                                                    dtype=torch.int32),
                    numerical_error=torch.tensor(flag))
                start_t = torch.tensor(start)
                *_, active = pdhg_step.primal_step(
                    s.current_primal_solution, p.objective_vector,
                    s.current_dual_product, p.variable_lower_bound,
                    p.variable_upper_bound, s.step_size, s.primal_weight,
                    s.termination_reason, s.numerical_error, s.iteration,
                    start_t, config.termination_evaluation_frequency,
                    config.criteria.iteration_limit, False)
                assert bool(active) == bool(
                    tx_pdhg._trial_active(s, start_t, config)), (
                        iteration, start, reason, flag)


@pytest.mark.parametrize("exponent,route", [
    (-0.3, pdhg_step.POW_GENERAL), (-0.6, pdhg_step.POW_GENERAL),
    (0.0, pdhg_step.POW_ZERO), (1.0, pdhg_step.POW_ONE),
    (0.5, pdhg_step.POW_SQRT), (-0.5, pdhg_step.POW_RSQRT),
    (-1.0, pdhg_step.POW_RECIP), (2.0, pdhg_step.POW_SQUARE),
    (3.0, pdhg_step.POW_CUBE), (-2.0, pdhg_step.POW_INV_SQUARE),
    # rounded to f32 before the product routes are tested, not before
    # the others
    (2.0 + 1e-12, pdhg_step.POW_SQUARE), (-1.0 + 1e-12,
                                          pdhg_step.POW_GENERAL),
])
def test_pow_route(exponent, route):
    assert pdhg_step.pow_route(exponent) == route


def c_struct(name):
    """(member, kind) of `struct name` in csrc/pdhg_step.cu: p pointer, i
    int, l long long, f float."""
    path = os.path.join(kernels_build.CSRC_DIR, "pdhg_step.cu")
    with open(path) as f:
        body = re.search(rf"struct {name} {{(.*?)\n}};", f.read(),
                         re.DOTALL).group(1)
    out = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        member = decl.rstrip(";").split()[-1].lstrip("*")
        kind = ("p" if "*" in decl else "l" if "long long" in decl
                else "f" if decl.startswith("float") else "i")
        out.append((member, kind))
    return out


@pytest.mark.parametrize("name", ["PrimalStepArgs", "EpilogueArgs"])
def test_argument_structs_match_the_source(name):
    cls = {"PrimalStepArgs": pdhg_step._PrimalStepArgs,
           "EpilogueArgs": pdhg_step._EpilogueArgs}[name]
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i",
            ctypes.c_longlong: "l", ctypes.c_float: "f"}
    assert [(n, kind[t]) for n, t in cls._fields_] == c_struct(name)
    assert kernels_build.KERNEL_SOURCES["primal_step"] == "pdhg_step.cu"
    assert kernels_build.KERNEL_SOURCES["trial_epilogue"] == "pdhg_step.cu"


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 6, 7, 1001, 100_000,
                               100_001, 100_002, 100_003])
def test_primal_layout_aligns_every_output(n):
    """F1a's output buffer: x+, z and dx each start at a multiple of 4
    floats (16 bytes) for every n mod 4, in order, without overlap, and
    sigma after dx, the buffer's last float."""
    (x_at, z_at, dx_at, sigma_at), size = pdhg_step.primal_layout(n)
    assert [a % 4 for a in (x_at, z_at, dx_at)] == [0, 0, 0]
    assert x_at == 0 and x_at + n <= z_at and z_at + n <= dx_at
    assert dx_at + n <= sigma_at == size - 1
    assert z_at - n < 4 and sigma_at - dx_at - n < 4


def primal_entries(n):
    """The entries each thread of F1a's grid writes (a model of
    primal_step_kernel's indexing), and the thread that writes sigma and
    the mask."""
    nq = n // 4
    threads = pdhg_step.primal_grid(n) * pdhg_step.PRIMAL_THREADS
    owner, scalar = {}, []
    for t in range(threads):
        if t < nq:
            mine = [4 * t + k for k in range(4)]
        elif t - nq < 3:
            i = 4 * nq + t - nq
            mine = [i] if i < n else []
        else:
            mine = []
            if t - nq == 3:
                scalar.append(t)
        for i in mine:
            assert i not in owner, (i, t)
            owner[i] = t
    return owner, scalar, threads


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 255, 1016, 1017, 1020, 1030,
                               4097, 100_000, 100_001, 100_002, 100_003,
                               1_000_000])
def test_primal_grid_writes_every_entry_once(n):
    """Every entry of x+, z and dx has one thread, for every n mod 4 and
    at the edges of a block; one thread, in the grid's last block and
    past every entry's, writes sigma and the mask; no block is without
    work; the block is the kernel's."""
    owner, scalar, threads = primal_entries(n)
    block = pdhg_step.PRIMAL_THREADS
    assert sorted(owner) == list(range(n))
    assert len(scalar) == 1 and all(t < scalar[0] for t in owner.values())
    assert threads - block <= scalar[0] < threads
    path = os.path.join(kernels_build.CSRC_DIR, "pdhg_step.cu")
    with open(path) as f:
        threads_in_source = int(re.search(
            r"constexpr int kPrimalThreads = (\d+);", f.read()).group(1))
    assert block == threads_in_source


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA, or tensors on two
    devices, raise: no plain fallback off the CPU."""
    prep, config = tc.prepared("bounded", "adaptive", "cpu")
    state, start = tc.case_state(prep, "accept")
    p = prep.bundle.scaled
    args = [state.current_primal_solution, p.objective_vector,
            state.current_dual_product, p.variable_lower_bound,
            p.variable_upper_bound, state.step_size, state.primal_weight,
            state.termination_reason, state.numerical_error,
            state.iteration, start]
    with pytest.raises(ValueError):
        pdhg_step.primal_step(*[a.to("meta") for a in args], 40, 100, False)
    with pytest.raises(ValueError):
        pdhg_step.primal_step(args[0].to("meta"), *args[1:], 40, 100, False)
    fields = tx_pdhg._trial_fields(state)
    meta = pdhg_step.TrialFields(*(
        getattr(fields, f.name).to("meta")
        for f in dataclasses.fields(fields)))
    vec = state.current_primal_solution.to("meta")
    yvec = state.current_dual_solution.to("meta")
    with pytest.raises(ValueError):
        pdhg_step.trial_epilogue(meta, vec, vec, yvec, vec, None, None,
                                 None, torch.tensor(True, device="meta"),
                                 0.3, 0.6, True)


def test_only_the_f32_kernel_operator_lp_takes_the_fused_trial():
    prep, _ = tc.prepared("bounded", "adaptive", "cpu")
    assert tx_pdhg._fused(prep.bundle.scaled, prep.initial_state)
    for dtype in ("float32", "float64"):  # CsrOp
        csr = dataclasses.replace(tc.params(), matrix_format="sparse",
                                  dtype=dtype)
        prep_csr = tx_pdhg.prepare_problem(csr, tc.bounded_lp(),
                                           device="cpu")
        assert not tx_pdhg._fused(prep_csr.bundle.scaled,
                                  prep_csr.initial_state)
    qp = dataclasses.replace(tc.bounded_lp(),
                             objective_matrix=sp.eye(400, format="csc"))
    prep_qp = tx_pdhg.prepare_problem(tc.params(), qp, device="cpu")
    assert not tx_pdhg._fused(prep_qp.bundle.scaled, prep_qp.initial_state)
