"""The fleet's PDHG lane trial in four kernels (ops/lanes_step.py: LF1a
lane_primal_step, L1 with the dual step, L1' with the step-control sums
and the verdict, LF1b lane_trial_epilogue; batch.fused_lane_step), on
the CPU, where each wrapper runs its plain version.

- The plain versions composed are today's eager adaptive trial
  (batch.pdhg_lane_step) bit for bit on a
  1,500-node 8-lane PageRank damping sweep mid-solve, in f32 and f64:
  every vector, the mask, the verdict and the selected state, trial by
  trial over whole segments. The one exception is the change of
  contract: the step-control sums are added in f64 and rounded once,
  so in f32 they are held to the rounding class of the eager f32 sums
  (within n 2^-24 sum |t|), and the verdict fed the eager sums is the
  eager verdict bitwise. In f64 nothing differs.
- The same with one lane per case: accept, reject, numerical error,
  interaction 0, an empty average, and inactive lanes (an evaluation
  iteration past the segment's start, a terminated lane, a flagged
  lane), which keep every bit.
- Which trials take the fused path (batch._fused_lanes): adaptive PDHG
  on a LanesOp f32 LP on CUDA; not constant steps, block lanes, QPs,
  f64, CPU tensors or fleets past MAX_LANES lanes; Mirror Prox never
  (its segments count no fused trial). A segment through the fused
  trial (forced on the CPU) is the eager segment bitwise in f64, with
  the same trials and read-backs.
- Whole f32 fleets through the fused trial (forced on the CPU), both
  ingests, against the JAX package's solve_batch_shared_pattern on the
  same LPs: every lane OPTIMAL, each answer within the sweep cell's
  limits (host f64 residuals, the l1 distance between the two
  packages' answers).
- The argument structures and constants against the C source.

The heterogeneous fleets' run_segment against the JAX package stays in
test_torch_batch_hetero.py; the kernels themselves run on the card
(tests/test_torch_cuda.py -k "lane_trial or fused").
"""

import ctypes
import dataclasses
import os
import re
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_torch as tx
from firstorderlp_torch import batch, spans
from firstorderlp_torch.generators import (generate_pagerank_lp_fleet,
                                           pagerank_fleet_spec)
from firstorderlp_torch.models import pdhg as _pdhg
from firstorderlp_torch.ops import kernels_build, lanes_step
from firstorderlp_torch.ops.block_lanes import build_block_lanes
from firstorderlp_torch.ops.lanes import LAUNCHES

NODES, LANES = 1_500, 8
CPU = torch.device("cpu")


def fleet_params(dtype, rule="adaptive", pkg=tx, **extra):
    """The sweep cell's PDLP settings in package `pkg` (the port or the
    JAX package)."""
    policy = (pkg.ConstantStepsizeParams() if rule == "constant"
              else pkg.AdaptiveStepsizeParams(reduction_exponent=0.3,
                                              growth_exponent=0.6))
    return pkg.PdhgParameters(
        l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0, primal_importance=1.0,
        scale_invariant_initial_primal_weight=True, verbosity=0,
        record_iteration_stats=False, termination_evaluation_frequency=40,
        termination_criteria=pkg.TerminationCriteria(
            eps_optimal_absolute=1e-4, eps_optimal_relative=1e-4,
            eps_primal_infeasible=0.0, eps_dual_infeasible=0.0,
            iteration_limit=20_000),
        restart_params=pkg.construct_restart_parameters(
            restart_scheme=pkg.RestartScheme.ADAPTIVE_NORMALIZED,
            restart_to_current_metric=(
                pkg.RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED),
            restart_frequency_if_fixed=100, artificial_restart_threshold=0.5,
            sufficient_reduction_for_restart=0.1,
            necessary_reduction_for_restart=0.9,
            primal_weight_update_smoothing=0.5,
            use_approximate_localized_duality_gap=False),
        step_size_policy_params=policy, dtype=dtype, **extra)


DAMPING = np.linspace(0.7, 0.99, LANES)


def sweep_problems(ingest, generators=None):
    """The damping sweep as a FleetSpec ("spec": the device ingest) or a
    list ("list": the per-instance ingest), made by the port's
    generators or the JAX package's (`generators`, the module)."""
    if ingest == "spec":
        if generators is None:
            return pagerank_fleet_spec(NODES, DAMPING, seed=0)
        return generators.pagerank_fleet_spec(NODES, DAMPING, seed=0)
    return (generators.generate_pagerank_lp_fleet if generators else
            generate_pagerank_lp_fleet)(NODES, DAMPING, seed=0)


_FLEETS = {}


def mid_solve(dtype, segments=12):
    """(problem, state, config, bundle): the sweep `segments` segments
    into its solve (eager), kept per (dtype, segments)."""
    key = (dtype, segments)
    if key not in _FLEETS:
        params = fleet_params(dtype)
        fleet = batch.prepare_shared_pattern_fleet(
            params, sweep_problems("spec"), device=CPU)
        config = batch._config(params)
        state = fleet.initial_state
        for _ in range(segments):
            state, _, _ = batch.run_segment(fleet.bundle, state, 0.0, config)
        _FLEETS[key] = (fleet.bundle.scaled, state, config, fleet.bundle)
    return _FLEETS[key]


def leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from leaves(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name, v


INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def bits(t):
    """`t` as integers of its width: NaN payloads compare too."""
    return t.view(INT_OF[t.dtype]) if t.dtype in INT_OF else t


def differing(got, want):
    """The leaves of two states (or TrialFields) whose bits differ."""
    g = dict(leaves(got))
    return [k for k, v in leaves(want)
            if not torch.equal(bits(g[k]), bits(v))]


def in_rounding_class(got, want, terms):
    """f64 sums rounded once against the eager f32 sums: within
    n 2^-24 sum |t| a lane (the bound of recursive f32 summation)."""
    n = terms.shape[0]
    bound = n * 2.0 ** -24 * terms.double().abs().sum(dim=0)
    return bool(((got.double() - want.double()).abs() <= bound).all())


def eager_parts(problem, state, start, config):
    """What the eager trial computes on its way (batch._pdhg_trial_point,
    pdhg_lane_step): the mask, x+, z, y+, A'y+, the f32 sums and their
    terms, and the next state."""
    active = batch._lane_active(state, start, config)
    next_x, next_y, next_aty = batch._pdhg_trial_point(problem, state)
    x, y = state.current_primal_solution, state.current_dual_solution
    dx, dy = next_x - x, next_y - y
    terms = {"dy2": dy * dy,
             "interaction": dx * (next_aty - state.current_dual_product),
             "dx2": dx * dx}
    policy = config.step_policy
    if isinstance(policy, _pdhg.ConstantStepsizeParams):
        after = batch.pdhg_lane_step_constant(problem, state, active)
    else:
        after = batch.pdhg_lane_step(problem, state, active, policy)
    return dict(active=active, next_x=next_x, z=next_x + (next_x - x),
                next_y=next_y, next_aty=next_aty, terms=terms,
                sums={k: torch.sum(t, dim=0) for k, t in terms.items()},
                after=after)


def check_trial(problem, state, start, config):
    """Each plain kernel against the eager trial's parts, then the
    composed trial. Returns the eager next state."""
    freq = config.termination_evaluation_frequency
    limit = config.criteria.iteration_limit
    policy = config.step_policy
    f64 = state.step_size.dtype == torch.float64
    e = eager_parts(problem, state, start, config)
    op = problem.constraint_matrix
    x, y = state.current_primal_solution, state.current_dual_solution
    aty, step, weight = (state.current_dual_product, state.step_size,
                         state.primal_weight)
    next_x, z, active = lanes_step.lane_primal_step(
        None, x, problem.objective_vector, aty, problem.variable_lower_bound,
        problem.variable_upper_bound, step, weight, state.termination_reason,
        state.numerical_error, state.iteration, start, freq, limit)
    for got, want in ((next_x, e["next_x"]), (z, e["z"]),
                      (active, e["active"])):
        assert torch.equal(got, want)
    next_y, dy2 = lanes_step.lanes_dual_step(
        None, op.pattern.fwd, op.vals, z, y, problem.right_hand_side,
        problem.is_equality, step, weight)
    assert torch.equal(next_y, e["next_y"])
    f = _pdhg._trial_fields(state)
    args = (state.termination_reason, start, freq, limit)
    next_aty, interaction, dx2 = lanes_step.lanes_rmv_stats_plain(
        op.pattern.bwd, op.vals_t, next_y, next_x, x, aty)
    assert torch.equal(next_aty, e["next_aty"])
    for name, got in (("dy2", dy2), ("interaction", interaction),
                      ("dx2", dx2)):
        if f64:
            assert torch.equal(got, e["sums"][name]), name
        else:
            assert in_rounding_class(got, e["sums"][name],
                                     e["terms"][name]), name
    verdict = (active, step, weight, state.total_number_iterations,
               policy.reduction_exponent, policy.growth_exponent)
    # the verdict fed the eager f32 sums is the eager verdict
    take, new_step, new_error = lanes_step.lane_verdict_plain(
        e["sums"]["dy2"], e["sums"]["interaction"], e["sums"]["dx2"],
        *verdict)
    got, word = lanes_step.lane_trial_epilogue(
        f, next_x, next_y, next_aty, active, take, new_step, new_error,
        *args)
    assert differing(got, _pdhg._trial_fields(e["after"])) == []
    assert int(word) == int(batch._lane_active(
        e["after"], start, config).any())
    # the wrapper: L1' and the verdict in one call
    wrapped = lanes_step.lanes_rmv_stats(
        None, op.pattern.bwd, op.vals_t, next_y, next_x, x, aty, dy2,
        *verdict)
    assert torch.equal(wrapped[0], next_aty)
    mine = lanes_step.lane_verdict_plain(dy2, interaction, dx2, *verdict)
    for a, b in zip(wrapped[1:], mine):
        assert torch.equal(a, b)
    # composed: the eager state but for the step size, which follows the
    # f64 sums in f32
    got, word = batch.fused_lane_step(problem, state, start, config)
    want = e["after"]
    if f64:
        assert differing(got, want) == []
    else:
        assert set(differing(got, want)) <= {"step_size"}
        assert torch.allclose(got.step_size, want.step_size, rtol=NODES
                              * 2.0 ** -24, atol=0.0)
    assert int(word) == int(batch._lane_active(got, start, config).any())
    return want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_trial_is_the_eager_trial_over_a_segment(dtype):
    """Every trial of a segment from the eager trial's states: each plain
    kernel and the composed trial against the eager trial."""
    problem, state, config, _ = mid_solve(dtype)
    start = state.iteration.clone()
    trials = 0
    while bool(batch._lane_active(state, start, config).any()):
        state = check_trial(problem, state, start, config)
        trials += 1
    assert trials >= 30


CASES = ("accept", "reject", "numerical_error", "interaction_zero",
         "empty_average", "evaluation_iteration", "terminated", "flagged")


def case_state(problem, state):
    """One lane per case (CASES, in lane order) on a mid-solve state:
    the step size 1e3 times over (reject), 0 (numerical error: x+ = x,
    y+ = y); x at its lower bound 0 with the gradient c - A'y = 1
    pushing into it (interaction 0: x+ = x); an empty average; the
    iteration an evaluation iteration past the segment's start; a
    termination reason; the numerical-error flag set."""
    lane = {c: i for i, c in enumerate(CASES)}

    def col(t, case, value):
        t = t.clone()
        t[..., lane[case]] = value
        return t

    def scale(t, case, factor):
        t = t.clone()
        t[..., lane[case]] *= factor
        return t

    i = lane["interaction_zero"]
    x = col(state.current_primal_solution, "interaction_zero", 0.0)
    aty = state.current_dual_product.clone()
    aty[:, i] = problem.objective_vector[:, i] - 1.0
    step = scale(state.step_size, "reject", 1e3)
    step = col(step, "numerical_error", 0.0)
    avg = state.avg
    e = lane["empty_average"]
    avg = dataclasses.replace(avg, **{
        f.name: col(getattr(avg, f.name), "empty_average", 0)
        for f in dataclasses.fields(avg)})
    iteration = col(state.iteration, "evaluation_iteration", 81)
    start = col(state.iteration, "evaluation_iteration", 80)
    state = dataclasses.replace(
        state, current_primal_solution=x, current_dual_product=aty,
        step_size=step, avg=avg, iteration=iteration,
        termination_reason=col(state.termination_reason, "terminated", 1),
        numerical_error=col(state.numerical_error, "flagged", True))
    assert int(avg.sum_primal_solutions_count[e]) == 0
    return state, start


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_trial_is_the_eager_trial_in_every_case(dtype):
    """One lane a case: the plain kernels and the composed trial against
    the eager trial, which takes each case's branch; the inactive lanes
    keep every bit."""
    problem, state, config, _ = mid_solve(dtype)
    state, start = case_state(problem, state)
    after = check_trial(problem, state, start, config)
    lane = {c: i for i, c in enumerate(CASES)}
    moved = after.iteration != state.iteration
    assert moved.tolist() == [
        c in ("accept", "interaction_zero", "empty_average") for c in CASES]
    assert bool(after.numerical_error[lane["numerical_error"]])
    for case in ("evaluation_iteration", "terminated", "flagged"):
        i = lane[case]
        for name, v in leaves(after):
            assert torch.equal(v[..., i], dict(leaves(state))[name][..., i]), (
                case, name)


def test_lane_mask_is_the_segment_mask():
    """lane_active_plain (batch._lane_active, the yardstick of LF1a's
    mask and LF1b's any-lane word) against the mask written out over
    iterations, starts, flags and reasons."""
    _, state, config, _ = mid_solve("float32")
    freq = config.termination_evaluation_frequency
    limit = config.criteria.iteration_limit
    rng = np.random.default_rng(0)
    it = torch.as_tensor(np.r_[1:130, limit - 1:limit + 3], dtype=torch.int64)
    k = it.shape[0]
    start = torch.as_tensor(rng.integers(1, 130, k), dtype=torch.int64)
    start[::3] = it[::3]
    reason = torch.as_tensor(rng.integers(0, 3, k) * (rng.random(k) < 0.3),
                             dtype=torch.int32)
    error = torch.as_tensor(rng.random(k) < 0.2)
    lanes = types.SimpleNamespace(iteration=it, termination_reason=reason,
                                  numerical_error=error)
    want = torch.tensor([
        r == 0 and not e and (i == s0 or not (
            (i - 1) % freq == 0 or i == limit + 1 or i <= 10))
        for r, e, i, s0 in zip(reason.tolist(), error.tolist(),
                               it.tolist(), start.tolist())])
    assert torch.equal(
        lanes_step.lane_active_plain(reason, error, it, start, freq, limit),
        want)
    assert torch.equal(batch._lane_active(lanes, start, config), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_segments_are_the_eager_segments(dtype, monkeypatch):
    """Segments through fused_lane_step (forced on the CPU, where it runs
    the plain versions) against the eager segments from the same
    states: f64 bitwise, with the same trials and read-backs (the word
    LF1b writes in place of the mask's .any()); f32 the same counts of
    trials until a step size's f64 sums round apart. The fused trials
    are counted in COUNTS["fused_lane_trials"], every trial of a
    segment."""
    _, state, config, bundle = mid_solve(dtype, segments=1)
    for _ in range(3):
        before = dict(spans.COUNTS)
        monkeypatch.setattr(batch, "_fused_lanes", lambda *a: True)
        fused = batch.run_segment(bundle, state, 0.0, config)
        fused_trials = spans.COUNTS["fused_lane_trials"] - before[
            "fused_lane_trials"]
        assert fused_trials == spans.COUNTS["steps"] - before["steps"]
        monkeypatch.undo()
        before = spans.COUNTS["fused_lane_trials"]
        eager = batch.run_segment(bundle, state, 0.0, config)
        assert spans.COUNTS["fused_lane_trials"] == before
        assert fused[2] == eager[2] and fused_trials == eager[2].trials
        if dtype == "float64":
            assert differing(fused[0], eager[0]) == []
        state = eager[0]


def test_only_a_lanes_op_f32_lp_on_cuda_takes_the_fused_trial():
    """_fused_lanes: adaptive PDHG on a LanesOp f32 LP on CUDA, up to
    MAX_LANES lanes; not constant steps, block lanes (heterogeneous
    fleets), a QP, f64, CPU tensors or Mirror Prox, whose segments count
    no fused trial."""
    problem, state, config, bundle = mid_solve("float32")
    n = state.current_primal_solution.shape[0]

    def x_on(device, dtype=torch.float32, lanes=LANES):
        return types.SimpleNamespace(current_primal_solution=(
            types.SimpleNamespace(dtype=dtype, device=torch.device(device),
                                  shape=(n, lanes))))

    def fused(p, x, c=config):
        return batch._fused_lanes(p, x, c)

    assert fused(problem, x_on("cuda"))
    assert not fused(problem, x_on("cpu"))
    assert not fused(problem, x_on("cuda", torch.float64))
    assert not fused(problem, x_on("cuda", lanes=lanes_step.MAX_LANES + 1))
    assert fused(problem, x_on("cuda", lanes=lanes_step.MAX_LANES)) is (
        problem.constraint_matrix.lanes == LANES)
    assert not fused(problem, x_on("cuda"),
                     batch._config(fleet_params("float32", "constant")))
    qp = dataclasses.replace(problem,
                             objective_matrix=problem.constraint_matrix)
    assert not fused(qp, x_on("cuda"))
    a = problem.constraint_matrix
    host = sp.csr_matrix((np.ones(a.pattern.nnz), a.pattern.fwd.indices,
                          a.pattern.fwd.indptr), shape=a.shape)
    block = dataclasses.replace(
        problem, constraint_matrix=build_block_lanes([host, host], CPU))
    assert not fused(block, x_on("cuda"))
    # Mirror Prox
    pdhg_params = fleet_params("float32")
    params = tx.MirrorProxParameters(
        l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0, primal_importance=1.0,
        scale_invariant_initial_primal_weight=True, diagonal_scaling="l2",
        verbosity=0, record_iteration_stats=False,
        restart_params=pdhg_params.restart_params,
        termination_evaluation_frequency=40,
        termination_criteria=pdhg_params.termination_criteria,
        dtype="float32")
    mp_config = batch._config(params)
    assert not fused(problem, x_on("cuda"), mp_config)
    fleet = batch.prepare_shared_pattern_fleet(
        params, sweep_problems("spec"), device=CPU)
    before = spans.COUNTS["fused_lane_trials"]
    mp_state, _, counts = batch.run_segment(
        fleet.bundle, fleet.initial_state, 0.0, mp_config)
    assert counts.trials > 0
    assert spans.COUNTS["fused_lane_trials"] == before


@pytest.mark.parametrize("ingest", ["spec", "list"])
def test_fused_fleet_answers_are_the_jax_fleets(ingest, monkeypatch):
    """The f32 sweep solved to 1e-4 through the fused trial (forced on
    the CPU, where its wrappers run the plain versions: the step-control
    sums in f64, rounded once), by the device ingest (a FleetSpec) and
    the per-instance one (a list), against the JAX package's
    solve_batch_shared_pattern on the same LPs (its trial's sums in f32):
    every lane OPTIMAL in both, every trial of the port fused, each
    lane's host-f64 residuals within the sweep cell's 1.1e-4, and each
    lane's primal answer within the cell's l1 limit of 0.01 of the JAX
    package's."""
    import firstorderlp_tpu as jx
    from firstorderlp_tpu import batch as jx_batch
    from firstorderlp_tpu import generators as jx_generators

    from test_torch_cuda import host_lp_residuals

    want = jx_batch.solve_batch_shared_pattern(
        fleet_params("float32", pkg=jx, matrix_format="ell"),
        sweep_problems(ingest, jx_generators))
    monkeypatch.setattr(batch, "_fused_lanes", lambda *a: True)
    before = dict(spans.COUNTS)
    got = batch.solve_batch_shared_pattern(
        fleet_params("float32"), sweep_problems(ingest), device=CPU)
    steps = spans.COUNTS["steps"] - before["steps"]
    assert steps > 0 and spans.COUNTS["fused_lane_trials"] - before[
        "fused_lane_trials"] == steps
    lps = generate_pagerank_lp_fleet(NODES, DAMPING, seed=0)
    for lp, g, w in zip(lps, got, want):
        assert g.termination_reason.name == w.termination_reason.name == (
            "TERMINATION_REASON_OPTIMAL")
        assert max(host_lp_residuals(lp, g.primal_solution,
                                     g.dual_solution)) <= 1.1e-4
        assert float(np.abs(np.asarray(g.primal_solution, np.float64)
                            - np.asarray(w.primal_solution)).sum()) <= 0.01


def source(name):
    with open(os.path.join(kernels_build.CSRC_DIR, name)) as f:
        return f.read()


def c_struct(name, text):
    """(member, kind) of `struct name` in the source text: p pointer, i
    int, l long long, f float."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", text, re.DOTALL).group(1)
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


@pytest.mark.parametrize("cls,name,file", [
    (lanes_step._LanePrimalArgs, "LanePrimalArgs", "lanes_step.cu"),
    (lanes_step._LaneEpilogueArgs, "LaneEpilogueArgs", "lanes_step.cu"),
    (lanes_step._LaneStepArgs, "LaneStepArgs", "lanes_spmv.cu"),
])
def test_argument_structs_match_the_source(cls, name, file):
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i",
            ctypes.c_longlong: "l", ctypes.c_float: "f"}
    assert [(n, kind[t]) for n, t in cls._fields_] == c_struct(
        name, source(file))


def test_constants_and_libraries_match_the_source():
    """GROUP_ITEMS is kGroupItems; MAX_LANES keeps the products' shared
    f64 sums (4 warps x 2 sums x B) within 48 KB; the four libraries and
    their launch counters."""
    text = source("lanes_spmv.cu")
    assert lanes_step.GROUP_ITEMS == int(re.search(
        r"constexpr int kGroupItems = (\d+);", text).group(1))
    warps = 128 // 32
    assert warps * 2 * lanes_step.MAX_LANES * 8 <= 48 * 1024
    assert {lib: kernels_build.KERNEL_SOURCES[lib] for lib in (
        "lanes_dual_step", "lanes_rmv_stats", "lane_primal_step",
        "lane_trial_epilogue")} == {
        "lanes_dual_step": "lanes_spmv.cu",
        "lanes_rmv_stats": "lanes_spmv.cu",
        "lane_primal_step": "lanes_step.cu",
        "lane_trial_epilogue": "lanes_step.cu"}
    for key in ("lane_primal_step", "lanes_spmv:A+dual",
                "lanes_spmv:AT+stats", "lane_trial_epilogue"):
        assert key in LAUNCHES


def test_wrappers_refuse_mixed_and_other_devices():
    problem, state, config, _ = mid_solve("float32")
    x = state.current_primal_solution
    meta = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError):
        lanes_step.lane_primal_step(
            None, meta, problem.objective_vector,
            state.current_dual_product, problem.variable_lower_bound,
            problem.variable_upper_bound, state.step_size,
            state.primal_weight, state.termination_reason,
            state.numerical_error, state.iteration, state.iteration, 40, 10)
    with pytest.raises(ValueError):
        lanes_step._on_cpu(torch.empty(1, device="meta"))
