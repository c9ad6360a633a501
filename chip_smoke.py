#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (firstorderlp_torch) on one GPU.

Run from the root of the repository:

    python3 chip_smoke.py [--out FILE] [--profile] [--parent DIR]

Phases, each printing one JSON line:

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: compiles the CUDA kernels from firstorderlp_torch/csrc;
3. kernels: on the 100k-node PageRank LP (seed 0) after rescaling, each
   CSR kernel against its plain PyTorch version on the card, with times
   (CUDA events, median of 100 runs after warm-up; the device time and
   the kernels launched per call from torch.profiler), the bound from
   the bytes each call must move, the torch.sparse_csr_tensor product as
   the library yardstick, what the launch looks like (blocks, the
   largest and the mean number of stored entries per block, rows cut
   into pieces), 20 launches bitwise equal with the tickets back at
   zero, and each again with no row cut (`ms_without_row_split`,
   `device_ms_without_row_split`);
   kernels_tiled: the same for the tile-plan kernels (tile_aligned=True),
   each also held against the CSR kernel on the same vectors and
   launched twice for the same bits, with the device time of a call
   from torch.profiler and what the launch looks like (blocks, the
   largest and the mean number of stored entries per block, tiles staged
   and gathered, bytes staged);
   kernels_tiled_large: the three tile-plan kernels and the three CSR
   kernels, again on a matrix of the PageRank LP's
   structure with a million nodes (generators.pagerank_like_matrix, made
   in bulk with numpy: the generator's graph is a Python loop over the
   nodes), whose arrays are larger than the L2 cache;
   kernels_probe: the two probe kernels (ops/probe_routed.py) at 819,200
   entries, seed 0: the expand bitwise equal to its plain version and to
   numpy, the reduce against its plain version in f64, twice bitwise
   equal, its tickets back at zero and one kernel a call (counted at
   the host's launch calls, in every turn), with times
   (events and device time, in turns with the one-call library
   versions), bounds and the reduce's bytes beyond its inputs;
   probe_path: the probe script itself
   (python3 -m firstorderlp_torch.ops.probe_routed), with each probe
   kernel's launch count on that run;
4. main_path: firstorderlp_torch.optimize on that LP in f32 with the
   kernel operator, to OPTIMAL at 1e-4, with residuals recomputed in f64
   on the host and each kernel's launch count on that run;
   then the same solve warm (with --profile, under torch.profiler:
   device busy time and the ops that take it); with --parent DIR,
   main_path_parent: the warm solve at six seeds by another version of
   the package (DIR holds it as firstorderlp_torch_parent) and by this
   one, in turns;
5. determinism: the 20k-node LP solved twice, both OPTIMAL with
   bitwise-equal results;
6. refine_path: firstorderlp_torch.optimize_iterative_refinement on the
   100k-node LP to OPTIMAL at 1e-8 with the f32 phases on the tile-plan
   kernels (ops.routed.DEFAULT_TILE_ALIGNED set for the phase),
   residuals and gap recomputed in f64 here, the tile-plan kernels'
   launch counts above 0 and the CSR kernels' at 0;
7. determinism_tiled: the 20k-node LP solved twice on the tile plan;
8. mirror_prox_path: firstorderlp_torch.optimize with
   MirrorProxParameters on the 100k-node LP in f32 with the kernel
   operator (CSR layout, l2 mirror map), to OPTIMAL at 1e-4, residuals
   and gap recomputed in f64 here, spmv_csr launched at least twice per
   iteration for A and for A', every other kernel of ops/routed.py at 0
   (with --profile the same solve again under torch.profiler);
9. determinism_mp: the 20k-node LP solved twice by Mirror Prox on the
   tile plan, tiled_spmv launched and the CSR kernels not;
10. kernels_lanes: the lane kernel L1 (ops/lanes.py) on the 128-lane
    20k-node PageRank fleet's scaled planes, A and A', against its plain
    version on the card and an f64 recomputation, 20 launches bitwise
    equal with the tickets back at zero, with times (events; device time
    and kernels a call in turns with the block-diagonal library SpMV),
    the bound, blocks and entries per block (ops/compare_kernels.lanes_row,
    which compare_kernels --layout lanes prints too);
11. fleet_path: batch.solve_batch_shared_pattern on that fleet (a
    FleetSpec, pagerank_fleet_spec) by PDHG in f32 to 1e-4 with a limit
    of 20,000 iterations a lane; every lane OPTIMAL with residuals and
    gap recomputed in f64 on the host (a lane that is not: solved alone
    by optimize under the same limit, which must give the same reason);
    L1 launched, the single-instance kernels not; lanes 0 and 127 solved
    again by optimize (the same reason, host residuals under 1e-4);
    fleet_mirror_prox: the same with Mirror Prox;
12. fleet_throughput: bench.py's protocol (zero tolerances, 600
    iterations a lane, a warm-up solve, then a timed one), PDHG and
    Mirror Prox: aggregate iterations and KKT passes a second, ingest
    cold and warm, step trials and read-backs, and the kernel launches
    of a step trial and of an evaluation (one segment under
    torch.profiler); with --profile the timed solves under
    torch.profiler (device busy and idle share, top ops);
13. determinism_fleet: 16 lanes solved twice, bitwise equal;
    fleet_checkpoint: an 8-lane fleet stopped by a limit of 120
    iterations (one dispatch) with a checkpoint, resumed, against an
    uninterrupted run: the same reasons, solutions within 1e-6, and
    whether they are bitwise equal;
14. the kernel list ({"kernels": [...]}).

Then the `nvidia-smi` line and, last, {"ok": true, "device": {...}}.
Exits non-zero, before the last line, when there is no CUDA device or
any phase fails. Imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import json
import sys
import time

import numpy as np

TOL_ENTRY = 1e-5  # |d| <= TOL_ENTRY * (|A||x|)_i + TOL_ABS
TOL_ABS = 1e-7
TOL_SUM = 1e-5  # relative, on the reduced sums
NODES = 100_000  # the main path's PageRank LP
DET_NODES = 20_000  # the determinism phase's
LARGE_NODES = 1_000_000  # kernels_tiled_large's
SOLVE_SEEDS = (0, 1, 2, 3, 4, 5)  # main_path_parent's LPs (--parent)
# The fleet phases: the JAX package's headline fleet (bench.py), a
# PageRank damping sweep on one 20k-node graph, 128 lanes.
FLEET_NODES = 20_000
FLEET_LANES = 128
DET_FLEET_LANES = 16  # determinism_fleet's
CKPT_FLEET_LANES = 8  # fleet_checkpoint's
CKPT_LIMIT = 120  # its first run's iteration limit, a multiple of 40
THROUGHPUT_ITERS = 600  # fleet_throughput's iterations per lane

_lines = []


_start = time.time()
_card = {}  # "line": the nvidia-smi name and power limit, once known


def emit(obj) -> None:
    if "phase" in obj:  # the card, and seconds since the script started
        obj = {**obj, "at_seconds": round(time.time() - _start, 3)}
        obj.setdefault("card", _card.get("line"))
    line = json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def fail(phase: str, message: str) -> None:
    emit({"phase": phase, "ok": False, "error": message})
    raise SystemExit(1)


def make_params(tol, limit, dtype="float32", fmt="routed", pkg=None):
    """bench.py's make_params settings with tolerances: adaptive steps
    0.3/0.6, adaptive-normalized restarts, 10 Ruiz iterations +
    Pock-Chambolle alpha=1, an evaluation every 40 iterations. `pkg`:
    the package whose parameter types to use (default
    firstorderlp_torch)."""
    if pkg is None:
        import firstorderlp_torch as pkg

    return pkg.PdhgParameters(
        l_inf_ruiz_iterations=10,
        l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0,
        primal_importance=1.0,
        scale_invariant_initial_primal_weight=True,
        verbosity=0,
        record_iteration_stats=False,
        termination_evaluation_frequency=40,
        termination_criteria=pkg.TerminationCriteria(
            eps_optimal_absolute=tol,
            eps_optimal_relative=tol,
            eps_primal_infeasible=0.0,
            eps_dual_infeasible=0.0,
            iteration_limit=limit,
        ),
        restart_params=pkg.construct_restart_parameters(
            restart_scheme=pkg.RestartScheme.ADAPTIVE_NORMALIZED,
            restart_to_current_metric=(
                pkg.RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED
            ),
            restart_frequency_if_fixed=100,
            artificial_restart_threshold=0.5,
            sufficient_reduction_for_restart=0.1,
            necessary_reduction_for_restart=0.9,
            primal_weight_update_smoothing=0.5,
            use_approximate_localized_duality_gap=False,
        ),
        step_size_policy_params=pkg.AdaptiveStepsizeParams(
            reduction_exponent=0.3, growth_exponent=0.6
        ),
        dtype=dtype,
        matrix_format=fmt,
        evaluations_per_dispatch=64,
    )


def make_mp_params(tol, limit, dtype="float32", fmt="routed"):
    """bench.py's make_mp_params settings with tolerances: make_params'
    rescaling, restarts and evaluation frequency, the l2 mirror map."""
    from firstorderlp_torch import MirrorProxParameters

    p = make_params(tol, limit, dtype, fmt)
    return MirrorProxParameters(
        l_inf_ruiz_iterations=p.l_inf_ruiz_iterations,
        l2_norm_rescaling=p.l2_norm_rescaling,
        pock_chambolle_alpha=p.pock_chambolle_alpha,
        primal_importance=p.primal_importance,
        scale_invariant_initial_primal_weight=(
            p.scale_invariant_initial_primal_weight
        ),
        diagonal_scaling="l2",
        verbosity=0,
        record_iteration_stats=False,
        termination_evaluation_frequency=40,
        termination_criteria=p.termination_criteria,
        restart_params=p.restart_params,
        dtype=dtype,
        matrix_format=fmt,
        evaluations_per_dispatch=p.evaluations_per_dispatch,
    )


def host_residuals(problem, x, y):
    """Relative residuals of (x, y) on the unscaled problem, recomputed
    in f64 with scipy: the solver's own definitions (l2 norms, relative
    to eps_abs/eps_rel = 1 plus the norm of b, c or the objectives)."""
    a = problem.constraint_matrix.tocsr()
    b = problem.right_hand_side
    c = problem.objective_vector
    lb, ub = problem.variable_lower_bound, problem.variable_upper_bound
    meq = problem.num_equalities
    ax = a @ x
    viol = np.concatenate([
        (b - ax)[:meq],
        np.maximum(b - ax, 0.0)[meq:],
        np.maximum(lb - x, 0.0),
        np.maximum(x - ub, 0.0),
    ])
    g = c - a.T @ y
    bound = np.where(g > 0.0, lb, ub)
    rc = np.where(np.isfinite(bound), g, 0.0)
    dual_viol = np.concatenate([np.maximum(-y[meq:], 0.0), g - rc])
    primal_obj = problem.objective_constant + np.sum(c * x)
    active = rc != 0.0
    dual_obj = (
        np.sum(b * y) + problem.objective_constant
        + np.sum(np.where(active, bound, 0.0) * rc)
    )

    def norm(v):  # no BLAS call: its threads cost tens of ms a call here
        return np.sqrt(np.sum(v * v))

    return {
        "rel_primal_residual": float(norm(viol) / (1.0 + norm(b))),
        "rel_dual_residual": float(norm(dual_viol) / (1.0 + norm(c))),
        "rel_gap": float(
            abs(primal_obj - dual_obj)
            / (1.0 + abs(primal_obj) + abs(dual_obj))
        ),
    }


@contextlib.contextmanager
def timed(torch, profile_on: bool):
    """Times the block on the host clock, up to a device synchronize,
    under torch.profiler when `profile_on`; the profiler's own start and
    stop stay outside the time. Yields a dict that holds "t0" (the
    block's start) and, once the block has ended, "seconds" and, when
    profiling, "profile"."""
    result = {}
    profiler = contextlib.nullcontext()
    if profile_on:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        )
    with profiler as active:
        result["t0"] = time.time()
        yield result
        torch.cuda.synchronize()
        result["seconds"] = time.time() - result["t0"]
    if profile_on:
        result["profile"] = profile_summary(torch, active, result["seconds"])


def profile_summary(torch, profiler, wall_s):
    """Busy and idle share of the device (the kernels' device time,
    scaled to the host's launches as probe_routed.device_profile does),
    launches, and the top ops."""
    from firstorderlp_torch.ops.probe_routed import LAUNCH_CALLS

    host_events = profiler.key_averages()
    # Kernels only: an aten op's device time repeats its kernels'.
    events = [e for e in host_events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kept = sum(e.count for e in events)
    launches = max(kept, sum(
        e.count for e in host_events
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.key in LAUNCH_CALLS))
    # the device records the profiler lost, at the mean time of the kept
    device_us = sum(e.self_device_time_total for e in events) * (
        launches / kept if kept else 0.0)
    return {
        "device_busy_seconds": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall_s,
        "kernel_launches": launches,
        "device_records_kept": kept,
        "top_device_ops": [
            {"name": e.key[:60], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in sorted(events,
                            key=lambda e: -e.self_device_time_total)[:12]
        ],
        # this repository's own kernels (namespace folp), whatever their rank
        "port_kernels": [
            {"name": e.key[:60], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in events if "folp::" in e.key
        ],
        "top_host_ops": [
            {"name": e.key[:60], "calls": e.count,
             "host_ms": e.self_cpu_time_total / 1e3}
            for e in sorted(host_events,
                            key=lambda e: -e.self_cpu_time_total)[:12]
        ],
    }


def kernels_lanes(torch, lanes, fleet, compare):
    """L1 on the fleet's scaled planes, A and A': compare.lanes_row (the
    f64 product and the plain version, repeats, times in turns with the
    library call)."""
    ph = "kernels_lanes"
    t_phase = time.time()
    op = fleet.bundle.scaled.constraint_matrix
    pattern = op.pattern
    nl = op.lanes
    dev = op.vals.device
    rng = np.random.default_rng(0)
    m, n = pattern.shape
    x = torch.as_tensor(rng.standard_normal((n, nl)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.standard_normal((m, nl)).astype(np.float32),
                        device=dev)
    rows = []
    for label, half, vals, v in (("A", pattern.fwd, op.vals, x),
                                 ("AT", pattern.bwd, op.vals_t, y)):
        try:
            row = compare.lanes_row(label, half, vals, v)
        except compare.KernelMismatch as e:
            fail(ph, str(e))
        rows.append({
            "name": row.pop("name"),
            "route": "cuda",
            "source": "firstorderlp_torch/csrc/lanes_spmv.cu",
            "replaces": "none (no pl.pallas_call): the JAX package's XLA "
                        "gathers over ELL planes under vmap, "
                        "firstorderlp_tpu/ops/linops.py:68",
            **row})
    emit({"phase": ph, "ok": True, "nodes": FLEET_NODES,
          "phase_seconds": time.time() - t_phase,
          "lanes": nl, "m": m, "n": n, "nnz": pattern.nnz,
          "tolerance": f"|d| <= {compare.TOL_ENTRY}*(|A||x|)_(r,b) + "
                       f"{compare.TOL_ABS} against the f64 product",
          "results": rows})
    return rows


def fleet_solve_phase(ph, torch, batch, lanes, routed, params, spec,
                      fleet, problems, single_optimize):
    """One fleet solve to 1e-4, checked lane by lane (see the module
    docstring, fleet_path)."""
    t_phase = time.time()
    lanes.reset_launch_counts()
    routed.reset_launch_counts()
    stats = batch.FleetRunStats()
    t0 = time.time()
    outs = batch.solve_batch_shared_pattern(params, spec, fleet=fleet,
                                            run_stats=stats)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    launches = dict(lanes.LAUNCHES)
    single_kernels = {k: v for k, v in routed.LAUNCHES.items() if v}
    reasons = [o.termination_reason.name for o in outs]
    iterations = [o.iteration_count for o in outs]
    kkt = [o.iteration_stats[-1].cumulative_kkt_matrix_passes
           for o in outs]
    problems_found = []
    worst = {"rel_primal_residual": 0.0, "rel_dual_residual": 0.0,
             "rel_gap": 0.0}
    alone = []
    for i, out in enumerate(outs):
        if not (np.all(np.isfinite(out.primal_solution))
                and np.all(np.isfinite(out.dual_solution))):
            problems_found.append(f"lane {i}: non-finite solution")
        if out.primal_solution.shape != (FLEET_NODES,):
            problems_found.append(f"lane {i}: primal shape")
        res = host_residuals(problems[i], out.primal_solution,
                             out.dual_solution)
        for k, v in res.items():
            worst[k] = max(worst[k], v)
        if reasons[i] != "TERMINATION_REASON_OPTIMAL":
            single = single_optimize(params, problems[i])
            alone.append({"lane": i, "fleet": reasons[i],
                          "alone": single.termination_reason.name})
            if single.termination_reason.name != reasons[i]:
                problems_found.append(
                    f"lane {i}: {reasons[i]} in the fleet, "
                    f"{single.termination_reason.name} alone")
        elif any(not v <= 1e-4 for v in res.values()):
            problems_found.append(f"lane {i}: host residuals {res}")
    if any(v <= 0 for v in launches.values()):
        problems_found.append(f"L1 was not launched: {launches}")
    if single_kernels:
        problems_found.append(f"a single-instance kernel was launched: "
                              f"{single_kernels}")
    singles = []
    for i in (0, len(outs) - 1):
        single = single_optimize(params, problems[i])
        res = host_residuals(problems[i], single.primal_solution,
                             single.dual_solution)
        singles.append({"lane": i, "reason": single.termination_reason.name,
                        "iterations": single.iteration_count,
                        "fleet_iterations": iterations[i],
                        "host_f64": res})
        if single.termination_reason.name != reasons[i]:
            problems_found.append(f"lane {i} alone: "
                                  f"{single.termination_reason.name}")
        if any(not v <= 1e-4 for v in res.values()):
            problems_found.append(f"lane {i} alone: host residuals {res}")
    counts = {r: reasons.count(r) for r in sorted(set(reasons))}
    rec = {
        "phase": ph, "nodes": FLEET_NODES,
        "lanes": len(outs), "reasons": counts,
        "iterations_min": min(iterations), "iterations_max": max(iterations),
        "iterations_sum": sum(iterations), "kkt_passes_sum": sum(kkt),
        "solve_seconds": solve_s,
        "aggregate_iterations_per_second": sum(iterations) / solve_s,
        "dispatches": stats.dispatches, "evaluations": stats.segments,
        "step_trials": stats.trials, "read_backs": stats.read_backs,
        "launches": launches,
        "host_f64_worst": worst, "not_optimal": alone,
        "single_solves": singles,
        "phase_seconds": time.time() - t_phase,
    }
    rec["ok"] = not problems_found
    if problems_found:
        rec["problems"] = problems_found
    emit(rec)
    if problems_found:
        raise SystemExit(1)
    return rec


def fleet_throughput(torch, batch, params_of, spec, profile_on, dev):
    """bench.py's protocol for one solver: zero tolerances, a fixed
    iteration budget a lane, a warm-up solve, then a timed one."""
    params = params_of(0.0, THROUGHPUT_ITERS)
    t0 = time.time()
    fleet = batch.prepare_shared_pattern_fleet(params, spec, device=dev)
    torch.cuda.synchronize()
    ingest = time.time() - t0
    batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
    torch.cuda.synchronize()
    stats = batch.FleetRunStats()
    with timed(torch, profile_on) as run:
        outs = batch.solve_batch_shared_pattern(params, spec, fleet=fleet,
                                                run_stats=stats)
    seconds = run["seconds"]
    iterations = sum(o.iteration_count for o in outs)
    kkt = sum(o.iteration_stats[-1].cumulative_kkt_matrix_passes
              for o in outs)
    rec = {"seconds": seconds, "ingest_seconds": ingest,
           "iterations_sum": iterations, "kkt_passes_sum": kkt,
           "aggregate_iterations_per_second": iterations / seconds,
           "aggregate_kkt_passes_per_second": kkt / seconds,
           "step_trials": stats.trials, "evaluations": stats.segments,
           "dispatches": stats.dispatches, "read_backs": stats.read_backs,
           "reasons": sorted({o.termination_reason.name for o in outs})}
    if profile_on:
        rec["profile"] = run["profile"]
    rec.update(segment_launches(torch, batch, params, fleet))
    return rec


def segment_launches(torch, batch, params, fleet):
    """Kernel launches of one step trial and of one evaluation: one
    segment after the first ten iterations (an evaluation and 30 or more
    trials) and its evaluation alone, each under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    config = batch._config(params)
    state = fleet.initial_state
    for _ in range(10):  # iterations 1-10 are one segment each
        state, _, _ = batch.run_segment(fleet.bundle, state, 0.0, config)
    eval_block = (batch.mp_eval_block if batch._is_mp(params)
                  else batch.pdhg_eval_block)

    def launches(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)

    _, per_eval = launches(lambda: eval_block(fleet.bundle, state, 0.0,
                                              config))
    (_, _, counts), per_segment = launches(
        lambda: batch.run_segment(fleet.bundle, state, 0.0, config))
    return {"segment_trials": counts.trials,
            "kernel_launches_per_evaluation": per_eval,
            "kernel_launches_per_trial":
            (per_segment - per_eval) / max(counts.trials, 1)}


def fleet_phases(args, torch, dev, compare, routed,
                 single_optimize):
    """The fleet's phases (kernels_lanes, fleet_path, fleet_mirror_prox,
    fleet_throughput, determinism_fleet, fleet_checkpoint); returns L1's
    rows for the kernel list."""
    import dataclasses
    import tempfile

    from firstorderlp_torch import batch, generators
    from firstorderlp_torch.ops import lanes

    damping = np.linspace(0.7, 0.995, FLEET_LANES)
    spec = generators.pagerank_fleet_spec(FLEET_NODES, damping, seed=0)
    params = make_params(1e-4, 20_000, fmt="auto")
    t0 = time.time()
    fleet = batch.prepare_shared_pattern_fleet(params, spec, device=dev)
    torch.cuda.synchronize()
    ingest_s = time.time() - t0
    rows = kernels_lanes(torch, lanes, fleet, compare)
    # the lanes as host problems, for the f64 residuals and the single
    # solves (the same graph as the spec's)
    problems = generators.generate_pagerank_lp_fleet(FLEET_NODES, damping,
                                                     seed=0)

    # 11. the fleet by PDHG, then by Mirror Prox
    rec = fleet_solve_phase("fleet_path", torch, batch, lanes, routed,
                            params, spec, fleet, problems, single_optimize)
    for r in rows:
        r["launches"] = rec["launches"][r["name"]]
    del fleet
    mp_params = make_mp_params(1e-4, 20_000, fmt="auto")
    mp_fleet = batch.prepare_shared_pattern_fleet(mp_params, spec,
                                                  device=dev)
    mrec = fleet_solve_phase("fleet_mirror_prox", torch, batch, lanes,
                             routed, mp_params, spec, mp_fleet, problems,
                             single_optimize)
    for r in rows:
        r["launches_mirror_prox"] = mrec["launches"][r["name"]]
    del mp_fleet

    # 12. throughput: bench.py's protocol
    t_phase = warm_t0 = time.time()
    batch.prepare_shared_pattern_fleet(params, spec, device=dev)
    torch.cuda.synchronize()
    warm_ingest_s = time.time() - warm_t0
    pdhg = fleet_throughput(
        torch, batch, lambda tol, lim: make_params(tol, lim, fmt="auto"),
        spec, args.profile, dev)
    mirror = fleet_throughput(
        torch, batch, lambda tol, lim: make_mp_params(tol, lim, fmt="auto"),
        spec, args.profile, dev)
    emit({"phase": "fleet_throughput", "ok": True,
          "nodes": FLEET_NODES, "lanes": FLEET_LANES,
          "iterations_per_lane": THROUGHPUT_ITERS,
          "ingest_cold_seconds": ingest_s,
          "ingest_warm_seconds": warm_ingest_s,
          "phase_seconds": time.time() - t_phase,
          "pdhg": pdhg, "mirror_prox": mirror})

    # 13. determinism of a 16-lane fleet, and checkpoint/resume
    t_phase = time.time()
    det_spec = generators.pagerank_fleet_spec(
        FLEET_NODES, np.linspace(0.7, 0.995, DET_FLEET_LANES), seed=0)
    runs = [batch.solve_batch_shared_pattern(params, det_spec, device=dev)
            for _ in range(2)]
    same = all(
        a.termination_reason == b.termination_reason
        and a.iteration_count == b.iteration_count
        and np.array_equal(a.primal_solution, b.primal_solution)
        and np.array_equal(a.dual_solution, b.dual_solution)
        for a, b in zip(*runs)
    ) and all(o.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
              for o in runs[0])
    emit({"phase": "determinism_fleet", "ok": bool(same),
          "nodes": FLEET_NODES, "lanes": DET_FLEET_LANES,
          "phase_seconds": time.time() - t_phase,
          "iterations": [o.iteration_count for o in runs[0]]})
    if not same:
        raise SystemExit(1)

    t_phase = time.time()
    ck_spec = generators.pagerank_fleet_spec(
        FLEET_NODES, np.linspace(0.7, 0.995, CKPT_FLEET_LANES), seed=0)
    full = batch.solve_batch_shared_pattern(params, ck_spec, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/fleet.npz"
        crit = params.termination_criteria
        first = dataclasses.replace(
            params, checkpoint_path=path,
            termination_criteria=dataclasses.replace(
                crit, iteration_limit=CKPT_LIMIT))
        cut_stats = batch.FleetRunStats()
        cut = batch.solve_batch_shared_pattern(first, ck_spec, device=dev,
                                               run_stats=cut_stats)
        resumed = batch.solve_batch_shared_pattern(
            dataclasses.replace(params, resume_from_checkpoint=path),
            ck_spec, device=dev)
    diff = max(max(float(np.max(np.abs(a.primal_solution
                                       - b.primal_solution))),
                   float(np.max(np.abs(a.dual_solution - b.dual_solution))))
               for a, b in zip(resumed, full))
    bitwise = all(np.array_equal(a.primal_solution, b.primal_solution)
                  and np.array_equal(a.dual_solution, b.dual_solution)
                  for a, b in zip(resumed, full))
    ok = (cut_stats.dispatches == 1
          and all(o.termination_reason.name
                  == "TERMINATION_REASON_ITERATION_LIMIT" for o in cut)
          and [o.termination_reason for o in resumed]
          == [o.termination_reason for o in full]
          and diff <= 1e-6)
    emit({"phase": "fleet_checkpoint", "ok": bool(ok),
          "lanes": CKPT_FLEET_LANES, "dispatches_before_checkpoint":
          cut_stats.dispatches,
          "reasons": sorted({o.termination_reason.name for o in resumed}),
          "iterations_resumed": [o.iteration_count for o in resumed],
          "iterations_uninterrupted": [o.iteration_count for o in full],
          "max_abs_diff": diff, "bitwise_equal": bool(bitwise),
          "phase_seconds": time.time() - t_phase})
    if not ok:
        raise SystemExit(1)
    return rows


def kernels_tiled_large(torch, routed, probe, device_ms, dev):
    """The three tile-plan kernels (tiled_spmv both ways,
    tiled_dual_step, tiled_rmv_stats) and the three CSR kernels
    (spmv_csr both ways, spmv_dual_step, spmv_rmv_stats), on the
    million-node matrix of generators.pagerank_like_matrix (seed 0),
    held against their plain versions (tiled_rmv_stats also against
    spmv_rmv_stats, and launched twice for the same bits); times as in
    kernels_tiled."""
    from firstorderlp_torch.generators import pagerank_like_matrix

    ph = "kernels_tiled_large"
    t0 = time.time()
    a64 = pagerank_like_matrix(LARGE_NODES, seed=0)
    make_s = time.time() - t0
    m, n = a64.shape
    t0 = time.time()
    top = routed.build_routed_op(a64, dev, tile_aligned=True)
    csr = routed.build_routed_op(a64, dev, tile_aligned=False)
    setup_s = time.time() - t0
    rng = np.random.default_rng(1)
    host = {"x": rng.standard_normal(n), "y": rng.standard_normal(m),
            "b": rng.standard_normal(m), "eq": np.arange(m) < 1,
            "dx": rng.standard_normal(n), "old": rng.standard_normal(n)}
    host = {k: np.asarray(a, np.float32) for k, a in host.items()}
    v = {k: torch.as_tensor(a, device=dev) for k, a in host.items()}
    sigma_val = 0.37
    sigma = torch.full((), sigma_val, dtype=torch.float32, device=dev)
    abs_a = abs(a64)
    scale = {"A": abs_a @ np.abs(host["x"]).astype(np.float64),
             "AT": abs_a.T @ np.abs(host["y"]).astype(np.float64)}
    scale["dual"] = (np.abs(host["y"]) + sigma_val * np.abs(host["b"])
                     + sigma_val * scale["A"])
    inter_scale = float(np.sum(np.abs(host["dx"]) * (
        scale["AT"] + np.abs(host["old"]))))

    def worst(name, got, want, bound):
        err = np.abs(got.double().cpu().numpy() - want.double().cpu().numpy())
        if np.any(err > bound):
            fail(ph, f"{name}: differs by {float(np.max(err)):.3e}")
        return float(np.max(err))

    lib = {"A": routed.library_spmv(csr.a), "AT": routed.library_spmv(csr.at)}
    dual_args = (v["x"], v["y"], v["b"], v["eq"], sigma)
    stats_args = (v["y"], v["dx"], v["old"])
    # name -> (layout, call, plain, library, vector bytes, epilogue flops)
    calls = {
        "tiled_spmv:A": (
            top.a, lambda: routed.tiled_spmv(top.a, v["x"]),
            lambda: routed.tiled_spmv_plain(top.a, v["x"]),
            lambda: lib["A"] @ v["x"], 4 * (m + n), 0),
        "tiled_spmv:AT": (
            top.at, lambda: routed.tiled_spmv(top.at, v["y"]),
            lambda: routed.tiled_spmv_plain(top.at, v["y"]),
            lambda: lib["AT"] @ v["y"], 4 * (m + n), 0),
        "tiled_dual_step": (
            top.a, lambda: routed.tiled_dual_step(top.a, *dual_args),
            lambda: routed.tiled_dual_step_plain(top.a, *dual_args),
            lambda: lib["A"] @ v["x"], 4 * n + 16 * m + 4, 7 * m),
        "tiled_rmv_stats": (
            top.at, lambda: routed.tiled_rmv_stats(top.at, *stats_args),
            lambda: routed.tiled_rmv_stats_plain(top.at, *stats_args),
            lambda: lib["AT"] @ v["y"], 4 * m + 12 * n + 8, 5 * n),
        "spmv_csr:A": (
            csr.a, lambda: routed.spmv_csr(csr.a, v["x"]),
            lambda: routed.spmv_csr_plain(csr.a, v["x"]),
            lambda: lib["A"] @ v["x"], 4 * (m + n), 0),
        "spmv_csr:AT": (
            csr.at, lambda: routed.spmv_csr(csr.at, v["y"]),
            lambda: routed.spmv_csr_plain(csr.at, v["y"]),
            lambda: lib["AT"] @ v["y"], 4 * (m + n), 0),
        "spmv_dual_step": (
            csr.a, lambda: routed.spmv_dual_step(csr.a, *dual_args),
            lambda: routed.spmv_dual_step_plain(csr.a, *dual_args),
            lambda: lib["A"] @ v["x"], 4 * n + 16 * m + 4, 7 * m),
        "spmv_rmv_stats": (
            csr.at, lambda: routed.spmv_rmv_stats(csr.at, *stats_args),
            lambda: routed.spmv_rmv_stats_plain(csr.at, *stats_args),
            lambda: lib["AT"] @ v["y"], 4 * m + 12 * n + 8, 5 * n),
    }
    results = []
    for name, (mat, call, plain, library, extra, flops) in calls.items():
        got, want = call(), plain()
        torch.cuda.synchronize()
        orientation = "A" if mat is top.a or mat is csr.a else "AT"
        if name.endswith("dual_step"):
            err = worst(name, got[0], want[0],
                        TOL_ENTRY * scale["dual"] + TOL_ABS)
            # against its own y+ in f64: the dense row's A z cancels, so
            # two correct y+ give sums further apart than TOL_SUM
            own = torch.sum((got[0].double() - v["y"].double()) ** 2)
            err = max(err, worst(f"{name} dy2", got[1], own,
                                 TOL_SUM * abs(float(own)) + TOL_ABS))
        elif name.endswith("rmv_stats"):
            # tiled: against the CSR kernel too, and twice the same bits
            wants = [("", want)]
            if name == "tiled_rmv_stats":
                wants.append((" vs spmv_rmv_stats",
                              routed.spmv_rmv_stats(csr.at, *stats_args)))
                again = call()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(ph, f"{name}: two launches differ")
            err = 0.0
            for label, want in wants:
                err = max(err, worst(f"{name}{label}", got[0], want[0],
                                     TOL_ENTRY * scale["AT"] + TOL_ABS))
                err = max(err, worst(f"{name}{label} interaction", got[1],
                                     want[1],
                                     TOL_ENTRY * inter_scale + TOL_ABS))
                err = max(err, worst(f"{name}{label} dx2", got[2], want[2],
                                     TOL_SUM * abs(float(want[2]))
                                     + TOL_ABS))
        else:
            err = worst(name, got, want,
                        TOL_ENTRY * scale[orientation] + TOL_ABS)
        tiled = isinstance(mat, routed.TilePlan)
        row = {
            "name": name, "max_abs_err": err,
            "ms": probe.time_ms(call), "device_ms": device_ms(call),
            "plain_ms": probe.time_ms(plain, reps=20, warmup=3),
            "library_ms": probe.time_ms(library),
            "library_device_ms": device_ms(library),
            "bytes": routed.csr_kernel_bytes(mat) + extra,
            "flops": 2 * mat.nnz + flops,
        }
        if tiled:
            row.update({"out_strip": mat.out_strip,
                        "in_window": mat.in_window, "group": mat.group,
                        "strips": mat.nstrips,
                        "padding_share": mat.padding_share,
                        **routed.tile_plan_stats(mat)})
        else:
            row.update(routed.csr_item_stats(mat))
        results.append(row)
    return {"phase": ph, "ok": True, "m": m, "n": n, "nnz": int(a64.nnz),
            "matrix": "generators.pagerank_like_matrix(1_000_000, seed=0)",
            "matrix_seconds": make_s, "setup_seconds": setup_s,
            "results": results}


def main_path_parent(torch, compare, parent_dir, dev):
    """The main path's solve, warm, on the PageRank LPs of SOLVE_SEEDS by
    another version of this package (`parent_dir` holds it as
    `firstorderlp_torch_parent`) and by this one, in turns (parent,
    this, this, parent): iterations, seconds (host clock up to a device
    synchronize) and reason of each solve."""
    dirs = {"parent": parent_dir, "this": None}
    mods = {who: {part: compare.package_module(part, where)
                  for part in ("", "generators", "models.pdhg")}
            for who, where in dirs.items()}

    def solve(who, problem):
        pkg, pdhg = mods[who][""], mods[who]["models.pdhg"]
        params = make_params(1e-4, 20_000, pkg=pkg)
        prepared = pdhg.prepare_problem(params, problem, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        out = pdhg.optimize(params, problem, prepared=prepared)
        torch.cuda.synchronize()
        return {"package": who, "iterations": out.iteration_count,
                "seconds": time.time() - t0,
                "reason": out.termination_reason.name}

    for who in dirs:  # kernels built and modules loaded, untimed
        solve(who, mods[who]["generators"].generate_pagerank_lp(
            num_nodes=DET_NODES, seed=0))
    rows = []
    for seed in SOLVE_SEEDS:
        problems = {who: mods[who]["generators"].generate_pagerank_lp(
            num_nodes=NODES, seed=seed) for who in dirs}
        for who in ("parent", "this", "this", "parent"):
            rows.append({"seed": seed, **solve(who, problems[who])})
    mine = [r for r in rows if r["package"] == "this"]
    ok = all(r["reason"] == "TERMINATION_REASON_OPTIMAL" for r in mine)
    return {"phase": "main_path_parent", "ok": ok, "nodes": NODES,
            "parent": parent_dir, "solves": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--profile", action="store_true",
                        help="trace the warm main-path solve with "
                             "torch.profiler")
    parser.add_argument("--parent", metavar="DIR",
                        help="also solve the main path's LP at other "
                             "seeds by another version of the package, "
                             "held in DIR as firstorderlp_torch_parent "
                             "(phase main_path_parent)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import firstorderlp_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is missing: {exc}", file=sys.stderr)
        return 2
    from firstorderlp_torch import refine, rescale_problem
    from firstorderlp_torch.generators import generate_pagerank_lp
    from firstorderlp_torch.models import mirror_prox
    from firstorderlp_torch.models.pdhg import optimize, prepare_problem
    from firstorderlp_torch.ops import (
        compare_kernels, kernels_build, probe_routed, routed,
    )

    try:
        return run(args, torch, optimize, rescale_problem,
                   generate_pagerank_lp, prepare_problem, kernels_build,
                   routed, refine, mirror_prox, probe_routed,
                   compare_kernels)
    finally:
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(_lines) + "\n")


def run(args, torch, optimize, rescale_problem, generate_pagerank_lp,
        prepare_problem, kernels_build, routed, refine, mirror_prox,
        probe, compare) -> int:
    dev = torch.device("cuda")
    time_ms = probe.time_ms  # CUDA events, median of 100 after warm-up
    device_ms = compare.device_ms  # torch.profiler, per call
    device_profile = compare.device_profile  # (device ms, kernels)
    matrix_bytes = routed.csr_kernel_bytes  # the bound's, in either layout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Each phase names its layout itself, whatever FOLP_TILE_ALIGNED says.
    routed.DEFAULT_TILE_ALIGNED = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi_line = _card["line"] = probe.card_line()
    emit({"phase": "device", "ok": True, "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    try:
        kernels_build.build_kernels()
    except RuntimeError as exc:
        fail("build", str(exc))
    ptxas = {
        lib: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for lib, log in kernels_build.last_build_log.items()
    }
    emit({"phase": "build", "ok": True,
          "seconds": kernels_build.last_build_seconds, "ptxas": ptxas})

    # 3. kernels, at the main path's shapes
    t0 = time.time()
    problem = generate_pagerank_lp(num_nodes=NODES, seed=0)
    scaled = rescale_problem(10, False, 1.0, 0, problem).scaled_qp
    a64 = scaled.constraint_matrix.tocsr()
    op = routed.build_routed_op(a64, dev)
    m, n = a64.shape
    setup_s = time.time() - t0
    rng = np.random.default_rng(0)
    abs_a = abs(a64)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    x_np = rng.standard_normal(n).astype(np.float32)
    y_np = rng.standard_normal(m).astype(np.float32)
    x, y = f32(x_np), f32(y_np)
    b = f32(scaled.right_hand_side)
    eq_np = np.zeros(m, np.float32)
    eq_np[: scaled.num_equalities] = 1.0
    eq = f32(eq_np)
    sigma_val = 0.37
    sigma = torch.full((), sigma_val, dtype=torch.float32, device=dev)
    dx_np = rng.standard_normal(n).astype(np.float32)
    aty_old_np = rng.standard_normal(n).astype(np.float32)
    dx, aty_old = f32(dx_np), f32(aty_old_np)
    scale_ax = abs_a @ np.abs(x_np.astype(np.float64))
    scale_aty = abs_a.T @ np.abs(y_np.astype(np.float64))
    scale_dual = (
        np.abs(y_np) + sigma_val * np.abs(scaled.right_hand_side)
        + sigma_val * scale_ax
    )
    lib_a = routed.library_spmv(op.a)
    lib_at = routed.library_spmv(op.at)

    def entry_check(name, got, want, scale, phase="kernels"):
        got = got.double().cpu().numpy()
        want = want.double().cpu().numpy()
        err = np.abs(got - want)
        bad = err > TOL_ENTRY * scale + TOL_ABS
        if bad.any():
            i = int(np.argmax(err - TOL_ENTRY * scale))
            fail(phase, f"{name}: entry {i} differs by {err[i]:.3e} "
                        f"(scale {scale[i]:.3e})")
        return float(err.max())

    def sum_check(name, got, want, phase="kernels"):
        got, want = float(got), float(want)
        if abs(got - want) > TOL_SUM * abs(want) + TOL_ABS:
            fail(phase, f"{name}: sum {got!r} vs {want!r}")
        return abs(got - want)

    results = []
    mbytes = {"A": routed.csr_kernel_bytes(op.a),
              "AT": routed.csr_kernel_bytes(op.at)}

    def csr_launch(name, mat, call):
        """What one call, `call(mat)`, looks like on the card: the kernels
        it launches and their device time (torch.profiler), the item
        table's shape, REPEATS launches bitwise equal with the tickets
        back at zero, and the times of the same call with no row cut
        into pieces."""
        problem = compare.repeat_differs(lambda: call(mat), (mat.tickets,))
        if problem:
            fail("kernels", f"{name}: {problem}")
        dev_ms, per_call = device_profile(lambda: call(mat))
        whole = routed.csr_with_items(mat, split_rows=False)
        return {"device_ms": dev_ms, "kernels_per_call": per_call,
                "repeats_bitwise": compare.REPEATS,
                "ms_without_row_split": time_ms(lambda: call(whole)),
                "device_ms_without_row_split": device_ms(
                    lambda: call(whole)),
                **routed.csr_item_stats(mat)}

    # spmv_csr, both orientations
    for label, mat, vec, scale, lib in (
        ("A", op.a, x, scale_ax, lib_a),
        ("AT", op.at, y, scale_aty, lib_at),
    ):
        whole = routed.csr_with_items(mat, split_rows=False)
        got = routed.spmv_csr(mat, vec)
        want = routed.spmv_csr_plain(mat, vec)
        got_whole = routed.spmv_csr(whole, vec)
        torch.cuda.synchronize()
        err = entry_check(f"spmv_csr:{label}", got, want, scale)
        entry_check(f"spmv_csr:{label} (no row split)", got_whole, want,
                    scale)
        nbytes = mbytes[label] + 4 * mat.num_cols + 4 * mat.num_rows
        results.append({
            "name": f"spmv_csr:{label}",
            "route": "cuda",
            "source": "firstorderlp_torch/csrc/spmv_csr.cu",
            "replaces": "firstorderlp_tpu/ops/routed.py:160 (_make_expand)"
                        " + routed.py:188 (_make_reduce)",
            "max_abs_err": err,
            "ms": time_ms(lambda: routed.spmv_csr(mat, vec)),
            "plain_ms": time_ms(
                lambda: routed.spmv_csr_plain(mat, vec)
            ),
            "bytes": nbytes,
            "flops": 2 * mat.nnz,
            "library_ms": time_ms(lambda: lib @ vec),
            "library_device_ms": device_ms(lambda: lib @ vec),
            "nnz": mat.nnz,
            "rows": mat.num_rows,
            **csr_launch(f"spmv_csr:{label}", mat,
                         lambda mat_, vec=vec: routed.spmv_csr(mat_, vec)),
        })

    # spmv_dual_step
    got_y, got_dy2 = routed.spmv_dual_step(op.a, x, y, b, eq, sigma)
    want_y, want_dy2 = routed.spmv_dual_step_plain(op.a, x, y, b, eq, sigma)
    torch.cuda.synchronize()
    err = entry_check("spmv_dual_step", got_y, want_y, scale_dual)
    err = max(err, sum_check("spmv_dual_step dy2", got_dy2, want_dy2))
    results.append({
        "name": "spmv_dual_step",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/spmv_dual_step.cu",
        "replaces": "firstorderlp_tpu/ops/routed.py:160 (_make_expand)"
                    " + routed.py:532 (_make_reduce_dual)",
        "max_abs_err": err,
        "ms": time_ms(
            lambda: routed.spmv_dual_step(op.a, x, y, b, eq, sigma)
        ),
        "plain_ms": time_ms(
            lambda: routed.spmv_dual_step_plain(op.a, x, y, b, eq, sigma),
        ),
        "bytes": mbytes["A"] + 4 * n + 4 * 4 * m + 4,
        "flops": 2 * op.a.nnz + 7 * m,
        "library_ms": time_ms(lambda: lib_a @ x),
        "library_device_ms": device_ms(lambda: lib_a @ x),
        **csr_launch("spmv_dual_step", op.a,
                     lambda mat: routed.spmv_dual_step(
                         mat, x, y, b, eq, sigma)),
    })

    # spmv_rmv_stats
    got = routed.spmv_rmv_stats(op.at, y, dx, aty_old)
    want = routed.spmv_rmv_stats_plain(op.at, y, dx, aty_old)
    torch.cuda.synchronize()
    err = entry_check("spmv_rmv_stats", got[0], want[0], scale_aty)
    err = max(err, sum_check("spmv_rmv_stats interaction", got[1], want[1]))
    err = max(err, sum_check("spmv_rmv_stats dx2", got[2], want[2]))
    results.append({
        "name": "spmv_rmv_stats",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/spmv_rmv_stats.cu",
        "replaces": "firstorderlp_tpu/ops/routed.py:160 (_make_expand)"
                    " + routed.py:566 (_make_reduce_rmv_stats)",
        "max_abs_err": err,
        "ms": time_ms(
            lambda: routed.spmv_rmv_stats(op.at, y, dx, aty_old)
        ),
        "plain_ms": time_ms(
            lambda: routed.spmv_rmv_stats_plain(op.at, y, dx, aty_old)
        ),
        "bytes": mbytes["AT"] + 4 * m + 3 * 4 * n + 8,
        "flops": 2 * op.at.nnz + 5 * n,
        "library_ms": time_ms(lambda: lib_at @ y),
        "library_device_ms": device_ms(lambda: lib_at @ y),
        **csr_launch("spmv_rmv_stats", op.at,
                     lambda mat: routed.spmv_rmv_stats(
                         mat, y, dx, aty_old)),
    })
    def add_bounds(rows):
        for r in rows:
            r["bound_ms"], r["bound_by"] = probe.bound_ms(
                r["bytes"], r["flops"]
            )

    tolerance = (f"|d| <= {TOL_ENTRY}*(|A||x|)_i + {TOL_ABS}; "
                 f"sums rtol {TOL_SUM}")
    add_bounds(results)
    emit({"phase": "kernels", "ok": True, "m": m, "n": n,
          "nnz": int(a64.nnz), "setup_seconds": setup_s,
          "tolerance": tolerance, "results": results})

    # 3b. the tile-plan kernels, against their plain versions and
    # against the CSR kernels on the same vectors
    ph = "kernels_tiled"
    t0 = time.time()
    top = routed.build_routed_op(a64, dev, tile_aligned=True)
    plan_setup_s = time.time() - t0
    tiled = []
    for label, plan, mat, vec, scale, lib in (
        ("A", top.a, op.a, x, scale_ax, lib_a),
        ("AT", top.at, op.at, y, scale_aty, lib_at),
    ):
        got = routed.tiled_spmv(plan, vec)
        want = routed.tiled_spmv_plain(plan, vec)
        torch.cuda.synchronize()
        err = entry_check(f"tiled_spmv:{label}", got, want, scale, ph)
        err_csr = entry_check(f"tiled_spmv:{label} vs spmv_csr", got,
                              routed.spmv_csr(mat, vec), scale, ph)
        if not torch.equal(got, routed.tiled_spmv(plan, vec)):
            fail(ph, f"tiled_spmv:{label}: two launches differ")
        tiled.append({
            "name": f"tiled_spmv:{label}",
            "route": "cuda",
            "source": "firstorderlp_torch/csrc/tiled_spmv.cu",
            "replaces": "firstorderlp_tpu/ops/routed.py:347 (_make_fused)",
            "max_abs_err": err,
            "max_abs_err_vs_csr_kernel": err_csr,
            "ms": time_ms(lambda: routed.tiled_spmv(plan, vec)),
            "plain_ms": time_ms(
                lambda: routed.tiled_spmv_plain(plan, vec)
            ),
            "bytes": matrix_bytes(plan) + 4 * plan.num_cols
            + 4 * plan.num_rows,
            "flops": 2 * plan.nnz,
            "library_ms": time_ms(lambda: lib @ vec),
            "device_ms": device_ms(lambda: routed.tiled_spmv(plan, vec)),
            "library_device_ms": device_ms(lambda: lib @ vec),
            "out_strip": plan.out_strip,
            "in_window": plan.in_window,
            "group": plan.group,
            "strips": plan.nstrips,
            "groups": plan.ngroups,
            "tiles": int(plan.tile_ptr.shape[0]) - 1,
            "padding_share": plan.padding_share,
            **routed.tile_plan_stats(plan),
        })

    got_y, got_dy2 = routed.tiled_dual_step(top.a, x, y, b, eq, sigma)
    want_y, want_dy2 = routed.tiled_dual_step_plain(
        top.a, x, y, b, eq, sigma
    )
    csr_y, csr_dy2 = routed.spmv_dual_step(op.a, x, y, b, eq, sigma)
    torch.cuda.synchronize()
    err = entry_check("tiled_dual_step", got_y, want_y, scale_dual, ph)
    err = max(err, sum_check("tiled_dual_step dy2", got_dy2, want_dy2, ph))
    err_csr = entry_check("tiled_dual_step vs spmv_dual_step", got_y,
                          csr_y, scale_dual, ph)
    err_csr = max(err_csr, sum_check("tiled_dual_step dy2 vs spmv_dual_step",
                                     got_dy2, csr_dy2, ph))
    again_y, again_dy2 = routed.tiled_dual_step(top.a, x, y, b, eq, sigma)
    if not (torch.equal(got_y, again_y) and torch.equal(got_dy2, again_dy2)):
        fail(ph, "tiled_dual_step: two launches differ")
    tiled.append({
        "name": "tiled_dual_step",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/tiled_dual_step.cu",
        "replaces": "firstorderlp_tpu/ops/routed.py:378 (_make_fused_dual)",
        "max_abs_err": err,
        "max_abs_err_vs_csr_kernel": err_csr,
        "ms": time_ms(
            lambda: routed.tiled_dual_step(top.a, x, y, b, eq, sigma)
        ),
        "plain_ms": time_ms(
            lambda: routed.tiled_dual_step_plain(top.a, x, y, b, eq, sigma),
        ),
        "bytes": matrix_bytes(top.a) + 4 * n + 4 * 4 * m + 4,
        "flops": 2 * top.a.nnz + 7 * m,
        "library_ms": time_ms(lambda: lib_a @ x),
        "device_ms": device_ms(
            lambda: routed.tiled_dual_step(top.a, x, y, b, eq, sigma)
        ),
        "library_device_ms": device_ms(lambda: lib_a @ x),
        **routed.tile_plan_stats(top.a),
    })

    got = routed.tiled_rmv_stats(top.at, y, dx, aty_old)
    want = routed.tiled_rmv_stats_plain(top.at, y, dx, aty_old)
    csr_got = routed.spmv_rmv_stats(op.at, y, dx, aty_old)
    torch.cuda.synchronize()
    err = entry_check("tiled_rmv_stats", got[0], want[0], scale_aty, ph)
    err_csr = entry_check("tiled_rmv_stats vs spmv_rmv_stats", got[0],
                          csr_got[0], scale_aty, ph)
    for k, what in ((1, "interaction"), (2, "dx2")):
        err = max(err, sum_check(f"tiled_rmv_stats {what}", got[k],
                                 want[k], ph))
        err_csr = max(err_csr, sum_check(
            f"tiled_rmv_stats {what} vs spmv_rmv_stats", got[k],
            csr_got[k], ph))
    again = routed.tiled_rmv_stats(top.at, y, dx, aty_old)
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        fail(ph, "tiled_rmv_stats: two launches differ")
    tiled.append({
        "name": "tiled_rmv_stats",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/tiled_rmv_stats.cu",
        "replaces": "firstorderlp_tpu/ops/routed.py:418 "
                    "(_make_fused_rmv_stats)",
        "max_abs_err": err,
        "max_abs_err_vs_csr_kernel": err_csr,
        "ms": time_ms(
            lambda: routed.tiled_rmv_stats(top.at, y, dx, aty_old)
        ),
        "plain_ms": time_ms(
            lambda: routed.tiled_rmv_stats_plain(top.at, y, dx, aty_old),
        ),
        "bytes": matrix_bytes(top.at) + 4 * m + 3 * 4 * n + 8,
        "flops": 2 * top.at.nnz + 5 * n,
        "library_ms": time_ms(lambda: lib_at @ y),
        "device_ms": device_ms(
            lambda: routed.tiled_rmv_stats(top.at, y, dx, aty_old)
        ),
        "library_device_ms": device_ms(lambda: lib_at @ y),
        **routed.tile_plan_stats(top.at),
    })
    add_bounds(tiled)
    emit({"phase": ph, "ok": True, "m": m, "n": n, "nnz": int(a64.nnz),
          "plan_setup_seconds": plan_setup_s, "tolerance": tolerance,
          "results": tiled})
    del op, top, plan, mat, whole, lib, lib_a, lib_at

    # 3b'. B2-B7 again where the arrays are larger than the L2 cache
    large = kernels_tiled_large(torch, routed, probe, device_ms, dev)
    add_bounds(large["results"])
    emit(large)
    for r in results + tiled:
        for big in large["results"]:
            if big["name"] == r["name"]:
                r["large"] = {k: big[k] for k in (
                    "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms", "plain_ms", "max_abs_err")}

    # 3c. the probe kernels, at the probe's default size
    ph = "kernels_probe"

    def probe_times(kernel, library):
        """ms, device ms and kernels a call of the kernel and the library
        call, in turns (probe.turn_summary)."""
        timed = probe.in_turns({"kernel": kernel, "library": library})
        out = {}
        for who, prefix in (("kernel", ""), ("library", "library_")):
            out.update({prefix + k: v for k, v in
                        probe.turn_summary(timed[who]).items()})
        return out

    host = probe.make_probe_inputs(probe.DEFAULT_NNZ, seed=0)
    pd = {k: torch.as_tensor(a, device=dev) for k, a in host.items()}
    n_strips = probe.N_STRIPS
    eargs = (pd["strip_ids"], pd["x_strips"], pd["hi"], pd["lo"])
    got = probe.probe_expand(*eargs)
    want = probe.probe_expand_plain(*eargs)
    torch.cuda.synchronize()
    sid = np.repeat(host["strip_ids"], probe.GROUP_ROWS)
    want_np = host["x_strips"][sid[:, None], host["hi"], host["lo"]]
    err = float((got - want).abs().max())
    err_np = float(np.max(np.abs(got.cpu().numpy() - want_np)))
    if err != 0.0 or err_np != 0.0:
        fail(ph, f"probe_expand: max |d| {err} against its plain version, "
                 f"{err_np} against numpy; want 0")
    hi64, lo64 = pd["hi"].long(), pd["lo"].long()
    probes = [{
        "name": "probe_expand",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/probe_expand.cu",
        "replaces": "benchmarking/probe_routed.py:64 (make_expand)",
        "max_abs_err": err,
        "plain_ms": time_ms(lambda: probe.probe_expand_plain(*eargs)),
        "bytes": probe.expand_bytes(*eargs),
        "flops": 0,
        **probe_times(lambda: probe.probe_expand(*eargs),
                      lambda: probe.library_expand(
                          pd["strip_ids"], pd["x_strips"], hi64, lo64)),
    }]

    g_in = pd["g2"].reshape(-1, 128)
    rargs = (pd["meta"], g_in, pd["v"], pd["hir"], pd["lor"])
    reduce_plan = probe.plan_probe_reduce(pd["meta"], n_strips)
    got = probe.probe_reduce(*rargs, n_strips, plan=reduce_plan)
    again = probe.probe_reduce(*rargs, n_strips, plan=reduce_plan)
    want = probe.probe_reduce_plain(pd["meta"], g_in.double(),
                                    pd["v"].double(), pd["hir"], pd["lor"],
                                    n_strips)
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    rel = err / (float(want.abs().max()) + 1.0)
    if not rel <= 1e-5:
        fail(ph, f"probe_reduce: relative error {rel:.3e} against its plain "
                 "version in f64; want <= 1e-5")
    if not torch.equal(got, again):
        fail(ph, "probe_reduce: two launches differ")
    if reduce_plan.tickets.any():
        fail(ph, "probe_reduce: a ticket is not back at zero")
    flat = probe.flat_slots(pd["meta"][:, 0], pd["hir"], pd["lor"],
                            probe.HR).reshape(-1)
    probes.append({
        "name": "probe_reduce",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/probe_reduce.cu",
        "replaces": "benchmarking/probe_routed.py:129 (make_reduce)",
        "max_abs_err": err,
        "max_rel_err": rel,
        "plain_ms": time_ms(lambda: probe.probe_reduce_plain(
            *rargs, n_strips)),
        "bytes": probe.reduce_bytes(*rargs, n_strips),
        "bytes_beyond_inputs": probe.reduce_scratch_bytes(reduce_plan),
        "flops": 2 * g_in.numel(),
        **probe_times(lambda: probe.probe_reduce(
            *rargs, n_strips, plan=reduce_plan),
            lambda: probe.library_reduce(flat, g_in, pd["v"], n_strips)),
        "chunks": reduce_plan.nchunks,
        "warps": reduce_plan.warps,
    })
    # One kernel a call in every turn, counted at its launches.
    if set(probes[-1]["kernels_per_call_turns"]) != {1}:
        fail(ph, f"probe_reduce: {probes[-1]['kernels_per_call_turns']} "
                 "kernels a call in the turns; want 1")
    add_bounds(probes)
    emit({"phase": ph, "ok": True, "nnz": int(g_in.numel()),
          "groups": int(pd["meta"].shape[0]), "strips": n_strips,
          "tolerance": "probe_expand: max |d| = 0; probe_reduce: max |d| "
                       "<= 1e-5 * (max |y| + 1) against f64, two launches "
                       "bitwise equal",
          "results": probes})
    del pd, host, got, again, want, flat, hi64, lo64, g_in

    # 3d. the probe itself, as a user runs it
    probe.reset_launch_counts()
    probe_result = probe.main([str(probe.DEFAULT_NNZ)])
    probe_launches = dict(probe.LAUNCHES)
    probe_ok = all(probe_launches[r["name"]] > 0 for r in probes) and (
        probe_result["expand"]["max_abs_err"] == 0.0
        and probe_result["reduce"]["max_rel_err"] <= 1e-5
    )
    emit({"phase": "probe_path", "ok": bool(probe_ok),
          "launches": probe_launches, "result": probe_result})
    if not probe_ok:
        raise SystemExit(1)
    for r in probes:
        r["launches"] = probe_launches[r["name"]]

    # 4. main path
    params = make_params(1e-4, 20_000)
    t0 = time.time()
    prepared = prepare_problem(params, problem, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.time() - t0
    routed.reset_launch_counts()
    t0 = time.time()
    out = optimize(params, problem, prepared=prepared)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    launches = dict(routed.LAUNCHES)
    reason = out.termination_reason.name
    stats = out.iteration_stats[-1] if out.iteration_stats else None
    res = host_residuals(problem, out.primal_solution, out.dual_solution)
    main = {
        "phase": "main_path", "nodes": NODES, "reason": reason,
        "iterations": out.iteration_count,
        "kkt_passes": stats.cumulative_kkt_matrix_passes if stats else None,
        "prepare_seconds": prepare_s, "solve_seconds": solve_s,
        "iterations_per_second": out.iteration_count / solve_s,
        "host_f64": res, "launches": launches,
        "finite": bool(np.all(np.isfinite(out.primal_solution))
                       and np.all(np.isfinite(out.dual_solution))),
    }
    problems = []
    if reason != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"reason {reason}")
    if not main["finite"]:
        problems.append("non-finite solution")
    if out.primal_solution.shape != (problem.num_variables,):
        problems.append("primal shape")
    if any(v > 1e-4 for v in res.values()):
        problems.append(f"host residuals {res}")
    csr_names = [r["name"] for r in results]
    if any(launches[k] <= 0 for k in csr_names):
        problems.append(f"a kernel was not launched: {launches}")
    main["ok"] = not problems
    if problems:
        main["problems"] = problems
    emit(main)
    if problems:
        raise SystemExit(1)
    for r in results:
        key = r["name"]
        r["launches"] = launches[key]
        r["launches_per_iteration"] = launches[key] / out.iteration_count

    # The same solve again, warm (kernels and PyTorch's own modules
    # loaded), optionally under torch.profiler for the device busy time.
    warm = prepare_problem(params, problem, device=dev)
    torch.cuda.synchronize()
    with timed(torch, args.profile) as warm_run:
        out2 = optimize(params, problem, prepared=warm)
    warm_s = warm_run["seconds"]
    record = {"phase": "main_path_warm", "ok": True,
              "iterations": out2.iteration_count,
              "solve_seconds": warm_s,
              "iterations_per_second": out2.iteration_count / warm_s}
    if args.profile:
        record["profile"] = warm_run["profile"]
    emit(record)
    del prepared, warm
    if args.parent:
        record = main_path_parent(torch, compare, args.parent, dev)
        emit(record)
        if not record["ok"]:
            raise SystemExit(1)

    # 5. determinism
    small = generate_pagerank_lp(num_nodes=DET_NODES, seed=0)
    runs = []
    for _ in range(2):
        o = optimize(params, small, device=dev)
        runs.append(o)
    reasons = [r.termination_reason.name for r in runs]
    same = (
        reasons == ["TERMINATION_REASON_OPTIMAL"] * 2
        and runs[0].iteration_count == runs[1].iteration_count
        and np.array_equal(runs[0].primal_solution, runs[1].primal_solution)
        and np.array_equal(runs[0].dual_solution, runs[1].dual_solution)
    )
    emit({"phase": "determinism", "ok": bool(same), "nodes": DET_NODES,
          "iterations": [r.iteration_count for r in runs],
          "reasons": reasons})
    if not same:
        raise SystemExit(1)

    # 6. refine path: certified 1e-8 with the f32 phases on the tile plan
    stages = []
    inner_optimize = refine._optimize

    def logged_optimize(stage_params, stage_problem, stage_prepared,
                        elapsed_offset=0.0):
        t_stage = time.time()
        stage_out = inner_optimize(stage_params, stage_problem,
                                   stage_prepared, elapsed_offset)
        crit = stage_params.termination_criteria
        stages.append({
            "dtype": stage_params.dtype,
            "eps": crit.eps_optimal_relative,
            "reason": stage_out.termination_reason.name,
            "iterations": stage_out.iteration_count,
            "begin": t_stage,  # run_refine rebases it on the run's start
            "seconds": time.time() - t_stage,
        })
        return stage_out

    refine_params = make_params(1e-8, 200_000, fmt="auto")

    def run_refine(profile_on=False):
        del stages[:]
        routed.DEFAULT_TILE_ALIGNED = True
        refine._optimize = logged_optimize
        try:
            routed.reset_launch_counts()
            with timed(torch, profile_on) as run:
                result = refine.optimize_iterative_refinement(
                    refine_params, problem, device=dev
                )
            for stage in stages:
                stage["begin"] -= run["t0"]
            return (result, run["seconds"], dict(routed.LAUNCHES),
                    run.get("profile"))
        finally:
            refine._optimize = inner_optimize
            routed.DEFAULT_TILE_ALIGNED = False

    (rout, used_fallback), refine_s, refine_launches, _ = run_refine()
    rstats = rout.iteration_stats[-1] if rout.iteration_stats else None
    rres = host_residuals(problem, rout.primal_solution, rout.dual_solution)
    rounds = (
        rstats.method_specific_stats.get("refinement_rounds")
        if rstats is not None and not used_fallback else None
    )
    rec = {
        "phase": "refine_path", "nodes": NODES,
        "reason": rout.termination_reason.name,
        "iterations": rout.iteration_count,
        "stages": list(stages), "refinement_rounds": rounds,
        "used_fallback": bool(used_fallback),
        "kkt_passes": rstats.cumulative_kkt_matrix_passes if rstats else None,
        "seconds": refine_s, "host_f64": rres,
        "launches": refine_launches,
    }
    problems = []
    if rec["reason"] != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"reason {rec['reason']}")
    if any(not v <= 1e-8 for v in rres.values()):
        problems.append(f"host residuals {rres}")
    tiled_names = [r["name"] for r in tiled]
    if any(refine_launches[k] <= 0 for k in tiled_names):
        problems.append(f"a tile-plan kernel was not launched: "
                        f"{refine_launches}")
    if any(refine_launches[k] != 0 for k in csr_names):
        problems.append(f"a CSR kernel was launched: {refine_launches}")
    rec["ok"] = not problems
    if problems:
        rec["problems"] = problems
    emit(rec)
    if problems:
        raise SystemExit(1)
    for r in tiled:
        r["launches"] = refine_launches[r["name"]]
        r["launches_per_iteration"] = (
            refine_launches[r["name"]] / rout.iteration_count
        )
    if args.profile:
        # The same path again under torch.profiler (operators built anew,
        # kernels loaded): where its wall time goes.
        (pout, _), profiled_s, _, summary = run_refine(profile_on=True)
        emit({"phase": "refine_path_profiled", "ok": True,
              "iterations": pout.iteration_count,
              "stages": list(stages), "seconds": profiled_s,
              "profile": summary})

    # 7. determinism on the tile plan
    routed.DEFAULT_TILE_ALIGNED = True
    try:
        routed.reset_launch_counts()
        runs = [optimize(params, small, device=dev) for _ in range(2)]
        det_launches = dict(routed.LAUNCHES)
    finally:
        routed.DEFAULT_TILE_ALIGNED = False
    reasons = [r.termination_reason.name for r in runs]
    same = (
        reasons == ["TERMINATION_REASON_OPTIMAL"] * 2
        and runs[0].iteration_count == runs[1].iteration_count
        and np.array_equal(runs[0].primal_solution, runs[1].primal_solution)
        and np.array_equal(runs[0].dual_solution, runs[1].dual_solution)
        and all(det_launches[k] > 0 for k in tiled_names)
        and all(det_launches[k] == 0 for k in csr_names)
    )
    emit({"phase": "determinism_tiled", "ok": bool(same),
          "nodes": DET_NODES,
          "iterations": [r.iteration_count for r in runs],
          "reasons": reasons, "launches": det_launches})
    if not same:
        raise SystemExit(1)

    # 8. Mirror Prox on the CSR layout: plain A x and A' y products only,
    # through the package's entry point (ingest included in the seconds)
    from firstorderlp_torch import optimize as package_optimize

    mp_params = make_mp_params(1e-4, 20_000)
    routed.reset_launch_counts()
    t0 = time.time()
    mout = package_optimize(mp_params, problem, device=dev)
    torch.cuda.synchronize()
    mp_s = time.time() - t0
    mp_launches = dict(routed.LAUNCHES)
    mstats = mout.iteration_stats[-1] if mout.iteration_stats else None
    mres = host_residuals(problem, mout.primal_solution, mout.dual_solution)
    iters = max(mout.iteration_count, 1)
    rec = {
        "phase": "mirror_prox_path", "nodes": NODES,
        "reason": mout.termination_reason.name,
        "iterations": mout.iteration_count,
        "kkt_passes": mstats.cumulative_kkt_matrix_passes if mstats else None,
        "seconds": mp_s, "host_f64": mres, "launches": mp_launches,
        "spmv_launches_per_iteration": (
            mp_launches["spmv_csr:A"] + mp_launches["spmv_csr:AT"]
        ) / iters,
    }
    problems = []
    if rec["reason"] != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"reason {rec['reason']}")
    if not (np.all(np.isfinite(mout.primal_solution))
            and np.all(np.isfinite(mout.dual_solution))):
        problems.append("non-finite solution")
    if any(not v <= 1e-4 for v in mres.values()):
        problems.append(f"host residuals {mres}")
    for key in ("spmv_csr:A", "spmv_csr:AT"):
        if mp_launches[key] < 2 * mout.iteration_count:
            problems.append(f"{key} launched {mp_launches[key]} times in "
                            f"{mout.iteration_count} iterations")
    others = [k for k in mp_launches if not k.startswith("spmv_csr:")]
    if any(mp_launches[k] != 0 for k in others):
        problems.append(f"another kernel was launched: {mp_launches}")
    rec["ok"] = not problems
    if problems:
        rec["problems"] = problems
    emit(rec)
    if problems:
        raise SystemExit(1)
    for r in results:
        if r["name"] in ("spmv_csr:A", "spmv_csr:AT"):
            r["launches_mirror_prox"] = mp_launches[r["name"]]
    # The same solve again without ingest (with --profile under
    # torch.profiler: device busy time, launches per iteration).
    t0 = time.time()
    mp_warm = mirror_prox.prepare_problem(mp_params, problem, device=dev)
    torch.cuda.synchronize()
    mp_prepare_s = time.time() - t0
    with timed(torch, args.profile) as mp_run:
        pout = mirror_prox.optimize(mp_params, problem, prepared=mp_warm)
    record = {"phase": "mirror_prox_path_warm", "ok": True,
              "iterations": pout.iteration_count,
              "prepare_seconds": mp_prepare_s,
              "solve_seconds": mp_run["seconds"],
              "iterations_per_second": (
                  pout.iteration_count / mp_run["seconds"])}
    if args.profile:
        summary = mp_run["profile"]
        record["kernel_launches_per_iteration"] = (
            summary["kernel_launches"] / max(pout.iteration_count, 1)
        )
        record["profile"] = summary
    emit(record)
    del mp_warm

    # 9. determinism of Mirror Prox, on the tile plan
    mp_small = make_mp_params(1e-4, 20_000)
    routed.DEFAULT_TILE_ALIGNED = True
    try:
        routed.reset_launch_counts()
        runs = [mirror_prox.optimize(mp_small, small, device=dev)
                for _ in range(2)]
        det_launches = dict(routed.LAUNCHES)
    finally:
        routed.DEFAULT_TILE_ALIGNED = False
    reasons = [r.termination_reason.name for r in runs]
    same = (
        reasons == ["TERMINATION_REASON_OPTIMAL"] * 2
        and runs[0].iteration_count == runs[1].iteration_count
        and np.array_equal(runs[0].primal_solution, runs[1].primal_solution)
        and np.array_equal(runs[0].dual_solution, runs[1].dual_solution)
        and all(det_launches[k] > 0
                for k in ("tiled_spmv:A", "tiled_spmv:AT"))
        and all(det_launches[k] == 0 for k in det_launches
                if not k.startswith("tiled_spmv:"))
    )
    emit({"phase": "determinism_mp", "ok": bool(same), "nodes": DET_NODES,
          "iterations": [r.iteration_count for r in runs],
          "reasons": reasons, "launches": det_launches})
    if not same:
        raise SystemExit(1)

    # 10-13. the shared-pattern fleet
    lane_rows = fleet_phases(
        args, torch, dev, compare, routed,
        lambda p, prob: package_optimize(p, prob, device=dev),
    )

    # 14. kernel list
    results = results + tiled + probes + lane_rows
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("ms_without_row_split", "device_ms_without_row_split",
             "launches_per_iteration",
             "launches_mirror_prox", "max_abs_err_vs_csr_kernel",
             "padding_share", "max_rel_err", "device_ms",
             "library_device_ms", "kernels_per_call",
             "library_kernels_per_call", "bytes_beyond_inputs", "chunks",
             "warps", "blocks",
             "entries_per_block_max", "entries_per_block_mean",
             "tiles_staged", "tiles_gathered", "bytes_staged", "large",
             "max_abs_err_vs_plain", "lanes", "kernels_per_call_turns")
    emit({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in results
    ], "card": smi_line})
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
