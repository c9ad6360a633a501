#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (firstorderlp_torch) on one GPU.

Run from the root of the repository:

    python3 chip_smoke.py [--out FILE] [--profile] [--parent DIR]
    python3 chip_smoke.py --only PHASES [--parent DIR]
        # the device and build phases and PHASES alone (comma-separated:
        # evaluation_split, kernels_trust_region, kernels_eval_stats,
        # kernels_trial)

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
   into pieces; for B2 its own item table, stages, bytes staged, empty
   rows and ptxas's registers and shared memory), 20 launches bitwise
   equal with the tickets back at zero, and each again with no row cut
   (`ms_without_row_split`, `device_ms_without_row_split`);
   kernels_tiled: the same for the tile-plan kernels (tile_aligned=True),
   each also held against the CSR kernel on the same vectors and
   launched twice for the same bits, with the device time of a call
   from torch.profiler and what the launch looks like (blocks, the
   largest and the mean number of stored entries per block, tiles staged
   and gathered, bytes staged);
   kernels_trial: the step trial's two kernels around B3/B4 (B6/B7),
   F1a primal_step and F1b trial_epilogue (ops/pdhg_step.py), on the
   scaled LP's data and a state made with numpy from a seed, on CSR and
   the tile plan, three step sizes, the mask on and off, adaptive and
   constant: each bitwise equal to its plain version, with times (CUDA
   events, device time and kernels a call, the plain version's; F1b's
   also for a trial that does not take its step) and the bytes bound;
   F1a's grid, its time on inputs that are views at an odd offset in
   turns with aligned ones, and on a million entries; given --parent, both kernels and the parent's in
   turns, F1a at a million entries too;
   kernels_trust_region: the f32 exact trust region's kernels
   (ops/trust_region_search.py), F2b (the prologue F2a and the knot
   search, 11 trips of 7 test points, SEARCH_BITS = 3: tr_search, one
   launch of a cluster a row, or the whole-card path, tr_knots and 11
   tr_trip launches, for a row too long to stage) and F2c tr_solution,
   at the restart scheme's shape (3 rows over the scaled LP's primal and
   dual bounds), the 128-lane fleet's (384 rows of 40,001, bounds a
   row), one row of 300,000 (past what 8-block clusters stage) and the
   1M-node LP's restart scheme (3 rows of 2,000,001 with its bound
   pattern: x >= 0, the equality row's dual free, the others >= 0),
   inputs made with numpy: t*, the solution and the split sums bitwise
   equal to the plain versions' and to a second launch, the launch plan
   (cluster and shared memory, or the whole card) and F2b's device time
   at each shape, F2c's grid (blocks a row, blocks) and device time at
   each shape (given --parent, beside the parent's tr_search and
   tr_solution in turns at each shape; at the 1M shape also one call
   replayed from a CUDA graph, timed in turns with the parent's, and the
   share of the entries still in the whole-card path's lists after its
   prologue and after each trip), F2b under 8- and 16-block plans and
   the whole-card path timed in turns at the restart scheme's shape,
   times (CUDA events, device time and kernels a call, the plain
   versions') and the bytes bound; the line before it
   (kernels_trust_region_plan) prints the search's bits, K, trips,
   threads, the card's cluster limit and its co-resident clusters, and
   tr_solution's wave (the card's SMs, the blocks an SM holds);
   kernels_eval_stats: an evaluation's statistics kernels
   (ops/eval_stats.py), F2d stats_point, F2e stats_primal and F2f
   stats_dual (the finalize in its last block), on the LP as optimize
   prepares it, a point and an average made with numpy, the products by
   B2 on the original operator, infeasibility detection off (the main
   path's criteria) and on: the points, the ray, every maximum and flag
   and the finalize bitwise the plain versions', each f64 sum within
   2^-40 sum|t| of the plain one, a second launch bitwise with the
   tickets at zero; times (CUDA events, device time and kernels a call,
   the plain versions'), the bytes bound and ptxas's registers; all three
   at that LP and at the million-node matrix's shape (vectors made with
   numpy; F2d with its average and without, F2e and F2f the ray off and
   on), in three turns with the version in --parent DIR where given,
   with their grids and bounds (`shapes`);
   kernels_tiled_large: the three tile-plan kernels and the three CSR
   kernels, again on a matrix of the PageRank LP's
   structure with a million nodes (generators.pagerank_like_matrix, made
   in bulk with numpy: the generator's graph is a Python loop over the
   nodes), whose arrays are larger than the L2 cache; F1a and F1b at its
   shapes on vectors made with numpy (bitwise their plain versions,
   device ms beside a one-element fill_'s, the floor of any launch);
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
   on the host, each kernel's launch count on that run (the graph
   replays credited, exactly one eager evaluation's and step's times
   their counts) and what its segments did (spans.COUNTS:
   evaluations, steps, read-backs a segment, replays, loads and
   unloads, the capture and its seconds, which the solve's seconds
   include); every trial and evaluation must be a replay; then the
   same solve warm (with --profile, under torch.profiler: device busy
   time and idle share, the ops that take it);
   segment_graph: the evaluation and a dispatch of three segments
   replayed from the bundle's CUDA graphs against the same run
   eagerly, from one state at iteration 81, PDHG on CSR and on the tile
   plan and Mirror Prox on CSR: state and result bitwise equal, the
   same launches, read-backs a segment, replays, the capture's
   seconds, the host's launch calls an evaluation, a segment and a
   step, and seconds in turns; for PDHG also the trial alone
   (`trial`): the device ms of a replayed trial, the host's
   cudaGraphLaunch time a replay, the trial graph's nodes, and an eager
   trial's host launch calls and kernels, which must be F1a, B3/B6,
   B4/B7 and F1b and nothing else; the evaluation's graph nodes;
   evaluation_split: one eager PDHG and one eager Mirror Prox
   evaluation from the state at iteration 81, split by function
   (evaluation_point, the statistics, the restart scheme, its bounds,
   the trust region and its knot search and solution), each range's
   device ms (CUDA events) and host launch calls (torch.profiler), and
   the replayed evaluation's device ms and graph nodes, for the
   version in --parent DIR too; this version's trust region must be
   two launches, its knot search one, its statistics (the evaluation
   point folded in) at most seven; with --parent DIR,
   main_path_parent: the warm solve and mirror_prox_path's at six seeds
   by another version of the package (DIR holds it as
   firstorderlp_torch_parent) and by this one, in turns (ms an
   iteration; every solve OPTIMAL with host-f64 residuals under 1e-4,
   each version's two solves of a seed and solver with the same
   iterations and the same bits of x and y, the versions' iterations
   side by side; then each version's PDHG trial from the state at
   iteration 81, in turns, measured as segment_graph's `trial`); hetero_parent: hetero_fleet's solve by both, in turns,
   and once each under torch.profiler (B2's share of the device time);
   cli_path: the port's CLIs (firstorderlp_torch/cli) as a user
   runs them: generate_pagerank_lp writes that LP (3 edges a node, the
   generator's default) to an .mps.gz, which must read back with the
   main path's pattern and values; the native tokenizer (it must load)
   and the Python parser read it, every field equal, with both MB/s;
   solve_qp in f32 on the kernel operator at 1e-4 must give OPTIMAL,
   its four files, host-f64 residuals of the written primal and dual
   under 1e-4, the CSR kernels launched and main_path's objective; at
   its default float64 (CsrOp) on the 20k-node LP OPTIMAL with no kernel
   launched (iterations, seconds); solve_lp_external with HiGHS on a
   2,000-node LP, residuals evaluated on the card; a traced optimize
   (profiler_trace_dir) on the 20k-node LP between two untraced ones,
   bitwise equal to them, whose Chrome trace must name the port's
   folp:: kernels; the build
   phase prints compile_meter's split;
5. determinism: the 20k-node LP solved twice, both OPTIMAL with
   bitwise-equal results;
6. refine_path: firstorderlp_torch.optimize_iterative_refinement on the
   100k-node LP to OPTIMAL at 1e-8 with the f32 phases on the tile-plan
   kernels (ops.routed.DEFAULT_TILE_ALIGNED set for the phase),
   residuals and gap recomputed in f64 here, the tile-plan kernels'
   launch counts above 0 and the CSR kernels' at 0, what the segments
   did (each shifted sub-solve's bundle captures its own graph);
7. determinism_tiled: the 20k-node LP solved twice on the tile plan;
8. mirror_prox_path: firstorderlp_torch.optimize with
   MirrorProxParameters on the 100k-node LP in f32 with the kernel
   operator (CSR layout, l2 mirror map), to OPTIMAL at 1e-4, residuals
   and gap recomputed in f64 here, spmv_csr launched at least twice per
   iteration for A and for A', every other kernel of ops/routed.py at 0,
   every iteration a replay and no read-back in the steps (with
   --profile the same solve again under torch.profiler);
9. determinism_mp: the 20k-node LP solved twice by Mirror Prox on the
   tile plan, tiled_spmv launched and the CSR kernels not;
10. kernels_lanes: the lane kernel L1 (ops/lanes.py) on the 128-lane
    20k-node PageRank fleet's scaled planes, A and A', against its plain
    version on the card and an f64 recomputation, 20 launches bitwise
    equal with the tickets back at zero, with times (events; device time
    and kernels a call in turns with the block-diagonal library SpMV),
    the bound, blocks and entries per block, and the launch's design: the
    variant (lanes a thread), the entries a warp loads at once, and what
    ptxas said of registers, static shared memory and spills
    (ops/compare_kernels.lanes_row, which compare_kernels --layout lanes
    prints too); kernels_lane_trial: the fleet's lane trial's four
    kernels (ops/lanes_step.py: LF1a, L1 with the dual step, L1' with
    the step-control sums, LF1b) at 128 x 100k and 128 x 20k on a sweep
    three segments into its solve, each against its plain version on the
    same inputs (vectors, mask, verdict and state bitwise, the f64 sums
    within an ulp, a second launch bitwise, tickets at zero), then timed
    in turns beside its plain version, and the fused trial beside the
    eager one (device ms, bytes bound; rows in the kernel list;
    --only kernels_lane_trial runs it alone);
11. fleet_path: batch.solve_batch_shared_pattern on that fleet (a
    FleetSpec, pagerank_fleet_spec) by PDHG in f32 to 1e-4 with a limit
    of 20,000 iterations a lane; every lane OPTIMAL with residuals and
    gap recomputed in f64 on the host (a lane that is not: solved alone
    by optimize under the same limit, which must give the same reason);
    L1 launched, the single-instance kernels not, every trial the fused
    lane trial (each of its four kernels' launches ==
    COUNTS["fused_lane_trials"] == COUNTS["steps"] > 0 over the solve);
    lanes 0 and 127 solved again by optimize (the same reason, host
    residuals under 1e-4); fleet_mirror_prox: the same with Mirror Prox,
    whose trials are never fused;
12. fleet_throughput: bench.py's protocol (zero tolerances, 600
    iterations a lane, a warm-up solve, then a timed one), PDHG and
    Mirror Prox: aggregate iterations and KKT passes a second, ingest
    cold and warm, step trials and read-backs, and the kernel launches
    of a step trial and of an evaluation (one segment under
    torch.profiler), and the timed PDHG solve's trials all fused (Mirror
    Prox's none); with --profile the timed solves under
    torch.profiler (device busy and idle share, top ops);
13. determinism_fleet: 16 lanes solved twice, bitwise equal;
    fleet_checkpoint: an 8-lane fleet stopped by a limit of 120
    iterations (one dispatch) with a checkpoint, resumed, against an
    uninterrupted run: the same reasons, solutions within 1e-6, and
    whether they are bitwise equal;
14. kernels_block_lanes: B2 (spmv_csr) on the heterogeneous fleet's
    interleaved block-diagonal matrix (ops/block_lanes.py), A and A',
    against its plain version on the card and an f64 product, 20
    launches bitwise equal with the tickets back at zero, times (events,
    device time and kernels a call in turns with the
    torch.sparse_csr_tensor product of the same block matrix), the bytes
    bound and B2's launch (compare_kernels.block_lanes_row);
15. hetero_fleet: batch.solve_batch on 32 PageRank LPs of 10,000-40,000
    nodes (generate_pagerank_lp(nodes_i, seed=10+i)) by PDHG in f32 to
    1e-4 with a limit of 20,000 iterations a lane: every lane OPTIMAL
    with host-f64 residuals and gap under 1e-4, B2 launched and L1 and
    B3-B7 not, lanes 0 and 31 solved again by optimize (the same
    reason); generation, ingest and solve seconds, lane-iterations a
    second;
16. qp_fleet: batch.solve_batch_shared_pattern on a 32-lane Tikhonov
    path (the 20k-node PageRank LP plus lambda_b I, lambda_b geometric
    in [1e-3, 1]) by PDHG and by Mirror Prox to 1e-4 (the per-instance
    ingest): every lane OPTIMAL in host f64, L1 launched for A, A' and
    Q, lanes 0 and 31 solved again by optimize;
17. constant_step_fleet: the 32-lane damping sweep as a problem list
    with constant steps and bound-width rescaling, to 1e-4 or 20,000
    iterations a lane: lanes 0 and 31 give the reasons of optimize
    alone, OPTIMAL lanes under 1e-4 in host f64, L1 launched, the fused
    lane trial not (constant steps keep the eager trial; nor does the
    QP fleet take it);
18. kernels_sharded: the block-partitioned operator
    (ops/routed_sharded.py) on (2, 2) and (4, 1) meshes of cuda:0, CSR
    blocks (B2) and tile-plan blocks (B5), at the shapes sharded_optimize
    gives them (the 100k-node LP padded to the mesh and rescaled): A x
    and A' y against the single-device RoutedOp and against the blocks'
    plain versions (the f32 rounding class), two calls bitwise equal, one
    launch a call for each non-empty block, CUDA-event ms a call beside
    the single-device operator's, the plain versions' and the library
    product's;
19. sharded_path: parallel.sharded_optimize with main_path's parameters
    on the 100k-node LP on (2, 2) and (4, 1) meshes of cuda:0 (B2 blocks
    launched, the fused kernels not), and Mirror Prox on the 20k-node LP
    on both meshes with tile-plan blocks (B5): OPTIMAL, host-f64
    residuals under 1e-4, iterations, seconds (ingest apart) and ms an
    iteration beside main_path's;
20. distributed_path: (a) a process group of one rank on NCCL in this
    process, parallel.distributed.distributed_optimize of the 20k-node
    LP on a (1, 1) mesh, bitwise equal to the single-process (1, 1)
    sharded_optimize; (b) two gloo ranks on the one card (this script
    again, `--distributed-worker`, on a free port, killed after 300 s),
    a (2, 1) solve of the 100k-node LP: both ranks give the same bits as
    the single-process (2, 1) mesh, OPTIMAL in host f64, B2 launched on
    each rank;
21. shard_ingest_path: row-sharded ingest (parallel/shard_ingest.py)
    on the 100k-node LP with main_path's parameters: (a)
    mps_row_shard_spec of cli_path's .mps.gz (handed on, not written
    again) equal to the port's reader, field by field, its row blocks
    reassembling the reader's matrix exactly; (b) host_sharded_optimize
    on (2, 2) (streaming the file) and (4, 1) (problem_row_shard_spec)
    meshes of cuda:0 and on the tile plan on (2, 2): OPTIMAL in host
    f64, B2 (or B5) launched a multiple of the non-empty cells, the
    rescale's B2 sums apart and no other kernel, load, rescale, build
    and solve seconds, ms an iteration beside sharded_path's, and the
    on-device rescale against the host f64 rescale_problem (relative
    1e-4); (c) the (2, 2) solve again, bitwise equal; (d) two gloo ranks
    on the card (`--distributed-worker ... ingest FILE`), each streaming
    exactly its row block of a (2, 1) mesh, bitwise equal to the
    single-process (2, 1) mesh; (e) the f64 CsrOp row-block path on
    (4, 1) at 20k nodes, OPTIMAL with no kernel launched;
22. the kernel list ({"kernels": [...]}), the sharded products' rows
    last (with the row-sharded ingest's launches beside sharded_path's).

Then the `nvidia-smi` line and, last, {"ok": true, "device": {...}}.

With --multi-gpu, on a host with four cards, only the device and build
phases and multi_gpu_path run: the 100k-node LP by sharded_optimize on
a (2, 2) mesh on one card and on a (2, 2) mesh over four cards, and by
four NCCL ranks (one card and one block each), all bitwise equal; then
host_sharded_optimize on (2, 2) as four NCCL ranks, bitwise equal to
the (2, 2) mesh on one card.
Exits non-zero, before the last line, when there is no CUDA device or
any phase fails. Imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
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
# The QP fleet (a Tikhonov path lambda I over one 20k-node PageRank LP)
# and the constant-step fleet (the damping sweep), 32 lanes each.
SLOW_FLEET_LANES = 32
# The f32 exact trust region's kernels (ops/trust_region_search.py): every
# f32 solve on the card runs them in its evaluations, fleets and meshes
# too; their launches on each path, for the kernel list.
TR_KERNELS = ("tr_search", "tr_solution")
# The fleet's lane trial (ops/lanes_step.py), each launch's entry in
# ops/lanes.LAUNCHES: LF1a, L1 with the dual step, L1' with the
# step-control sums, LF1b.
LANE_TRIAL_KERNELS = ("lane_primal_step", "lanes_spmv:A+dual",
                      "lanes_spmv:AT+stats", "lane_trial_epilogue")
# kernels_lane_trial's shapes: (nodes, lanes), the sweep cell's and the
# fleet phases'.
LANE_TRIAL_SHAPES = ((100_000, 128), (20_000, 128))
_tr_launches = {}
# An evaluation's statistics kernels (ops/eval_stats.py): every f32
# single-instance evaluation on the kernel operator runs them, meshes and
# fleets do not.
STATS_KERNELS = ("stats_point", "stats_primal", "stats_dual")

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


def make_mp_params(tol, limit, dtype="float32", fmt="routed", pkg=None):
    """bench.py's make_mp_params settings with tolerances: make_params'
    rescaling, restarts and evaluation frequency, the l2 mirror map
    (`pkg` as in make_params)."""
    if pkg is None:
        import firstorderlp_torch as pkg

    p = make_params(tol, limit, dtype, fmt, pkg=pkg)
    return pkg.MirrorProxParameters(
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
    to eps_abs/eps_rel = 1 plus the norm of b, c or the objectives; a
    QP's objective matrix Q in the gradient Q x + c - A'y and in both
    objectives)."""
    a = problem.constraint_matrix.tocsr()
    q = problem.objective_matrix
    qx = q.tocsr() @ x if q is not None and q.nnz else np.zeros_like(x)
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
    g = qx + c - a.T @ y
    bound = np.where(g > 0.0, lb, ub)
    rc = np.where(np.isfinite(bound), g, 0.0)
    dual_viol = np.concatenate([np.maximum(-y[meq:], 0.0), g - rc])
    quadratic = 0.5 * np.sum(x * qx)
    primal_obj = problem.objective_constant + np.sum(c * x) + quadratic
    active = rc != 0.0
    dual_obj = (
        np.sum(b * y) + problem.objective_constant - quadratic
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


def fused_trial_problems(launches, counts, fused: bool):
    """What is wrong with a fleet solve's lane-trial launches: with
    `fused`, each of LANE_TRIAL_KERNELS once a trial and every trial
    fused (each count == COUNTS["fused_lane_trials"] == COUNTS["steps"]
    > 0, the counters' change over the solve); without, none of them
    and no fused trial."""
    got = [launches[k] for k in LANE_TRIAL_KERNELS] + [
        counts["fused_lane_trials"]]
    if fused:
        if not (counts["steps"] > 0
                and all(v == counts["steps"] for v in got)):
            return [f"not every trial was fused: {got} against "
                    f"{counts['steps']} trials"]
    elif any(got):
        return [f"the fused lane trial ran: {got}"]
    return []


def counts_since(before):
    """spans.COUNTS' change since `before` (a copy), for the trials."""
    from firstorderlp_torch import spans

    return {k: spans.COUNTS[k] - before[k]
            for k in ("steps", "fused_lane_trials")}


def kernels_lane_trial(torch, compare, shapes=LANE_TRIAL_SHAPES):
    """The fleet's lane trial's four kernels (ops/lanes_step.py) on a
    damping sweep three segments into its solve, at each (nodes, lanes)
    of `shapes`: each against its plain version on the same inputs
    (compare_kernels.lane_trial_checks: vectors, mask, verdict and state
    bitwise, the f64 sums within an ulp, a second launch bitwise, the
    tickets at zero), then each kernel, its plain version, the fused
    trial and the eager one timed in turns (lane_trial_times). Returns
    the kernel list's rows, one a kernel and shape."""
    ph = "kernels_lane_trial"
    t_phase = time.time()
    dev = torch.device("cuda")
    rows, results = [], []
    for nodes, nl in shapes:
        case = compare.lane_trial_case(nodes, nl, dev)
        checks = compare.lane_trial_checks(*case)
        if not checks["ok"]:
            fail(ph, f"{nl} x {nodes}: a kernel differs from its plain "
                     f"version: {checks}")
        times = compare.lane_trial_times(*case)
        op = case[0].constraint_matrix
        results.append({"nodes": nodes, "lanes": nl, "m": op.shape[0],
                        "n": op.shape[1], "nnz": op.pattern.nnz,
                        "checks": checks, "times": times})
        for name in LANE_TRIAL_KERNELS:
            t, plain = times[name], times[name + ":plain"]
            rows.append({
                "name": f"{name} {nl}x{nodes}", "route": "cuda",
                "source": "firstorderlp_torch/csrc/" + (
                    "lanes_spmv.cu" if name.startswith("lanes_spmv")
                    else "lanes_step.cu"),
                "replaces": "none (no pl.pallas_call): the JAX package's "
                            "vmapped _segment_core, XLA-fused, "
                            "firstorderlp_tpu/batch.py:162",
                "ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": plain["ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes",
                "kernels_per_call": t["kernels_per_call"], "lanes": nl,
                "bitwise_equal": checks[name]["bitwise"]})
    emit({"phase": ph, "ok": True, "phase_seconds": time.time() - t_phase,
          "results": results})
    return rows


def fleet_solve_phase(ph, torch, batch, lanes, routed, params, spec,
                      fleet, problems, single_optimize, fused):
    """One fleet solve to 1e-4, checked lane by lane (see the module
    docstring, fleet_path); `fused`: whether every trial must be the
    fused lane trial (fused_trial_problems)."""
    from firstorderlp_torch import spans

    t_phase = time.time()
    lanes.reset_launch_counts()
    routed.reset_launch_counts()
    before = dict(spans.COUNTS)
    stats = batch.FleetRunStats()
    t0 = time.time()
    outs = batch.solve_batch_shared_pattern(params, spec, fleet=fleet,
                                            run_stats=stats)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    launches = dict(lanes.LAUNCHES)
    trial_counts = counts_since(before)
    _tr_launches[ph] = {k: routed.LAUNCHES[k] for k in TR_KERNELS}
    single_kernels = {k: v for k, v in routed.LAUNCHES.items()
                      if v and k not in TR_KERNELS}
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
    if not (launches["lanes_spmv:A"] > 0 and launches["lanes_spmv:AT"] > 0):
        problems_found.append(f"L1 was not launched: {launches}")
    problems_found += fused_trial_problems(launches, trial_counts, fused)
    if not all(_tr_launches[ph].values()):
        problems_found.append(f"a trust-region kernel was not launched: "
                              f"{_tr_launches[ph]}")
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
        "launches": launches, "trial_counts": trial_counts,
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
    from firstorderlp_torch import spans
    from firstorderlp_torch.ops import lanes

    batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
    torch.cuda.synchronize()
    stats = batch.FleetRunStats()
    lanes.reset_launch_counts()
    before = dict(spans.COUNTS)
    with timed(torch, profile_on) as run:
        outs = batch.solve_batch_shared_pattern(params, spec, fleet=fleet,
                                                run_stats=stats)
    seconds = run["seconds"]
    counts = counts_since(before)
    launches = {k: lanes.LAUNCHES[k] for k in LANE_TRIAL_KERNELS}
    iterations = sum(o.iteration_count for o in outs)
    kkt = sum(o.iteration_stats[-1].cumulative_kkt_matrix_passes
              for o in outs)
    rec = {"seconds": seconds, "ingest_seconds": ingest,
           "iterations_sum": iterations, "kkt_passes_sum": kkt,
           "aggregate_iterations_per_second": iterations / seconds,
           "aggregate_kkt_passes_per_second": kkt / seconds,
           "step_trials": stats.trials, "evaluations": stats.segments,
           "dispatches": stats.dispatches, "read_backs": stats.read_backs,
           "reasons": sorted({o.termination_reason.name for o in outs}),
           "trial_counts": counts, "lane_trial_launches": launches,
           "lane_trial_problems": fused_trial_problems(
               launches, counts, not batch._is_mp(params))}
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


def fleet_parent(torch, compare, parent_dir, dev):
    """fleet_throughput's PDHG protocol (zero tolerances,
    THROUGHPUT_ITERS iterations a lane, the 128-lane fleet prepared and
    solved once untimed) by another version of this package
    (`parent_dir` holds it as `firstorderlp_torch_parent`) and by this
    one, in turns (parent, this, this, parent): lane-iterations a
    second, seconds (host clock up to a device synchronize) and L1's
    launches in each timed solve."""
    dirs = {"parent": parent_dir, "this": None}
    runs = {}
    for who, where in dirs.items():
        pkg, batch, generators, lanes = (
            compare.package_module(part, where)
            for part in ("", "batch", "generators", "ops.lanes"))
        params = make_params(0.0, THROUGHPUT_ITERS, fmt="auto", pkg=pkg)
        spec = generators.pagerank_fleet_spec(
            FLEET_NODES, np.linspace(0.7, 0.995, FLEET_LANES), seed=0)
        fleet = batch.prepare_shared_pattern_fleet(params, spec, device=dev)
        batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
        runs[who] = (batch, lanes, params, spec, fleet)
    torch.cuda.synchronize()
    rows = []
    for who in ("parent", "this", "this", "parent"):
        batch, lanes, params, spec, fleet = runs[who]
        lanes.reset_launch_counts()
        t0 = time.time()
        outs = batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        iterations = sum(o.iteration_count for o in outs)
        rows.append({"package": who, "seconds": seconds,
                     "iterations_sum": iterations,
                     "aggregate_iterations_per_second": iterations / seconds,
                     "launches": dict(lanes.LAUNCHES)})
    ok = all(r["iterations_sum"] == FLEET_LANES * THROUGHPUT_ITERS
             and r["launches"]["lanes_spmv:A"] > 0
             and r["launches"]["lanes_spmv:AT"] > 0 for r in rows)
    return {"phase": "fleet_parent", "ok": ok, "nodes": FLEET_NODES,
            "lanes": FLEET_LANES, "iterations_per_lane": THROUGHPUT_ITERS,
            "parent": parent_dir, "solves": rows}


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
    trial_rows = kernels_lane_trial(torch, compare)
    # the lanes as host problems, for the f64 residuals and the single
    # solves (the same graph as the spec's)
    problems = generators.generate_pagerank_lp_fleet(FLEET_NODES, damping,
                                                     seed=0)

    # 11. the fleet by PDHG, then by Mirror Prox
    rec = fleet_solve_phase("fleet_path", torch, batch, lanes, routed,
                            params, spec, fleet, problems, single_optimize,
                            fused=True)
    for r in rows:
        r["launches"] = rec["launches"][r["name"]]
    for r in trial_rows:
        if r["name"].endswith(f"x{FLEET_NODES}"):
            r["launches"] = rec["launches"][r["name"].split(" ")[0]]
    del fleet
    mp_params = make_mp_params(1e-4, 20_000, fmt="auto")
    mp_fleet = batch.prepare_shared_pattern_fleet(mp_params, spec,
                                                  device=dev)
    mrec = fleet_solve_phase("fleet_mirror_prox", torch, batch, lanes,
                             routed, mp_params, spec, mp_fleet, problems,
                             single_optimize, fused=False)
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
    emit_checked({"phase": "fleet_throughput",
                  "nodes": FLEET_NODES, "lanes": FLEET_LANES,
                  "iterations_per_lane": THROUGHPUT_ITERS,
                  "ingest_cold_seconds": ingest_s,
                  "ingest_warm_seconds": warm_ingest_s,
                  "phase_seconds": time.time() - t_phase,
                  "pdhg": pdhg, "mirror_prox": mirror},
                 pdhg["lane_trial_problems"]
                 + mirror["lane_trial_problems"])
    if args.parent:
        record = fleet_parent(torch, compare, args.parent, dev)
        emit(record)
        if not record["ok"]:
            raise SystemExit(1)

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
    return rows + trial_rows


def block_lanes_rows(torch, compare, op):
    """B2 on the heterogeneous fleet's interleaved block-diagonal matrix
    (ops/block_lanes.py), A and A' (compare_kernels.block_lanes_row):
    against its plain version on the card and an f64 product on the
    host, 20 launches bitwise equal with the tickets back at zero, times
    in turns with the library call on the same block matrix, the bytes
    bound and what the launch looks like."""
    ph = "kernels_block_lanes"
    rng = np.random.default_rng(0)
    m, n = op.shape
    rows = []
    for label, mat, dim in (("A", op.a, n), ("AT", op.at, m)):
        v = torch.as_tensor(
            rng.standard_normal((dim, op.lanes)).astype(np.float32),
            device=op.a.device)
        try:
            row = compare.block_lanes_row(label, mat, v)
        except compare.KernelMismatch as exc:
            fail(ph, str(exc))
        rows.append({
            **row,
            "route": "cuda",
            "source": "firstorderlp_torch/csrc/spmv_csr.cu",
            "replaces": "firstorderlp_tpu/ops/routed.py:160 (_make_expand)"
                        " + routed.py:188 (_make_reduce); the JAX package "
                        "runs this product as XLA gathers over aligned ELL "
                        "planes, firstorderlp_tpu/batch.py:1248",
        })
    return rows


def lane_checks(problems, outs, params, single_optimize, single_lanes):
    """Each lane's host-f64 residuals (every OPTIMAL lane under 1e-4),
    finite solutions of the lane's own shape, and the lanes
    `single_lanes` solved again alone by optimize, which must give the
    same reason. Returns (record fields, problems found)."""
    found = []
    worst = {"rel_primal_residual": 0.0, "rel_dual_residual": 0.0,
             "rel_gap": 0.0}
    reasons = [o.termination_reason.name for o in outs]
    for i, (problem, out) in enumerate(zip(problems, outs)):
        if not (np.all(np.isfinite(out.primal_solution))
                and np.all(np.isfinite(out.dual_solution))):
            found.append(f"lane {i}: non-finite solution")
        if (out.primal_solution.shape != (problem.num_variables,)
                or out.dual_solution.shape != (problem.num_constraints,)):
            found.append(f"lane {i}: solution shapes "
                         f"{out.primal_solution.shape} "
                         f"{out.dual_solution.shape}")
            continue
        res = host_residuals(problem, out.primal_solution,
                             out.dual_solution)
        for k, v in res.items():
            worst[k] = max(worst[k], v)
        if (reasons[i] == "TERMINATION_REASON_OPTIMAL"
                and any(not v <= 1e-4 for v in res.values())):
            found.append(f"lane {i}: host residuals {res}")
    singles = []
    for i in single_lanes:
        single = single_optimize(params, problems[i])
        singles.append({"lane": i, "reason": single.termination_reason.name,
                        "iterations": single.iteration_count,
                        "fleet_iterations": outs[i].iteration_count})
        if single.termination_reason.name != reasons[i]:
            found.append(f"lane {i}: {reasons[i]} in the fleet, "
                         f"{single.termination_reason.name} alone")
    iterations = [o.iteration_count for o in outs]
    return {
        "reasons": {r: reasons.count(r) for r in sorted(set(reasons))},
        "iterations_min": min(iterations), "iterations_max": max(iterations),
        "iterations_sum": sum(iterations),
        "kkt_passes_sum": sum(o.iteration_stats[-1]
                              .cumulative_kkt_matrix_passes for o in outs),
        "host_f64_worst": worst, "single_solves": singles,
    }, found


def run_fleet(torch, batch, lanes, routed, solve, params, problems, fleet):
    """One fleet solve with the launch counts set to 0 just before it
    and read just after: (outputs, seconds, run stats, L1 launches, the
    routed kernels' launches)."""
    lanes.reset_launch_counts()
    routed.reset_launch_counts()
    stats = batch.FleetRunStats()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = solve(params, problems, fleet=fleet, run_stats=stats)
    torch.cuda.synchronize()
    return (outs, time.time() - t0, stats, dict(lanes.LAUNCHES),
            dict(routed.LAUNCHES))


def emit_checked(rec, found):
    rec["ok"] = not found
    if found:
        rec["problems"] = found
    emit(rec)
    if found:
        raise SystemExit(1)


# The multi-device phases: the block-partitioned operator on one card,
# sharded_optimize on (2, 2) and (4, 1) meshes of cuda:0, and the
# torch.distributed layer (NCCL world of 1; two gloo ranks on the card).
SHARDED_MESHES = ((2, 2), (4, 1))
DIST_MESH = (2, 1)  # the two gloo ranks' mesh
DIST_TIMEOUT = 300  # seconds; a rank that waits longer fails the phase


def sharded_plain(torch, routed, sop, v, transpose):
    """A ShardedRoutedOp's product with each block's plain version, the
    partials added in the operator's order."""
    n_dual, n_primal = sop.mesh.shape
    rows, cols = sop.num_rows // n_dual, sop.num_cols // n_primal
    plain = (routed.tiled_spmv_plain if sop.tile_aligned
             else routed.spmv_csr_plain)
    pieces = []
    for outer in range(n_primal if transpose else n_dual):
        total = torch.zeros(cols if transpose else rows,
                            dtype=torch.float32, device=v.device)
        for inner in range(n_dual if transpose else n_primal):
            d, p = (inner, outer) if transpose else (outer, inner)
            block = sop.blocks[d][p]
            if block is None:
                continue
            part = (plain(block.at, v[d * rows:(d + 1) * rows]) if transpose
                    else plain(block.a, v[p * cols:(p + 1) * cols]))
            total = total + part
        pieces.append(total)
    return torch.cat(pieces)


def kernels_sharded(torch, dev, routed, probe, compare, rescale_problem,
                    problem):
    """B2 (CSR blocks) and B5 (tile-plan blocks) through the
    block-partitioned operator on (2, 2) and (4, 1) meshes of cuda:0, at
    the shapes sharded_optimize gives them: the 100k-node LP padded to
    the mesh and rescaled. Each product against the single-device
    RoutedOp of the same matrix and against the blocks' plain versions
    (the f32 rounding class), 20 calls bitwise equal with the blocks'
    tickets back at zero, launches a call (one per non-empty block),
    CUDA-event ms a call beside the single-device operator's, and B2's
    launches over the blocks (stages, bytes staged, empty rows)."""
    from firstorderlp_torch.ops.routed_sharded import (
        build_sharded_routed_op, plan_routed_shards,
    )
    from firstorderlp_torch.parallel import pad_problem, solver_mesh

    ph = "kernels_sharded"
    t_phase = time.time()
    rows, records = [], []
    for shape in SHARDED_MESHES:
        mesh = solver_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        padded, _, _ = pad_problem(problem, *shape)
        a = rescale_problem(10, False, 1.0, 0, padded).scaled_qp
        a = a.constraint_matrix.tocsr()
        m, n = a.shape
        rng = np.random.default_rng(0)
        x_np = rng.standard_normal(n).astype(np.float32)
        y_np = rng.standard_normal(m).astype(np.float32)
        x = torch.as_tensor(x_np, device=dev)
        y = torch.as_tensor(y_np, device=dev)
        scale = {"A": abs(a) @ np.abs(x_np.astype(np.float64)),
                 "AT": abs(a).T @ np.abs(y_np.astype(np.float64))}
        csr_single = routed.build_routed_op(a, dev)
        lib = {"A": routed.library_spmv(csr_single.a),
               "AT": routed.library_spmv(csr_single.at)}
        for tile_aligned in (False, True):
            layout = "tiled" if tile_aligned else "csr"
            plan = dataclasses.replace(
                plan_routed_shards(m, n, a.nnz, mesh),
                tile_aligned=tile_aligned)
            t0 = time.time()
            sop = build_sharded_routed_op(a, plan)
            build_s = time.time() - t0
            single = routed.build_routed_op(a, dev, tile_aligned=tile_aligned)
            blocks = [b for row in sop.blocks for b in row if b is not None]
            kernel = "tiled_spmv" if tile_aligned else "spmv_csr"
            for label, vec, transpose in (("A", x, False), ("AT", y, True)):
                call = (lambda v=vec, t=transpose:
                        sop.rmv(v) if t else sop.mv(v))
                one = (lambda v=vec, t=transpose:
                       single.rmv(v) if t else single.mv(v))
                routed.reset_launch_counts()
                got = call()
                torch.cuda.synchronize()
                launches = routed.LAUNCHES[f"{kernel}:{label}"]
                want_single = one()
                want_plain = sharded_plain(torch, routed, sop, vec, transpose)
                torch.cuda.synchronize()
                errs = {}
                for what, want in (("single", want_single),
                                   ("plain", want_plain)):
                    err = (got.double() - want.double()).abs().cpu().numpy()
                    bad = err > TOL_ENTRY * scale[label] + TOL_ABS
                    if bad.any():
                        i = int(np.argmax(err - TOL_ENTRY * scale[label]))
                        fail(ph, f"{shape} {layout} {label}: entry {i} "
                                 f"differs from the {what} product by "
                                 f"{err[i]:.3e}")
                    errs[what] = float(err.max())
                mats = [b.at if transpose else b.a for b in blocks]
                differs = compare.repeat_differs(
                    call, compare.tickets_of(*mats))
                if differs:
                    fail(ph, f"{shape} {layout} {label}: {differs}")
                if launches != len(blocks):
                    fail(ph, f"{shape} {layout} {label}: {launches} launches "
                             f"a call for {len(blocks)} non-empty blocks")
                nbytes = (sum(routed.csr_kernel_bytes(mat) for mat in mats)
                          + 4 * m + 4 * n)
                bound, bound_by = probe.bound_ms(nbytes, 2 * a.nnz)
                row = {
                    "name": f"{kernel}:{label} [{shape[0]}x{shape[1]} "
                            "blocks]",
                    "route": "cuda",
                    "source": ("firstorderlp_torch/csrc/tiled_spmv.cu"
                               if tile_aligned else
                               "firstorderlp_torch/csrc/spmv_csr.cu"),
                    "replaces": (
                        "firstorderlp_tpu/ops/routed.py:347 (_make_fused)"
                        if tile_aligned else
                        "firstorderlp_tpu/ops/routed.py:160 (_make_expand)"
                        " + routed.py:188 (_make_reduce)")
                    + " per block of firstorderlp_tpu/ops/routed_sharded.py"
                    + (":191 (ShardedRoutedOp.rmv)" if transpose
                       else ":173 (ShardedRoutedOp.mv)"),
                    "mesh": list(shape),
                    "layout": layout,
                    "max_abs_err": errs["plain"],
                    "max_abs_err_vs_single_device": errs["single"],
                    "ms": probe.time_ms(call),
                    "single_device_ms": probe.time_ms(one),
                    "plain_ms": probe.time_ms(
                        lambda v=vec, t=transpose: sharded_plain(
                            torch, routed, sop, v, t)),
                    "library_ms": probe.time_ms(
                        lambda v=vec, l=lib[label]: l @ v),
                    "bound_ms": bound,
                    "bound_by": bound_by,
                    "launches_a_call": launches,
                    "blocks": len(blocks),
                    "block_nnz": [mat.nnz for mat in mats],
                    "build_seconds": build_s,
                    "repeats_bitwise": compare.REPEATS,
                }
                if not tile_aligned:  # B2's launches, summed over blocks
                    launch = [compare.b2_launch_stats(mat) for mat in mats]
                    row.update({
                        "design": launch[0]["design"],
                        "stages": sum(b["stages"] for b in launch),
                        "bytes_staged": sum(b["bytes_staged"]
                                            for b in launch),
                        "empty_rows": sum(b["empty_rows"] for b in launch),
                        "smem_bytes": max(b["smem_bytes"] for b in launch),
                        "registers": launch[0]["registers"],
                        "static_smem_bytes": launch[0]["static_smem_bytes"],
                    })
                rows.append(row)
            del sop, single
        del csr_single, lib
    emit({"phase": ph, "ok": True, "nodes": NODES,
          "seconds": time.time() - t_phase,
          "tolerance": f"|d| <= {TOL_ENTRY}*(|A||x|)_i + {TOL_ABS} against "
                       "the single-device RoutedOp and the blocks' plain "
                       "versions; two calls bitwise equal",
          "results": rows})
    return rows


def sharded_solve_record(torch, routed, solve, problem, label, host_tol):
    """One sharded solve with its launches, host-f64 check and the split
    of its seconds (ingest: the solver's prepare_problem, timed by
    wrapping it)."""
    routed.reset_launch_counts()
    t0 = time.time()
    out, prepare_s = solve()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    res = host_residuals(problem, out.primal_solution, out.dual_solution)
    iters = max(out.iteration_count, 1)
    rec = {"solve": label, "reason": out.termination_reason.name,
           "iterations": out.iteration_count, "seconds": seconds,
           "prepare_seconds": prepare_s,
           "solve_seconds": seconds - prepare_s,
           "ms_per_iteration": 1e3 * (seconds - prepare_s) / iters,
           "host_f64": res, "launches": dict(routed.LAUNCHES)}
    problems = []
    if rec["reason"] != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"{label}: reason {rec['reason']}")
    if out.primal_solution.shape != (problem.num_variables,) or (
            out.dual_solution.shape != (problem.num_constraints,)):
        problems.append(f"{label}: solution shapes")
    if not (np.all(np.isfinite(out.primal_solution))
            and np.all(np.isfinite(out.dual_solution))):
        problems.append(f"{label}: non-finite solution")
    if any(not v <= host_tol for v in res.values()):
        problems.append(f"{label}: host residuals {res}")
    return out, rec, problems


def timed_prepare(module):
    """Wraps module.prepare_problem to record its seconds; returns the
    record and a function that restores the module."""
    inner = module.prepare_problem
    spent = {"seconds": 0.0}

    def prepare(*args, **kwargs):
        t0 = time.time()
        try:
            return inner(*args, **kwargs)
        finally:
            spent["seconds"] += time.time() - t0

    module.prepare_problem = prepare
    return spent, lambda: setattr(module, "prepare_problem", inner)


def sharded_path(torch, dev, routed, problem, small, params, mp_params,
                 main_rec, warm_rec):
    """sharded_optimize as a user calls it: main_path's PDHG parameters
    on the 100k-node LP on (2, 2) and (4, 1) meshes of cuda:0 (B2 blocks,
    the fused kernels not launched), and Mirror Prox on both meshes at
    20k nodes on the tile plan (B5 blocks). OPTIMAL with host-f64 residuals
    under 1e-4, iterations, seconds and ms an iteration beside
    main_path's."""
    from firstorderlp_torch.models import mirror_prox as mp_module
    from firstorderlp_torch.models import pdhg as pdhg_module
    from firstorderlp_torch.parallel import sharded_optimize, solver_mesh

    ph = "sharded_path"
    t_phase = time.time()
    solves, problems, launches = [], [], {}
    csr_keys = ("spmv_csr:A", "spmv_csr:AT")
    tiled_keys = ("tiled_spmv:A", "tiled_spmv:AT")
    for shape in SHARDED_MESHES:
        mesh = solver_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        spent, restore = timed_prepare(pdhg_module)
        try:
            _, rec, bad = sharded_solve_record(
                torch, routed,
                lambda: (sharded_optimize(params, problem, mesh),
                         spent["seconds"]),
                problem, f"pdhg {shape[0]}x{shape[1]}", 1e-4)
        finally:
            restore()
        got = rec["launches"]
        if any(got[k] <= 0 for k in csr_keys + TR_KERNELS) or any(
                v for k, v in got.items() if k not in csr_keys + TR_KERNELS):
            bad.append(f"pdhg {shape}: launches {got}")
        rec["mesh"] = list(shape)
        solves.append(rec)
        problems += bad
        launches[("csr",) + shape] = got
    for shape in SHARDED_MESHES:
        mesh = solver_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        routed.DEFAULT_TILE_ALIGNED = True
        spent, restore = timed_prepare(mp_module)
        try:
            _, rec, bad = sharded_solve_record(
                torch, routed,
                lambda: (sharded_optimize(mp_params, small, mesh),
                         spent["seconds"]),
                small, f"mirror_prox {shape[0]}x{shape[1]} tiled", 1e-4)
        finally:
            restore()
            routed.DEFAULT_TILE_ALIGNED = False
        got = rec["launches"]
        if any(got[k] <= 0 for k in tiled_keys + TR_KERNELS) or any(
                v for k, v in got.items()
                if k not in tiled_keys + TR_KERNELS):
            bad.append(f"mirror_prox {shape}: launches {got}")
        rec.update(mesh=list(shape), nodes=DET_NODES)
        solves.append(rec)
        problems += bad
        launches[("tiled",) + shape] = got
    main_ms = 1e3 * main_rec["solve_seconds"] / main_rec["iterations"]
    warm_ms = 1e3 * warm_rec["solve_seconds"] / warm_rec["iterations"]
    record = {"phase": ph, "ok": not problems, "nodes": NODES,
              "seconds": time.time() - t_phase, "solves": solves,
              "main_path_iterations": main_rec["iterations"],
              "main_path_ms_per_iteration": main_ms,
              "main_path_warm_ms_per_iteration": warm_ms}
    if problems:
        record["problems"] = problems
    emit(record)
    if problems:
        raise SystemExit(1)
    return launches, solves


def distributed_worker(argv) -> int:
    """One rank of a process group: `chip_smoke.py --distributed-worker
    RANK WORLD PORT OUT N_DUAL N_PRIMAL [ingest SOURCE]` solves the
    100k-node LP with main_path's parameters on an (N_DUAL, N_PRIMAL)
    global mesh and saves its result to OUT (.npz): by
    distributed_optimize, or with `ingest` by
    shard_ingest.host_sharded_optimize, streaming its row block out of
    the MPS file SOURCE (`-`: problem_row_shard_spec of the LP, made in
    the rank)."""
    import torch
    import torch.distributed as dist

    from firstorderlp_torch.generators import generate_pagerank_lp
    from firstorderlp_torch.models import pdhg as pdhg_module
    from firstorderlp_torch.ops import routed
    from firstorderlp_torch.parallel import distributed as D
    from firstorderlp_torch.parallel import shard_ingest

    rank, world, port = (int(a) for a in argv[:3])
    out_path = argv[3]
    shape = (int(argv[4]), int(argv[5]))
    source = argv[7] if argv[6:7] == ["ingest"] else None
    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    problem = (generate_pagerank_lp(num_nodes=NODES, seed=0)
               if source in (None, "-") else None)
    D.initialize(f"localhost:{port}", world, rank)
    mesh = D.global_solver_mesh(*shape)  # the first collective, untimed
    spent, restore = timed_prepare(pdhg_module)
    extra = {}
    try:
        routed.reset_launch_counts()
        t0 = time.time()
        if source is None:
            out = D.distributed_optimize(make_params(1e-4, 20_000), problem,
                                         *shape)
        else:
            spec = (shard_ingest.problem_row_shard_spec(problem)
                    if problem is not None
                    else shard_ingest.mps_row_shard_spec(source))
            ranges, inner = [], spec.row_loader

            def loader(lo, hi):
                triplet = inner(lo, hi)
                ranges.append((lo, hi, len(triplet[2])))
                return triplet

            spec.row_loader = loader
            report = {}
            out = shard_ingest.host_sharded_optimize(
                make_params(1e-4, 20_000), spec, mesh, report)
            # ingest: the spec's pass 1, the load, rescale and build
            spent["seconds"] = time.time() - t0 - report["solve_seconds"]
            extra = {"ranges": json.dumps(ranges),
                     "report": json.dumps(report)}
        torch.cuda.synchronize()
        seconds = time.time() - t0
        np.savez(out_path, primal=out.primal_solution,
                 dual=out.dual_solution, iterations=out.iteration_count,
                 reason=out.termination_reason.name, seconds=seconds,
                 prepare_seconds=spent["seconds"],
                 backend=dist.get_backend(),
                 device=str(torch.device("cuda", torch.cuda.current_device())),
                 launches=json.dumps(dict(routed.LAUNCHES)), **extra)
    finally:
        restore()
        dist.destroy_process_group()
    return 0


def segment_counts(spans):
    """What the solvers' segments did in the run just made
    (spans.COUNTS): segments, evaluations, steps, read-backs (the
    evaluations' included) and read-backs a segment, graph replays of
    steps and of evaluations, loads into and unloads out of the graphs'
    buffers, captures and their seconds (warm-up included)."""
    c = spans.COUNTS
    return {"segments": c["segments"], "evaluations": c["evaluations"],
            "steps": c["steps"], "read_backs": c["read_backs"],
            "read_backs_per_segment": c["read_backs"] / max(
                c["segments"], 1),
            "replays": c["replays"], "eval_replays": c["eval_replays"],
            "loads": c["loads"], "unloads": c["unloads"],
            "captures": c["captures"],
            "capture_seconds": c["capture_seconds"]}


def states_equal(a, b) -> bool:
    """Every field of two solver states or evaluation results equal:
    tensors bitwise (NaN payloads too), host values by ==, a host number
    against a 0-d tensor by value."""
    import torch

    if dataclasses.is_dataclass(a):
        return all(states_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(
            states_equal(u, v) for u, v in zip(a, b))
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype in ints:
            a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
        return bool(torch.equal(a, b))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return float(a) == float(b)
    return a == b


def exact_launches(torch, routed, module, bundle, state, config, counts,
                   launches):
    """The B2-B7, F1a and F1b launches a solve must have made, from the
    launches of one eager evaluation, step and final bound estimate on
    `bundle`
    (`module` is models.pdhg or models.mirror_prox): each evaluation's
    and each step's, the replays credited, plus one evaluation and one
    step for each capture's warm-up, plus the final bound estimate.
    Returns the problems found against `launches`."""
    def measure(fn):
        torch.cuda.synchronize()
        routed.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return dict(routed.LAUNCHES)

    state = module._device_counters(state)
    per_eval = measure(lambda: module._eval_block(bundle, state, 0.0,
                                                  config))
    if module.__name__.endswith("pdhg"):
        start = state.iteration.clone()
        per_step = measure(lambda: module._masked_trial(
            bundle.scaled, config, state, start))
        final = measure(lambda: module._final_bound_estimates(
            bundle, state.current_primal_solution,
            state.current_dual_solution, state.step_size,
            state.primal_weight))
    else:
        per_step = measure(lambda: module._iterate(bundle.scaled, state))
        final = measure(lambda: module._final_bound_estimates(
            bundle, state.current_primal, state.current_dual,
            state.primal_scaling, state.dual_scaling))
    if config.need_bound_estimates:  # then the loop computed them
        final = {k: 0 for k in final}
    evals = counts["evaluations"] + counts["captures"]
    steps = counts["steps"] + counts["captures"]
    want = {k: per_eval[k] * evals + per_step[k] * steps + final[k]
            for k in launches}
    if want != launches:
        return [f"launches {launches} against {want} from "
                f"{evals} evaluations and {steps} steps"]
    return []


def eval_host_calls(torch, module, bundle, state, config) -> int:
    """The host's launch calls (torch.profiler: kernel launches, copies,
    memsets and cudaGraphLaunch) of one evaluation on `bundle` as the
    solve runs it (a replay of the bundle's graph where it has one), the
    runner's load and unload left out."""
    from torch.profiler import ProfilerActivity, profile

    from firstorderlp_torch.ops.probe_routed import LAUNCH_CALLS

    runner = module._runner(bundle, module._device_counters(state), 0.0,
                            config, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.evaluate()
        torch.cuda.synchronize()
    runner.unload()
    return sum(e.count for e in prof.key_averages()
               if e.key in LAUNCH_CALLS | {"cudaGraphLaunch"})


def graph_nodes(torch, graph) -> int:
    """The nodes of a CUDA graph captured with keep_graph=True
    (cuGraphGetNodes on its cudaGraph_t)."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(count.value)


TRIAL_REPLAYS = 40  # replays a device time of a trial is taken over


def trial_measures(torch, pdhg_mod, graphs_mod, routed_mod, bundle, config,
                   state):
    """A PDHG trial of one version of the package (`pdhg_mod`, its
    ops.graphs and ops.routed) from `state` on `bundle`, as the solver
    replays it: the device ms of a replayed trial (CUDA events around
    TRIAL_REPLAYS replays of the bundle's step graph, a sleeping kernel
    first), the host's cudaGraphLaunch time a replay (torch.profiler),
    the nodes of the trial's graph (the trial and its copy-back into the
    buffers, captured again with keep_graph=True), and the host's launch
    calls of one eager trial alone (no copy-back) with the kernels it
    launched (routed.LAUNCHES and the profiler's device records)."""
    from torch.profiler import ProfilerActivity, profile

    from firstorderlp_torch.ops.probe_routed import LAUNCH_CALLS

    state = pdhg_mod._device_counters(state)
    start = state.iteration.clone()
    runner = pdhg_mod._runner(bundle, state, 0.0, config, False)
    start_event = torch.cuda.Event(enable_timing=True)
    end_event = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s: the host runs ahead
    start_event.record()
    runner.steps(TRIAL_REPLAYS)
    end_event.record()
    torch.cuda.synchronize()
    out = {"device_ms_per_trial":
           start_event.elapsed_time(end_event) / TRIAL_REPLAYS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.steps(TRIAL_REPLAYS)
        torch.cuda.synchronize()
    launch = [e for e in prof.key_averages() if e.key == "cudaGraphLaunch"]
    out["graph_launch_host_us"] = (
        launch[0].self_cpu_time_total / launch[0].count if launch else None)
    runner.unload()

    saved = dict(routed_mod.LAUNCHES)
    static = graphs_mod.StaticState(state, (
        torch.zeros((), dtype=torch.float64, device=start.device), start))

    def trial(s, elapsed, first):
        return pdhg_mod._masked_trial(bundle.scaled, config, s, first)

    side = torch.cuda.Stream(start.device)
    side.wait_stream(torch.cuda.current_stream(start.device))
    with torch.cuda.stream(side):
        static.apply(trial)  # warm-up, as SegmentGraphs does
    torch.cuda.current_stream(start.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        static.apply(trial)
    out["graph_nodes"] = graph_nodes(torch, graph)
    del graph, static

    pdhg_mod._masked_trial(bundle.scaled, config, state, start)
    torch.cuda.synchronize()
    routed_mod.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pdhg_mod._masked_trial(bundle.scaled, config, state, start)
        torch.cuda.synchronize()
    events = prof.key_averages()
    out["host_launch_calls_per_eager_trial"] = sum(
        e.count for e in events if e.key in LAUNCH_CALLS)
    out["eager_trial_launches"] = {
        k: v for k, v in routed_mod.LAUNCHES.items() if v}
    device_events = [e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    out["eager_trial_device_records"] = sum(e.count for e in device_events)
    out["eager_trial_device_kernels"] = sorted(e.key[:60]
                                               for e in device_events)
    routed_mod.LAUNCHES.update(saved)
    return out


# segment_graph's first segments: iterations 1-9 one each, 10 -> 41,
# 41 -> 81; the compared segments start at 81
SEGMENT_WARMUP = 11
SEGMENT_COMPARED = 3  # segments in the compared dispatch


def segment_graph(torch, routed, problem, params, mp_params, dev):
    """The evaluation and a dispatch of SEGMENT_COMPARED segments on the
    100k-node LP, from the state at iteration 81 (the first
    SEGMENT_WARMUP segments run as optimize runs them, the graphs
    captured in the first), replayed from the bundle's CUDA graphs and
    run eagerly (the solvers' private `_eager`): PDHG on CSR and on the
    tile plan, Mirror Prox on CSR. The evaluation alone (on a runner
    loaded outside the count) and the dispatch must each give every
    field of the state and of the evaluation's result bitwise and the
    same kernel launches (the replays credited); the dispatch reads back
    the same number of times either way, PDHG once a round (so at most
    once more a segment than its rejected trials), Mirror Prox once a
    segment. Reported: the host's launch calls an evaluation and a
    segment (torch.profiler: kernel launches, copies and memsets, and
    cudaGraphLaunch), steps, read-backs, replays, the captures and
    their seconds, the device ms of a replayed evaluation and step (CUDA
    events around 5 and 40 replays), and the dispatch's seconds
    untraced, in turns (eager, replayed, replayed, eager)."""
    from torch.profiler import ProfilerActivity, profile

    from firstorderlp_torch import spans
    from firstorderlp_torch.models import mirror_prox, pdhg
    from firstorderlp_torch.ops import graphs
    from firstorderlp_torch.ops.probe_routed import LAUNCH_CALLS

    calls_of = LAUNCH_CALLS | {"cudaGraphLaunch"}

    def host_calls(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, sum(e.count for e in prof.key_averages()
                        if e.key in calls_of)

    def seconds(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    rows, problems = [], []
    for label, solver, tile in (("pdhg_csr", pdhg, False),
                                ("pdhg_tiled", pdhg, True),
                                ("mirror_prox_csr", mirror_prox, False)):
        p = params if solver is pdhg else mp_params
        routed.DEFAULT_TILE_ALIGNED = tile
        try:
            prepared = solver.prepare_problem(p, problem, device=dev)
        finally:
            routed.DEFAULT_TILE_ALIGNED = False
        bundle, config = prepared.bundle, solver._make_config(p)

        def dispatch(state, count, eager=False):
            if solver is pdhg:
                out, result, _, reason = pdhg._run_segments(
                    bundle, state, 0.0, config, count,
                    int(state.iteration), _eager=eager)
            else:
                out, result, reason = mirror_prox._run_segments(
                    bundle, state, 0.0, config, count, _eager=eager)
            return out, result, reason

        spans.reset_counts()
        state = solver._device_counters(prepared.initial_state)
        state, _, reason = dispatch(state, SEGMENT_WARMUP)
        captured = segment_counts(spans)
        start = int(state.iteration)
        if reason != 0 or start != 81:
            problems.append(f"{label}: warm-up ended at {start}, "
                            f"reason {reason}")
            continue

        def evaluation(eager):
            runner = solver._runner(bundle, state, 0.0, config, eager)
            spans.reset_counts()
            routed.reset_launch_counts()
            result, calls = host_calls(runner.evaluate)
            launches = dict(routed.LAUNCHES)
            return (runner.unload(), runner.detach(result), calls,
                    launches)

        def segments(eager):
            spans.reset_counts()
            routed.reset_launch_counts()
            (out, result, _), calls = host_calls(
                lambda: dispatch(state, SEGMENT_COMPARED, eager))
            return (out, result, calls, dict(routed.LAUNCHES),
                    segment_counts(spans))

        ev = {mode: evaluation(mode == "eager")
              for mode in ("eager", "graphed")}
        sg = {mode: segments(mode == "eager")
              for mode in ("eager", "graphed")}
        counts = sg["graphed"][4]
        n_seg = max(counts["segments"], 1)
        steps_run = counts["steps"]
        if solver is pdhg:
            accepted = int(sg["graphed"][0].iteration) - start
            rejected = steps_run - accepted
        else:
            accepted = int(sg["graphed"][0].accepted_iterations) - int(
                state.accepted_iterations)
            rejected = None
        row = {
            "label": label, "iteration": start,
            "segments": counts["segments"], "steps": steps_run,
            "accepted": accepted, "rejected_trials": rejected,
            "evaluation": {
                "bitwise_equal": states_equal(ev["graphed"][0],
                                              ev["eager"][0])
                and states_equal(ev["graphed"][1], ev["eager"][1]),
                "launches_equal": ev["graphed"][3] == ev["eager"][3],
                "launches": ev["graphed"][3],
                "host_launch_calls": {"eager": ev["eager"][2],
                                      "graphed": ev["graphed"][2]},
            },
            "bitwise_equal": states_equal(sg["graphed"][0], sg["eager"][0])
            and states_equal(sg["graphed"][1], sg["eager"][1]),
            "launches_equal": sg["graphed"][3] == sg["eager"][3],
            "launches": sg["graphed"][3],
            "read_backs": {"eager": sg["eager"][4]["read_backs"],
                           "graphed": counts["read_backs"]},
            "read_backs_per_segment": counts["read_backs"] / n_seg,
            "replays": counts["replays"],
            "eval_replays": counts["eval_replays"],
            "loads": counts["loads"], "unloads": counts["unloads"],
            "captures": captured["captures"],
            "capture_seconds": captured["capture_seconds"],
            "host_launch_calls_per_segment": {
                "eager": sg["eager"][2] / n_seg,
                "graphed": sg["graphed"][2] / n_seg},
            "host_launch_calls_per_step": {
                mode: (sg[mode][2] / n_seg - ev[mode][2])
                * n_seg / max(steps_run, 1)
                for mode in ("eager", "graphed")},
        }
        # device time of replayed evaluations and steps (CUDA events; a
        # sleeping kernel first holds the card while the host enqueues
        # them; a masked step runs every kernel of an active one)
        runner = solver._runner(bundle, state, 0.0, config, False)
        for name, fn, count in (
                ("device_ms_per_evaluation", runner.evaluate, 5),
                ("device_ms_per_step", lambda: runner.steps(1), 40)):
            start_event = torch.cuda.Event(enable_timing=True)
            end_event = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)  # about 0.1 s
            start_event.record()
            for _ in range(count):
                fn()
            end_event.record()
            torch.cuda.synchronize()
            row[name] = start_event.elapsed_time(end_event) / count
        runner.unload()
        row["evaluation"]["graph_nodes"] = eval_graph_measures(
            torch, solver, routed, bundle, config, state)[
                "evaluation_graph_nodes"]
        if solver is pdhg:
            # the trial alone: F1a, B3/B6, B4/B7 and F1b eagerly
            row["trial"] = trial = trial_measures(
                torch, pdhg, graphs, routed, bundle, config, state)
            dual = (("tiled_dual_step", "tiled_rmv_stats") if tile else
                    ("spmv_dual_step", "spmv_rmv_stats"))
            want = dict.fromkeys(("primal_step", *dual, "trial_epilogue"),
                                 1)
            # the profiler may drop device records (PERF.md): every one
            # it keeps must be a kernel of the port
            kernels = trial["eager_trial_device_kernels"]
            if (trial["eager_trial_launches"] != want
                    or trial["host_launch_calls_per_eager_trial"] != 4
                    or not 0 < len(kernels) <= 4
                    or not all("folp::" in k for k in kernels)):
                problems.append(f"{label}: an eager trial launched "
                                f"{trial['eager_trial_launches']}, "
                                f"{trial['host_launch_calls_per_eager_trial']}"
                                f" host launch calls, kernels {kernels}")
        # untraced, in turns: eager, replayed, replayed, eager
        row["seconds"] = {"eager": [], "graphed": []}
        for mode in ("eager", "graphed", "graphed", "eager"):
            row["seconds"][mode].append(seconds(
                lambda: dispatch(state, SEGMENT_COMPARED, mode == "eager")))
        rows.append(row)
        if not row["evaluation"]["bitwise_equal"]:
            problems.append(f"{label}: replayed and eager evaluations "
                            "differ")
        if not row["evaluation"]["launches_equal"]:
            problems.append(f"{label}: evaluation launches "
                            f"{ev['graphed'][3]} against {ev['eager'][3]}")
        if not row["evaluation"]["host_launch_calls"]["graphed"] < 10:
            problems.append(f"{label}: {ev['graphed'][2]} host launch "
                            "calls for a replayed evaluation")
        if not row["bitwise_equal"]:
            problems.append(f"{label}: replayed and eager states differ")
        if not row["launches_equal"]:
            problems.append(f"{label}: launches {sg['graphed'][3]} against "
                            f"{sg['eager'][3]}")
        if (row["replays"] != steps_run
                or row["eval_replays"] != counts["evaluations"]
                or captured["captures"] != 1
                or row["loads"] != 1 or row["unloads"] != 1):
            problems.append(f"{label}: {counts} after {captured} captured")
        if row["read_backs"]["eager"] != row["read_backs"]["graphed"]:
            problems.append(f"{label}: read-backs {row['read_backs']}")
        if solver is pdhg:
            if not n_seg <= counts["read_backs"] <= n_seg + rejected:
                problems.append(f"{label}: read-backs {row['read_backs']}")
        elif counts["read_backs"] != n_seg:
            problems.append(f"{label}: Mirror Prox read back "
                            f"{counts['read_backs']} times in {n_seg} "
                            "segments")
        del prepared, bundle, state, ev, sg
    return {"phase": "segment_graph", "ok": not problems,
            "nodes": NODES, "rows": rows,
            **({"problems": problems} if problems else {})}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def same_bits(a, b) -> bool:
    return (str(a["reason"]) == str(b["reason"])
            and int(a["iterations"]) == int(b["iterations"])
            and np.array_equal(a["primal"], b["primal"])
            and np.array_equal(a["dual"], b["dual"]))


def as_record(out):
    return {"primal": out.primal_solution, "dual": out.dual_solution,
            "iterations": out.iteration_count,
            "reason": out.termination_reason.name}


def run_ranks(shape, problem, reference, backend, ingest=None):
    """Runs one process a cell of an `shape` mesh (this script with
    --distributed-worker, on a free port, all killed after DIST_TIMEOUT
    seconds) and holds them to `reference`, the single-process mesh's
    solve: the same bits on every rank, `backend`, OPTIMAL in host f64,
    B2 launched on every rank. `ingest`: the ranks run
    host_sharded_optimize from that source (an MPS file, or `-`), and
    each record carries its loader calls ((lo, hi, entries)) and the
    ingest's report. Returns (per-rank records, wall seconds,
    problems)."""
    import os
    import subprocess
    import tempfile

    world = shape[0] * shape[1]
    problems, ranks, logs = [], [], []
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(world)]
        port = str(free_port())
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--distributed-worker", str(r), str(world), port, outs[r],
             str(shape[0]), str(shape[1])]
            + ([] if ingest is None else ["ingest", ingest]),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, DIST_TIMEOUT - (time.time() - t0)))[0])
        except subprocess.TimeoutExpired:
            problems.append(f"the ranks ran over {DIST_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.time() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0 or not os.path.exists(outs[r]):
                tail = logs[r][-1500:] if r < len(logs) else ""
                problems.append(f"rank {r} exited {p.returncode}: {tail}")
            else:
                ranks.append(dict(np.load(outs[r])))
    records = [{"rank": r, "reason": str(x["reason"]),
                "iterations": int(x["iterations"]),
                "seconds": float(x["seconds"]),
                "prepare_seconds": float(x["prepare_seconds"]),
                "ms_per_iteration": 1e3 * (float(x["seconds"])
                                           - float(x["prepare_seconds"]))
                / max(int(x["iterations"]), 1),
                "backend": str(x["backend"]), "device": str(x["device"]),
                "launches": json.loads(str(x["launches"])),
                **{k: json.loads(str(x[k])) for k in ("ranges", "report")
                   if k in x}}
               for r, x in enumerate(ranks)]
    if len(ranks) == world:
        if not all(same_bits(x, reference) for x in ranks):
            problems.append("a rank differs from the single-process mesh")
        if str(ranks[0]["reason"]) != "TERMINATION_REASON_OPTIMAL":
            problems.append(f"ranks: {ranks[0]['reason']}")
        res = host_residuals(problem, ranks[0]["primal"], ranks[0]["dual"])
        if any(not v <= 1e-4 for v in res.values()):
            problems.append(f"ranks: host residuals {res}")
        for rec in records:
            if rec["backend"] != backend or any(
                    rec["launches"][k] <= 0
                    for k in ("spmv_csr:A", "spmv_csr:AT")):
                problems.append(f"rank {rec['rank']}: {rec['backend']}, "
                                f"launches {rec['launches']}")
    return records, wall, problems


def distributed_path(torch, dev, routed, problem, small, params):
    """(a) a world of 1 on NCCL in this process: distributed_optimize on
    a (1, 1) mesh of the 20k-node LP, bitwise equal to the
    single-process (1, 1) sharded_optimize; (b) two gloo ranks on the
    one card (separate processes): a (2, 1) solve of the 100k-node LP
    whose two ranks give the same bits as the single-process (2, 1)
    mesh."""
    import torch.distributed as dist

    from firstorderlp_torch.parallel import distributed as D
    from firstorderlp_torch.parallel import sharded_optimize, solver_mesh

    ph = "distributed_path"
    t_phase = time.time()
    problems = []
    # (a)
    reference = sharded_optimize(params, small, solver_mesh(1, 1, [dev]))
    D.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        routed.reset_launch_counts()
        t0 = time.time()
        world1 = D.distributed_optimize(params, small, 1, 1)
        torch.cuda.synchronize()
        world1_s = time.time() - t0
        world1_launches = dict(routed.LAUNCHES)
    finally:
        dist.destroy_process_group()
    if backend != "nccl":
        problems.append(f"world of 1 on {backend}, not nccl")
    if not same_bits(as_record(world1), as_record(reference)):
        problems.append("world of 1 differs from the (1, 1) mesh")
    if world1.termination_reason.name != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"world of 1: {world1.termination_reason.name}")
    # (b)
    t0 = time.time()
    single = as_record(sharded_optimize(
        params, problem, solver_mesh(*DIST_MESH, devices=[dev] * 2)))
    single_s = time.time() - t0
    ranks, ranks_s, bad = run_ranks(DIST_MESH, problem, single, "gloo")
    problems += bad
    record = {
        "phase": ph, "ok": not problems, "seconds": time.time() - t_phase,
        "world_of_1": {"backend": backend, "nodes": DET_NODES,
                       "iterations": world1.iteration_count,
                       "seconds": world1_s, "launches": world1_launches,
                       "bitwise_equal_to_1x1_mesh": same_bits(
                           as_record(world1), as_record(reference))},
        "gloo_ranks": {"mesh": list(DIST_MESH), "nodes": NODES,
                       "wall_seconds": ranks_s, "ranks": ranks,
                       "single_process_seconds": single_s,
                       "single_process_iterations": single["iterations"]},
    }
    if problems:
        record["problems"] = problems
    emit(record)
    if problems:
        raise SystemExit(1)


# The row-sharded ingest (parallel/shard_ingest.py) on the main path's LP.
INGEST_MESHES = ((2, 2), (4, 1))  # (2, 2) streams the file, (4, 1) not
INGEST_F64_MESH = (4, 1)  # the f64 CsrOp row-block path, at DET_NODES
INGEST_TOL = 1e-4  # the rescaled values against the host f64 rescale


def ingest_solve(torch, routed, problem, label, solve, layout="csr"):
    """One host_sharded_optimize with its report, host-f64 check and
    launches. `layout` "csr" or "tiled": the solve's own B2 (or B5)
    launches are one a non-empty cell a product, so a positive multiple
    of the cells; "none": the solve launches no kernel. The rescale's B2
    sums come on top (report["rescale_sums"]); no other kernel."""
    routed.reset_launch_counts()
    report = {}
    t0 = time.time()
    out = solve(report)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(routed.LAUNCHES)
    res = host_residuals(problem, out.primal_solution, out.dual_solution)
    iters = max(out.iteration_count, 1)
    rec = {"solve": label, "reason": out.termination_reason.name,
           "iterations": out.iteration_count, "seconds": seconds,
           **{k: report[k] for k in (
               "load_seconds", "rescale_seconds", "build_seconds",
               "solve_seconds", "block_nnz", "loaded_nnz", "rescale_sums",
               "nonempty_cells")},
           "ms_per_iteration": 1e3 * report["solve_seconds"] / iters,
           "host_f64": res, "launches": launches}
    problems = []
    if rec["reason"] != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"{label}: reason {rec['reason']}")
    if out.primal_solution.shape != (problem.num_variables,) or (
            out.dual_solution.shape != (problem.num_constraints,)):
        problems.append(f"{label}: solution shapes")
    if not (np.all(np.isfinite(out.primal_solution))
            and np.all(np.isfinite(out.dual_solution))):
        problems.append(f"{label}: non-finite solution")
    if any(not v <= 1e-4 for v in res.values()):
        problems.append(f"{label}: host residuals {res}")
    kernel = {"csr": "spmv_csr", "tiled": "tiled_spmv"}.get(layout)
    own_keys = () if kernel is None else (f"{kernel}:A", f"{kernel}:AT")
    cells = report["nonempty_cells"]
    for key, count in launches.items():
        own = count - report["rescale_sums"].get(key, 0)
        if key in TR_KERNELS and own_keys:
            if own <= 0:
                problems.append(f"{label}: {key} was not launched")
        elif key in own_keys and (own <= 0 or own % cells):
            problems.append(f"{label}: {own} {key} launches of the solve "
                            f"for {cells} non-empty cells")
        elif key not in own_keys and own != 0:
            problems.append(f"{label}: {key} launched: {launches}")
    return out, rec, problems


def shard_ingest_path(torch, dev, routed, rescale_problem, small, params,
                      mps_path, cli_rec, sharded_solves):
    """Row-sharded ingest as a user calls it, on the main path's LP: (a)
    mps_row_shard_spec of cli_path's .mps.gz against the port's reader;
    (b) host_sharded_optimize with main_path's parameters on (2, 2)
    (streaming the file) and (4, 1) (problem_row_shard_spec of the
    reader's LP) meshes of cuda:0, OPTIMAL in host f64, B2 launched on
    every cell, load, rescale, build and solve seconds, ms an iteration
    beside sharded_path's, the rescale against the host f64
    rescale_problem, the same (2, 2) solve on the tile plan (B5); (c)
    the (2, 2) solve again from the loaded rows, bitwise equal; (d) two
    gloo ranks on the card, each streaming its row block of a (2, 1)
    mesh, bitwise equal to the single-process (2, 1) mesh; (e) the f64
    CsrOp row-block path on (4, 1) at 20k nodes, no kernel launched."""
    import scipy.sparse as sp

    from firstorderlp_torch import qps_reader_to_standard_form
    from firstorderlp_torch.ops import lanes
    from firstorderlp_torch.parallel import solver_mesh
    from firstorderlp_torch.parallel import shard_ingest as si

    ph = "shard_ingest_path"
    t_phase = time.time()
    problems = []
    rec = {"phase": ph, "nodes": NODES,
           "mps": {"file": "cli_path's .mps.gz, handed on (not written "
                           "again)",
                   "written_by_cli_path_seconds":
                       cli_rec.get("generate_and_write_seconds"),
                   "file_bytes": cli_rec.get("file_bytes"),
                   "text_bytes": cli_rec.get("text_bytes")}}

    def mesh_of(shape):
        return solver_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))

    # (a) the streamed spec against the reader
    t0 = time.time()
    reader = qps_reader_to_standard_form(mps_path)
    read_s = time.time() - t0
    t0 = time.time()
    spec = si.mps_row_shard_spec(mps_path)
    pass1_s = time.time() - t0
    loaded = {}
    inner = spec.row_loader

    def recording(lo, hi):
        t_call = time.time()
        triplet = inner(lo, hi)
        loaded[lo, hi] = triplet
        rec["mps"].setdefault("row_block_scan_seconds", []).append(
            time.time() - t_call)
        return triplet

    spec.row_loader = recording
    a = sp.csr_matrix(reader.constraint_matrix, dtype=np.float64)
    a.sum_duplicates()
    fields = {
        "num_constraints": spec.num_constraints == reader.num_constraints,
        "num_variables": spec.num_variables == reader.num_variables,
        "num_equalities": spec.num_equalities == reader.num_equalities,
        "objective_constant": (spec.objective_constant
                               == reader.objective_constant),
        "nnz": spec.nnz == a.nnz,
    }
    for name, want in (("objective_vector", reader.objective_vector),
                       ("right_hand_side", reader.right_hand_side),
                       ("variable_lower_bound", reader.variable_lower_bound),
                       ("variable_upper_bound",
                        reader.variable_upper_bound)):
        fields[name] = bool(np.array_equal(getattr(spec, name), want))
    problems += [f"spec field {k} differs from the reader's"
                 for k, ok in fields.items() if not ok]
    rec["mps"].update(reader_seconds=read_s, spec_pass1_seconds=pass1_s,
                      fields_equal=fields)
    if problems:
        rec.update(ok=False, problems=problems)
        emit(rec)
        raise SystemExit(1)

    # (b) the (2, 2) solve streams the file
    solves, launches = [], {}
    out22, r22, bad = ingest_solve(
        torch, routed, reader, "pdhg 2x2 (mps stream)",
        lambda rep: si.host_sharded_optimize(params, spec,
                                             mesh_of((2, 2)), rep))
    solves.append(r22)
    problems += bad
    launches[("csr", 2, 2)] = r22["launches"]
    parts = [loaded[k] for k in sorted(loaded)]
    rebuilt = sp.csr_matrix(
        (np.concatenate([p[2] for p in parts]),
         (np.concatenate([p[0] for p in parts]),
          np.concatenate([p[1] for p in parts]))), shape=a.shape)
    diff = float(abs(rebuilt - a).max()) if a.nnz else 0.0
    rec["reassembly"] = {"row_blocks": sorted(loaded), "nnz": rebuilt.nnz,
                         "reader_nnz": a.nnz, "max_abs_diff": diff}
    if rebuilt.nnz != a.nnz or diff != 0.0:
        problems.append(f"the row blocks reassemble to {rebuilt.nnz} "
                        f"entries, max |diff| {diff}")

    # the same rows again, without the file: (c) and the references
    replay = dataclasses.replace(spec, row_loader=lambda lo, hi:
                                 loaded[lo, hi])
    out22b, r22b, bad = ingest_solve(
        torch, routed, reader, "pdhg 2x2 again (loaded rows)",
        lambda rep: si.host_sharded_optimize(params, replay,
                                             mesh_of((2, 2)), rep))
    solves.append(r22b)
    problems += bad
    det = same_bits(as_record(out22), as_record(out22b))
    rec["determinism_bitwise_equal"] = det
    if not det:
        problems.append("the (2, 2) solve twice: the bits differ")

    mem_spec = si.problem_row_shard_spec(reader)
    _, r41, bad = ingest_solve(
        torch, routed, reader, "pdhg 4x1 (in-memory spec)",
        lambda rep: si.host_sharded_optimize(params, mem_spec,
                                             mesh_of((4, 1)), rep))
    solves.append(r41)
    problems += bad
    launches[("csr", 4, 1)] = r41["launches"]

    routed.DEFAULT_TILE_ALIGNED = True
    try:
        _, rtiled, bad = ingest_solve(
            torch, routed, reader, "pdhg 2x2 tile plan (loaded rows)",
            lambda rep: si.host_sharded_optimize(params, replay,
                                                 mesh_of((2, 2)), rep),
            layout="tiled")
    finally:
        routed.DEFAULT_TILE_ALIGNED = False
    solves.append(rtiled)
    problems += bad
    launches[("tiled", 2, 2)] = rtiled["launches"]

    for r in solves:
        shape = r["solve"].split()[1]
        match = [s for s in sharded_solves
                 if s["solve"] == f"pdhg {shape}"]
        if match:
            r["sharded_path_ms_per_iteration"] = match[0]["ms_per_iteration"]

    # the rescale at the (2, 2) solve's blocks against the host f64 one
    t0 = time.time()
    m, n = spec.num_constraints, spec.num_variables
    m_b = -(-m // 2)
    blocks = {d: si.load_row_block(replay, d, m_b, n, dev, "routed")
              for d in range(2)}

    def vec(v, size):
        out = np.zeros(size)
        out[:len(v)] = v
        return torch.as_tensor(out, device=dev).to(torch.float32)

    got = si.sharded_rescale(
        blocks, {"b": vec(spec.right_hand_side, 2 * m_b),
                 "c": vec(spec.objective_vector, n),
                 "lo": vec(spec.variable_lower_bound, n),
                 "hi": vec(spec.variable_upper_bound, n)},
        mesh_of((2, 1)), params.l_inf_ruiz_iterations,
        params.l2_norm_rescaling, params.pock_chambolle_alpha)
    host = rescale_problem(params.l_inf_ruiz_iterations,
                           params.l2_norm_rescaling,
                           params.pock_chambolle_alpha, 0, reader)
    scaled = sp.csr_matrix(host.scaled_qp.constraint_matrix)
    scaled.sum_duplicates()

    def rel(got_t, want):
        g = np.asarray(got_t.cpu().numpy(), np.float64)
        return float(np.max(np.abs(g - want) / np.abs(want)))

    values = torch.cat([got.values[0], got.values[1]])
    rescale = {
        "values_max_rel_diff": rel(values, scaled.data),
        "constraint_rescaling_max_rel_diff": rel(
            got.constraint_rescaling[:m], host.constraint_rescaling),
        "variable_rescaling_max_rel_diff": rel(
            got.variable_rescaling, host.variable_rescaling),
        "seconds_with_host_rescale": time.time() - t0,
        "tolerance": f"relative {INGEST_TOL} (f32 against f64)",
    }
    rec["rescale_vs_host_f64"] = rescale
    if not all(v <= INGEST_TOL for k, v in rescale.items()
               if k.endswith("diff")):
        problems.append(f"the rescale against the host f64 one: {rescale}")
    del blocks, got, host, scaled, values

    # (d) two gloo ranks stream their row blocks of a (2, 1) mesh
    t0 = time.time()
    single = as_record(si.host_sharded_optimize(params, replay,
                                                mesh_of((2, 1))))
    single_s = time.time() - t0
    ranks, ranks_s, bad = run_ranks((2, 1), reader, single, "gloo",
                                    ingest=mps_path)
    problems += bad
    row_nnz = np.diff(a.indptr)
    for r in ranks:
        (lo, hi, got_nnz), = r["ranges"]
        if (lo, hi) != (r["rank"] * m_b, min((r["rank"] + 1) * m_b, m)) or (
                got_nnz != int(row_nnz[lo:hi].sum())):
            problems.append(f"rank {r['rank']} loaded {r['ranges']}")
    if sum(r["ranges"][0][2] for r in ranks) != a.nnz:
        problems.append("the ranks' loads do not partition the matrix")
    rec["gloo_ranks"] = {"mesh": [2, 1], "wall_seconds": ranks_s,
                         "ranks": ranks,
                         "single_process_seconds": single_s,
                         "single_process_iterations": single["iterations"]}

    # (e) the f64 CsrOp row-block path at 20k nodes
    lanes.reset_launch_counts()
    _, r64, bad = ingest_solve(
        torch, routed, small, "pdhg f64 4x1 CsrOp blocks",
        lambda rep: si.host_sharded_optimize(
            make_params(1e-4, 20_000, dtype="float64", fmt="sparse"),
            si.problem_row_shard_spec(small), mesh_of(INGEST_F64_MESH),
            rep), layout="none")
    r64["nodes"] = DET_NODES
    if any(r64["launches"].values()) or any(lanes.LAUNCHES.values()):
        bad.append(f"f64: a kernel was launched: {r64['launches']}, "
                   f"{dict(lanes.LAUNCHES)}")
    solves.append(r64)
    problems += bad

    rec.update(ok=not problems, seconds=time.time() - t_phase,
               solves=solves)
    if problems:
        rec["problems"] = problems
    emit(rec)
    if problems:
        raise SystemExit(1)
    return launches


def multi_gpu_path(torch, routed, problem, params):
    """--multi-gpu, on a host with at least four cards: the 100k-node LP
    by sharded_optimize on a (2, 2) mesh with every cell on cuda:0 (the
    reference, solved twice: the first solve of the process pays its
    warm-up), on a (2, 2) mesh over cuda:0-3 (blocks on four cards, the
    vectors on cuda:0), and by four NCCL ranks, one card and one block
    each: the same bits everywhere, OPTIMAL in host f64, with seconds
    and ms an iteration (ingest and the group's first collective
    apart). Then host_sharded_optimize on (2, 2) as four NCCL ranks,
    each loading only its row block, bitwise equal to the (2, 2) mesh
    on one card."""
    from firstorderlp_torch.models import pdhg as pdhg_module
    from firstorderlp_torch.parallel import sharded_optimize, solver_mesh
    from firstorderlp_torch.parallel.shard_ingest import (
        host_sharded_optimize, problem_row_shard_spec,
    )

    ph = "multi_gpu_path"
    t_phase = time.time()
    count = torch.cuda.device_count()
    if count < 4:
        fail(ph, f"needs 4 CUDA devices, has {count}")
    cards = [torch.device("cuda", i) for i in range(4)]
    solves, problems = {}, []
    # the first solve of the process pays its warm-up: run one card again
    for label, devices in (("one_card_first", [cards[0]] * 4),
                           ("four_cards", cards),
                           ("one_card", [cards[0]] * 4)):
        mesh = solver_mesh(2, 2, devices)
        spent, restore = timed_prepare(pdhg_module)
        try:
            out, rec, bad = sharded_solve_record(
                torch, routed,
                lambda: (sharded_optimize(params, problem, mesh),
                         spent["seconds"]),
                problem, f"pdhg 2x2 {label}", 1e-4)
        finally:
            restore()
        solves[label] = (as_record(out), rec)
        problems += bad
    reference = solves["one_card"][0]
    for label in ("one_card_first", "four_cards"):
        if not same_bits(solves[label][0], reference):
            problems.append(f"{label} differs from one card")
    ranks, ranks_s, bad = run_ranks((2, 2), problem, reference, "nccl")
    problems += bad
    if sorted(r["device"] for r in ranks) != [str(c) for c in cards]:
        problems.append(f"the ranks' cards: {[r['device'] for r in ranks]}")
    # row-sharded ingest: each NCCL rank loads its row block of (2, 2)
    t0 = time.time()
    ingest_ref = as_record(host_sharded_optimize(
        params, problem_row_shard_spec(problem),
        solver_mesh(2, 2, [cards[0]] * 4)))
    ingest_ref_s = time.time() - t0
    ingest_ranks, ingest_s, bad = run_ranks((2, 2), problem, ingest_ref,
                                            "nccl", ingest="-")
    problems += [f"host-sharded: {b}" for b in bad]
    record = {"phase": ph, "ok": not problems, "nodes": NODES,
              "seconds": time.time() - t_phase, "cards": count,
              "solves": [rec for _, rec in solves.values()],
              "nccl_ranks": {"mesh": [2, 2], "wall_seconds": ranks_s,
                             "ranks": ranks},
              "host_sharded_nccl_ranks": {
                  "mesh": [2, 2], "wall_seconds": ingest_s,
                  "ranks": ingest_ranks,
                  "one_card_seconds": ingest_ref_s,
                  "one_card_iterations": ingest_ref["iterations"]}}
    if problems:
        record["problems"] = problems
    emit(record)
    if problems:
        raise SystemExit(1)


def slow_and_hetero_phases(torch, dev, compare, routed, probe,
                           single_optimize):
    """The heterogeneous fleet (kernels_block_lanes, hetero_fleet), the
    QP fleet (qp_fleet) and the constant-step fleet
    (constant_step_fleet); returns B2's rows at the heterogeneous
    fleet's shape for the kernel list."""
    import dataclasses

    import scipy.sparse as sp

    from firstorderlp_torch import ConstantStepsizeParams, batch, generators
    from firstorderlp_torch.ops import lanes

    params = make_params(1e-4, 20_000, fmt="auto")
    last = (0, compare.HETERO_LANES - 1)

    # 15. the heterogeneous fleet through B2
    t_phase = t0 = time.time()
    problems = compare.hetero_fleet_problems()
    generate_s = time.time() - t0
    t0 = time.time()
    fleet = batch.prepare_batch(params, problems, device=dev)
    torch.cuda.synchronize()
    ingest_s = time.time() - t0
    op = fleet.bundle.scaled.constraint_matrix
    rows = block_lanes_rows(torch, compare, op)
    emit({"phase": "kernels_block_lanes", "ok": True, "lanes": op.lanes,
          "m": op.num_rows, "n": op.num_cols,
          "block_shape": [op.a.num_rows, op.a.num_cols],
          "tolerance": f"|d| <= {TOL_ENTRY}*(|A||x|)_i + {TOL_ABS} "
                       "against the f64 product and the plain version",
          "phase_seconds": time.time() - t_phase, "results": rows})
    t_phase = time.time()
    outs, solve_s, stats, l1, b2 = run_fleet(
        torch, batch, lanes, routed, batch.solve_batch, params, problems,
        fleet)
    del fleet, op
    fields, found = lane_checks(problems, outs, params, single_optimize,
                                last)
    if fields["reasons"] != {
            "TERMINATION_REASON_OPTIMAL": compare.HETERO_LANES}:
        found.append(f"not every lane OPTIMAL: {fields['reasons']}")
    if not (b2["spmv_csr:A"] > 0 and b2["spmv_csr:AT"] > 0):
        found.append(f"B2 was not launched: {b2}")
    others = {k: v for k, v in b2.items()
              if v and k not in ("spmv_csr:A", "spmv_csr:AT") + TR_KERNELS}
    _tr_launches["hetero_fleet"] = {k: b2[k] for k in TR_KERNELS}
    if others or any(l1.values()) or not all(
            _tr_launches["hetero_fleet"].values()):
        found.append(f"another kernel was launched: {others} {l1}")
    for r in rows:
        r["launches"] = b2[r["name"].split(" ")[0]]
    emit_checked({
        "phase": "hetero_fleet", "lanes": compare.HETERO_LANES,
        "nodes": [problems[0].constraint_matrix.shape[1],
                  problems[-1].constraint_matrix.shape[1]],
        "nnz_sum": int(sum(p.constraint_matrix.nnz for p in problems)),
        "generate_seconds": generate_s, "ingest_seconds": ingest_s,
        "solve_seconds": solve_s,
        "aggregate_iterations_per_second": fields["iterations_sum"]
        / solve_s,
        "dispatches": stats.dispatches, "evaluations": stats.segments,
        "step_trials": stats.trials, "read_backs": stats.read_backs,
        "launches": {k: v for k, v in b2.items() if v},
        "lane_kernel_launches": l1, **fields,
        "phase_seconds": time.time() - t_phase}, found)
    del problems, outs

    # 16. a QP fleet (one pattern of A and of Q) by PDHG and Mirror Prox,
    # through the per-instance ingest and L1
    t_phase = t0 = time.time()
    base = generators.generate_pagerank_lp(FLEET_NODES, seed=0)
    lambdas = np.geomspace(1e-3, 1.0, SLOW_FLEET_LANES)
    qps = [dataclasses.replace(base, objective_matrix=sp.csc_matrix(
        w * sp.eye(base.num_variables))) for w in lambdas]
    generate_s = time.time() - t0
    last = (0, SLOW_FLEET_LANES - 1)
    record = {"phase": "qp_fleet", "lanes": SLOW_FLEET_LANES,
              "nodes": FLEET_NODES,
              "lambda": [float(lambdas[0]), float(lambdas[-1])],
              "generate_seconds": generate_s}
    found = []
    for solver, solver_params in (
            ("pdhg", params), ("mirror_prox", make_mp_params(
                1e-4, 20_000, fmt="auto"))):
        t0 = time.time()
        fleet = batch.prepare_shared_pattern_fleet(solver_params, qps,
                                                   device=dev)
        torch.cuda.synchronize()
        ingest_s = time.time() - t0
        outs, solve_s, stats, l1, b2 = run_fleet(
            torch, batch, lanes, routed, batch.solve_batch_shared_pattern,
            solver_params, qps, fleet)
        del fleet
        fields, lane_found = lane_checks(qps, outs, solver_params,
                                         single_optimize, last)
        found += [f"{solver}: {f}" for f in lane_found]
        if fields["reasons"] != {"TERMINATION_REASON_OPTIMAL":
                                 SLOW_FLEET_LANES}:
            found.append(f"{solver}: not every lane OPTIMAL: "
                         f"{fields['reasons']}")
        if not all(l1[k] > 0 for k in ("lanes_spmv:A", "lanes_spmv:AT",
                                       "lanes_spmv:Q")):
            found.append(f"{solver}: L1 was not launched for A, A' and "
                         f"Q: {l1}")
        if any(v for k, v in b2.items() if k not in TR_KERNELS):
            found.append(f"{solver}: a routed kernel was launched: {b2}")
        if any(l1[k] for k in LANE_TRIAL_KERNELS):
            found.append(f"{solver}: the fused lane trial ran: {l1}")
        record[solver] = {
            "ingest_seconds": ingest_s, "solve_seconds": solve_s,
            "aggregate_iterations_per_second":
            fields["iterations_sum"] / solve_s,
            "step_trials": stats.trials, "evaluations": stats.segments,
            "launches": l1, **fields}
        del outs
    record["phase_seconds"] = time.time() - t_phase
    emit_checked(record, found)
    del qps

    # 17. the damping sweep with constant steps and bound-width
    # rescaling, through the per-instance ingest
    t_phase = t0 = time.time()
    sweep = generators.generate_pagerank_lp_fleet(
        FLEET_NODES, np.linspace(0.7, 0.995, SLOW_FLEET_LANES), seed=0)
    generate_s = time.time() - t0
    const_params = dataclasses.replace(
        params, step_size_policy_params=ConstantStepsizeParams(),
        bound_width_rescaling=True)
    t0 = time.time()
    fleet = batch.prepare_shared_pattern_fleet(const_params, sweep,
                                               device=dev)
    torch.cuda.synchronize()
    ingest_s = time.time() - t0
    outs, solve_s, stats, l1, b2 = run_fleet(
        torch, batch, lanes, routed, batch.solve_batch_shared_pattern,
        const_params, sweep, fleet)
    del fleet
    fields, found = lane_checks(sweep, outs, const_params, single_optimize,
                                last)
    if not (l1["lanes_spmv:A"] > 0 and l1["lanes_spmv:AT"] > 0):
        found.append(f"L1 was not launched: {l1}")
    if any(l1[k] for k in LANE_TRIAL_KERNELS):
        found.append(f"constant steps ran the fused lane trial: {l1}")
    if any(v for k, v in b2.items() if k not in TR_KERNELS):
        found.append(f"a routed kernel was launched: {b2}")
    emit_checked({
        "phase": "constant_step_fleet", "lanes": SLOW_FLEET_LANES,
        "nodes": FLEET_NODES, "generate_seconds": generate_s,
        "ingest_seconds": ingest_s, "solve_seconds": solve_s,
        "aggregate_iterations_per_second": fields["iterations_sum"]
        / solve_s,
        "step_trials": stats.trials, "evaluations": stats.segments,
        "launches": l1, **fields,
        "phase_seconds": time.time() - t_phase}, found)
    return rows


TRIAL_VARIANTS = {  # step size (times 1 / max|A_ij|), primal weight
    "small_step": (1e-3, 1.0),
    "unit_step": (1.0, 1.0),
    "large_step": (3.0, 0.01),
}


def kernels_trial(torch, routed, ops, scaled, dev, time_ms, device_profile,
                  compare, parent_dir=None):
    """F1a (primal_step) and F1b (trial_epilogue) of ops/pdhg_step.py at
    the main path's shapes, on the scaled LP's c, bounds and b and a
    state made with numpy from seed 1 (x inside the bounds, y >= 0 on
    the inequalities, A'y by B2): on the CSR and the tile-plan operator
    (`ops`), for each TRIAL_VARIANTS step size and with the mask off,
    adaptive and constant, F1a's outputs and then F1b's (on B3/B4's or
    B6/B7's outputs) must equal their plain versions' bitwise. Times on
    CSR, small_step: CUDA-event ms (median of 100), device ms and
    kernels a call (torch.profiler), the plain version's ms; the bytes
    bound counts what the call must move (F1b: the side of each select
    that `take` chooses). F1b's device time also on a trial that does not
    take its step (the mask off: it reads both sides). F1a's grid, a
    view at an odd offset and a million entries (primal_step_views,
    primal_step_million). With `parent_dir`, both
    kernels and that version's in turns (this, parent, parent, this,
    ...), and whether the parent's give the same bits."""
    from firstorderlp_torch.ops import pdhg_step, probe_routed

    rng = np.random.default_rng(1)
    m, n = ops["csr"].shape

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    lower = scaled.variable_lower_bound
    upper = scaled.variable_upper_bound
    eq = np.arange(m) < scaled.num_equalities
    y_np = rng.standard_normal(m)
    y = f32(np.where(eq, y_np, np.abs(y_np)))
    x = f32(np.clip(rng.standard_normal(n), lower, upper))
    aty = routed.spmv_csr(ops["csr"].at, y)
    c, b = f32(scaled.objective_vector), f32(scaled.right_hand_side)
    lo, hi, eq32 = f32(lower), f32(upper), f32(eq)
    step0 = 1.0 / float(abs(scaled.constraint_matrix).max())
    fields = pdhg_step.TrialFields(
        x=x, y=y, delta_x=f32(rng.standard_normal(n)),
        delta_y=f32(rng.standard_normal(m)), aty=aty,
        sum_x=f32(rng.standard_normal(n)), sum_y=f32(rng.standard_normal(m)),
        count_x=scalar(37, torch.int64), count_y=scalar(37, torch.int64),
        weight_x=scalar(1.5, torch.float32),
        weight_y=scalar(1.5, torch.float32),
        step_size=scalar(step0, torch.float32),
        primal_weight=scalar(1.0, torch.float32),
        numerical_error=scalar(False, torch.bool),
        total=scalar(61, torch.int64), iteration=scalar(57, torch.int64),
        kkt=scalar(123.5, torch.float64))
    variants, timed_args = [], None
    for layout, op in ops.items():
        for name, (scale, weight) in TRIAL_VARIANTS.items():
            for masked in (False, True):
                for constant in (False, True):
                    f = dataclasses.replace(
                        fields, step_size=scalar(step0 * scale,
                                                 torch.float32),
                        primal_weight=scalar(weight, torch.float32),
                        iteration=scalar(81 if masked else 57, torch.int64))
                    start = scalar(80 if masked else 57, torch.int64)
                    args = (x, c, aty, lo, hi, f.step_size, f.primal_weight,
                            scalar(0, torch.int32), f.numerical_error,
                            f.iteration, start, 40, 20_000, constant)
                    got = pdhg_step.primal_step(*args)
                    same_primal = states_equal(
                        got, pdhg_step.primal_step_plain(*args))
                    x_next, z, dx, sigma, active = got
                    y_next, y_layout, dy2 = op.mv_dual_step(
                        z, y, b, eq32, sigma)
                    aty_next, inter, dx2 = op.rmv_stats(y_layout, dx, aty)
                    tail = (x_next, dx, y_next, aty_next,
                            *((None,) * 3 if constant
                              else (dy2, inter, dx2)),
                            active, 0.3, 0.6, constant)
                    after = pdhg_step.trial_epilogue(f, *tail)
                    same_epilogue = states_equal(
                        after, pdhg_step.trial_epilogue_plain(f, *tail))
                    torch.cuda.synchronize()
                    variants.append({
                        "layout": layout, "variant": name, "masked": masked,
                        "constant": constant,
                        "active": bool(active),
                        "accepted": int(after.iteration) > int(f.iteration),
                        "primal_step_bitwise": same_primal,
                        "trial_epilogue_bitwise": same_epilogue})
                    if (layout, name, masked, constant) == (
                            "csr", "small_step", False, False):
                        timed_args = (args, f, tail)
                    if (layout, name, masked, constant) == (
                            "csr", "small_step", True, False):
                        not_taken = (f, tail)
    bad = [v for v in variants if not (v["primal_step_bitwise"]
                                       and v["trial_epilogue_bitwise"])]
    if bad:
        fail("kernels_trial", f"kernel and plain version differ: {bad}")
    args, f, tail = timed_args
    accepted = [v["accepted"] for v in variants
                if (v["layout"], v["variant"], v["masked"],
                    v["constant"]) == ("csr", "small_step", False, False)]
    rows = []
    for name, kernel, plain, nbytes, flops, replaces in (
        ("primal_step", lambda: pdhg_step.primal_step(*args),
         lambda: pdhg_step.primal_step_plain(*args),
         # x, c, A'y, l, u read; x+, z, dx written; the 0-d inputs and
         # outputs
         4 * 8 * n + 4 + 4 + 4 + 1 + 8 + 8 + 4 + 1, 8 * n,
         "none (no pl.pallas_call): XLA's fusion in "
         "firstorderlp_tpu/models/pdhg.py:303 (_take_step_adaptive) of "
         ":246 (_compute_next_primal), :343 (z) and :354 (dx)"),
        ("trial_epilogue", lambda: pdhg_step.trial_epilogue(f, *tail),
         lambda: pdhg_step.trial_epilogue_plain(f, *tail),
         # each select reads the side `take` chooses (and the sums, and
         # y for dy): 4 n + 3 m floats read, as many written; the 0-d
         # inputs and outputs
         4 * (8 * n + 6 * m) + 150, 2 * n + 3 * m + 30,
         "none (no pl.pallas_call): XLA's fusion in "
         "firstorderlp_tpu/models/pdhg.py:303 (_take_step_adaptive) of "
         ":355-410 (movement, limit, accept, step size, selects, "
         "average) and :412 (_take_step_constant)"),
    ):
        kernel()
        torch.cuda.synchronize()
        dev_ms, per_call = device_profile(kernel)
        rows.append({
            "name": name, "route": "cuda",
            "source": "firstorderlp_torch/csrc/pdhg_step.cu",
            "replaces": replaces, "max_abs_err": 0.0,
            "bitwise_equal": True, "accepted": accepted[0],
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "device_ms": dev_ms, "kernels_per_call": per_call,
            "bytes": nbytes, "flops": flops, "library_ms": None,
        })
    f_off, tail_off = not_taken
    rows[1]["device_ms_not_taken"] = device_profile(
        lambda: pdhg_step.trial_epilogue(f_off, *tail_off))[0]
    rows[0].update(primal_step_views(torch, pdhg_step, probe_routed, args))
    parent = (compare.package_module("ops.pdhg_step", parent_dir)
              if parent_dir else None)
    rows[0]["million"] = primal_step_million(torch, pdhg_step, probe_routed,
                                             parent, dev)
    if parent_dir:
        pf = parent.TrialFields(**{fl.name: getattr(f, fl.name)
                                   for fl in dataclasses.fields(f)})
        calls = {
            "primal_step": lambda: pdhg_step.primal_step(*args),
            "parent_primal_step": lambda: parent.primal_step(*args),
            "trial_epilogue": lambda: pdhg_step.trial_epilogue(f, *tail),
            "parent_trial_epilogue": lambda: parent.trial_epilogue(pf,
                                                                   *tail),
        }
        turns = {key: probe_routed.turn_summary(got) for key, got in
                 probe_routed.in_turns(calls).items()}
        for row in rows:
            name = row["name"]
            theirs = calls[f"parent_{name}"]()
            ours = calls[name]()
            row["turns"] = turns[name]
            row["parent"] = {**turns[f"parent_{name}"],
                             "bitwise_equal": states_equal(ours, theirs)}
    return rows, variants


def primal_step_views(torch, pdhg_step, probe_routed, args):
    """F1a's grid, and its inputs as views at an offset of one float
    (read 4 bytes at a time) in turns with the aligned inputs, each
    bitwise the plain version; beside them PyTorch's copy of one n-vector
    (a floor of a kernel that reads and writes device memory)."""
    n = args[0].shape[0]
    plain = pdhg_step.primal_step_plain(*args)
    views = []
    for t in args[:5]:
        buf = torch.empty(n + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t)
        views.append(buf[1:])
    view_args = (*views, *args[5:])
    calls = {"aligned": lambda: pdhg_step.primal_step(*args),
             "not_aligned": lambda: pdhg_step.primal_step(*view_args)}
    bits = {key: states_equal(call(), plain) for key, call in calls.items()}
    # a yardstick of a kernel's floor here: PyTorch's copy of one n-vector
    calls["copy"] = lambda: torch.empty_like(args[0]).copy_(args[0])
    torch.cuda.synchronize()
    if not all(bits.values()):
        fail("kernels_trial", f"primal_step on views differs from the "
                              f"plain version: {bits}")
    turns = {key: probe_routed.turn_summary(got) for key, got in
             probe_routed.in_turns(calls).items()}
    return {
        "grid": {"blocks": pdhg_step.primal_grid(n),
                 "threads": pdhg_step.PRIMAL_THREADS, "slots": 1},
        "aligned": turns["aligned"],
        "not_aligned": {"aligned_mask": pdhg_step.aligned_mask(views),
                        **turns["not_aligned"]},
        "copy_one_vector": turns["copy"],
    }


def primal_step_million(torch, pdhg_step, probe_routed, parent, dev):
    """F1a on a million entries made with numpy (seed 4), bitwise its
    plain version; beside `parent`'s primal_step in turns when given."""
    rng = np.random.default_rng(4)
    n = 1_000_000

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    lower = np.where(rng.random(n) < 0.3, -np.inf, -rng.random(n))
    upper = np.where(rng.random(n) < 0.3, np.inf, rng.random(n))
    args = (vec(np.clip(rng.standard_normal(n), lower, upper)),
            vec(rng.standard_normal(n)), vec(rng.standard_normal(n)),
            vec(lower), vec(upper), scalar(1e-3, torch.float32),
            scalar(1.0, torch.float32), scalar(0, torch.int32),
            scalar(False, torch.bool), scalar(57, torch.int64),
            scalar(57, torch.int64), 40, 20_000, False)
    calls = {"this": lambda: pdhg_step.primal_step(*args)}
    if parent is not None:
        calls["parent"] = lambda: parent.primal_step(*args)
    bits = {key: states_equal(call(), pdhg_step.primal_step_plain(*args))
            for key, call in calls.items()}
    torch.cuda.synchronize()
    if not bits["this"]:
        fail("kernels_trial", "primal_step differs from its plain version "
                              "at a million entries")
    turns = probe_routed.in_turns(calls)
    return {"n": n, "bytes": 4 * 8 * n + 38,
            **{key: {**probe_routed.turn_summary(turns[key]),
                     "bitwise_equal": bits[key]} for key in calls}}


def kernels_tiled_large(torch, routed, probe, compare, device_ms, dev):
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
        elif name.startswith("spmv_csr"):
            row.update(compare.b2_launch_stats(mat))
        else:
            row.update(routed.csr_item_stats(mat))
        results.append(row)
    trial = trial_kernels_large(torch, n, m, dev, probe.time_ms,
                                compare.device_profile)
    for r in trial:
        r["bound_ms"], r["bound_by"] = probe.bound_ms(r["bytes"], r["flops"])
    return {"phase": ph, "ok": True, "m": m, "n": n, "nnz": int(a64.nnz),
            "matrix": "generators.pagerank_like_matrix(1_000_000, seed=0)",
            "matrix_seconds": make_s, "setup_seconds": setup_s,
            "results": results, "trial_kernels": trial}


def cli_path(torch, routed, problem, small, main_out, params, dev,
             keep_dir):
    """The user's front door, the port's CLIs, at the main path's
    size (see the module docstring, phase cli_path). Returns the phase's
    record; its "problems" list is empty when every check held. The
    100k-node .mps.gz it writes stays in `keep_dir` (shard_ingest_path
    streams it)."""
    import dataclasses
    import gzip
    import os
    import tempfile

    import scipy.sparse as sp

    from firstorderlp_torch import compile_meter, qps_reader_to_standard_form
    from firstorderlp_torch.cli import (
        generate_pagerank_lp as gen_cli,
        solve_lp_external,
        solve_qp,
    )
    from firstorderlp_torch.io import mps, native
    from firstorderlp_torch.models.pdhg import PROFILER_TRACE_FILE, optimize

    rec = {"phase": "cli_path", "nodes": NODES}
    problems = []
    # The CLIs print their "Elapsed time" lines; stdout stays this
    # script's JSON lines.
    quiet = contextlib.redirect_stdout(sys.stderr)
    csr_names = ("spmv_csr:A", "spmv_csr:AT", "spmv_dual_step",
                 "spmv_rmv_stats")

    def canonical(matrix):
        csr = sp.csr_matrix(matrix, dtype=np.float64)
        csr.sum_duplicates()
        return csr

    def summary_of(out_dir, name):
        with open(os.path.join(out_dir, name + "_summary.json")) as f:
            return json.load(f)

    def solution_of(out_dir, name):
        return (np.loadtxt(os.path.join(out_dir, name + "_primal.txt")),
                np.loadtxt(os.path.join(out_dir, name + "_dual.txt")))

    with tempfile.TemporaryDirectory() as tmp:
        # The LP, written by the generator CLI with the edge count that
        # generate_pagerank_lp takes when it gets None (3 per node).
        path = os.path.join(keep_dir, "pagerank.mps.gz")
        t0 = time.time()
        gen_cli.main(["--num_nodes", str(NODES), "--approx_num_edges",
                      str(3 * NODES), "--output_filename", path])
        rec["generate_and_write_seconds"] = time.time() - t0
        rec["file_bytes"] = os.path.getsize(path)

        # Read back: the native tokenizer and the Python parser.
        with compile_meter.CompileWindow() as window:
            lib = native.load()
        rec["tokenizer_build"] = {"seconds": window.seconds,
                                  "backend_seconds": window.backend_seconds,
                                  "library": getattr(lib, "_name", None)}
        if lib is None:
            rec.update(ok=False, problems=["the native tokenizer did not "
                                           "load"])
            return rec
        with open(path, "rb") as f:
            raw = gzip.decompress(f.read())
        rec["text_bytes"] = len(raw)
        t0 = time.time()
        native_data = mps.read_mps(path)
        native_s = time.time() - t0
        t0 = time.time()
        native.parse_bytes(lib, raw)
        tokenize_s = time.time() - t0
        t0 = time.time()
        python_data = mps._read_mps_python(path)
        python_s = time.time() - t0
        rec["read_mb_per_second"] = {
            "native": len(raw) / 1e6 / native_s,
            "native_tokenize_only": len(raw) / 1e6 / tokenize_s,
            "python": len(raw) / 1e6 / python_s,
        }
        for field in dataclasses.fields(native_data):
            a = getattr(native_data, field.name)
            b = getattr(python_data, field.name)
            same = (np.array_equal(a, b, equal_nan=True)
                    if isinstance(a, np.ndarray) else a == b)
            if not same:
                problems.append(f"parsers differ in {field.name}")
        del native_data, python_data, raw
        read_back = qps_reader_to_standard_form(path)
        a_file = canonical(read_back.constraint_matrix)
        a_main = canonical(problem.constraint_matrix)
        rec["pattern_hash_equal"] = (
            routed.pattern_hash(a_file) == routed.pattern_hash(a_main))
        if not rec["pattern_hash_equal"]:
            problems.append("the file's pattern differs from the main "
                            "path's")
        if (a_file != a_main).nnz or not np.array_equal(
                read_back.right_hand_side, problem.right_hand_side):
            problems.append("the file's values differ from the main path's")
        del read_back, a_file, a_main

        # solve_qp in f32 on the kernel operator, at main_path's
        # tolerances
        out_dir = os.path.join(tmp, "f32")
        flags = ["--method", "pdhg", "--instance_path", path,
                 "--output_dir", out_dir, "--verbosity", "0",
                 "--absolute_optimality_tol", "1e-4",
                 "--relative_optimality_tol", "1e-4",
                 "--iteration_limit", "20000", "--device", dev.type]
        routed.reset_launch_counts()
        t0 = time.time()
        with quiet:
            solve_qp.main(flags + ["--dtype", "float32",
                                   "--matrix_format", "routed"])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        launches = dict(routed.LAUNCHES)
        summary = summary_of(out_dir, "pagerank")
        files = sorted(os.listdir(out_dir))
        x, y = solution_of(out_dir, "pagerank")
        res = host_residuals(problem, x, y)
        objective = summary["solution_stats"]["convergence_information"][0][
            "primal_objective"]
        main_objective = main_out.iteration_stats[-1].convergence_information[
            0].primal_objective
        rec["f32"] = {
            "reason": summary["termination_reason"],
            "iterations": summary["iteration_count"],
            "solve_time_sec": summary["solve_time_sec"],
            "cli_seconds": cli_s, "files": files, "host_f64": res,
            "launches": launches, "objective": objective,
            "main_path_objective": main_objective,
        }
        if summary["termination_reason"] != "TERMINATION_REASON_OPTIMAL":
            problems.append(f"f32 CLI solve: {summary['termination_reason']}")
        if len(files) != 4:
            problems.append(f"f32 CLI solve wrote {files}")
        if any(not v <= 1e-4 for v in res.values()):
            problems.append(f"f32 CLI solve: host residuals {res}")
        if any(launches[k] <= 0 for k in csr_names[1:]):
            problems.append(f"f32 CLI solve: a kernel was not launched: "
                            f"{launches}")
        if not abs(objective - main_objective) <= 1e-4 * (
                1.0 + abs(main_objective)):
            problems.append(f"f32 CLI objective {objective} against "
                            f"main_path's {main_objective}")

        # solve_qp at its default float64 (CsrOp) on the 20k-node LP
        small_path = os.path.join(tmp, "pagerank20k.mps.gz")
        gen_cli.main(["--num_nodes", str(DET_NODES), "--approx_num_edges",
                      str(3 * DET_NODES), "--output_filename", small_path])
        out_dir = os.path.join(tmp, "f64")
        flags[flags.index(path)] = small_path
        flags[flags.index(os.path.join(tmp, "f32"))] = out_dir
        routed.reset_launch_counts()
        t0 = time.time()
        with quiet:
            solve_qp.main(flags)
        torch.cuda.synchronize()
        f64_s = time.time() - t0
        launches = dict(routed.LAUNCHES)
        summary = summary_of(out_dir, "pagerank20k")
        res = host_residuals(small, *solution_of(out_dir, "pagerank20k"))
        rec["f64"] = {
            "nodes": DET_NODES, "reason": summary["termination_reason"],
            "iterations": summary["iteration_count"],
            "solve_time_sec": summary["solve_time_sec"],
            "cli_seconds": f64_s, "host_f64": res, "launches": launches,
        }
        if summary["termination_reason"] != "TERMINATION_REASON_OPTIMAL":
            problems.append(f"f64 CLI solve: {summary['termination_reason']}")
        if any(launches.values()):
            problems.append(f"f64 CLI solve launched a kernel: {launches}")
        if any(not v <= 1e-4 for v in res.values()):
            problems.append(f"f64 CLI solve: host residuals {res}")

        # solve_lp_external with HiGHS, residuals evaluated on the card
        ext_path = os.path.join(tmp, "pagerank2k.mps.gz")
        gen_cli.main(["--num_nodes", "2000", "--approx_num_edges", "6000",
                      "--output_filename", ext_path])
        t0 = time.time()
        with quiet:
            log = solve_lp_external.main([
                "--solver", "highs", "--instance_path", ext_path,
                "--output_dir", os.path.join(tmp, "highs"),
                "--device", dev.type])
        conv = log.solution_stats.convergence_information[0]
        rec["highs"] = {
            "nodes": 2000, "reason": log.termination_reason.name,
            "seconds": time.time() - t0, "solve_time_sec": log.solve_time_sec,
            "l2_primal_residual": conv.l2_primal_residual,
            "l2_dual_residual": conv.l2_dual_residual,
            "relative_optimality_gap": conv.relative_optimality_gap,
        }
        if log.termination_reason.name != "TERMINATION_REASON_OPTIMAL":
            problems.append(f"HiGHS: {log.termination_reason.name}")
        if not (conv.l2_primal_residual <= 1e-6
                and conv.l2_dual_residual <= 1e-6):
            problems.append(f"HiGHS residuals {rec['highs']}")

        # optimize under the profiler trace, against the same solve
        # untraced
        trace_dir = os.path.join(tmp, "trace")
        traced_params = dataclasses.replace(params,
                                            profiler_trace_dir=trace_dir)
        solves, traced_bits = {}, {}
        for label, p in (("untraced", params), ("traced", traced_params),
                         ("untraced_again", params)):
            torch.cuda.synchronize()
            t0 = time.time()
            o = optimize(p, small, device=dev)
            torch.cuda.synchronize()
            solves[label] = {"seconds": time.time() - t0,
                             "iterations": o.iteration_count,
                             "reason": o.termination_reason.name}
            traced_bits[label] = as_record(o)
        trace_path = os.path.join(trace_dir, PROFILER_TRACE_FILE)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({
            e["name"].split("<")[0].replace("void ", "")
            for e in events
            if str(e.get("cat", "")).lower() == "kernel"
            and "folp::" in e.get("name", "")})
        rec["trace"] = {"solves": solves, "trace_bytes":
                        os.path.getsize(trace_path), "events": len(events),
                        "folp_kernels": kernels}
        if not kernels:
            problems.append("the trace names no folp kernel")
        if any(v["reason"] != "TERMINATION_REASON_OPTIMAL"
               for v in solves.values()):
            problems.append(f"traced or untraced solve: {solves}")
        # the traced solve (its steps replayed from a graph captured
        # under the profiler) is bitwise the untraced ones
        rec["trace"]["bitwise_equal"] = all(
            same_bits(traced_bits["untraced"], traced_bits[label])
            for label in ("traced", "untraced_again"))
        if not rec["trace"]["bitwise_equal"]:
            problems.append("the traced solve differs from the untraced")
    rec["ok"] = not problems
    if problems:
        rec["problems"] = problems
    return rec


def main_path_parent(torch, compare, parent_dir, dev):
    """The main path's solve and mirror_prox_path's, warm, on the
    PageRank LPs of SOLVE_SEEDS by another version of this package
    (`parent_dir` holds it as `firstorderlp_torch_parent`) and by this
    one, in turns (parent, this, this, parent): iterations, seconds
    (host clock up to a device synchronize), ms an iteration and reason
    of each solve; then a PDHG trial of each version from the state at
    iteration 81 of seed 0 (trial_measures), in turns."""
    dirs = {"parent": parent_dir, "this": None}
    mods = {who: {part: compare.package_module(part, where)
                  for part in ("", "generators", "models.pdhg",
                               "models.mirror_prox", "ops.graphs",
                               "ops.routed")}
            for who, where in dirs.items()}

    def solve(who, solver, problem):
        pkg = mods[who][""]
        if solver == "pdhg":
            params = make_params(1e-4, 20_000, pkg=pkg)
        else:
            params = make_mp_params(1e-4, 20_000, pkg=pkg)
        module = mods[who][f"models.{solver}"]
        prepared = module.prepare_problem(params, problem, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        out = module.optimize(params, problem, prepared=prepared)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        return {"package": who, "solver": solver,
                "iterations": out.iteration_count, "seconds": seconds,
                "host_f64": host_residuals(problem, out.primal_solution,
                                           out.dual_solution),
                "ms_per_iteration": 1e3 * seconds / max(
                    out.iteration_count, 1),
                "reason": out.termination_reason.name,
                "solution_sha256": hashlib.sha256(
                    out.primal_solution.tobytes()
                    + out.dual_solution.tobytes()).hexdigest()}

    for who in dirs:  # kernels built and modules loaded, untimed
        for solver in ("pdhg", "mirror_prox"):
            solve(who, solver, mods[who]["generators"].generate_pagerank_lp(
                num_nodes=DET_NODES, seed=0))
    rows = []
    for seed in SOLVE_SEEDS:
        problems = {who: mods[who]["generators"].generate_pagerank_lp(
            num_nodes=NODES, seed=seed) for who in dirs}
        for solver in ("pdhg", "mirror_prox"):
            for who in ("parent", "this", "this", "parent"):
                rows.append({"seed": seed,
                             **solve(who, solver, problems[who])})
    # every solve OPTIMAL with host-f64 residuals under 1e-4, each
    # version's two solves of a seed and solver bitwise equal; the
    # versions' iterations side by side (the trust region's f64 sums
    # moved the trajectory: whole solves are held to their reason and
    # residuals, never to equal iterations)
    problems = [f"seed {r['seed']} {r['solver']} {r['package']}: "
                f"{r['reason']}, host residuals {r['host_f64']}"
                for r in rows if r["reason"] != "TERMINATION_REASON_OPTIMAL"
                or any(not v <= 1e-4 for v in r["host_f64"].values())]
    side_by_side = []
    for seed in SOLVE_SEEDS:
        for solver in ("pdhg", "mirror_prox"):
            iterations = {}
            for who in dirs:
                runs = {(r["iterations"], r["solution_sha256"]) for r in rows
                        if (r["seed"], r["solver"], r["package"])
                        == (seed, solver, who)}
                if len(runs) != 1:
                    problems.append(f"seed {seed} {solver} {who}: two "
                                    f"solves differ: {sorted(runs)}")
                iterations[who] = sorted(runs)[0][0]
            side_by_side.append({"seed": seed, "solver": solver,
                                 **iterations})
    trials = []
    cases = {}
    for who in dirs:
        pkg, module = mods[who][""], mods[who]["models.pdhg"]
        params = make_params(1e-4, 20_000, pkg=pkg)
        prepared = module.prepare_problem(
            params, mods[who]["generators"].generate_pagerank_lp(
                num_nodes=NODES, seed=0), device=dev)
        config = module._make_config(params)
        state, _, _, _ = module._run_segments(
            prepared.bundle, module._device_counters(prepared.initial_state),
            0.0, config, SEGMENT_WARMUP, 1)
        cases[who] = (module, prepared.bundle, config, state)
    for who in ("parent", "this", "this", "parent"):
        module, bundle, config, state = cases[who]
        trials.append({"package": who, **trial_measures(
            torch, module, mods[who]["ops.graphs"], mods[who]["ops.routed"],
            bundle, config, state)})
    for t in trials:
        del t["eager_trial_device_kernels"]
    del cases
    return {"phase": "main_path_parent", "ok": not problems,
            "nodes": NODES, "parent": parent_dir, "solves": rows,
            "iterations": side_by_side, "trials": trials,
            **({"problems": problems} if problems else {})}


def hetero_parent(torch, compare, parent_dir, dev):
    """hetero_fleet's solve (32 PageRank LPs, make_params at 1e-4) by
    another version of this package (`parent_dir` holds it as
    `firstorderlp_torch_parent`) and by this one: each fleet prepared
    and solved once untimed, then in turns (parent, this, this, parent)
    seconds, iterations a lane summed and reasons; then one solve each
    under torch.profiler: the device time of every kernel and of B2's
    (its kernels of the routed product: the parent's csr_item_kernel
    with StoreRow, this package's spmv_stage_kernel)."""
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    for who, where in {"parent": parent_dir, "this": None}.items():
        pkg, batch, generators = (compare.package_module(part, where)
                                  for part in ("", "batch", "generators"))
        params = make_params(1e-4, 20_000, fmt="auto", pkg=pkg)
        problems = compare.hetero_fleet_problems(generators)
        fleet = batch.prepare_batch(params, problems, device=dev)
        batch.solve_batch(params, problems, fleet=fleet)
        runs[who] = (batch, params, problems, fleet)
    torch.cuda.synchronize()
    rows = []
    for who in ("parent", "this", "this", "parent"):
        batch, params, problems, fleet = runs[who]
        t0 = time.time()
        outs = batch.solve_batch(params, problems, fleet=fleet)
        torch.cuda.synchronize()
        rows.append({"package": who, "seconds": time.time() - t0,
                     "iterations_sum": sum(o.iteration_count for o in outs),
                     "optimal": sum(o.termination_reason.name
                                    == "TERMINATION_REASON_OPTIMAL"
                                    for o in outs)})
    profiles = {}
    for who, (batch, params, problems, fleet) in runs.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            batch.solve_batch(params, problems, fleet=fleet)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        b2 = [e for e in device if "spmv_stage_kernel" in e.key
              or ("csr_item_kernel" in e.key and "StoreRow" in e.key)]
        total = sum(e.self_device_time_total for e in device)
        b2_us = sum(e.self_device_time_total for e in b2)
        profiles[who] = {"device_ms": total / 1e3, "b2_device_ms": b2_us / 1e3,
                         "b2_share": b2_us / total if total else 0.0,
                         "b2_kernels": sum(e.count for e in b2)}
    ok = all(r["optimal"] == compare.HETERO_LANES for r in rows
             if r["package"] == "this")
    return {"phase": "hetero_parent", "ok": ok,
            "lanes": compare.HETERO_LANES,
            "parent": parent_dir, "solves": rows, "profiled": profiles}


# The evaluation's split by function (evaluation_split): the ranges that
# wrap module functions of a version of the package, by the name each
# module binds (outermost first); nested calls name their range by the
# path of ranges around them.
SPLIT_TARGETS = (
    ("solver", "evaluation_point", "evaluation_point"),
    ("solver", "evaluate_unscaled_stats", "statistics"),
    # the point and the statistics in one call (the kernels' route folds
    # the point in), and the statistics' three kernels
    ("solver", "evaluate_statistics", "statistics"),
    ("ops.eval_stats", "stats_point", "stats_point"),
    ("ops.eval_stats", "stats_primal", "stats_primal"),
    ("ops.eval_stats", "stats_dual", "stats_dual"),
    ("solver", "update_objective_bound_estimates", "bound_estimates"),
    ("solver", "run_restart_scheme", "restart_scheme"),
    ("saddle_point", "bound_optimal_objective_euclidean_batched",
     "restart_bounds"),
    ("trust_region", "solve_bound_constrained_trust_region", "trust_region"),
    # the knot search: the previous release's _t_star_bisect (its totals
    # included), or F2b (the prologue fused) and F2c
    ("trust_region", "_t_star_bisect", "knot_search"),
    ("ops.trust_region_search", "tr_search", "knot_search"),
    ("ops.trust_region_search", "tr_solution", "tr_solution"),
)
SPLIT_SLEEP_CYCLES = 400_000_000  # about 0.2 s: the host enqueues ahead
SPLIT_RUNS = 3  # eager evaluations timed a version and solver
TR_PATH = "restart_scheme/restart_bounds/trust_region"
STATS_MAX_LAUNCHES = 7  # three B2 products and at most four kernels


@contextlib.contextmanager
def split_ranges(torch, modules, marks):
    """Wraps each SPLIT_TARGETS function that `modules` (name -> module)
    hold: a torch.profiler range "split:<path>" and CUDA events around
    each call, appended to `marks` as (path, start, end)."""
    from torch.profiler import record_function

    stack, saved = [], []

    def wrap(fn, label):
        def ranged(*args, **kwargs):
            stack.append(label)
            path = "/".join(stack)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                with record_function(f"split:{path}"):
                    return fn(*args, **kwargs)
            finally:
                end.record()
                marks.append((path, start, end))
                stack.pop()
        return ranged

    try:
        for part, name, label in SPLIT_TARGETS:
            module = modules.get(part)
            if module is not None and hasattr(module, name):
                saved.append((module, name, getattr(module, name)))
                setattr(module, name, wrap(getattr(module, name), label))
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def launches_under(prof):
    """Host launch calls (kernels, copies, memsets) under each
    "split:<path>" range of a torch.profiler run, summed by path."""
    from firstorderlp_torch.ops.probe_routed import LAUNCH_CALLS

    def count(event):
        launch = event.name in LAUNCH_CALLS or event.name.startswith(
            ("cudaLaunch", "cuLaunch"))
        return int(launch) + sum(count(c) for c in event.cpu_children)

    out = {}
    for e in prof.events():
        if e.name.startswith("split:"):
            key = e.name[len("split:"):]
            out[key] = out.get(key, 0) + count(e)
    return out


def derived_split(ms):
    """The evaluation's parts from the ranges' device ms (by path): the
    restart scheme's products and gradients (its bounds less the trust
    region), its scalars and selects, the trust region less its knot
    search (the previous release's prologue and solution; F2c and the
    glue around the kernels here), and the state selects, A'y and the
    rest of _eval_block."""
    def get(path):
        return ms.get(path, 0.0)

    top = ("evaluation_point", "statistics", "bound_estimates",
           "restart_scheme")
    return {
        "restart_products": get("restart_scheme/restart_bounds")
        - get(TR_PATH),
        "restart_scalars_and_selects": get("restart_scheme")
        - get("restart_scheme/restart_bounds"),
        "trust_region_less_knot_search": get(TR_PATH)
        - get(TR_PATH + "/knot_search"),
        "state_selects_and_rest": get("evaluation")
        - sum(get(p) for p in top),
    }


def eval_graph_measures(torch, module, routed_mod, bundle, config, state):
    """The replayed evaluation of one version on `state`: device ms (the
    median of three samples, each CUDA events around 20 replays queued
    behind a sleeping kernel) and the nodes of its graph (the evaluation
    and its copy-back into the buffers, captured again with
    keep_graph=True on the runner's buffers)."""
    runner = module._runner(bundle, state, 0.0, config, False)
    start_event = torch.cuda.Event(enable_timing=True)
    end_event = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start_event.record()
        for _ in range(20):
            runner.evaluate()
        end_event.record()
        torch.cuda.synchronize()
        samples.append(start_event.elapsed_time(end_event) / 20)
    out = {"device_ms_per_replayed_evaluation": float(np.median(samples)),
           "device_ms_per_replayed_evaluation_samples": samples}
    saved = dict(routed_mod.LAUNCHES)
    device = bundle.scaled.objective_vector.device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        runner.static.apply(runner._evaluate, evaluation=True)
    routed_mod.LAUNCHES.update(saved)
    out["evaluation_graph_nodes"] = graph_nodes(torch, graph)
    del graph
    runner.unload()
    return out


def evaluation_split(torch, compare, parent_dir, dev):
    """One eager PDHG evaluation and one eager Mirror Prox evaluation on
    the 100k-node LP from the state at iteration 81 (SEGMENT_WARMUP
    segments as optimize runs them), by the version in `parent_dir` (if
    given) and by this one, split by function (SPLIT_TARGETS): for each
    range its device ms (CUDA events, median of SPLIT_RUNS evaluations,
    a sleeping kernel first so the host enqueues ahead of the card: the
    span, gaps between launches included) and its host launch calls
    (one evaluation under torch.profiler), then the derived parts
    (derived_split); and the replayed evaluation's
    device ms and graph nodes (eval_graph_measures). This version's
    trust region must be two launches, its knot search one, and its
    statistics (the evaluation point folded in) at most
    STATS_MAX_LAUNCHES."""
    from torch.profiler import ProfilerActivity, profile

    versions = {"parent": parent_dir} if parent_dir else {}
    versions["this"] = None
    rows, problems = [], []
    for who, where in versions.items():
        mods = {part: compare.package_module(part, where) for part in (
            "", "generators", "models.pdhg", "models.mirror_prox",
            "saddle_point", "trust_region", "ops.routed")}
        for part in ("ops.trust_region_search", "ops.eval_stats"):
            try:
                mods[part] = compare.package_module(part, where)
            except ImportError:
                pass
        problem = mods["generators"].generate_pagerank_lp(num_nodes=NODES,
                                                          seed=0)
        for solver in ("pdhg", "mirror_prox"):
            module = mods[f"models.{solver}"]
            make = make_params if solver == "pdhg" else make_mp_params
            params = make(1e-4, 20_000, pkg=mods[""])
            prepared = module.prepare_problem(params, problem, device=dev)
            config = module._make_config(params)
            state = module._device_counters(prepared.initial_state)
            if solver == "pdhg":
                state = module._run_segments(
                    prepared.bundle, state, 0.0, config, SEGMENT_WARMUP,
                    int(state.iteration))[0]
            else:
                state = module._run_segments(
                    prepared.bundle, state, 0.0, config, SEGMENT_WARMUP)[0]
            modules = dict(mods, solver=module)
            elapsed = torch.zeros((), dtype=torch.float64, device=dev)

            def evaluate():
                return module._eval_block(prepared.bundle, state, elapsed,
                                          config)

            evaluate()  # modules loaded, kernels built
            runs = []
            for _ in range(SPLIT_RUNS):
                marks = []
                with split_ranges(torch, modules, marks):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    evaluate()
                    end.record()
                    torch.cuda.synchronize()
                ms = {"evaluation": start.elapsed_time(end)}
                for path, s, e in marks:
                    ms[path] = ms.get(path, 0.0) + s.elapsed_time(e)
                runs.append(ms)
            device_ms = {k: float(np.median([r[k] for r in runs]))
                         for k in runs[0]}
            with split_ranges(torch, modules, []):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    with torch.profiler.record_function("split:evaluation"):
                        evaluate()
                    torch.cuda.synchronize()
            launches = launches_under(prof)
            row = {"package": who, "solver": solver, "nodes": NODES,
                   "iteration": int(state.iteration),
                   "device_ms": device_ms,
                   "device_ms_runs": [r["evaluation"] for r in runs],
                   "launches": launches,
                   "derived_device_ms": derived_split(device_ms),
                   **eval_graph_measures(torch, module, mods["ops.routed"],
                                         prepared.bundle, config, state)}
            rows.append(row)
            if who == "this" and (
                    launches.get(TR_PATH) != 2
                    or launches.get(TR_PATH + "/knot_search") != 1):
                problems.append(f"{solver}: the trust region launched "
                                f"{launches.get(TR_PATH)} kernels, its "
                                f"knot search "
                                f"{launches.get(TR_PATH + '/knot_search')};"
                                " want 2 and 1")
            if who == "this" and not (
                    0 < launches.get("statistics", 0) <= STATS_MAX_LAUNCHES):
                problems.append(f"{solver}: the statistics launched "
                                f"{launches.get('statistics')} kernels; "
                                f"want at most {STATS_MAX_LAUNCHES}")
            del prepared, state
    return {"phase": "evaluation_split", "ok": not problems,
            "method": "device ms: CUDA events around each range, median "
                      f"of {SPLIT_RUNS} eager evaluations; launches: host "
                      "launch calls under each range (torch.profiler)",
            "rows": rows, **({"problems": problems} if problems else {})}


TR_RADII = (0.05, 0.7, 5.0)  # kernels_trust_region's restart-like radii


def tr_inputs(torch, rng, rows, lower, upper, dev, radii=TR_RADII):
    """A trust-region batch made with numpy from `rng`: `rows` rows over
    the bounds (N,) or (rows, N), c inside them (a tenth at a finite
    bound), g and the weights normal and uniform in [0.5, 2]; f32 on the
    card."""
    n = lower.shape[-1]
    lo = np.broadcast_to(lower, (rows, n))
    hi = np.broadcast_to(upper, (rows, n))
    c = np.clip(rng.standard_normal((rows, n)), lo, hi)
    at = (rng.random((rows, n)) < 0.1) & np.isfinite(lo)
    c = np.where(at, lo, c)
    g = rng.standard_normal((rows, n))
    weight = rng.uniform(0.5, 2.0, lower.shape)
    radius = np.resize(np.asarray(radii), rows)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    return tuple(f32(v) for v in (c, g, lower, upper, weight, radius))


TR_SEARCH_REPLACES = (
    "none (no pl.pallas_call): XLA's fusion of "
    "firstorderlp_tpu/trust_region.py:42 "
    "(solve_bound_constrained_trust_region: frozen, direction, knots) "
    "and :112 (_t_star_bisect), vmapped at :401")


def tr_search_bytes(rows, n, bounds_rows):
    """F2b's bytes bound: c and g a row, the bounds and weights once (or a
    row each), the radius read and t* written."""
    return 4 * (2 * rows * n + 3 * n * bounds_rows + 2 * rows)


def tr_solution_bytes(rows, n, bounds_rows):
    """F2c's bytes bound: c and g read and the solution written a row,
    the bounds and weights once (or a row each), t* read and the sums
    written."""
    return 4 * (3 * rows * n + 3 * n * bounds_rows + rows + 3 * rows)


def replayed(torch, call):
    """A function that replays one call of `call` captured in a CUDA
    graph (after a warm-up call), as the evaluation graph runs it."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    return graph.replay


def live_share(torch, trs, c, g, lower, upper, weight, radius):
    """The whole-card path's live knots over all entries after its
    prologue and after each trip: its warps' list lengths (what _sweep
    returns), read back here after a run of 0 to SEARCH_TRIPS trips."""
    rows, n = c.shape
    t_star = torch.empty(rows, dtype=torch.float32, device=c.device)
    share = []
    for trips in range(trs.SEARCH_TRIPS + 1):
        counts = trs._sweep([c, g, lower, upper, weight],
                            radius.contiguous(), t_star, trips)
        share.append(int(counts.sum()) / (rows * n))
    return share


def kernels_trust_region(torch, scaled, dev, time_ms, device_profile,
                         compare, parent_dir=None):
    """F2b (with the prologue F2a) and F2c (tr_solution) of
    ops/trust_region_search.py at the main path's shape (the restart
    scheme's 3 rows over the scaled 100k-node LP's primal and dual
    bounds, N = n + m, bounds (N,)), the 128-lane fleet's (384 rows of
    40,001, bounds (B, N)), one row of 300,000 (past the 218,112
    entries that 8-block clusters stage) and the 1M-node LP's restart
    scheme (3 rows of 2,000,001, its bound pattern, bounds (N,)), inputs
    made with numpy from seed 2: t*, the solution and the sums bitwise
    the plain versions', twice the same bits, F2b's device time and plan
    and F2c's grid and device time at each shape, and `parent_dir`'s
    tr_search and tr_solution beside them in turns; at the 1M shape one
    call replayed from a CUDA graph in turns with the parent's, and the
    whole-card path's live-knot share after its prologue and each trip
    (its lists' lengths, read back here only); at the main path's shape
    F2b under 8- and 16-block plans and the whole-card path, bitwise
    the plain version and timed in turns, and F2c's and the plain
    versions' times and the bytes bounds."""
    from firstorderlp_torch.ops import probe_routed
    from firstorderlp_torch.ops import trust_region_search as trs

    rng = np.random.default_rng(2)
    m = scaled.constraint_matrix.shape[0]
    eq = np.arange(m) < scaled.num_equalities
    main_lower = np.concatenate([scaled.variable_lower_bound,
                                 np.where(eq, -np.inf, 0.0)])
    main_upper = np.concatenate([scaled.variable_upper_bound,
                                 np.full(m, np.inf)])
    fleet_n = 2 * FLEET_NODES + 1
    fleet_lower = np.where(rng.random((384, fleet_n)) < 0.5, -np.inf, 0.0)
    fleet_upper = np.where(rng.random((384, fleet_n)) < 0.5, np.inf, 1.0)
    long_n = 300_000
    long_lower = np.where(rng.random(long_n) < 0.3, -np.inf, -rng.random(
        long_n))
    long_upper = np.where(rng.random(long_n) < 0.3, np.inf, rng.random(
        long_n))
    million_lower = np.zeros(2 * LARGE_NODES + 1)
    million_lower[LARGE_NODES] = -np.inf  # the equality row's dual
    million_upper = np.full(2 * LARGE_NODES + 1, np.inf)
    shapes = {
        "main_path": tr_inputs(torch, rng, 3, main_lower, main_upper, dev),
        "fleet": tr_inputs(torch, rng, 384, fleet_lower, fleet_upper, dev),
        "past_eight_blocks": tr_inputs(torch, rng, 1, long_lower,
                                       long_upper, dev, radii=(0.7,)),
        "million": tr_inputs(torch, rng, 3, million_lower, million_upper,
                             dev),
    }
    search = {"bits": trs.SEARCH_BITS, "K": 2 ** trs.SEARCH_BITS - 1,
              "trips": trs.SEARCH_TRIPS, "threads": trs.SEARCH_THREADS,
              "cluster_limit": trs.search_cluster_limit(dev),
              "active_clusters": trs.active_clusters(dev),
              "solution_wave": dict(zip(("sms", "blocks_an_sm"),
                                        trs.solution_wave(dev))),
              "sweep_wave": dict(zip(("sms", "blocks_an_sm"),
                                     trs.sweep_wave(dev)))}
    emit({"phase": "kernels_trust_region_plan", "ok": True, **search})
    ptrs = (compare.package_module("ops.trust_region_search", parent_dir)
            if parent_dir else None)
    variants, shape_times, timed_args = [], {}, None
    for label, (c, g, lower, upper, weight, radius) in shapes.items():
        rows, n = c.shape
        split = scaled.constraint_matrix.shape[1] if label == "main_path" \
            else n // 2
        outs = []
        for _ in range(2):
            t_star = trs.tr_search(c, g, lower, upper, weight, radius)
            outs.append((t_star, *trs.tr_solution(c, g, lower, upper,
                                                  weight, t_star, split)))
        plain_t = trs.tr_search_plain(
            trs.tr_prologue_plain(c, g, lower, upper, weight), radius)
        plain = (plain_t, *trs.tr_solution_plain(c, g, lower, upper, weight,
                                                 plain_t, split))
        torch.cuda.synchronize()
        plan = trs.device_search_plan(rows, n, dev)
        call = (lambda c=c, g=g, lower=lower, upper=upper, weight=weight,
                radius=radius: trs.tr_search(c, g, lower, upper, weight,
                                             radius))
        dev_ms, per_call = device_profile(call)
        bounds_rows = lower.shape[0] if lower.dim() == 2 else 1
        t_this = outs[0][0]
        solution_call = (lambda c=c, g=g, lower=lower, upper=upper,
                         weight=weight, t=t_this, split=split:
                         trs.tr_solution(c, g, lower, upper, weight, t,
                                         split))
        solution_ms, _ = device_profile(solution_call)
        blocks = trs.solution_blocks(rows, n, *trs.solution_wave(dev))
        shape_times[label] = {
            "device_ms": dev_ms, "kernels_per_call": per_call,
            "ms": time_ms(call),
            "bytes": tr_search_bytes(rows, n, bounds_rows),
            "tr_solution": {
                "device_ms": solution_ms,
                "blocks_a_row": blocks, "blocks": rows * blocks,
                "bytes": tr_solution_bytes(rows, n, bounds_rows)}}
        if ptrs is not None:
            parent_call = (lambda c=c, g=g, lower=lower, upper=upper,
                           weight=weight, radius=radius: ptrs.tr_search(
                               c, g, lower, upper, weight, radius))
            parent_bits = states_equal(parent_call(), plain_t)
            turns = probe_routed.in_turns({"this": call,
                                           "parent": parent_call})
            shape_times[label]["in_turns"] = {
                "this": probe_routed.turn_summary(turns["this"]),
                "parent": {**probe_routed.turn_summary(turns["parent"]),
                           "bitwise_equal": parent_bits}}
            parent_solution = (lambda c=c, g=g, lower=lower, upper=upper,
                               weight=weight, t=t_this, split=split:
                               ptrs.tr_solution(c, g, lower, upper, weight,
                                                t, split))
            parent_bits = states_equal(parent_solution(), solution_call())
            turns = probe_routed.in_turns({"this": solution_call,
                                           "parent": parent_solution})
            shape_times[label]["tr_solution"]["in_turns"] = {
                "this": probe_routed.turn_summary(turns["this"]),
                "parent": {**probe_routed.turn_summary(turns["parent"]),
                           "bitwise_equal": parent_bits}}
            if label == "million":
                shape_times[label]["replayed_in_turns"] = {
                    key: probe_routed.turn_summary(got) for key, got in
                    probe_routed.in_turns({
                        "this": replayed(torch, call),
                        "parent": replayed(torch, parent_call)}).items()}
        if plan == trs.WHOLE_CARD:
            shape_times[label]["live_share"] = live_share(
                torch, trs, c, g, lower, upper, weight, radius)
        variants.append({
            "shape": label, "rows": rows, "n": n,
            "bounds": list(lower.shape),
            "search_bitwise": states_equal(outs[0][0], plain[0]),
            "solution_bitwise": states_equal(outs[0][1:], plain[1:]),
            "repeat_bitwise": states_equal(outs[0], outs[1]),
            "cluster": plan.cluster, "whole_card": plan == trs.WHOLE_CARD,
            "smem_bytes": plan.smem_bytes,
            "sweep_blocks_a_row": trs.sweep_blocks(rows, n,
                                                   *trs.sweep_wave(dev)),
            "solution_blocks_a_row": blocks,
            "solution_blocks": rows * blocks,
            "tr_search_device_ms": dev_ms,
            "tr_solution_device_ms": solution_ms,
        })
        if label == "main_path":
            timed_args = (c, g, lower, upper, weight, radius, outs[0][0],
                          split)
    bad = [v for v in variants if not (v["search_bitwise"]
                                       and v["solution_bitwise"]
                                       and v["repeat_bitwise"])]
    if bad:
        fail("kernels_trust_region", f"kernel and plain version differ, or "
                                     f"two launches: {bad}")
    c, g, lower, upper, weight, radius, t_star, split = timed_args
    rows, n = c.shape
    tries, calls = [], {}
    want = trs.tr_search_plain(trs.tr_prologue_plain(
        c, g, lower, upper, weight), radius)
    plans = [trs.search_plan(rows, n, limit)
             for limit in (trs.MAX_CLUSTER, trs.WIDE_CLUSTER)
             if trs.active_clusters(dev)[limit] >= 1] + [trs.WHOLE_CARD]
    for plan in plans:
        key = (f"cluster{plan.cluster}" if plan != trs.WHOLE_CARD
               else "whole_card")
        calls[key] = (lambda plan=plan: trs.tr_search(
            c, g, lower, upper, weight, radius, plan=plan))
        tries.append({"key": key, **plan._asdict(),
                      "bitwise": states_equal(calls[key](), want)})
    if not all(t["bitwise"] for t in tries):
        fail("kernels_trust_region", f"a tr_search plan differs from the "
                                     f"plain version: {tries}")
    turns = {key: probe_routed.turn_summary(got) for key, got in
             probe_routed.in_turns(calls).items()}
    for t in tries:
        t.update(turns[t["key"]])
    inputs = 4 * (2 * rows * n + 3 * n + rows)  # c, g a row; l, u, w once
    rows_out = []
    for name, kernel, plain, nbytes, flops, replaces in (
        ("tr_search",
         lambda: trs.tr_search(c, g, lower, upper, weight, radius),
         lambda: trs.tr_search_plain(trs.tr_prologue_plain(
             c, g, lower, upper, weight), radius),
         # the inputs once, t* written; two multiplies and an add an entry
         # in each of the bisection's 33 passes (the totals, 31 trips, the
         # parts): the plain version's work
         inputs + 4 * rows, 33 * 3 * rows * n, TR_SEARCH_REPLACES),
        ("tr_solution",
         lambda: trs.tr_solution(c, g, lower, upper, weight, t_star, split),
         lambda: trs.tr_solution_plain(c, g, lower, upper, weight, t_star,
                                       split),
         tr_solution_bytes(rows, n, 1), 6 * rows * n,
         "none (no pl.pallas_call): XLA's fusion of "
         "firstorderlp_tpu/trust_region.py:107-108 (the solution and "
         "its value) and :406-416 (the lower and upper values)"),
    ):
        kernel()
        torch.cuda.synchronize()
        dev_ms, per_call = device_profile(kernel)
        row = {
            "name": name, "route": "cuda",
            "source": "firstorderlp_torch/csrc/trust_region_search.cu",
            "replaces": replaces, "max_abs_err": 0.0,
            "bitwise_equal": True,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=10,
                                                       warmup=1),
            "device_ms": dev_ms, "kernels_per_call": per_call,
            "bytes": nbytes, "flops": flops, "library_ms": None,
        }
        if name == "tr_search":
            row.update({"search": search, "shapes": shape_times,
                        "tries": tries})
            if parent_dir:
                row["parent"] = shape_times["main_path"]["in_turns"][
                    "parent"]
        else:
            row.update({"shapes": {key: times["tr_solution"] for key, times
                                   in shape_times.items()}})
            if parent_dir:
                row["parent"] = shape_times["main_path"]["tr_solution"][
                    "in_turns"]["parent"]
        rows_out.append(row)
    return rows_out, variants


STATS_REPLACES = {
    "stats_point": "none (no pl.pallas_call): XLA's fusion of the "
                   "evaluation point inline in _eval_block "
                   "(firstorderlp_tpu/models/pdhg.py:577, mirror_prox.py:238) "
                   "and the unscaling in firstorderlp_tpu/models/common.py:50",
    "stats_primal": "none (no pl.pallas_call): XLA's fusion of "
                    "firstorderlp_tpu/iteration_stats.py:62-262 over the "
                    "variables (evaluate_unscaled_stats, "
                    "firstorderlp_tpu/models/common.py:50)",
    "stats_dual": "none (no pl.pallas_call): XLA's fusion of "
                  "firstorderlp_tpu/iteration_stats.py:62-262 over the rows "
                  "and firstorderlp_tpu/termination.py:98-190",
}
STATS_SUM_BOUND = 2.0 ** -40  # times sum|t|: chains of at most 2^12 adds


def stats_bytes(name, items, ray):
    """F2e's or F2f's bytes bound over `items` entries: F2e reads x, A'y,
    c, l, u (and writes the ray), F2f reads y, A x, b (and A ray) and a
    byte a row."""
    if name == "stats_primal":
        return 4 * (5 + ray) * items
    return (4 * (3 + ray) + 1) * items


def large_stats_inputs(torch, dev):
    """The statistics kernels' inputs at the million-node matrix's shape
    (n = LARGE_NODES columns, m = n + 1 rows), made with numpy: F2e's and
    F2f's from seed 4 (bounds of every kind, a third of the rows
    equalities, the products normal vectors: the kernels take them as
    given), F2d's from seed 5 (an iterate, an average of 40 points and
    the rescaling)."""
    from firstorderlp_torch.ops import eval_stats as es

    rng = np.random.default_rng(4)
    n, m = LARGE_NODES, LARGE_NODES + 1

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    lower = np.where(rng.random(n) < 0.5, 0.0, -np.inf)
    upper = np.where(rng.random(n) < 0.4, 1.0 + rng.random(n), np.inf)
    x, y = rng.normal(size=n), rng.normal(size=m)
    scalars = es.Scalars(*(f32(v) for v in (0.25, 3.0, 2.0, 900.0, 800.0)),
                         torch.tensor(False, device=dev),
                         torch.tensor(80, dtype=torch.int64, device=dev),
                         torch.tensor(164.0, dtype=torch.float64, device=dev),
                         torch.tensor(0.0, dtype=torch.float64, device=dev))
    aty = f32(rng.normal(size=n))
    point_rng = np.random.default_rng(5)
    point = (f32(point_rng.normal(size=n)), f32(point_rng.normal(size=m)),
             f32(point_rng.uniform(0.5, 2.0, n)),
             f32(point_rng.uniform(0.5, 2.0, m)),
             es.Average(f32(point_rng.normal(size=n) * 4.0),
                        f32(point_rng.normal(size=m) * 4.0),
                        torch.tensor(40, device=dev),
                        torch.tensor(40, device=dev),
                        torch.tensor(4.0, device=dev),
                        torch.tensor(4.0, device=dev),
                        torch.tensor(False, device=dev)))
    return {"point": point, "primal": f32(x), "aty": aty,
            "vectors": (f32(rng.normal(size=n)), f32(lower), f32(upper)),
            "primal_norm": f32(np.max(np.abs(x))), "dual": f32(y),
            "ax": f32(rng.normal(size=m)), "aray": f32(rng.normal(size=m)),
            "rhs": f32(rng.normal(size=m)),
            "is_equality": torch.as_tensor(np.arange(m) < m // 3,
                                           device=dev),
            "scalars": scalars}


def point_bits(torch, point):
    """F2d's outputs as one int32 tensor of their bits (the scaled point
    where it is given)."""
    return torch.cat([t.reshape(-1).view(torch.int32) for t in point
                      if t is not None])


def stats_turns(torch, es, parent, dev, shapes, rules):
    """The statistics kernels at each shape (name -> large_stats_inputs'
    keys): F2d with its average and without, F2e and F2f the ray off and
    on; each kernel in turns with `parent`'s (another version's
    ops.eval_stats, when given) on the same inputs, three turns
    (probe_routed.in_turns), with its grid and bytes bound (F2d: the
    sums and the rescaling read, both points written; without the
    average the iterate and the rescaling read, the point written), and
    whether the parent's maxima and flags (F2f: its totals' maxima) and
    all its outputs have this version's bits (F2e's and F2f's sums add
    in another order; F2d's contract fixes them all)."""
    from firstorderlp_torch.ops import probe_routed

    out = {}
    versions = {"this": es, **({"parent": parent} if parent else {})}
    for label, inp in shapes.items():
        n, m = inp["primal"].shape[0], inp["dual"].shape[0]
        for avg in (True, False):
            args = inp["point"] if avg else (*inp["point"][:4], None)
            calls = {who: (lambda mod=mod: mod.stats_point(*args))
                     for who, mod in versions.items()}
            row = {who: probe_routed.turn_summary(got) for who, got in
                   probe_routed.in_turns(calls).items()}
            row["blocks"] = es.point_grid(n, m, *es.stats_wave(
                dev, "stats_point"))
            row["bytes"] = (16 if avg else 12) * (n + m)
            row["bound_ms"] = probe_routed.bound_ms(row["bytes"], 0)[0]
            if parent:
                row["parent_blocks"] = (
                    parent.point_grid(n, m, *parent.stats_wave(
                        dev, "stats_point"))
                    if hasattr(parent, "point_grid")
                    else parent.blocks(n + m))
                row["parent_same_bits"] = bool(torch.equal(
                    point_bits(torch, calls["this"]()),
                    point_bits(torch, calls["parent"]())))
            out[f"{label}_average_{'on' if avg else 'off'}_stats_point"] = row
        for ray in (False, True):
            r = dataclasses.replace(rules, ray=ray)
            ray_out, ptot = es.stats_primal(
                inp["primal"], inp["aty"], *inp["vectors"],
                inp["primal_norm"], ray)
            aray = inp["aray"] if ray else None
            primal_calls, dual_calls = {}, {}
            for who, mod in versions.items():
                primal_calls[who] = (
                    lambda mod=mod: mod.stats_primal(
                        inp["primal"], inp["aty"], *inp["vectors"],
                        inp["primal_norm"], ray))
                dual_calls[who] = (
                    lambda mod=mod: mod.stats_dual(
                        inp["dual"], inp["ax"], aray, inp["rhs"],
                        inp["is_equality"], ptot, inp["primal_norm"],
                        inp["scalars"], r))
            for name, calls, items in (("stats_primal", primal_calls, n),
                                       ("stats_dual", dual_calls, m)):
                turns = probe_routed.in_turns(calls)
                row = {who: probe_routed.turn_summary(got)
                       for who, got in turns.items()}
                row["blocks"] = es.stats_grid(items, *es.stats_wave(dev,
                                                                    name))
                row["bytes"] = stats_bytes(name, items, ray)
                row["bound_ms"] = probe_routed.bound_ms(row["bytes"], 0)[0]
                if parent:
                    row["parent_blocks"] = parent.stats_grid(
                        items, *parent.stats_wave(dev, name))
                    mine, theirs = calls["this"](), calls["parent"]()
                    if name == "stats_primal":
                        mine, theirs = mine[1], theirs[1]
                        flags = slice(len(es.PRIMAL_SUMS), None)
                    else:
                        mine = torch.cat([mine[0], mine[1].double(),
                                          mine[3].double()[None]])
                        theirs = torch.cat([theirs[0], theirs[1].double(),
                                            theirs[3].double()[None]])
                        flags = slice(len(es.DUAL_SUMS), len(es.DUAL_TOTALS))
                    row["parent_same_maxima_and_flags"] = bool(
                        torch.equal(mine[flags], theirs[flags]))
                    row["parent_same_bits"] = bool(torch.equal(mine, theirs))
                out[f"{label}_ray_{'on' if ray else 'off'}_{name}"] = row
    return out


def kernels_eval_stats(torch, problem, dev, time_ms, device_profile,
                       compare, parent_dir=None):
    """F2d stats_point, F2e stats_primal and F2f stats_dual
    (ops/eval_stats.py) on the main path's LP as optimize prepares it
    (the original copy's vectors, rescaling, norm cache and kernel
    operator), a scaled point and an average made with numpy from seed
    3, the products by B2 on the original operator, with infeasibility
    detection off (the main path's criteria) and on: the points, the ray
    and every maximum and flag bitwise the plain versions', each f64 sum
    within 2^-40 sum|t| of the plain one (the order of addition), the
    reason and every field bitwise the plain finalize of the kernels'
    totals, and a second launch bitwise the first with the tickets at
    zero. At the main path's criteria: times (CUDA events, device ms and
    kernels a call, the plain versions'), the bytes bound and ptxas's
    registers. All three also at the million-node matrix's shape (F2d
    with its average and without, F2e and F2f the ray off and on), in
    three turns with `parent_dir`'s version of them where given
    (stats_turns)."""
    from firstorderlp_torch.models import pdhg
    from firstorderlp_torch.ops import eval_stats as es

    params = make_params(1e-4, 20_000)
    bundle = pdhg.prepare_problem(params, problem, device=dev).bundle
    original = bundle.original
    op = original.constraint_matrix
    n = original.objective_vector.shape[0]
    m = original.right_hand_side.shape[0]
    rng = np.random.default_rng(3)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    x, y = f32(rng.normal(size=n)), f32(rng.normal(size=m))
    average = es.Average(f32(rng.normal(size=n) * 4.0),
                         f32(rng.normal(size=m) * 4.0),
                         scalar(40, torch.int64), scalar(40, torch.int64),
                         scalar(4.0, torch.float32),
                         scalar(4.0, torch.float32), scalar(False, torch.bool))
    cache = bundle.qp_cache
    scalars = es.Scalars(
        original.objective_constant, cache.l_inf_norm_primal_linear_objective,
        cache.l_inf_norm_primal_right_hand_side,
        cache.l2_norm_primal_linear_objective,
        cache.l2_norm_primal_right_hand_side, scalar(False, torch.bool),
        scalar(80, torch.int64), scalar(164.0, torch.float64),
        scalar(0.0, torch.float64))
    path_rules = es.criteria_of(params.termination_criteria)
    rules = {"main_path": path_rules,
             "infeasibility_on": dataclasses.replace(path_rules, ray=True)}
    vectors = (original.objective_vector, original.variable_lower_bound,
               original.variable_upper_bound)

    def run(rules):
        point = es.stats_point(x, y, bundle.variable_rescaling,
                               bundle.constraint_rescaling, average)
        ax, aty = op.mv(point.primal), op.rmv(point.dual)
        ray, primal_totals = es.stats_primal(
            point.primal, aty, *vectors, point.primal_norm, rules.ray)
        aray = op.mv(ray) if rules.ray else None
        dual = es.stats_dual(point.dual, ax, aray, original.right_hand_side,
                             original.is_equality, primal_totals,
                             point.primal_norm, scalars, rules)
        return point, ax, aty, ray, aray, primal_totals, dual

    def err(got, want):
        d = (got.double() - want.double()).abs()
        d = torch.where((got == want) | (torch.isnan(got) & torch.isnan(want)),
                        0.0, d)
        return float(d.max()) if d.numel() else 0.0

    def same(got, want):
        return err(got, want) == 0.0

    variants, errors, timed = [], {k: 0.0 for k in STATS_KERNELS}, None
    for label, r in rules.items():
        out = run(r)
        again = run(r)
        torch.cuda.synchronize()
        point, ax, aty, ray, aray, ptot, (dtot, conv, infeas, reason) = out
        plain_point = es.stats_point_plain(
            x, y, bundle.variable_rescaling, bundle.constraint_rescaling,
            average)
        plain_ray, sums, other = es.primal_terms(
            point.primal, aty, *vectors, point.primal_norm, r.ray)
        dsums, dother = es.dual_terms(point.dual, ax, aray,
                                      original.right_hand_side,
                                      original.is_equality)
        want_p = es.totals_from_terms(es.PRIMAL_TOTALS, sums, other,
                                      point.primal)
        want_d = es.totals_from_terms(es.DUAL_TOTALS, dsums, dother,
                                      point.dual)
        fin = es.stats_finalize_plain(ptot, dtot, point.primal_norm,
                                      scalars, r)

        def totals_ok(got, want, names, sums):
            for i, name in enumerate(names):
                if name in sums:
                    bound = STATS_SUM_BOUND * float(sums[name].double().abs()
                                                    .sum())
                    if not err(got[i], want[i]) <= bound:
                        return False
                elif not same(got[i], want[i]):
                    return False
            return True

        checks = {
            "point_bitwise": all(same(g, w) for g, w in zip(
                point, plain_point)),
            "ray_bitwise": ray is None or same(ray, plain_ray),
            "primal_totals_within_bound": totals_ok(
                ptot, want_p, es.PRIMAL_TOTALS, sums),
            "dual_totals_within_bound": totals_ok(
                dtot, want_d, es.DUAL_TOTALS, dsums),
            "finalize_bitwise": (same(conv, fin[0]) and same(infeas, fin[1])
                                 and int(reason) == int(fin[2])),
            "repeat_bitwise": all(
                same(g, w) for g, w in zip(*(
                    [t for t in (*o[0], *o[3:6], *o[6]) if t is not None]
                    for o in (out, again)))),
            "tickets_at_zero": not bool(es.tickets(dev).any()),
        }
        errors["stats_point"] = max(errors["stats_point"], max(
            err(g, w) for g, w in zip(point, plain_point)))
        errors["stats_primal"] = max(errors["stats_primal"], err(ptot, want_p))
        errors["stats_dual"] = max(errors["stats_dual"], err(dtot, want_d),
                                   err(conv, fin[0]), err(infeas, fin[1]))
        variants.append({"criteria": label, "ray": r.ray,
                         "reason": int(reason), **checks})
        if label == "main_path":
            timed = point, ax, aty, ptot
    bad = [v for v in variants if not all(
        v[k] for k in v if k.endswith(("bitwise", "bound", "zero")))]
    if bad:
        fail("kernels_eval_stats", f"a kernel and its plain version differ: "
                                   f"{bad}")
    point, ax, aty, ptot = timed
    r = rules["main_path"]
    calls = {
        "stats_point": (
            lambda: es.stats_point(x, y, bundle.variable_rescaling,
                                   bundle.constraint_rescaling, average),
            lambda: es.stats_point_plain(x, y, bundle.variable_rescaling,
                                         bundle.constraint_rescaling,
                                         average),
            # the sums and the rescaling read, both points written
            16 * (n + m), 3 * (n + m)),
        "stats_primal": (
            lambda: es.stats_primal(point.primal, aty, *vectors,
                                    point.primal_norm, False),
            lambda: es.stats_primal_plain(point.primal, aty, *vectors,
                                          point.primal_norm, False),
            # x, A'y, c, l, u read
            20 * n, 25 * n),
        "stats_dual": (
            lambda: es.stats_dual(point.dual, ax, None,
                                  original.right_hand_side,
                                  original.is_equality, ptot,
                                  point.primal_norm, scalars, r),
            lambda: es.stats_dual_plain(point.dual, ax, None,
                                        original.right_hand_side,
                                        original.is_equality, ptot,
                                        point.primal_norm, scalars, r),
            # y, A x, b read and a byte a row
            13 * m, 15 * m),
    }
    parent = (compare.package_module("ops.eval_stats", parent_dir)
              if parent_dir else None)
    main_shape = {"point": (x, y, bundle.variable_rescaling,
                            bundle.constraint_rescaling, average),
                  "primal": point.primal, "aty": aty, "vectors": vectors,
                  "primal_norm": point.primal_norm, "dual": point.dual,
                  "ax": ax, "aray": op.mv(point.primal),
                  "rhs": original.right_hand_side,
                  "is_equality": original.is_equality, "scalars": scalars}
    turns = stats_turns(torch, es, parent, dev,
                        {"100k": main_shape,
                         "1M": large_stats_inputs(torch, dev)}, r)
    usage = compare.ptxas_usage("stats_point")
    rows = []
    for name, (kernel, plain, nbytes, flops) in calls.items():
        kernel()
        torch.cuda.synchronize()
        dev_ms, per_call = device_profile(kernel)
        found = [u for k, u in usage.items() if f"{name}_kernel" in k]
        rows.append({
            "name": name, "route": "cuda",
            "source": "firstorderlp_torch/csrc/eval_stats.cu",
            "replaces": STATS_REPLACES[name],
            "max_abs_err": errors[name],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain, reps=10, warmup=1),
            "device_ms": dev_ms, "kernels_per_call": per_call,
            "bytes": nbytes, "flops": flops, "library_ms": None,
            "blocks": (es.point_grid(n, m, *es.stats_wave(dev, name))
                       if name == "stats_point" else
                       es.stats_grid(n if name == "stats_primal" else m,
                                     *es.stats_wave(dev, name))),
            **({"registers": found[0].get("registers")} if found else {}),
            "shapes": {key: row for key, row in turns.items()
                       if key.endswith(name)},
        })
        if parent_dir:
            rows[-1]["parent"] = turns[
                "100k_average_on_stats_point" if name == "stats_point"
                else f"100k_ray_off_{name}"]["parent"]
    return rows, variants


def trial_kernels_large(torch, n, m, dev, time_ms, device_profile):
    """F1a and F1b at the million-node matrix's shapes (n columns, m
    rows), on vectors made with numpy from seed 3 (a state whose trial is
    active and accepted), each bitwise its plain version, with device ms
    and CUDA-event ms beside a one-element fill_'s device time (the
    floor of any launch) and the bytes bound."""
    from firstorderlp_torch.ops import pdhg_step

    rng = np.random.default_rng(3)

    def vec(size):
        return torch.as_tensor(rng.standard_normal(size).astype(np.float32),
                               device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    x, c, aty = vec(n), vec(n), vec(n)
    lower = torch.full((n,), -1.0, device=dev)
    upper = torch.full((n,), 1.0, device=dev)
    f = pdhg_step.TrialFields(
        x=x, y=vec(m), delta_x=vec(n), delta_y=vec(m), aty=aty,
        sum_x=vec(n), sum_y=vec(m), count_x=scalar(37, torch.int64),
        count_y=scalar(37, torch.int64), weight_x=scalar(1.5, torch.float32),
        weight_y=scalar(1.5, torch.float32),
        step_size=scalar(1e-3, torch.float32),
        primal_weight=scalar(1.0, torch.float32),
        numerical_error=scalar(False, torch.bool),
        total=scalar(61, torch.int64), iteration=scalar(57, torch.int64),
        kkt=scalar(123.5, torch.float64))
    args = (x, c, aty, lower, upper, f.step_size, f.primal_weight,
            scalar(0, torch.int32), f.numerical_error, f.iteration,
            scalar(57, torch.int64), 40, 20_000, False)
    x_next, _, dx, _, active = pdhg_step.primal_step(*args)
    tail = (x_next, dx, vec(m), vec(n), scalar(1.0, torch.float32),
            scalar(1e-6, torch.float32), scalar(1.0, torch.float32), active,
            0.3, 0.6, False)
    one = torch.zeros(1, device=dev)
    empty_ms, _ = device_profile(lambda: one.fill_(0.0))
    rows = []
    for name, kernel, plain, nbytes, flops in (
        ("primal_step", lambda: pdhg_step.primal_step(*args),
         lambda: pdhg_step.primal_step_plain(*args),
         4 * 8 * n + 38, 8 * n),
        ("trial_epilogue", lambda: pdhg_step.trial_epilogue(f, *tail),
         lambda: pdhg_step.trial_epilogue_plain(f, *tail),
         4 * (8 * n + 6 * m) + 150, 2 * n + 3 * m + 30),
    ):
        same = states_equal(kernel(), plain())
        torch.cuda.synchronize()
        if not same:
            fail("kernels_tiled_large", f"{name}: kernel and plain version "
                                        "differ at the million-node shape")
        dev_ms, per_call = device_profile(kernel)
        rows.append({"name": name, "n": n, "m": m, "bitwise_equal": same,
                     "ms": time_ms(kernel), "device_ms": dev_ms,
                     "kernels_per_call": per_call,
                     "empty_kernel_device_ms": empty_ms,
                     "bytes": nbytes, "flops": flops})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--profile", action="store_true",
                        help="trace the warm main-path solve with "
                             "torch.profiler")
    parser.add_argument("--parent", metavar="DIR",
                        help="also solve the main path's LP at other "
                             "seeds (PDHG and Mirror Prox), the "
                             "heterogeneous fleet and the fleet's "
                             "throughput protocol by another version of "
                             "the package, held in DIR as "
                             "firstorderlp_torch_parent (phases "
                             "main_path_parent, hetero_parent, "
                             "fleet_parent)")
    parser.add_argument("--only", metavar="PHASES",
                        help="only the device and build phases and these "
                             "(comma-separated: evaluation_split, "
                             "kernels_trust_region, kernels_eval_stats, "
                             "kernels_trial, kernels_lane_trial), then the "
                             "last lines")
    parser.add_argument("--multi-gpu", action="store_true",
                        help="only the multi-device solve across four "
                             "cards (phase multi_gpu_path), after the "
                             "build")
    if sys.argv[1:2] == ["--distributed-worker"]:
        return distributed_worker(sys.argv[2:])
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
    from firstorderlp_torch import spans
    from firstorderlp_torch.models import pdhg

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
    from firstorderlp_torch import compile_meter

    try:
        with compile_meter.CompileWindow() as build_window:
            kernels_build.build_kernels()
    except RuntimeError as exc:
        fail("build", str(exc))
    ptxas = {
        lib: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for lib, log in kernels_build.last_build_log.items()
    }
    emit({"phase": "build", "ok": True,
          "seconds": kernels_build.last_build_seconds,
          "compile_meter": {"seconds": build_window.seconds,
                            "backend_seconds": build_window.backend_seconds},
          "ptxas": ptxas})

    if args.only:
        for phase in args.only.split(","):
            if phase == "evaluation_split":
                record = evaluation_split(torch, compare, args.parent, dev)
            elif phase == "kernels_trust_region":
                scaled = rescale_problem(
                    10, False, 1.0, 0,
                    generate_pagerank_lp(num_nodes=NODES, seed=0)).scaled_qp
                rows, variants = kernels_trust_region(
                    torch, scaled, dev, time_ms, device_profile, compare,
                    args.parent)
                for r in rows:
                    r["bound_ms"], r["bound_by"] = probe.bound_ms(
                        r["bytes"], r["flops"])
                record = {"phase": phase, "ok": True, "variants": variants,
                          "results": rows}
            elif phase == "kernels_trial":
                scaled = rescale_problem(
                    10, False, 1.0, 0,
                    generate_pagerank_lp(num_nodes=NODES, seed=0)).scaled_qp
                a64 = scaled.constraint_matrix.tocsr()
                ops = {"csr": routed.build_routed_op(a64, dev),
                       "tiled": routed.build_routed_op(a64, dev,
                                                       tile_aligned=True)}
                rows, variants = kernels_trial(
                    torch, routed, ops, scaled, dev, time_ms,
                    device_profile, compare, args.parent)
                for r in rows:
                    r["bound_ms"], r["bound_by"] = probe.bound_ms(
                        r["bytes"], r["flops"])
                record = {"phase": phase, "ok": True, "variants": variants,
                          "results": rows}
            elif phase == "kernels_lane_trial":
                rows = kernels_lane_trial(torch, compare)
                record = {"phase": phase + "_rows", "ok": True,
                          "results": rows}
            elif phase == "kernels_eval_stats":
                rows, variants = kernels_eval_stats(
                    torch, generate_pagerank_lp(num_nodes=NODES, seed=0),
                    dev, time_ms, device_profile, compare, args.parent)
                for r in rows:
                    r["bound_ms"], r["bound_by"] = probe.bound_ms(
                        r["bytes"], r["flops"])
                record = {"phase": phase, "ok": True, "variants": variants,
                          "results": rows}
            else:
                fail("only", f"no phase {phase} runs alone")
            emit(record)
            if not record["ok"]:
                raise SystemExit(1)
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count(),
        }}))
        return 0

    if args.multi_gpu:
        multi_gpu_path(torch, routed,
                       generate_pagerank_lp(num_nodes=NODES, seed=0),
                       make_params(1e-4, 20_000))
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count(),
        }}))
        return 0

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
        problem = compare.repeat_differs(lambda: call(mat),
                                         compare.tickets_of(mat))
        if problem:
            fail("kernels", f"{name}: {problem}")
        dev_ms, per_call = device_profile(lambda: call(mat))
        whole = routed.csr_with_items(mat, split_rows=False)
        stats = (compare.b2_launch_stats(mat) if name.startswith("spmv_csr")
                 else routed.csr_item_stats(mat))
        return {"device_ms": dev_ms, "kernels_per_call": per_call,
                "repeats_bitwise": compare.REPEATS,
                "ms_without_row_split": time_ms(lambda: call(whole)),
                "device_ms_without_row_split": device_ms(
                    lambda: call(whole)),
                **stats}

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

    # 3b. the trial's kernels around B3/B4 (B6/B7): F1a and F1b
    trial_rows, trial_variants = kernels_trial(
        torch, routed, {"csr": op, "tiled": top}, scaled, dev, time_ms,
        device_profile, compare, args.parent)
    add_bounds(trial_rows)
    emit({"phase": "kernels_trial", "ok": True, "m": m, "n": n,
          "tolerance": "bitwise equal to the plain versions",
          "variants": trial_variants, "results": trial_rows})

    # 3b. the exact trust region's kernels: F2b (with F2a) and F2c
    tr_rows, tr_variants = kernels_trust_region(torch, scaled, dev, time_ms,
                                                device_profile, compare,
                                                args.parent)
    add_bounds(tr_rows)
    emit({"phase": "kernels_trust_region", "ok": True,
          "tolerance": "bitwise equal to the plain versions, and to a "
                       "second launch",
          "variants": tr_variants, "results": tr_rows})

    # 3b. the evaluation's statistics kernels: F2d, F2e and F2f
    stats_rows, stats_variants = kernels_eval_stats(
        torch, problem, dev, time_ms, device_profile, compare, args.parent)
    add_bounds(stats_rows)
    emit({"phase": "kernels_eval_stats", "ok": True,
          "tolerance": "points, ray, maxima, flags and the finalize "
                       "bitwise the plain versions'; each f64 sum within "
                       "2^-40 sum|t| of the plain one; a second launch "
                       "bitwise",
          "variants": stats_variants, "results": stats_rows})
    del op, top, plan, mat, whole, lib, lib_a, lib_at

    # 3b'. B2-B7 again where the arrays are larger than the L2 cache
    large = kernels_tiled_large(torch, routed, probe, compare, device_ms, dev)
    add_bounds(large["results"])
    emit(large)
    for r in results + tiled:
        for big in large["results"]:
            if big["name"] == r["name"]:
                r["large"] = {k: big[k] for k in (
                    "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms", "plain_ms", "max_abs_err")}
    for r in trial_rows:
        for big in large["trial_kernels"]:
            if big["name"] == r["name"]:
                r["large"] = {k: big[k] for k in (
                    "ms", "device_ms", "bound_ms", "bound_by",
                    "empty_kernel_device_ms")}

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
    spans.reset_counts()
    t0 = time.time()
    out = optimize(params, problem, prepared=prepared)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    launches = dict(routed.LAUNCHES)
    main_segments = segment_counts(spans)
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
        # the solve's seconds include the capture's
        "segments": main_segments,
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
    trial_names = [r["name"] for r in trial_rows]
    if any(launches[k] <= 0 for k in csr_names + trial_names + list(
            TR_KERNELS + STATS_KERNELS)):
        problems.append(f"a kernel was not launched: {launches}")
    if (main_segments["replays"] != main_segments["steps"]
            or main_segments["eval_replays"]
            != main_segments["evaluations"]):
        problems.append(f"not every trial and evaluation was replayed: "
                        f"{main_segments}")
    if main_segments["loads"] != main_segments["unloads"]:
        problems.append(f"loads and unloads differ: {main_segments}")
    problems += exact_launches(torch, routed, pdhg, prepared.bundle,
                               prepared.initial_state,
                               pdhg._make_config(params), main_segments,
                               launches)
    main["host_launch_calls_per_evaluation"] = eval_host_calls(
        torch, pdhg, prepared.bundle, prepared.initial_state,
        pdhg._make_config(params))
    main["ok"] = not problems
    if problems:
        main["problems"] = problems
    emit(main)
    if problems:
        raise SystemExit(1)
    for r in results + trial_rows + tr_rows + stats_rows:
        key = r["name"]
        r["launches"] = launches[key]
        r["launches_per_iteration"] = launches[key] / out.iteration_count

    # The same solve again, warm (kernels and PyTorch's own modules
    # loaded), optionally under torch.profiler for the device busy time.
    warm = prepare_problem(params, problem, device=dev)
    torch.cuda.synchronize()
    spans.reset_counts()
    with timed(torch, args.profile) as warm_run:
        out2 = optimize(params, problem, prepared=warm)
    warm_s = warm_run["seconds"]
    record = {"phase": "main_path_warm", "ok": True,
              "iterations": out2.iteration_count,
              "solve_seconds": warm_s,
              "iterations_per_second": out2.iteration_count / warm_s,
              "segments": segment_counts(spans)}
    if args.profile:
        record["profile"] = warm_run["profile"]
    emit(record)
    warm_rec = record
    del prepared, warm

    # 4a. the evaluation and three segments replayed from CUDA graphs and
    # run eagerly
    record = segment_graph(torch, routed, problem, params,
                           make_mp_params(1e-4, 20_000), dev)
    emit(record)
    if not record["ok"]:
        raise SystemExit(1)
    # 4a'. the evaluation split by function, the parent's too
    record = evaluation_split(torch, compare, args.parent, dev)
    emit(record)
    if not record["ok"]:
        raise SystemExit(1)
    if args.parent:
        for parent_phase in (main_path_parent, hetero_parent):
            record = parent_phase(torch, compare, args.parent, dev)
            emit(record)
            if not record["ok"]:
                raise SystemExit(1)

    # 4b. the CLIs; their 100k-node .mps.gz stays for shard_ingest_path
    small = generate_pagerank_lp(num_nodes=DET_NODES, seed=0)
    lp_dir = tempfile.TemporaryDirectory()
    cli_rec = cli_path(torch, routed, problem, small, out, params, dev,
                       lp_dir.name)
    emit(cli_rec)
    if not cli_rec["ok"]:
        raise SystemExit(1)

    # 5. determinism
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
    inner_optimize = refine.api.optimize

    def logged_optimize(stage_params, stage_problem, **kwargs):
        t_stage = time.time()
        stage_out = inner_optimize(stage_params, stage_problem, **kwargs)
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
        refine.api.optimize = logged_optimize
        try:
            routed.reset_launch_counts()
            spans.reset_counts()
            with timed(torch, profile_on) as run:
                result = refine.optimize_iterative_refinement(
                    refine_params, problem, device=dev
                )
            for stage in stages:
                stage["begin"] -= run["t0"]
            return (result, run["seconds"], dict(routed.LAUNCHES),
                    run.get("profile"), segment_counts(spans))
        finally:
            refine.api.optimize = inner_optimize
            routed.DEFAULT_TILE_ALIGNED = False

    (rout, used_fallback), refine_s, refine_launches, _, refine_segments = (
        run_refine())
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
        # each shifted sub-solve's bundle is new: its own capture
        "segments": refine_segments,
    }
    problems = []
    if rec["reason"] != "TERMINATION_REASON_OPTIMAL":
        problems.append(f"reason {rec['reason']}")
    if any(not v <= 1e-8 for v in rres.values()):
        problems.append(f"host residuals {rres}")
    tiled_names = [r["name"] for r in tiled]
    if any(refine_launches[k] <= 0
           for k in tiled_names + trial_names + list(TR_KERNELS
                                                     + STATS_KERNELS)):
        problems.append(f"a tile-plan or trial kernel was not launched: "
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
    for r in trial_rows + tr_rows + stats_rows:
        r["launches_refine_path"] = refine_launches[r["name"]]
    if args.profile:
        # The same path again under torch.profiler (operators built anew,
        # kernels loaded): where its wall time goes.
        (pout, _), profiled_s, _, summary, _ = run_refine(profile_on=True)
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
    spans.reset_counts()
    t0 = time.time()
    mout = package_optimize(mp_params, problem, device=dev)
    torch.cuda.synchronize()
    mp_s = time.time() - t0
    mp_launches = dict(routed.LAUNCHES)
    mp_segments = segment_counts(spans)
    mstats = mout.iteration_stats[-1] if mout.iteration_stats else None
    mres = host_residuals(problem, mout.primal_solution, mout.dual_solution)
    iters = max(mout.iteration_count, 1)
    rec = {
        "phase": "mirror_prox_path", "nodes": NODES,
        "reason": mout.termination_reason.name,
        "iterations": mout.iteration_count,
        "kkt_passes": mstats.cumulative_kkt_matrix_passes if mstats else None,
        "seconds": mp_s, "host_f64": mres, "launches": mp_launches,
        "segments": mp_segments,
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
    others = [k for k in mp_launches if not k.startswith("spmv_csr:")
              and k not in TR_KERNELS + STATS_KERNELS]
    if any(mp_launches[k] != 0 for k in others) or not all(
            mp_launches[k] > 0 for k in TR_KERNELS + STATS_KERNELS):
        problems.append(f"another kernel was launched: {mp_launches}")
    # a read-back a segment, and the final statistics' one
    if (mp_segments["replays"] != mp_segments["steps"]
            or mp_segments["eval_replays"] != mp_segments["evaluations"]
            or mp_segments["read_backs"] != mp_segments["segments"] + 1):
        problems.append(f"iterations or evaluations not replayed, or read "
                        f"back more than once a segment: {mp_segments}")
    measured = mirror_prox.prepare_problem(mp_params, problem, device=dev)
    problems += exact_launches(torch, routed, mirror_prox, measured.bundle,
                               measured.initial_state,
                               mirror_prox._make_config(mp_params),
                               mp_segments, mp_launches)
    rec["host_launch_calls_per_evaluation"] = eval_host_calls(
        torch, mirror_prox, measured.bundle, measured.initial_state,
        mirror_prox._make_config(mp_params))
    del measured
    rec["ok"] = not problems
    if problems:
        rec["problems"] = problems
    emit(rec)
    if problems:
        raise SystemExit(1)
    for r in results:
        if r["name"] in ("spmv_csr:A", "spmv_csr:AT"):
            r["launches_mirror_prox"] = mp_launches[r["name"]]
    for r in tr_rows + stats_rows:
        r["launches_mirror_prox"] = mp_launches[r["name"]]
    # The same solve again without ingest (with --profile under
    # torch.profiler: device busy time, launches per iteration).
    t0 = time.time()
    mp_warm = mirror_prox.prepare_problem(mp_params, problem, device=dev)
    torch.cuda.synchronize()
    mp_prepare_s = time.time() - t0
    spans.reset_counts()
    with timed(torch, args.profile) as mp_run:
        pout = mirror_prox.optimize(mp_params, problem, prepared=mp_warm)
    record = {"phase": "mirror_prox_path_warm", "ok": True,
              "iterations": pout.iteration_count,
              "prepare_seconds": mp_prepare_s,
              "segments": segment_counts(spans),
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
                if not k.startswith("tiled_spmv:")
                and k not in TR_KERNELS + STATS_KERNELS)
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

    # 15-17. the heterogeneous, QP and constant-step fleets
    block_rows = slow_and_hetero_phases(
        torch, dev, compare, routed, probe,
        lambda p, prob: package_optimize(p, prob, device=dev),
    )

    # 18-20. the multi-device solve
    sharded_rows = kernels_sharded(torch, dev, routed, probe, compare,
                                   rescale_problem, problem)
    path_launches, sharded_solves = sharded_path(
        torch, dev, routed, problem, small, params,
        make_mp_params(1e-4, 20_000), main, warm_rec)
    distributed_path(torch, dev, routed, problem, small, params)

    # 21. row-sharded ingest, streaming cli_path's file
    ingest_launches = shard_ingest_path(
        torch, dev, routed, rescale_problem, small, params,
        os.path.join(lp_dir.name, "pagerank.mps.gz"), cli_rec,
        sharded_solves)
    lp_dir.cleanup()
    for r in sharded_rows:
        key = r["name"].split(" ")[0]
        cell = (r["layout"],) + tuple(r["mesh"])
        r["launches"] = path_launches[cell][key]
        if cell in ingest_launches:
            r["launches_shard_ingest"] = ingest_launches[cell][key]

    # 22. kernel list
    for r in tr_rows:
        r["launches_fleet"] = {ph: counts[r["name"]]
                               for ph, counts in _tr_launches.items()}
    results = (results + tiled + trial_rows + tr_rows + stats_rows + probes
               + lane_rows + block_rows + sharded_rows)
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
             "max_abs_err_vs_plain", "lanes", "kernels_per_call_turns",
             "variant", "lanes_a_thread", "unroll", "split_rows", "mesh",
             "layout", "single_device_ms", "max_abs_err_vs_single_device",
             "launches_a_call", "launches_shard_ingest", "design",
             "stages", "empty_rows", "smem_bytes", "registers",
             "static_smem_bytes", "bitwise_equal", "accepted",
             "launches_refine_path", "launches_fleet")
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
