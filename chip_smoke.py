#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (firstorderlp_torch) on one GPU.

Run from the root of the repository:

    python3 chip_smoke.py [--out FILE] [--profile]

Phases, each printing one JSON line:

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: compiles the CUDA kernels from firstorderlp_torch/csrc;
3. kernels: on the 100k-node PageRank LP (seed 0) after rescaling, each
   kernel against its plain PyTorch version on the card, with times
   (CUDA events, median of 100 runs after warm-up), the bound from the
   bytes each call must move, and the torch.sparse_csr_tensor product
   as the library yardstick;
   kernels_tiled: the same for the tile-plan kernels (tile_aligned=True),
   each also held against the CSR kernel on the same vectors;
4. main_path: firstorderlp_torch.optimize on that LP in f32 with the
   kernel operator, to OPTIMAL at 1e-4, with residuals recomputed in f64
   on the host and each kernel's launch count on that run;
   then the same solve warm (with --profile, under torch.profiler:
   device busy time and the ops that take it);
5. determinism: the 20k-node LP solved twice, both OPTIMAL with
   bitwise-equal results;
6. refine_path: firstorderlp_torch.optimize_iterative_refinement on the
   100k-node LP to OPTIMAL at 1e-8 with the f32 phases on the tile-plan
   kernels (ops.routed.DEFAULT_TILE_ALIGNED set for the phase),
   residuals and gap recomputed in f64 here, the tile-plan kernels'
   launch counts above 0 and the CSR kernels' at 0;
7. determinism_tiled: the 20k-node LP solved twice on the tile plan;
8. the kernel list ({"kernels": [...]}).

Then the `nvidia-smi` line and, last, {"ok": true, "device": {...}}.
Exits non-zero, before the last line, when there is no CUDA device or
any phase fails. Imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
TIMING_REPS = 100
TOL_ENTRY = 1e-5  # |d| <= TOL_ENTRY * (|A||x|)_i + TOL_ABS
TOL_ABS = 1e-7
TOL_SUM = 1e-5  # relative, on the reduced sums
NODES = 100_000  # the main path's PageRank LP
DET_NODES = 20_000  # the determinism phase's

_lines = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def fail(phase: str, message: str) -> None:
    emit({"phase": phase, "ok": False, "error": message})
    raise SystemExit(1)


def make_params(tol, limit, dtype="float32", fmt="routed"):
    """bench.py's make_params settings with tolerances: adaptive steps
    0.3/0.6, adaptive-normalized restarts, 10 Ruiz iterations +
    Pock-Chambolle alpha=1, an evaluation every 40 iterations."""
    from firstorderlp_torch import (
        AdaptiveStepsizeParams,
        PdhgParameters,
        RestartScheme,
        RestartToCurrentMetric,
        TerminationCriteria,
        construct_restart_parameters,
    )

    return PdhgParameters(
        l_inf_ruiz_iterations=10,
        l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0,
        primal_importance=1.0,
        scale_invariant_initial_primal_weight=True,
        verbosity=0,
        record_iteration_stats=False,
        termination_evaluation_frequency=40,
        termination_criteria=TerminationCriteria(
            eps_optimal_absolute=tol,
            eps_optimal_relative=tol,
            eps_primal_infeasible=0.0,
            eps_dual_infeasible=0.0,
            iteration_limit=limit,
        ),
        restart_params=construct_restart_parameters(
            restart_scheme=RestartScheme.ADAPTIVE_NORMALIZED,
            restart_to_current_metric=(
                RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED
            ),
            restart_frequency_if_fixed=100,
            artificial_restart_threshold=0.5,
            sufficient_reduction_for_restart=0.1,
            necessary_reduction_for_restart=0.9,
            primal_weight_update_smoothing=0.5,
            use_approximate_localized_duality_gap=False,
        ),
        step_size_policy_params=AdaptiveStepsizeParams(
            reduction_exponent=0.3, growth_exponent=0.6
        ),
        dtype=dtype,
        matrix_format=fmt,
        evaluations_per_dispatch=64,
    )


def time_ms(torch, fn, reps=TIMING_REPS, warmup=10) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


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
    primal_obj = problem.objective_constant + c @ x
    active = rc != 0.0
    dual_obj = (
        b @ y + problem.objective_constant
        + np.sum(np.where(active, bound, 0.0) * rc)
    )
    return {
        "rel_primal_residual": float(
            np.linalg.norm(viol) / (1.0 + np.linalg.norm(b))
        ),
        "rel_dual_residual": float(
            np.linalg.norm(dual_viol) / (1.0 + np.linalg.norm(c))
        ),
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
    host_events = profiler.key_averages()
    # Kernels only: an aten op's device time repeats its kernels'.
    events = [e for e in host_events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    return {
        "device_busy_seconds": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall_s,
        "kernel_launches": sum(e.count for e in events),
        "top_device_ops": [
            {"name": e.key[:60], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in sorted(events,
                            key=lambda e: -e.self_device_time_total)[:12]
        ],
        "top_host_ops": [
            {"name": e.key[:60], "calls": e.count,
             "host_ms": e.self_cpu_time_total / 1e3}
            for e in sorted(host_events,
                            key=lambda e: -e.self_cpu_time_total)[:12]
        ],
    }


def plan_bytes(plan) -> int:
    """Packed indices and values of every stored entry, padding
    included, the group table and the tile and strip pointers, each read
    once."""
    return (8 * plan.ngroups * plan.group + 16 * plan.ngroups
            + 4 * int(plan.tile_ptr.shape[0])
            + 4 * int(plan.strip_tile_ptr.shape[0]))


def csr_bytes(mat) -> int:
    """indptr, indices and values read once (the long-row tables are a
    few hundred bytes and left out)."""
    return 4 * (mat.num_rows + 1) + 8 * mat.nnz


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--profile", action="store_true",
                        help="trace the warm main-path solve with "
                             "torch.profiler")
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
    from firstorderlp_torch.models.pdhg import optimize, prepare_problem
    from firstorderlp_torch.ops import kernels_build, routed

    try:
        return run(args, torch, optimize, rescale_problem,
                   generate_pagerank_lp, prepare_problem, kernels_build,
                   routed, refine)
    finally:
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(_lines) + "\n")


def run(args, torch, optimize, rescale_problem, generate_pagerank_lp,
        prepare_problem, kernels_build, routed, refine) -> int:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Each phase names its layout itself, whatever FOLP_TILE_ALIGNED says.
    routed.DEFAULT_TILE_ALIGNED = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
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
    mbytes = {"A": csr_bytes(op.a), "AT": csr_bytes(op.at)}

    # spmv_csr, both orientations
    for label, mat, vec, scale, lib in (
        ("A", op.a, x, scale_ax, lib_a),
        ("AT", op.at, y, scale_aty, lib_at),
    ):
        mat_ns = routed._without_long_row_pass(mat)
        got = routed.spmv_csr(mat, vec)
        want = routed.spmv_csr_plain(mat, vec)
        got_ns = routed.spmv_csr(mat_ns, vec)
        torch.cuda.synchronize()
        err = entry_check(f"spmv_csr:{label}", got, want, scale)
        entry_check(f"spmv_csr:{label} (no long-row pass)", got_ns, want,
                    scale)
        nbytes = mbytes[label] + 4 * mat.num_cols + 4 * mat.num_rows
        results.append({
            "name": f"spmv_csr:{label}",
            "route": "cuda",
            "source": "firstorderlp_torch/csrc/spmv_csr.cu",
            "replaces": "firstorderlp_tpu/ops/routed.py:160 (_make_expand)"
                        " + routed.py:188 (_make_reduce)",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: routed.spmv_csr(mat, vec)),
            "ms_without_long_row_pass": time_ms(
                torch, lambda: routed.spmv_csr(mat_ns, vec)
            ),
            "plain_ms": time_ms(
                torch, lambda: routed.spmv_csr_plain(mat, vec)
            ),
            "bytes": nbytes,
            "flops": 2 * mat.nnz,
            "library_ms": time_ms(torch, lambda: lib @ vec),
            "nnz": mat.nnz,
            "rows": mat.num_rows,
            "tpr": mat.tpr,
            "long_rows": int(mat.long_rows.shape[0]),
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
            torch, lambda: routed.spmv_dual_step(op.a, x, y, b, eq, sigma)
        ),
        "plain_ms": time_ms(
            torch,
            lambda: routed.spmv_dual_step_plain(op.a, x, y, b, eq, sigma),
        ),
        "bytes": mbytes["A"] + 4 * n + 4 * 4 * m + 4,
        "flops": 2 * op.a.nnz + 7 * m,
        "library_ms": time_ms(torch, lambda: lib_a @ x),
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
            torch, lambda: routed.spmv_rmv_stats(op.at, y, dx, aty_old)
        ),
        "plain_ms": time_ms(
            torch, lambda: routed.spmv_rmv_stats_plain(op.at, y, dx, aty_old)
        ),
        "bytes": mbytes["AT"] + 4 * m + 3 * 4 * n + 8,
        "flops": 2 * op.at.nnz + 5 * n,
        "library_ms": time_ms(torch, lambda: lib_at @ y),
    })
    def add_bounds(rows):
        for r in rows:
            t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
            t_ops = r["flops"] / H100_F32_FLOPS * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"

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
        tiled.append({
            "name": f"tiled_spmv:{label}",
            "route": "cuda",
            "source": "firstorderlp_torch/csrc/tiled_spmv.cu",
            "replaces": "firstorderlp_tpu/ops/routed.py:347 (_make_fused)",
            "max_abs_err": err,
            "max_abs_err_vs_csr_kernel": err_csr,
            "ms": time_ms(torch, lambda: routed.tiled_spmv(plan, vec)),
            "plain_ms": time_ms(
                torch, lambda: routed.tiled_spmv_plain(plan, vec)
            ),
            "bytes": plan_bytes(plan) + 4 * plan.num_cols
            + 4 * plan.num_rows,
            "flops": 2 * plan.nnz,
            "library_ms": time_ms(torch, lambda: lib @ vec),
            "out_strip": plan.out_strip,
            "in_window": plan.in_window,
            "group": plan.group,
            "strips": plan.nstrips,
            "groups": plan.ngroups,
            "tiles": int(plan.tile_ptr.shape[0]) - 1,
            "padding_share": plan.padding_share,
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
    tiled.append({
        "name": "tiled_dual_step",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/tiled_dual_step.cu",
        "replaces": "firstorderlp_tpu/ops/routed.py:378 (_make_fused_dual)",
        "max_abs_err": err,
        "max_abs_err_vs_csr_kernel": err_csr,
        "ms": time_ms(
            torch, lambda: routed.tiled_dual_step(top.a, x, y, b, eq, sigma)
        ),
        "plain_ms": time_ms(
            torch,
            lambda: routed.tiled_dual_step_plain(top.a, x, y, b, eq, sigma),
        ),
        "bytes": plan_bytes(top.a) + 4 * n + 4 * 4 * m + 4,
        "flops": 2 * top.a.nnz + 7 * m,
        "library_ms": time_ms(torch, lambda: lib_a @ x),
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
    tiled.append({
        "name": "tiled_rmv_stats",
        "route": "cuda",
        "source": "firstorderlp_torch/csrc/tiled_rmv_stats.cu",
        "replaces": "firstorderlp_tpu/ops/routed.py:418 "
                    "(_make_fused_rmv_stats)",
        "max_abs_err": err,
        "max_abs_err_vs_csr_kernel": err_csr,
        "ms": time_ms(
            torch, lambda: routed.tiled_rmv_stats(top.at, y, dx, aty_old)
        ),
        "plain_ms": time_ms(
            torch,
            lambda: routed.tiled_rmv_stats_plain(top.at, y, dx, aty_old),
        ),
        "bytes": plan_bytes(top.at) + 4 * m + 3 * 4 * n + 8,
        "flops": 2 * top.at.nnz + 5 * n,
        "library_ms": time_ms(torch, lambda: lib_at @ y),
    })
    add_bounds(tiled)
    emit({"phase": ph, "ok": True, "m": m, "n": n, "nnz": int(a64.nnz),
          "plan_setup_seconds": plan_setup_s, "tolerance": tolerance,
          "results": tiled})
    del op, top, plan, mat, mat_ns, lib, lib_a, lib_at

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

    # 8. kernel list
    results = results + tiled
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("ms_without_long_row_pass", "launches_per_iteration",
             "max_abs_err_vs_csr_kernel", "padding_share")
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
