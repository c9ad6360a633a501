"""Times the tile-plan kernels on one GPU, optionally beside those of
another checkout of this package, in turns on the same card.

    python3 -m firstorderlp_torch.ops.compare_tiled [--nodes N]
        [--parent DIR] [--bulk] [--sweep] [--out FILE]

--parent DIR: a directory that holds another version of this package
  under the name `firstorderlp_torch_parent` (for example
  `git archive <commit> firstorderlp_torch | tar -x -C DIR` and a
  rename). Its kernels are built beside this package's and every product
  is timed parent, this, this, parent.
--bulk: the matrix of generators.pagerank_like_matrix (made in bulk)
  instead of the rescaled generate_pagerank_lp.
--sweep: this package's kernels again at other warps per block and
  other strip and group sizes.

Prints one JSON line per step, after the card's name and power limit:
what ptxas said of the tile-plan kernels, each kernel against its plain
version and against the CSR kernel on the same vectors (the tolerance of
chip_smoke.py), 20 launches bitwise equal, then per product the time of
one call (CUDA events around each call, median of 100: the wrapper's
host work included), the time per call of 50 calls enqueued back to back
(`burst_ms`), the device time per call of every kernel the call
launches, from torch.profiler (`device_ms`), the same three for the
one-call library product, and the bytes bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys

import numpy as np
import torch

from .. import generators
from ..preprocess import rescale_problem
from . import kernels_build, probe_routed, routed

TOL_ENTRY, TOL_ABS, TOL_SUM = 1e-5, 1e-7, 1e-5
BURST = 50


def burst_ms(fn, reps: int = 20) -> float:
    """Median time per call of BURST calls enqueued back to back."""
    for _ in range(BURST):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return float(np.median(times))


def device_ms(fn, calls: int = BURST) -> float:
    """Device time per call: every kernel's time under torch.profiler
    over `calls` calls, the library's and PyTorch's own included."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / calls


def products(mod, op, v):
    """name -> call, for one package's tile-plan operator."""
    return {
        "tiled_spmv:A": lambda: mod.tiled_spmv(op.a, v["x"]),
        "tiled_spmv:AT": lambda: mod.tiled_spmv(op.at, v["y"]),
        "tiled_dual_step": lambda: mod.tiled_dual_step(
            op.a, v["x"], v["y"], v["b"], v["eq"], v["sigma"]),
        "tiled_rmv_stats": lambda: mod.tiled_rmv_stats(
            op.at, v["y"], v["dx"], v["aty_old"]),
    }


def check(name, got, want, scale=None):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    err = np.abs(got - want)
    bound = (TOL_ENTRY * scale + TOL_ABS if scale is not None
             else TOL_SUM * np.abs(want) + TOL_ABS)
    if np.any(err > bound):
        raise SystemExit(f"{name}: differs by {float(np.max(err)):.3e}")
    return float(np.max(err))


def verify(op, csr, v, scales):
    """Every tile-plan kernel against its plain version and the CSR
    kernel; 20 launches of each bitwise equal."""
    errs = {}
    for label, plan, mat, vec in (("A", op.a, csr.a, v["x"]),
                                  ("AT", op.at, csr.at, v["y"])):
        got = routed.tiled_spmv(plan, vec)
        errs[f"tiled_spmv:{label}"] = max(
            check(f"tiled_spmv:{label}", got,
                  routed.tiled_spmv_plain(plan, vec), scales[label]),
            check(f"tiled_spmv:{label} vs csr", got,
                  routed.spmv_csr(mat, vec), scales[label]))
    args = (v["x"], v["y"], v["b"], v["eq"], v["sigma"])
    got = routed.tiled_dual_step(op.a, *args)
    for what, want in (("plain", routed.tiled_dual_step_plain(op.a, *args)),
                       ("csr", routed.spmv_dual_step(csr.a, *args))):
        errs["tiled_dual_step"] = check(
            f"tiled_dual_step vs {what}", got[0], want[0], scales["dual"])
    # The sum is held against its own y+ in f64: where one row's A z
    # cancels (the dense row), sum((y+ - y)^2) of two correct y+ differ
    # by more than any tolerance on a sum.
    check("tiled_dual_step dy2", got[1],
          torch.sum((got[0].double() - v["y"].double()) ** 2))
    args = (v["y"], v["dx"], v["aty_old"])
    got = routed.tiled_rmv_stats(op.at, *args)
    for what, want in (("plain", routed.tiled_rmv_stats_plain(op.at, *args)),
                       ("csr", routed.spmv_rmv_stats(csr.at, *args))):
        errs["tiled_rmv_stats"] = max(
            check(f"tiled_rmv_stats vs {what}", got[0], want[0],
                  scales["AT"]),
            check(f"tiled_rmv_stats dx2 vs {what}", got[2], want[2]))
        inter = abs(float(got[1]) - float(want[1]))
        if inter > TOL_ENTRY * scales["inter"] + TOL_ABS:
            raise SystemExit(f"tiled_rmv_stats interaction vs {what}: "
                             f"{inter:.3e}")
    for name, call in products(routed, op, v).items():
        first = call()
        first = first if isinstance(first, tuple) else (first,)
        for _ in range(19):
            again = call()
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise SystemExit(f"{name}: two launches differ")
    torch.cuda.synchronize()
    return errs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=100_000)
    parser.add_argument("--parent")
    parser.add_argument("--bulk", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_tiled: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    card = probe_routed.card_line()
    print(card, flush=True)
    kernels_build.build_kernels()
    emit({"step": "build", "seconds": kernels_build.last_build_seconds,
          "ptxas": {lib: [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln]
                    for lib, log in kernels_build.last_build_log.items()
                    if lib.startswith("tiled")}})

    rng = np.random.default_rng(0)
    if args.bulk:
        a64 = generators.pagerank_like_matrix(args.nodes, seed=0)
        rhs = rng.standard_normal(a64.shape[0])
        num_eq = 1
    else:
        problem = generators.generate_pagerank_lp(args.nodes, seed=0)
        scaled = rescale_problem(10, False, 1.0, 0, problem).scaled_qp
        a64 = scaled.constraint_matrix.tocsr()
        rhs, num_eq = scaled.right_hand_side, scaled.num_equalities
    m, n = a64.shape
    host = {"x": rng.standard_normal(n), "y": rng.standard_normal(m),
            "b": rhs, "dx": rng.standard_normal(n),
            "aty_old": rng.standard_normal(n)}
    host["eq"] = (np.arange(m) < num_eq).astype(np.float64)
    host = {k: a.astype(np.float32) for k, a in host.items()}
    v = {k: torch.as_tensor(a, device=dev) for k, a in host.items()}
    sigma = 0.37
    v["sigma"] = torch.full((), sigma, dtype=torch.float32, device=dev)
    abs_a = abs(a64)
    scales = {"A": abs_a @ np.abs(host["x"]).astype(np.float64),
              "AT": abs_a.T @ np.abs(host["y"]).astype(np.float64)}
    scales["dual"] = (np.abs(host["y"]) + sigma * np.abs(host["b"])
                      + sigma * scales["A"])
    csr = routed.build_routed_op(a64, dev, tile_aligned=False)
    op = routed.build_routed_op(a64, dev, tile_aligned=True)
    scales["inter"] = float(np.sum(np.abs(host["dx"]) * (
        abs_a.T @ np.abs(host["y"]) + np.abs(host["aty_old"]))))
    emit({"step": "verify", "card": card, "m": m, "n": n,
          "nnz": int(a64.nnz), "max_abs_err": verify(op, csr, v, scales),
          "plan_A": routed.tile_plan_stats(op.a),
          "plan_AT": routed.tile_plan_stats(op.at),
          "geometry": [op.a.out_strip, op.a.in_window, op.a.group],
          "padding_share": [op.a.padding_share, op.at.padding_share]})

    parent_calls = None
    if args.parent:
        sys.path.insert(0, args.parent)
        parent = importlib.import_module(
            "firstorderlp_torch_parent.ops.routed")
        parent_op = parent.build_routed_op(a64, dev, tile_aligned=True)
        parent_calls = products(parent, parent_op, v)
    lib = {"A": routed.library_spmv(csr.a), "AT": routed.library_spmv(csr.at)}
    lib_calls = {
        "tiled_spmv:A": lambda: lib["A"] @ v["x"],
        "tiled_spmv:AT": lambda: lib["AT"] @ v["y"],
        "tiled_dual_step": lambda: lib["A"] @ v["x"],
        "tiled_rmv_stats": lambda: lib["AT"] @ v["y"],
    }
    extra = {"tiled_spmv:A": 4 * (m + n), "tiled_spmv:AT": 4 * (m + n),
             "tiled_dual_step": 4 * n + 16 * m + 4,
             "tiled_rmv_stats": 4 * m + 12 * n + 8}
    time_ms = probe_routed.time_ms
    for name, call in products(routed, op, v).items():
        plan = op.a if name in ("tiled_spmv:A", "tiled_dual_step") else op.at
        row = {"step": "time", "name": name, "card": card}
        if parent_calls:
            old = parent_calls[name]
            row["parent_ms"] = [time_ms(old)]
            row["ms"] = [time_ms(call), time_ms(call)]
            row["parent_ms"].append(time_ms(old))
            row["parent_burst_ms"] = burst_ms(old)
            row["parent_device_ms"] = device_ms(old)
        else:
            row["ms"] = [time_ms(call), time_ms(call)]
        row["burst_ms"] = burst_ms(call)
        row["device_ms"] = device_ms(call)
        row["library_ms"] = time_ms(lib_calls[name])
        row["library_burst_ms"] = burst_ms(lib_calls[name])
        row["library_device_ms"] = device_ms(lib_calls[name])
        row["bound_ms"], row["bound_by"] = probe_routed.bound_ms(
            routed.tile_plan_bytes(plan) + extra[name], 2 * plan.nnz)
        emit(row)

    if args.sweep:
        for warps in (2, 4, 8, 16):
            if 4 * warps * op.a.out_strip > 200 * 1024:
                continue
            sw = dataclasses.replace
            op_w = routed.RoutedOp(a=sw(op.a, warps=warps),
                                   at=sw(op.at, warps=warps),
                                   tile_aligned=True)
            emit({"step": "sweep", "warps": warps, "device_ms": {
                k: device_ms(c) for k, c in products(routed, op_w, v).items()
            }})
        strip = op.a.out_strip
        for out_strip, group in ((strip, 128), (strip, 64), (strip, 32),
                                 (strip // 2, 128), (strip // 2, 64),
                                 (strip // 2, 32), (strip * 2, 128),
                                 (strip * 2, 64), (strip * 2, 32)):
            op_g = routed.build_routed_op(a64, dev, tile_aligned=True,
                                          out_strip=out_strip, group=group)
            emit({"step": "sweep", "out_strip": out_strip, "group": group,
                  "warps": op_g.a.warps,
                  "padding_share": op_g.a.padding_share,
                  "blocks": [op_g.a.nitems, op_g.at.nitems],
                  "device_ms": {k: device_ms(c) for k, c in
                                products(routed, op_g, v).items()}})
    if args.out:
        with open(args.out, "w") as f:
            f.write(card + "\n" + "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
