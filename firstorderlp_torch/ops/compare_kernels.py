"""Checks and times the kernel operator's kernels in one layout on one
GPU, optionally beside those of another checkout of this package, in
turns on the same card.

    python3 -m firstorderlp_torch.ops.compare_kernels
        [--layout csr|tiled|probe|lanes] [--nodes N] [--lanes B]
        [--parent DIR] [--bulk] [--sweep] [--out FILE]

--layout: the CSR kernels (spmv_csr, spmv_dual_step, spmv_rmv_stats;
  the default), the tile-plan kernels (tiled_spmv, tiled_dual_step,
  tiled_rmv_stats) or the probe's two kernels (probe_expand,
  probe_reduce) at the probe's default size (--nodes and --bulk do not
  apply), or the fleet's lane kernel (lanes_spmv, A and A') on the
  scaled value planes of a PageRank damping sweep of --lanes lanes
  (default 128) at --nodes nodes (default 20,000 for this layout;
  --bulk does not apply), beside the block-diagonal library SpMV
  (ops/lanes.library_lanes_matrix).
--parent DIR: a directory that holds another version of this package
  under the name `firstorderlp_torch_parent` (for example
  `git archive <commit> firstorderlp_torch | tar -x -C DIR` and a
  rename). Its kernels are built beside this package's, every product
  is timed in turns with this package's and the library's, and each
  product's outputs are compared bit for bit with the other version's.
--bulk: the matrix of generators.pagerank_like_matrix (made in bulk)
  instead of the rescaled generate_pagerank_lp.
--sweep: this package's kernels again at other item sizes and group
  widths (csr), at other warps per block and strip and group sizes
  (tiled), probe_reduce at other chunk counts and warps per block
  (probe), or lanes_spmv at other item sizes (lanes).

Prints one JSON line per step, after the card's name and power limit:
what ptxas said of the layout's kernels; each kernel against its plain
version (tiled: also against the CSR kernel on the same vectors; probe:
probe_expand bitwise, probe_reduce in f64) with the tolerance of
chip_smoke.py, REPEATS launches bitwise equal and the tickets back at
zero; with --parent, which products give the other
version's bits; then per product, one value for each of three turns
(probe_routed.in_turns), the time of one call (`ms`: CUDA events around
each call, median of 100, the wrapper's host work included) and the
device time per call from torch.profiler (`device_ms`), with the kernels
launched per call, and the time per call of 50 calls enqueued back to
back (`burst_ms`), each also for the other version (`parent_*`) and the
one-call library product (`library_*`); the bytes bound; csr: also the
device time and events time of the product with no row cut into pieces
(`*_without_row_split`); last (csr, tiled) the tails, turn by turn: the
fused kernels' device time over the product's on the same matrix.
Lanes: one "time" line per orientation (lanes_row, which chip_smoke.py
shares) with the checks and the times in one. Kernels a call are counted
at their launches on the host, and the device time of the kernels the
profiler kept is scaled to them (probe_routed.device_profile).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
from typing import Optional

import numpy as np
import torch

from .. import generators
from ..preprocess import rescale_problem
from . import kernels_build, probe_routed, routed
from .probe_routed import device_profile

TOL_ENTRY, TOL_ABS, TOL_SUM = 1e-5, 1e-7, 1e-5
BURST = 50
REPEATS = 20
# layout -> its (product, dual step, rmv stats) kernels
KERNELS = {"csr": ("spmv_csr", "spmv_dual_step", "spmv_rmv_stats"),
           "tiled": ("tiled_spmv", "tiled_dual_step", "tiled_rmv_stats")}


def package_module(module: str, parent_dir: Optional[str] = None):
    """`module` ("" for the package, "ops.routed", ...) of this package,
    or, given `parent_dir`, of the version of it that the directory holds
    as `firstorderlp_torch_parent`."""
    root = "firstorderlp_torch"
    if parent_dir:
        if parent_dir not in sys.path:
            sys.path.insert(0, parent_dir)
        root = "firstorderlp_torch_parent"
    return importlib.import_module(".".join(filter(None, (root, module))))


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
    """Device time per call (device_profile)."""
    return device_profile(fn, calls)[0]


def repeat_differs(call, tickets=(), times: int = REPEATS):
    """None when `times` calls of `call` return the same bits and every
    tensor of `tickets` is zero after them; else what went wrong."""
    def outputs():
        out = call()
        return out if isinstance(out, tuple) else (out,)

    first = outputs()
    for k in range(1, times):
        differ = [int(torch.count_nonzero(u != v))
                  for u, v in zip(first, outputs())]
        if any(differ):
            return f"launch {k + 1} differs from the first in {differ} entries"
    if first[0].is_cuda:
        torch.cuda.synchronize()
    if any(bool(t.any()) for t in tickets):
        return "a ticket is not back at zero"
    return None


def products(mod, op, v, layout):
    """name -> call, for one package's operator in `layout`."""
    spmv, dual, stats = KERNELS[layout]
    return {
        f"{spmv}:A": lambda: getattr(mod, spmv)(op.a, v["x"]),
        f"{spmv}:AT": lambda: getattr(mod, spmv)(op.at, v["y"]),
        dual: lambda: getattr(mod, dual)(
            op.a, v["x"], v["y"], v["b"], v["eq"], v["sigma"]),
        stats: lambda: getattr(mod, stats)(
            op.at, v["y"], v["dx"], v["aty_old"]),
    }


def probe_products(mod, d, plan):
    """name -> call of the probe's two kernels in `mod` (a probe_routed
    module) on the probe's inputs `d` (make_probe_inputs, as tensors);
    `plan`: the reduce's chunk table, from `mod`."""
    g = d["g2"].reshape(-1, 128)
    return {
        "probe_expand": lambda: mod.probe_expand(
            d["strip_ids"], d["x_strips"], d["hi"], d["lo"]),
        "probe_reduce": lambda: mod.probe_reduce(
            d["meta"], g, d["v"], d["hir"], d["lor"], mod.N_STRIPS,
            plan=plan),
    }


def check(name, got, want, scale=None):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    err = np.abs(got - want)
    bound = (TOL_ENTRY * scale + TOL_ABS if scale is not None
             else TOL_SUM * np.abs(want) + TOL_ABS)
    if np.any(err > bound):
        raise SystemExit(f"{name}: differs by {float(np.max(err)):.3e}")
    return float(np.max(err))


def verify(layout, op, csr, v, scales):
    """Every kernel of `layout` against its plain version (tiled: and
    against the CSR kernel of `csr`); REPEATS launches of each bitwise
    equal, the tickets at zero after them."""
    spmv, dual, stats = KERNELS[layout]

    def wants(kernel, mat, csr_mat, args):
        out = [("plain", getattr(routed, kernel + "_plain")(mat, *args))]
        if layout == "tiled":
            twin = KERNELS["csr"][KERNELS["tiled"].index(kernel)]
            out.append(("csr", getattr(routed, twin)(csr_mat, *args)))
        return out

    errs = {}
    for label, mat, cmat, vec in (("A", op.a, csr.a, v["x"]),
                                  ("AT", op.at, csr.at, v["y"])):
        got = getattr(routed, spmv)(mat, vec)
        errs[f"{spmv}:{label}"] = max(
            check(f"{spmv}:{label} vs {what}", got, want, scales[label])
            for what, want in wants(spmv, mat, cmat, (vec,)))
    args = (v["x"], v["y"], v["b"], v["eq"], v["sigma"])
    got = getattr(routed, dual)(op.a, *args)
    errs[dual] = max(check(f"{dual} vs {what}", got[0], want[0],
                           scales["dual"])
                     for what, want in wants(dual, op.a, csr.a, args))
    # The sum is held against its own y+ in f64: where one row's A z
    # cancels (the dense row), sum((y+ - y)^2) of two correct y+ differ
    # by more than any tolerance on a sum.
    check(f"{dual} dy2", got[1],
          torch.sum((got[0].double() - v["y"].double()) ** 2))
    args = (v["y"], v["dx"], v["aty_old"])
    got = getattr(routed, stats)(op.at, *args)
    errs[stats] = 0.0
    for what, want in wants(stats, op.at, csr.at, args):
        errs[stats] = max(
            errs[stats],
            check(f"{stats} vs {what}", got[0], want[0], scales["AT"]),
            check(f"{stats} dx2 vs {what}", got[2], want[2]))
        inter = abs(float(got[1]) - float(want[1]))
        if inter > TOL_ENTRY * scales["inter"] + TOL_ABS:
            raise SystemExit(f"{stats} interaction vs {what}: {inter:.3e}")
    for name, call in products(routed, op, v, layout).items():
        problem = repeat_differs(call, (op.a.tickets, op.at.tickets))
        if problem:
            raise SystemExit(f"{name}: {problem}")
    return errs


def sweep_csr(op, v, emit):
    def width(tpr, factor):
        return int(min(max(tpr * factor, 2), 32))

    for entries in (256, 512, 1024, 2048, 4096, 8192):
        for factor in (0.5, 1, 2):
            op_s = routed.RoutedOp(
                a=routed.csr_with_items(op.a, entries,
                                        tpr=width(op.a.tpr, factor)),
                at=routed.csr_with_items(op.at, entries,
                                         tpr=width(op.at.tpr, factor)))
            emit({"step": "sweep", "item_entries": entries,
                  "tpr": [op_s.a.tpr, op_s.at.tpr],
                  "blocks": [op_s.a.nitems, op_s.at.nitems],
                  "device_ms": {
                      k: device_ms(c)
                      for k, c in products(routed, op_s, v, "csr").items()}})


def sweep_tiled(a64, op, v, emit):
    for warps in (2, 4, 8, 16):
        if 4 * warps * op.a.out_strip > 200 * 1024:
            continue
        sw = dataclasses.replace
        op_w = routed.RoutedOp(a=sw(op.a, warps=warps),
                               at=sw(op.at, warps=warps), tile_aligned=True)
        emit({"step": "sweep", "warps": warps, "device_ms": {
            k: device_ms(c)
            for k, c in products(routed, op_w, v, "tiled").items()}})
    strip = op.a.out_strip
    for out_strip in (strip, strip // 2, strip * 2):
        for group in (128, 64, 32):
            op_g = routed.build_routed_op(a64, op.a.device, tile_aligned=True,
                                          out_strip=out_strip, group=group)
            emit({"step": "sweep", "out_strip": out_strip, "group": group,
                  "warps": op_g.a.warps,
                  "padding_share": op_g.a.padding_share,
                  "blocks": [op_g.a.nitems, op_g.at.nitems],
                  "device_ms": {
                      k: device_ms(c)
                      for k, c in products(routed, op_g, v, "tiled").items()
                  }})


def sweep_probe(d, emit):
    probe = probe_routed
    for target in (33, 66, 132, 264, 528):
        plan = probe.plan_probe_reduce(d["meta"], probe.N_STRIPS, target)
        for warps in (1, 2, 4, 8, 11):
            call = probe_products(probe, d, dataclasses.replace(
                plan, warps=warps))["probe_reduce"]
            emit({"step": "sweep", "target_chunks": target,
                  "chunks": plan.nchunks, "warps": warps,
                  "max_rel_err": reduce_error(d, call()),
                  "device_ms": device_ms(call)})


def reduce_error(d, y):
    """probe_reduce's largest error against its plain version in f64,
    over (max |y| + 1)."""
    want = probe_routed.probe_reduce_plain(
        d["meta"], d["g2"].reshape(-1, 128).double(), d["v"].double(),
        d["hir"], d["lor"], probe_routed.N_STRIPS)
    return float((y.double() - want).abs().max()) / (
        float(want.abs().max()) + 1.0)


def same_bits(this_calls, parent_calls):
    """name -> whether the two versions' calls give the same bits."""
    same = {}
    for name, call in this_calls.items():
        mine, theirs = call(), parent_calls[name]()
        mine = mine if isinstance(mine, tuple) else (mine,)
        theirs = theirs if isinstance(theirs, tuple) else (theirs,)
        same[name] = all(torch.equal(u, w) for u, w in zip(mine, theirs))
    return same


def time_in_turns(this_calls, lib_calls, parent_calls, bounds, card, emit,
                  whole_calls=None):
    """One "time" line a call (in_turns with the library's call and the
    parent's, burst_ms, the bound); name -> {who: device ms a turn}."""
    device = {}
    for name, call in this_calls.items():
        row = {"step": "time", "name": name, "card": card}
        turns = {"this": call, "library": lib_calls[name]}
        if parent_calls:
            turns = {"parent": parent_calls[name], **turns}
        timed = probe_routed.in_turns(turns)
        for who, got in timed.items():
            prefix = "" if who == "this" else f"{who}_"
            for key, value in got.items():
                row[prefix + key] = value
            row[prefix + "burst_ms"] = burst_ms(turns[who])
        device[name] = {who: got["device_ms"] for who, got in timed.items()}
        if whole_calls:
            row["ms_without_row_split"] = probe_routed.time_ms(
                whole_calls[name])
            row["device_ms_without_row_split"] = device_ms(whole_calls[name])
        row["bound_ms"], row["bound_by"] = bounds[name]
        emit(row)
    return device


def compare_probe(args, dev, card, emit):
    """--layout probe: P1 and P2 checked, against the parent's bits,
    timed in turns and (--sweep) P2 swept."""
    probe = probe_routed
    d = {k: torch.as_tensor(a, device=dev)
         for k, a in probe.make_probe_inputs(probe.DEFAULT_NNZ,
                                             seed=0).items()}
    plan = probe.plan_probe_reduce(d["meta"], probe.N_STRIPS)
    this_calls = probe_products(probe, d, plan)
    eargs = (d["strip_ids"], d["x_strips"], d["hi"], d["lo"])
    errs = {"probe_expand": float((this_calls["probe_expand"]()
                                   - probe.probe_expand_plain(*eargs))
                                  .abs().max()),
            "probe_reduce": reduce_error(d, this_calls["probe_reduce"]())}
    if errs["probe_expand"] != 0.0 or not errs["probe_reduce"] <= TOL_SUM:
        raise SystemExit(f"probe kernels against their plain versions: "
                         f"{errs}")
    for name, call in this_calls.items():
        problem = repeat_differs(call, (plan.tickets,))
        if problem:
            raise SystemExit(f"{name}: {problem}")
    emit({"step": "verify", "layout": "probe", "card": card,
          "nnz": probe.DEFAULT_NNZ, "max_err": errs,
          "chunks": plan.nchunks, "warps": plan.warps,
          "bytes_beyond_inputs": probe.reduce_scratch_bytes(plan)})
    parent_calls = None
    if args.parent:
        old = package_module("ops.probe_routed", args.parent)
        parent_calls = probe_products(
            old, d, old.plan_probe_reduce(d["meta"], probe.N_STRIPS))
        emit({"step": "bitwise_equal_to_parent",
              "equal": same_bits(this_calls, parent_calls),
              "parent_max_err": {
                  "probe_reduce": reduce_error(
                      d, parent_calls["probe_reduce"]())}})
    g = d["g2"].reshape(-1, 128)
    flat = probe.flat_slots(d["meta"][:, 0], d["hir"], d["lor"],
                            probe.HR).reshape(-1)
    hi64, lo64 = d["hi"].long(), d["lo"].long()
    lib_calls = {
        "probe_expand": lambda: probe.library_expand(
            d["strip_ids"], d["x_strips"], hi64, lo64),
        "probe_reduce": lambda: probe.library_reduce(
            flat, g, d["v"], probe.N_STRIPS),
    }
    rargs = (d["meta"], g, d["v"], d["hir"], d["lor"], probe.N_STRIPS)
    bounds = {
        "probe_expand": probe.bound_ms(probe.expand_bytes(*eargs), 0),
        "probe_reduce": probe.bound_ms(probe.reduce_bytes(*rargs),
                                       2 * g.numel()),
    }
    time_in_turns(this_calls, lib_calls, parent_calls, bounds, card, emit)
    if args.sweep:
        sweep_probe(d, emit)


class KernelMismatch(RuntimeError):
    """A kernel disagrees with its plain version or does not repeat its
    bits."""


def check_lanes(label, half, vals, v):
    """L1 (ops/lanes.lanes_spmv) on one orientation of a fleet ("A": `half`
    is the pattern's fwd, "AT": its bwd), its value planes `vals` and lane
    vectors `v`: against the f64 product entry by entry and against its
    plain version (TOL_ENTRY, TOL_ABS), REPEATS launches bitwise equal
    with the tickets back at zero, and the block-diagonal library SpMV
    against the f64 product. The errors as a row; raises KernelMismatch."""
    from . import lanes

    name = f"lanes_spmv:{label}"
    got = lanes.lanes_spmv(half, vals, v)
    plain = lanes.lanes_spmv_plain(half, vals, v)
    f64 = lanes.lanes_spmv_plain(half, vals.double(), v.double())
    scale = lanes.lanes_spmv_plain(half, vals.double().abs(),
                                   v.double().abs())
    err = (got.double() - f64).abs()
    bad = err > TOL_ENTRY * scale + TOL_ABS
    if bool(bad.any()):
        raise KernelMismatch(f"{name}: {int(bad.sum())} entries off the f64 "
                             f"product, max |d| {float(err.max()):.3e}")
    err_plain = float((got - plain).abs().max())
    if err_plain > TOL_ENTRY * float(scale.max()) + TOL_ABS:
        raise KernelMismatch(f"{name}: max |d| {err_plain:.3e} against its "
                             "plain version")
    problem = repeat_differs(lambda: lanes.lanes_spmv(half, vals, v),
                             (half.tickets,))
    if problem:
        raise KernelMismatch(f"{name}: {problem}")
    lib = lanes.library_lanes_matrix(half, vals) @ v.reshape(-1)
    return {"name": name,
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / (scale + 1e-30)).max()),
            "max_abs_err_vs_plain": err_plain,
            "library_max_abs_err": float(
                (lib.reshape(-1, v.shape[1]).double() - f64).abs().max()),
            "repeats_bitwise": REPEATS}


def lanes_row(label, half, vals, v, parent_call=None):
    """check_lanes, then L1 timed in turns (probe_routed.in_turns) beside
    the block-diagonal library SpMV and `parent_call`, another version's
    launch, if given; with its plain
    version's time, its bound and its work items. The row of
    chip_smoke.py's kernels_lanes and of --layout lanes."""
    from . import lanes

    row = check_lanes(label, half, vals, v)
    nl = v.shape[1]
    lib = lanes.library_lanes_matrix(half, vals)
    flat = v.reshape(-1)
    turns = {"this": lambda: lanes.lanes_spmv(half, vals, v),
             "library": lambda: lib @ flat}
    if parent_call is not None:
        turns = {"parent": parent_call, **turns}
    for who, got in probe_routed.in_turns(turns).items():
        prefix = "" if who == "this" else f"{who}_"
        row.update({prefix + k: value for k, value in
                    probe_routed.turn_summary(got).items()})
        row[prefix + "burst_ms"] = burst_ms(turns[who])
    sizes = np.diff(half.items.cpu().numpy()[:, 0])
    row.update({
        "plain_ms": probe_routed.time_ms(
            lambda: lanes.lanes_spmv_plain(half, vals, v)),
        "bytes": lanes.lanes_kernel_bytes(half, nl, v.element_size()),
        "flops": 2 * half.nnz * nl,
        "lanes": nl, "nnz": half.nnz, "rows": half.num_rows,
        "blocks": half.nitems, "item_entries": half.item_entries,
        "entries_per_block_max": int(sizes.max()),
        "entries_per_block_mean": float(sizes.mean()),
    })
    row["bound_ms"], row["bound_by"] = probe_routed.bound_ms(row["bytes"],
                                                             row["flops"])
    return row


def compare_lanes(args, dev, card, emit):
    """--layout lanes: L1 on a fleet's scaled planes, checked, against
    the parent's bits, timed in turns with the block-diagonal library
    SpMV (lanes_row) and (--sweep) at other item sizes."""
    from .. import batch
    from . import lanes

    nodes, nl = args.nodes or 20_000, args.lanes
    spec = generators.pagerank_fleet_spec(
        nodes, np.linspace(0.7, 0.995, nl), seed=0)
    pat = batch._canonical_csr(spec.base_problem.constraint_matrix)
    m, n = pat.shape
    pattern = lanes.build_lanes_pattern(pat, dev)
    v_orig, vectors, _ = batch._spec_lanes(spec, torch.float32, dev,
                                           (m, n, pat.nnz))
    op = lanes.lanes_op(pattern, batch.fleet_rescale(
        pattern, v_orig, vectors, 10, False, 1.0).v)
    rng = np.random.default_rng(0)
    vecs = {"A": torch.as_tensor(rng.standard_normal((n, nl)),
                                 device=dev).float(),
            "AT": torch.as_tensor(rng.standard_normal((m, nl)),
                                  device=dev).float()}

    def calls(mod, pat_obj):
        return {
            "lanes_spmv:A": lambda: mod.lanes_spmv(pat_obj.fwd, op.vals,
                                                   vecs["A"]),
            "lanes_spmv:AT": lambda: mod.lanes_spmv(pat_obj.bwd, op.vals_t,
                                                    vecs["AT"]),
        }

    emit({"step": "fleet", "layout": "lanes", "card": card, "m": m,
          "n": n, "nnz": pat.nnz, "lanes": nl})
    parent_calls = {}
    if args.parent:
        old = package_module("ops.lanes", args.parent)
        parent_calls = calls(old, old.build_lanes_pattern(pat, dev))
        emit({"step": "bitwise_equal_to_parent",
              "equal": same_bits(calls(lanes, pattern), parent_calls)})
    for label, half, vals in (("A", pattern.fwd, op.vals),
                              ("AT", pattern.bwd, op.vals_t)):
        row = lanes_row(label, half, vals, vecs[label],
                        parent_calls.get(f"lanes_spmv:{label}"))
        emit({"step": "time", "card": card, **row})
    if args.sweep:
        for entries in (16, 32, 64, 128, 256, 512, 2048):
            swept = lanes.build_lanes_pattern(pat, dev, item_entries=entries)
            row = {"step": "sweep", "item_entries": entries, "card": card}
            for name, call in calls(lanes, swept).items():
                row[name] = {"device_ms": device_ms(call),
                             "blocks": (swept.fwd if name.endswith(":A")
                                        else swept.bwd).nitems}
            emit(row)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layout",
                        choices=sorted(KERNELS) + ["probe", "lanes"],
                        default="csr")
    parser.add_argument("--nodes", type=int, default=None,
                        help="default 100,000 (20,000 for lanes)")
    parser.add_argument("--lanes", type=int, default=128)
    parser.add_argument("--parent")
    parser.add_argument("--bulk", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    layout, tiled = args.layout, args.layout == "tiled"
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    card = probe_routed.card_line()
    print(card, flush=True)
    kernels_build.build_kernels()
    names = {"probe": probe_routed.LAUNCHES,
             "lanes": ("lanes_spmv",)}.get(layout) or KERNELS[layout]
    emit({"step": "build", "layout": layout,
          "seconds": kernels_build.last_build_seconds,
          "ptxas": {lib: [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln]
                    for lib, log in kernels_build.last_build_log.items()
                    if lib in names}})
    if layout == "probe":
        compare_probe(args, dev, card, emit)
        return finish(args, card, lines)
    if layout == "lanes":
        compare_lanes(args, dev, card, emit)
        return finish(args, card, lines)
    args.nodes = args.nodes or 100_000

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
    scales["inter"] = float(np.sum(np.abs(host["dx"]) * (
        scales["AT"] + np.abs(host["aty_old"]))))
    csr = routed.build_routed_op(a64, dev, tile_aligned=False)
    op = routed.build_routed_op(a64, dev, tile_aligned=True) if tiled else csr
    step = {"step": "verify", "layout": layout, "card": card, "m": m,
            "n": n, "nnz": int(a64.nnz),
            "max_abs_err": verify(layout, op, csr, v, scales)}
    if tiled:
        step.update({"plan_A": routed.tile_plan_stats(op.a),
                     "plan_AT": routed.tile_plan_stats(op.at),
                     "geometry": [op.a.out_strip, op.a.in_window,
                                  op.a.group],
                     "padding_share": [op.a.padding_share,
                                       op.at.padding_share]})
    else:
        step.update({"items_A": routed.csr_item_stats(op.a),
                     "items_AT": routed.csr_item_stats(op.at)})
    emit(step)

    parent_calls = whole_calls = None
    if args.parent:
        parent = package_module("ops.routed", args.parent)
        parent_op = parent.build_routed_op(a64, dev, tile_aligned=tiled)
        parent_calls = products(parent, parent_op, v, layout)
    if not tiled:
        whole = routed.RoutedOp(
            a=routed.csr_with_items(op.a, split_rows=False),
            at=routed.csr_with_items(op.at, split_rows=False))
        whole_calls = products(routed, whole, v, "csr")
    lib = {"A": routed.library_spmv(csr.a), "AT": routed.library_spmv(csr.at)}
    spmv, dual, stats = KERNELS[layout]
    lib_calls = {
        f"{spmv}:A": lambda: lib["A"] @ v["x"],
        f"{spmv}:AT": lambda: lib["AT"] @ v["y"],
        dual: lambda: lib["A"] @ v["x"],
        stats: lambda: lib["AT"] @ v["y"],
    }
    # bytes of the vectors each product reads and writes, each once, and
    # the operations of its epilogue
    extra = {f"{spmv}:A": (4 * (m + n), 0), f"{spmv}:AT": (4 * (m + n), 0),
             dual: (4 * n + 16 * m + 4, 7 * m),
             stats: (4 * m + 12 * n + 8, 5 * n)}
    this_calls = products(routed, op, v, layout)
    if parent_calls:
        emit({"step": "bitwise_equal_to_parent",
              "equal": same_bits(this_calls, parent_calls)})
    bounds = {}
    for name in this_calls:
        mat = op.a if name in (f"{spmv}:A", dual) else op.at
        bounds[name] = probe_routed.bound_ms(
            routed.csr_kernel_bytes(mat) + extra[name][0],
            2 * mat.nnz + extra[name][1])
    device = time_in_turns(this_calls, lib_calls, parent_calls, bounds,
                           card, emit, whole_calls)
    # the epilogue and the launch's tail: each fused kernel's device time
    # over the product's on the same matrix, turn by turn
    tails = {}
    for fused, product in ((dual, f"{spmv}:A"), (stats, f"{spmv}:AT")):
        for who in set(device[fused]) - {"library"}:
            tails[f"{fused} - {product}" + ("" if who == "this"
                                            else f" ({who})")] = [
                a - b for a, b in zip(device[fused][who],
                                      device[product][who])]
    emit({"step": "tails", "device_ms": tails})

    if args.sweep:
        if tiled:
            sweep_tiled(a64, op, v, emit)
        else:
            sweep_csr(op, v, emit)
    return finish(args, card, lines)


def finish(args, card, lines) -> int:
    if args.out:
        with open(args.out, "w") as f:
            f.write(card + "\n" + "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
