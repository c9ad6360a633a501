"""Checks and times the kernel operator's kernels in one layout on one
GPU, optionally beside those of another checkout of this package, in
turns on the same card.

    python3 -m firstorderlp_torch.ops.compare_kernels
        [--layout csr|tiled|probe|lanes|block_lanes|lane_trial] [--nodes N]
        [--lanes B] [--parent DIR] [--bulk] [--sweep] [--out FILE]

--layout: the CSR kernels (spmv_csr, spmv_dual_step, spmv_rmv_stats;
  the default), the tile-plan kernels (tiled_spmv, tiled_dual_step,
  tiled_rmv_stats) or the probe's two kernels (probe_expand,
  probe_reduce) at the probe's default size (--nodes and --bulk do not
  apply), or the fleet's lane kernel (lanes_spmv, A and A') on the
  scaled value planes of a PageRank damping sweep of --lanes lanes
  (default 128) at --nodes nodes (default 20,000 for this layout;
  --bulk does not apply), beside the block-diagonal library SpMV
  (ops/lanes.library_lanes_matrix), or B2 (spmv_csr, A and A') on the
  heterogeneous fleet's interleaved block matrix (ops/block_lanes.py)
  of 32 PageRank LPs of 10,000-40,000 nodes (seeds 10-41), padded and
  rescaled as batch.prepare_batch does, beside the library SpMV of the
  same matrix
  (--nodes, --lanes, --bulk and --sweep do not apply), or the fleet's
  lane trial (ops/lanes_step.py: LF1a, L1 with the dual step, L1' with
  the step-control sums, LF1b) on a damping sweep of --lanes lanes at
  --nodes nodes (default 100,000) three segments into its solve, each
  kernel beside its plain version and the fused trial beside the eager
  one (--parent, --bulk and --sweep do not apply).
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
  (probe), or lanes_spmv at other item sizes, entries loaded at once
  and lanes a thread (lanes; one constant at a time).

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
Lanes and block_lanes: one "time" line per orientation (lanes_row,
block_lanes_row, which chip_smoke.py shares) with the checks and the
times in one. B2's rows carry what its launch looks like
(b2_launch_stats: stages, bytes staged, empty rows, ptxas's registers
and shared memory). Kernels a call are counted
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
import scipy.sparse as sp
import torch

from .. import generators
from ..preprocess import rescale_problem
from . import kernels_build, probe_routed, routed
from .probe_routed import device_profile

TOL_ENTRY, TOL_ABS, TOL_SUM = 1e-5, 1e-7, 1e-5
BURST = 50
REPEATS = 20
# The heterogeneous fleet: 32 PageRank LPs of 10k-40k nodes, seeds
# 10-41 (the construction of tests/test_batch.py's mixed fleet at the
# size docs/performance.md names for such fleets).
HETERO_LANES = 32
HETERO_NODES = (10_000, 40_000)
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


def tickets_of(*mats):
    """Every ticket tensor of `mats`, for repeat_differs: a tile plan's,
    or both of a CSR matrix's (B3 and B4's table and B2's)."""
    out = []
    for mat in mats:
        out.append(mat.tickets)
        if isinstance(mat, routed.CsrKernelMatrix):
            out.append(mat.stage_tickets)
    return tuple(out)


def b2_launch_stats(mat):
    """What a launch of B2 (spmv_csr) over `mat` looks like: its item
    table's shape (routed.stage_item_stats: blocks, one stage each; the
    bytes staged; the empty rows, written without a gather), the
    kernel's registers and static shared memory
    (routed.spmv_csr_attributes) and what ptxas said of it in this
    process's build ({} when the libraries came from the cache)."""
    return {**routed.stage_item_stats(mat), "stages": mat.nstage,
            **routed.spmv_csr_attributes(),
            "ptxas": ptxas_usage("spmv_csr")}


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
        problem = repeat_differs(call, tickets_of(op.a, op.at))
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


def ptxas_usage(lib):
    """Each kernel of `lib` (its mangled name) -> registers a thread,
    static shared memory a block and bytes spilled, as ptxas printed them
    in the last compile in this process; {} when the libraries were
    loaded from the cache."""
    found, name = {}, None
    for line in kernels_build.last_build_log.get(lib, "").splitlines():
        words = line.replace(",", "").split()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found[name] = {}
        elif name and "spill stores" in line:
            found[name]["spill_bytes"] = int(words[words.index("spill") - 2])
        elif name and "Used" in words and "registers" in words:
            found[name]["registers"] = int(words[words.index("Used") + 1])
            if "smem" in words:
                found[name]["smem_bytes"] = int(
                    words[words.index("smem") - 2])
    return found


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
    plan = lanes.launch_plan(half, vals, v)
    row.update({
        "plain_ms": probe_routed.time_ms(
            lambda: lanes.lanes_spmv_plain(half, vals, v)),
        "bytes": lanes.lanes_kernel_bytes(half, nl, v.element_size()),
        "flops": 2 * half.nnz * nl,
        "lanes": nl, "nnz": half.nnz, "rows": half.num_rows,
        "blocks": half.nitems, "item_entries": half.item_entries,
        "entries_per_block_max": int(sizes.max()),
        "entries_per_block_mean": float(sizes.mean()),
        "variant": plan.variant, "lanes_a_thread": plan.vec,
        "unroll": plan.unroll, "slabs": plan.slabs,
        "ptxas": ptxas_usage("lanes_spmv"),
    })
    row["bound_ms"], row["bound_by"] = probe_routed.bound_ms(row["bytes"],
                                                             row["flops"])
    return row


def block_lanes_row(label, mat, v, parent_call=None):
    """B2 on one orientation of a heterogeneous fleet's block matrix
    (`mat`, a routed.CsrKernelMatrix of ops/block_lanes.py; `v` the
    (dim, lanes) lane vectors): against an f64 product on the host and
    its plain version (TOL_ENTRY, TOL_ABS), REPEATS launches bitwise
    equal with the tickets back at zero (raises KernelMismatch), then
    timed in turns (probe_routed.in_turns) beside the library SpMV of
    the same matrix and `parent_call`, another version's launch, if
    given; with its plain version's time, its bound and its launch
    (b2_launch_stats). The row of chip_smoke.py's kernels_block_lanes
    and of --layout block_lanes."""
    from . import block_lanes

    name = f"spmv_csr:{label} (block lanes)"
    flat = v.reshape(-1)
    out_dim, nl = mat.num_rows // v.shape[1], v.shape[1]
    got = routed.spmv_csr(mat, flat).reshape(out_dim, nl)
    plain = block_lanes.block_lanes_spmv_plain(mat, v)
    host = sp.csr_matrix(
        (mat.vals.double().cpu().numpy(), mat.indices.cpu().numpy(),
         mat.indptr.cpu().numpy()), shape=(mat.num_rows, mat.num_cols))
    v64 = v.double().cpu().numpy().reshape(-1)
    scale = abs(host) @ np.abs(v64)
    got_np = got.double().cpu().numpy().reshape(-1)
    err = np.abs(got_np - host @ v64)
    err_plain = np.abs(got_np - plain.double().cpu().numpy().reshape(-1))
    for what, e in (("f64", err), ("plain", err_plain)):
        bad = e > TOL_ENTRY * scale + TOL_ABS
        if bad.any():
            i = int(np.argmax(e - TOL_ENTRY * scale))
            raise KernelMismatch(
                f"{name} against {what}: entry {i} differs by {e[i]:.3e} "
                f"(scale {scale[i]:.3e})")
    problem = repeat_differs(lambda: routed.spmv_csr(mat, flat),
                             tickets_of(mat))
    if problem:
        raise KernelMismatch(f"{name}: {problem}")
    lib = routed.library_spmv(mat)
    turns = {"this": lambda: routed.spmv_csr(mat, flat),
             "library": lambda: lib @ flat}
    if parent_call is not None:
        turns = {"parent": parent_call, **turns}
    row = {"name": name, "max_abs_err": float(err.max()),
           "max_abs_err_vs_plain": float(err_plain.max()),
           "repeats_bitwise": REPEATS}
    for who, timed in probe_routed.in_turns(turns).items():
        prefix = "" if who == "this" else f"{who}_"
        row.update({prefix + k: value for k, value in
                    probe_routed.turn_summary(timed).items()})
    nbytes = routed.csr_kernel_bytes(mat) + 4 * (mat.num_cols + mat.num_rows)
    row.update({
        "plain_ms": probe_routed.time_ms(
            lambda: block_lanes.block_lanes_spmv_plain(mat, v)),
        "bytes": nbytes, "flops": 2 * mat.nnz,
        "lanes": nl, "nnz": mat.nnz, "rows": mat.num_rows,
        **b2_launch_stats(mat),
    })
    row["bound_ms"], row["bound_by"] = probe_routed.bound_ms(nbytes,
                                                             2 * mat.nnz)
    return row


def hetero_fleet_problems(gen=generators):
    """The heterogeneous fleet's LPs (chip_smoke.py's hetero_fleet and
    hetero_parent): HETERO_LANES PageRank LPs of HETERO_NODES nodes,
    seeds 10 up, by the generators module `gen` (another version's, for
    that version's problem types)."""
    nodes = np.rint(np.linspace(*HETERO_NODES, HETERO_LANES)).astype(int)
    return [gen.generate_pagerank_lp(int(k), seed=10 + i)
            for i, k in enumerate(nodes)]


def compare_block_lanes(args, dev, card, emit):
    """--layout block_lanes: B2 on the heterogeneous fleet's rescaled
    block matrix, A and A', checked, against the parent's bits and timed
    in turns with the library SpMV and the parent (block_lanes_row)."""
    from ..parallel import pad_problem
    from .block_lanes import build_block_lanes

    # batch.prepare_batch's ingest at chip_smoke.py's parameters: each LP
    # padded to the largest and rescaled (10 Ruiz passes, Pock-Chambolle
    # alpha 1)
    problems = hetero_fleet_problems()
    shape = (max(p.constraint_matrix.shape[0] for p in problems),
             max(p.constraint_matrix.shape[1] for p in problems))
    op = build_block_lanes(
        [rescale_problem(10, False, 1.0, 0, pad_problem(p, *shape)[0])
         .scaled_qp.constraint_matrix for p in problems], dev)
    m, n = op.shape
    nl = op.lanes
    rng = np.random.default_rng(0)
    vecs = {"A": torch.as_tensor(rng.standard_normal((n, nl)),
                                 dtype=torch.float32, device=dev),
            "AT": torch.as_tensor(rng.standard_normal((m, nl)),
                                  dtype=torch.float32, device=dev)}
    mats = {"A": op.a, "AT": op.at}
    emit({"step": "fleet", "layout": "block_lanes", "card": card,
          "lanes": nl, "m": m, "n": n,
          "block_shape": [op.a.num_rows, op.a.num_cols], "nnz": op.a.nnz})
    parent_calls = {}
    if args.parent:
        old = package_module("ops.routed", args.parent)
        for label, mat in mats.items():
            host = sp.csr_matrix(
                (mat.vals.double().cpu().numpy(), mat.indices.cpu().numpy(),
                 mat.indptr.cpu().numpy()), shape=(mat.num_rows, mat.num_cols))
            twin = old.build_csr_kernel_matrix(host, dev, label)
            flat = vecs[label].reshape(-1)
            parent_calls[label] = (lambda t=twin, f=flat, o=old:
                                   o.spmv_csr(t, f))
        emit({"step": "bitwise_equal_to_parent", "equal": {
            f"spmv_csr:{label}": bool(torch.equal(
                routed.spmv_csr(mats[label], vecs[label].reshape(-1)),
                parent_calls[label]())) for label in mats}})
    for label, mat in mats.items():
        row = block_lanes_row(label, mat, vecs[label],
                              parent_calls.get(label))
        emit({"step": "time", "card": card, **row})


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
        sweep_lanes(pat, dev, op, vecs, card, emit)


def lane_trial_case(nodes, nl, dev, segments=3):
    """(problem, state, start, config) of a PageRank damping sweep of
    `nl` lanes at `nodes` nodes, `segments` segments into its solve on
    the card (chip_smoke.py's fleet parameters), with the segment's start
    at its iteration: every running lane active."""
    import firstorderlp_torch as tx
    from .. import batch

    params = tx.PdhgParameters(
        l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0, primal_importance=1.0,
        scale_invariant_initial_primal_weight=True, verbosity=0,
        record_iteration_stats=False, termination_evaluation_frequency=40,
        termination_criteria=tx.TerminationCriteria(
            eps_optimal_absolute=1e-4, eps_optimal_relative=1e-4,
            eps_primal_infeasible=0.0, eps_dual_infeasible=0.0,
            iteration_limit=20_000),
        restart_params=tx.construct_restart_parameters(
            restart_scheme=tx.RestartScheme.ADAPTIVE_NORMALIZED,
            restart_to_current_metric=(
                tx.RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED),
            restart_frequency_if_fixed=100, artificial_restart_threshold=0.5,
            sufficient_reduction_for_restart=0.1,
            necessary_reduction_for_restart=0.9,
            primal_weight_update_smoothing=0.5,
            use_approximate_localized_duality_gap=False),
        step_size_policy_params=tx.AdaptiveStepsizeParams(
            reduction_exponent=0.3, growth_exponent=0.6),
        dtype="float32")
    spec = generators.pagerank_fleet_spec(
        nodes, np.linspace(0.7, 0.995, nl), seed=0)
    fleet = batch.prepare_shared_pattern_fleet(params, spec, device=dev)
    config = batch._config(params)
    state = fleet.initial_state
    for _ in range(segments):
        state, _, _ = batch.run_segment(fleet.bundle, state, 0.0, config)
    return fleet.bundle.scaled, state, state.iteration.clone(), config


def _lane_trial_inputs(problem, state, start, config):
    """Each of the lane trial's four kernels' arguments on the state, the
    inputs of each the plain versions' outputs before it: (primal, dual,
    stats, verdict, epilogue) argument tuples, and dy2 (the plain f64
    sum L1' is given)."""
    from . import lanes_step
    from ..models.pdhg import _trial_fields

    policy = config.step_policy
    freq = config.termination_evaluation_frequency
    limit = config.criteria.iteration_limit
    op = problem.constraint_matrix
    x, y = state.current_primal_solution, state.current_dual_solution
    aty, step, weight = (state.current_dual_product, state.step_size,
                         state.primal_weight)
    primal = (x, problem.objective_vector, aty, problem.variable_lower_bound,
              problem.variable_upper_bound, step, weight,
              state.termination_reason, state.numerical_error,
              state.iteration, start, freq, limit)
    next_x, z, active = lanes_step.lane_primal_step_plain(*primal)
    dual = (op.pattern.fwd, op.vals, z, y, problem.right_hand_side,
            problem.is_equality, step, weight)
    next_y, dy2 = lanes_step.lanes_dual_step_plain(*dual)
    stats = (op.pattern.bwd, op.vals_t, next_y, next_x, x, aty)
    verdict = (active, step, weight, state.total_number_iterations,
               policy.reduction_exponent, policy.growth_exponent)
    next_aty, interaction, dx2 = lanes_step.lanes_rmv_stats_plain(*stats)
    take, new_step, new_error = lanes_step.lane_verdict_plain(
        dy2, interaction, dx2, *verdict)
    epilogue = (_trial_fields(state), next_x, next_y, next_aty, active, take,
                new_step, new_error, state.termination_reason, start, freq,
                limit)
    return primal, dual, stats, verdict, epilogue, dy2


def lane_trial_calls(problem, state, start, config):
    """name -> (kernel call, its plain version's call) for the lane
    trial's four kernels on the state, and the whole trial fused
    (batch.fused_lane_step) beside the eager one (the mask and
    batch.pdhg_lane_step)."""
    from .. import batch
    from . import lanes_step

    ws = lanes_step.trial_workspace(problem.constraint_matrix)
    primal, dual, stats, verdict, epilogue, dy2 = _lane_trial_inputs(
        problem, state, start, config)

    def eager_trial():
        return batch.pdhg_lane_step(
            problem, state, batch._lane_active(state, start, config),
            config.step_policy)

    def stats_plain():
        got = lanes_step.lanes_rmv_stats_plain(*stats)
        return (got[0], *lanes_step.lane_verdict_plain(dy2, *got[1:],
                                                       *verdict))

    return {
        "lane_primal_step": (
            lambda: lanes_step.lane_primal_step(ws, *primal),
            lambda: lanes_step.lane_primal_step_plain(*primal)),
        "lanes_spmv:A+dual": (
            lambda: lanes_step.lanes_dual_step(ws, *dual),
            lambda: lanes_step.lanes_dual_step_plain(*dual)),
        "lanes_spmv:AT+stats": (
            lambda: lanes_step.lanes_rmv_stats(ws, *stats, dy2, *verdict),
            stats_plain),
        "lane_trial_epilogue": (
            lambda: lanes_step.lane_trial_epilogue(*epilogue),
            lambda: lanes_step.lane_trial_epilogue_plain(*epilogue)),
        "trial": (lambda: batch.fused_lane_step(problem, state, start,
                                                config),
                  eager_trial),
    }


def _within_an_ulp(got, want) -> bool:
    """Each f32 entry equal to `want` or to a neighbour of it."""
    up = torch.nextafter(want, torch.full_like(want, float("inf")))
    down = torch.nextafter(want, torch.full_like(want, float("-inf")))
    return bool(((got == want) | (got == up) | (got == down)).all())


def lane_trial_checks(problem, state, start, config) -> dict:
    """Each of the lane trial's four kernels against its plain version
    on the same inputs. name -> {"bitwise": its vectors, mask, verdict
    and state, each equal to the plain version's (L1''s verdict against
    the plain verdict from the kernel's own sums); "sums_within_an_ulp":
    its f64 sums rounded once (dy2; the interaction and dx2), each lane
    within an ulp of the plain f64 sums; "repeat_bitwise": a second
    launch the same bits; "tickets_at_zero"}; "ok" when every one
    holds."""
    from . import lanes_step

    op = problem.constraint_matrix
    ws = lanes_step.trial_workspace(op)
    primal, dual, stats, verdict, epilogue, dy2 = _lane_trial_inputs(
        problem, state, start, config)

    def launch():
        got = {"lane_primal_step": lanes_step.lane_primal_step(ws, *primal),
               "lanes_spmv:A+dual": lanes_step.lanes_dual_step(ws, *dual)}
        got = {k: tuple(t.clone() for t in v) for k, v in got.items()}
        got["lanes_spmv:AT+stats"] = tuple(t.clone() for t in (
            *lanes_step.lanes_rmv_stats(ws, *stats, dy2, *verdict),
            *ws.stats["sums"]))
        got["lane_trial_epilogue"] = tuple(
            _flat(lanes_step.lane_trial_epilogue(*epilogue)))
        return got

    got, again = launch(), launch()
    torch.cuda.synchronize()
    next_aty, interaction, dx2 = lanes_step.lanes_rmv_stats_plain(*stats)
    kernel_sums = got["lanes_spmv:AT+stats"][4:]
    want_y, want_dy2 = lanes_step.lanes_dual_step_plain(*dual)
    pairs = {
        "lane_primal_step": (
            list(zip(got["lane_primal_step"],
                     lanes_step.lane_primal_step_plain(*primal))), []),
        "lanes_spmv:A+dual": ([(got["lanes_spmv:A+dual"][0], want_y)],
                              [(got["lanes_spmv:A+dual"][1], want_dy2)]),
        "lanes_spmv:AT+stats": (
            list(zip(got["lanes_spmv:AT+stats"][:4], (
                next_aty, *lanes_step.lane_verdict_plain(
                    dy2, *kernel_sums, *verdict)))),
            list(zip(kernel_sums, (interaction, dx2)))),
        "lane_trial_epilogue": (
            list(zip(got["lane_trial_epilogue"], _flat(
                lanes_step.lane_trial_epilogue_plain(*epilogue)))), []),
    }
    tickets = (ws.dual["tickets"], ws.stats["tickets"],
               op.pattern.fwd.tickets, op.pattern.bwd.tickets)
    checks = {}
    for name, (exact, sums) in pairs.items():
        checks[name] = {
            "bitwise": all(bool(torch.equal(g, w)) for g, w in exact),
            "sums_within_an_ulp": all(_within_an_ulp(g, w)
                                      for g, w in sums),
            "repeat_bitwise": all(bool(torch.equal(g, a)) for g, a in zip(
                got[name], again[name])),
            "tickets_at_zero": not any(bool(t.any()) for t in tickets),
        }
    checks["ok"] = all(all(c.values()) for c in checks.values())
    return checks


def lane_trial_times(problem, state, start, config) -> dict:
    """Each of the lane trial's four kernels and its plain version, and
    the fused trial and the eager one, timed in turns
    (probe_routed.in_turns): name -> turn_summary, with each kernel's
    bytes bound (bound_ms)."""
    op = problem.constraint_matrix
    calls = lane_trial_calls(problem, state, start, config)
    timed = {}
    for name, (kernel, plain) in calls.items():
        timed[name] = kernel
        timed["trial:eager" if name == "trial" else name + ":plain"] = plain
    bounds = {name: probe_routed.bound_ms(nbytes, 0)[0]
              for name, nbytes in lane_trial_bytes(op, op.lanes).items()}
    return {name: {"bound_ms": bounds.get(name.split(":plain")[0]),
                   **probe_routed.turn_summary(result)}
            for name, result in probe_routed.in_turns(timed).items()}


def lane_trial_bytes(op, lanes: int) -> dict:
    """Bytes each kernel of the lane trial must move in f32, each input
    read once and each output written once: LF1a five (n, B) planes in,
    two out; L1 with the dual step L1's bytes plus y and b; L1' with the
    step control L1's plus x+, x and A'y; LF1b four (n, B) and three
    (m, B) planes each way."""
    from .lanes import lanes_kernel_bytes

    m, n = op.shape
    p, q = 4 * n * lanes, 4 * m * lanes
    return {"lane_primal_step": 7 * p,
            "lanes_spmv:A+dual": lanes_kernel_bytes(op.pattern.fwd, lanes, 4)
            + 2 * q,
            "lanes_spmv:AT+stats": lanes_kernel_bytes(op.pattern.bwd,
                                                      lanes, 4) + 3 * p,
            "lane_trial_epilogue": 8 * p + 6 * q}


def compare_lane_trial(args, dev, card, emit):
    """--layout lane_trial: the fleet's lane trial's four kernels on a
    mid-solve state, each against its plain version (lane_trial_checks);
    then each, its plain version, the fused trial and the eager one
    timed in turns, with the bytes bound (lane_trial_times)."""
    case = lane_trial_case(args.nodes or 100_000, args.lanes, dev)
    op = case[0].constraint_matrix
    m, n = op.shape
    emit({"step": "fleet", "layout": "lane_trial", "card": card, "m": m,
          "n": n, "nnz": op.pattern.nnz, "lanes": op.lanes,
          "items": [op.pattern.fwd.nitems, op.pattern.bwd.nitems]})
    emit({"step": "verify", "checks": lane_trial_checks(*case)})
    for name, row in lane_trial_times(*case).items():
        emit({"step": "time", "card": card, "name": name, **row})


def _flat(out):
    """The tensors of a kernel's result, in order (dataclasses' fields,
    tuples' members)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        return [t for f in dataclasses.fields(out)
                for t in _flat(getattr(out, f.name))]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return []


def sweep_lanes(pat, dev, op, vecs, card, emit):
    """L1's design constants one at a time around the package's: item
    entries (a new pattern), entries a warp loads at once (unroll) and
    the bytes of a thread's lanes (4, 8, 16); device ms a call of A x and
    A' y, with each plan's shape."""
    from . import lanes

    base = {"item_entries": lanes.LANE_ITEM_ENTRIES,
            "unroll": lanes.LANE_UNROLL,
            "vector_bytes": lanes.LANE_VECTOR_BYTES}
    values = {"item_entries": (16, 32, 64, 128, 256, 512),
              "unroll": (4, 8, 16),
              "vector_bytes": (4, 8, 16)}
    patterns = {}
    for key, options in values.items():
        for value in options:
            cfg = dict(base, **{key: value})
            entries = cfg.pop("item_entries")
            if entries not in patterns:
                patterns[entries] = lanes.build_lanes_pattern(
                    pat, dev, item_entries=entries)
            swept = patterns[entries]
            row = {"step": "sweep", "card": card, "swept": key,
                   "item_entries": entries, **cfg}
            for label, half, vals in (("A", swept.fwd, op.vals),
                                      ("AT", swept.bwd, op.vals_t)):
                v = vecs[label]
                plan = lanes.lanes_plan(half, v.shape[1], v.element_size(),
                                        True, **cfg)
                row[f"lanes_spmv:{label}"] = {
                    "device_ms": device_ms(
                        lambda: lanes.lanes_spmv(half, vals, v, plan=plan)),
                    "blocks": half.nitems, "variant": plan.variant}
            emit(row)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layout",
                        choices=sorted(KERNELS) + ["probe", "lanes",
                                                   "block_lanes",
                                                   "lane_trial"],
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
    names = {"probe": probe_routed.LAUNCHES, "lanes": ("lanes_spmv",),
             "block_lanes": ("spmv_csr",),
             "lane_trial": ("lanes_dual_step", "lanes_rmv_stats",
                            "lane_primal_step", "lane_trial_epilogue")
             }.get(layout) or KERNELS[layout]
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
    if layout == "block_lanes":
        compare_block_lanes(args, dev, card, emit)
        return finish(args, card, lines)
    if layout == "lane_trial":
        compare_lane_trial(args, dev, card, emit)
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
                     "items_AT": routed.csr_item_stats(op.at),
                     "spmv_csr_A": b2_launch_stats(op.a),
                     "spmv_csr_AT": b2_launch_stats(op.at)})
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
