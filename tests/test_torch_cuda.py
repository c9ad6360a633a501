"""The CUDA kernels of firstorderlp_torch on the card.

Marked `cuda`: each test skips where no CUDA device is present (the
decision is made in the fixture, when the test runs). On a machine with
a card, from the root of the repository:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use.) Each kernel is held against its plain PyTorch version on the
card, on shapes with the structures that stress the layout: hub rows
and columns cut into pieces over many blocks (or, as a yardstick, not
cut), empty rows and columns, more items than a block has threads. The
CSR kernels also launch 20 times for the same bits with their tickets
back at zero, are one launch a call (counted at the host's launch
calls; the records torch.profiler keeps name only the port's kernels),
return sums that outlive the next launch, and reject bad inputs; B2's
staged walk is held to its plain version, 20 launches bitwise and one
launch a call on 40% empty rows, items at every entry offset in a
16-byte word (indices and values each moved off their word), rows past
a stage and a row cut across items. The
tile-plan kernels are held against their plain versions and against the
CSR kernels, at the card's own strip sizes and at small ones that force
ragged and empty strips and runs of one row across many steps, and on
matrices built for the paths of the work items: a strip split over many
blocks, a strip that is one dense row, steps that cross tiles, fewer
rows than a strip, a single strip; tiled_rmv_stats also on a plan of A'
with split strips and on one without. The probe's reduce is one kernel
a call, gives the same bits on every launch with its tickets back at
zero, and writes every strip, those that no group names too, at every
block size it allows. The lane kernel (ops/lanes.py) is held against its
plain version in f32 and f64 at 1 to 300 lanes, in its vector and its
scalar variant, with the dense rows cut into pieces and walked whole,
gives the same bits on row slices that are not 16-byte aligned and
under every plan the sweep takes, repeats its bits with the tickets
back at zero, counts one launch a product, rejects bad inputs, and
carries a small fleet to OPTIMAL. The fleet's lane trial
(ops/lanes_step.py: LF1a, L1 with the dual step, L1' with the
step-control sums, LF1b) is held to its plain versions at 128 x 20k,
128 x 100k and 3 lanes (vectors, mask, verdict and state bitwise, the
f64 sums within an ulp), repeats its bits, is four launches a trial,
is not taken by constant steps, and carries a 128-lane sweep to
OPTIMAL within the sweep cell's limits, every trial fused, each lane's
answer within the cell's l1 limit of the eager trial's. The
heterogeneous fleet's block lane operator (ops/block_lanes.py) runs B2
on an interleaved block-diagonal matrix of lanes of mixed sizes and
patterns: against its plain version,
20 launches bitwise equal; a 4-lane heterogeneous fleet and a 4-lane QP
fleet (PDHG and Mirror Prox) end OPTIMAL on the card with the reasons
of the same fleets on the CPU. The block-partitioned operator
(ops/routed_sharded.py) on a (2, 2) mesh of the card, CSR and tile-plan
blocks with an empty block, against its blocks' plain versions, one
launch a non-empty block; sharded_optimize on that mesh ends OPTIMAL
with the same bits twice, and so does the row-sharded ingest
(parallel/shard_ingest.py) with CSR and tile-plan cells, whose rescale
on the card is within 1e-5 of the CPU's. The step trial's kernels
(ops/pdhg_step.py: F1a primal_step, F1b trial_epilogue) are each held
bitwise to their plain versions on the states of tests/trial_cases.py
(accept, reject, numerical error, interaction 0, inactive, the first
step, the mask off for each reason), on CSR and the tile plan, adaptive
and constant, over sums with signed zeros, infinities and NaN and every
route of PyTorch's pow, and over inputs that hold NaN and crossed
bounds; a replayed trial is bitwise the eager one with the same
launches, and a trial is captured under
torch.cuda.set_sync_debug_mode("error"), four host launch calls
eagerly. The f32 exact trust region's kernels (ops/trust_region_search.py:
F2b on a cluster a row (tr_search) or on the whole card (tr_knots and
tr_trip), F2c tr_solution) are each bitwise their plain versions
over the cases of tests/trust_region_cases.py with bounds (N,) and
(B, N), at the main path's (3 x 200,001), the fleet's (384 x 40,001),
a row too long to stage and the 1M LP's (3 x 2,000,001) shapes, the
same bits on every launch; the whole-card path also forced on every
case and on rows with no live knot or NaN inputs, replayed from a CUDA
graph on new inputs and cut into row chunks; F2c also at 1, 3 and 384
rows with the split at 0, at n and
inside a 16-byte slot, on transposed views, and replayed from a CUDA
graph bitwise the eager call, its tickets back at zero; both at 65,536
rows (two launches each) bitwise the plain versions, and a 21,846-lane
fleet, whose restart solves 65,538 rows, bitwise its two halves; F1a also on
views at odd offsets at every n mod 4 under each launch plan; a
replayed PDHG and Mirror Prox evaluation is bitwise the eager
one with the same launches, and an evaluation is captured under
torch.cuda.set_sync_debug_mode("error"). The evaluation's statistics
kernels (ops/eval_stats.py: F2d stats_point, F2e stats_primal, F2f
stats_dual) are each held to their plain versions over the cases of
tests/eval_stats_cases.py from one entry to past one wave of F2e's and
F2f's grid (the 100k-node and the million-node LP's shapes among them),
on aligned vectors and on views 4 bytes off: the points, the ray and every maximum and flag bitwise, each
sum within the order bound of its terms, the finalize bitwise the plain
finalize of the kernels' own totals, the same bits on a second launch
with the tickets back at zero; a replayed PDHG (CSR and tile plan) and
Mirror Prox evaluation runs each once and is bitwise the eager one; and
at iteration 81 the fused statistics give the eager route's reason and
maxima, with infeasibility detection off and on. F2d alone is held to
its plain version bitwise at n + m from 2 to twice one wave of its grid,
aligned and 4 bytes off, with and without an average and in each case
that decides whether the average is taken, with infinities and a NaN in
the point: every output on 16 bytes, a second launch bitwise the first,
its ticket and its word of the maximum back at zero.
"""

import dataclasses
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_torch.generators import generate_pagerank_lp
from firstorderlp_torch.ops import lanes as lane_ops
from firstorderlp_torch.ops import routed
from firstorderlp_torch.ops.compare_kernels import repeat_differs, tickets_of

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def hub_matrix(m, n, hub_len, seed):
    """Random entries plus a dense-ish row 0 and column 0 of `hub_len`
    entries (long rows, cut into pieces over several items), and empty
    rows/columns."""
    rng = np.random.default_rng(seed)
    nnz = 4 * m
    rows = np.concatenate([rng.integers(2, m, nnz), np.zeros(hub_len, int),
                           rng.integers(2, m, hub_len)])
    cols = np.concatenate([rng.integers(2, n, nnz),
                           rng.integers(0, n, hub_len), np.zeros(hub_len,
                                                                 int)])
    a = sp.coo_matrix((rng.normal(size=rows.size), (rows, cols)),
                      shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


MATRICES = {
    "hub": lambda: hub_matrix(3000, 2500, 6000, 0),
    "tiny": lambda: hub_matrix(40, 30, 10, 1),
    "pagerank2000": lambda: generate_pagerank_lp(2000, seed=0)
    .constraint_matrix,
}


def check(got, want, scale):
    err = (got.double() - want.double()).abs().cpu().numpy()
    assert np.all(err <= 1e-5 * scale + 1e-7), float(err.max())


# The CSR kernels' matrices: MATRICES, and one of more items than a
# block has threads (the launch's last ticket adds 256+ partials).
CSR_MATRICES = dict(
    MATRICES, many_items=lambda: hub_matrix(20000, 20000, 30000, 2))
# Item sizes below ITEM_ENTRIES, where that would leave the dense row of
# 2,000 entries whole or fewer items than a block has threads.
CSR_ITEM_ENTRIES = {"pagerank2000": 256, "many_items": 256}


def csr_op(cuda, name, split):
    """The CSR operator of CSR_MATRICES[name], its items cut to
    CSR_ITEM_ENTRIES; split=False: the same rows with no row cut into
    pieces (a long row is one block)."""
    a = sp.csr_matrix(CSR_MATRICES[name]())
    op = routed.build_routed_op(a, cuda, tile_aligned=False)
    entries = CSR_ITEM_ENTRIES.get(name)
    if entries or not split:
        op = routed.RoutedOp(
            a=routed.csr_with_items(op.a, entries, split_rows=split),
            at=routed.csr_with_items(op.at, entries, split_rows=split))
    return a, op


def csr_calls(op, gen_device, m, n):
    """name -> call of the three CSR kernels on vectors drawn on the
    card from a seeded generator; each call returns a tuple."""
    gen = torch.Generator(device=gen_device).manual_seed(0)
    x, dx, old = (torch.randn(n, device=gen_device, generator=gen)
                  for _ in range(3))
    y, b = (torch.randn(m, device=gen_device, generator=gen)
            for _ in range(2))
    eq = (torch.rand(m, device=gen_device, generator=gen) < 0.3).float()
    sigma = torch.full((), 0.37, device=gen_device)
    return {
        "spmv_csr:A": lambda: (routed.spmv_csr(op.a, x),),
        "spmv_csr:AT": lambda: (routed.spmv_csr(op.at, y),),
        "spmv_dual_step": lambda: routed.spmv_dual_step(
            op.a, x, y, b, eq, sigma),
        "spmv_rmv_stats": lambda: routed.spmv_rmv_stats(
            op.at, y, dx, old),
    }


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", sorted(CSR_MATRICES))
def test_kernels_match_plain(cuda, name, split):
    """split: rows longer than the item size are cut across items (the
    default); else no row is cut."""
    a, op = csr_op(cuda, name, split)
    m, n = a.shape
    pieces = op.a.items[:-1, 3].cpu().numpy()
    if name != "tiny":
        assert (pieces.max() > 1) == split
    if name == "many_items":
        assert op.a.nitems > routed.ITEM_BLOCK_THREADS
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(rng.normal(size=m), dtype=torch.float32, device=cuda)
    absa = abs(a)
    scale_ax = absa @ np.abs(x.cpu().numpy().astype(np.float64))
    scale_aty = absa.T @ np.abs(y.cpu().numpy().astype(np.float64))
    check(routed.spmv_csr(op.a, x), routed.spmv_csr_plain(op.a, x),
          scale_ax)
    check(routed.spmv_csr(op.at, y), routed.spmv_csr_plain(op.at, y),
          scale_aty)

    b = torch.as_tensor(rng.normal(size=m), dtype=torch.float32, device=cuda)
    eq = torch.as_tensor((rng.random(m) < 0.3).astype(np.float32),
                         device=cuda)
    sigma = torch.full((), 0.37, dtype=torch.float32, device=cuda)
    yn, dy2 = routed.spmv_dual_step(op.a, x, y, b, eq, sigma)
    yn_p, dy2_p = routed.spmv_dual_step_plain(op.a, x, y, b, eq, sigma)
    check(yn, yn_p, np.abs(y.cpu().numpy()) + 0.37 * (
        np.abs(b.cpu().numpy()) + scale_ax))
    # and against its own y+ in f64
    own = torch.sum((yn.double() - y.double()) ** 2)
    assert float(dy2) == pytest.approx(float(own), rel=1e-5)
    assert float(dy2) == pytest.approx(float(dy2_p), rel=1e-5)

    dx = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                         device=cuda)
    old = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                          device=cuda)
    got = routed.spmv_rmv_stats(op.at, y, dx, old)
    want = routed.spmv_rmv_stats_plain(op.at, y, dx, old)
    check(got[0], want[0], scale_aty)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-5)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", sorted(CSR_MATRICES))
def test_csr_kernels_repeat_bitwise(cuda, name, split):
    """20 launches of each CSR kernel on the same inputs give the same
    bits, however the blocks were scheduled; the tickets are back at
    zero after every launch."""
    a, op = csr_op(cuda, name, split)
    for key, call in csr_calls(op, cuda, *a.shape).items():
        problem = repeat_differs(call, tickets_of(op.a, op.at), 20)
        assert problem is None, (key, problem)


def staged_matrix(case):
    """B2's cases (csrc/spmv_csr.cu): 40% empty rows between short rows;
    rows of many lengths, so small items start at every entry offset in
    a 16-byte word; a row longer than a stage (5,000 entries: pieces of
    at most 2,048) and rows past STAGE_LONG_ROW (walked by a whole
    block) among short rows; the hub matrix's dense row cut across
    items."""
    rng = np.random.default_rng(11)
    if case == "cut_row":
        return hub_matrix(3000, 2500, 6000, 0)
    if case == "empty40":
        lengths = rng.integers(1, 12, 4000) * (rng.random(4000) >= 0.4)
    elif case == "offsets":
        lengths = rng.integers(0, 40, 3000)
    else:  # long_rows
        lengths = rng.integers(0, 9, 3000)
        lengths[[10, 1500]] = (routed.STAGE_LONG_ROW + 44, 5000)
    n = 6000
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate(
        [np.sort(rng.choice(n, size=k, replace=False)) for k in lengths])
    return sp.csr_matrix((rng.normal(size=indptr[-1]), indices, indptr),
                         shape=(len(lengths), n))


def misaligned(mat, cuda, shift_idx, shift_val):
    """`mat` with its indices and values moved `shift_*` 4-byte slots
    into a 16-byte word (views at a storage offset), so the bulk copies
    of the two arrays start at other entries."""
    def moved(t, shift):
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda)
        view = buf[shift:shift + t.numel()]
        view.copy_(t)
        return view

    return dataclasses.replace(mat, indices=moved(mat.indices, shift_idx),
                               vals=moved(mat.vals, shift_val))


@pytest.mark.parametrize("entries", [16, 256, routed.ITEM_ENTRIES])
@pytest.mark.parametrize("case", ["empty40", "offsets", "long_rows",
                                  "cut_row"])
def test_spmv_csr_staged_walk_matches_plain_and_repeats(cuda, case,
                                                        entries):
    """B2 against its plain version on the card (the f32 rounding
    class), 20 launches bitwise equal with its tickets back at zero, and
    one launch a call, on each case of staged_matrix at items of 16, 256
    and 2,048 units, both orientations, with the indices and the values
    at every offset in their 16-byte words."""
    a = sp.csr_matrix(staged_matrix(case))
    a.sum_duplicates()
    for label, csr in (("A", a), ("AT", sp.csr_matrix(a.T))):
        mat = routed.csr_with_items(
            routed.build_csr_kernel_matrix(csr, cuda, label), entries)
        starts = mat.stage_items[:-1, 0].cpu().numpy() % 4
        if entries == 16:
            assert set(starts.tolist()) == {0, 1, 2, 3}
        if case == "long_rows" and label == "A":
            stats = routed.stage_item_stats(mat)
            assert stats["long_rows"] == 2
            assert stats["split_rows"] == (2 if entries < 300 else 1)
        x = torch.randn(csr.shape[1], device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
        scale = abs(csr) @ np.abs(x.cpu().numpy().astype(np.float64))
        want = routed.spmv_csr_plain(mat, x)
        for shift in range(4):
            moved = misaligned(mat, cuda, shift, (shift + 1) % 4)
            check(routed.spmv_csr(moved, x), want, scale)
        routed.reset_launch_counts()
        problem = repeat_differs(lambda: routed.spmv_csr(mat, x),
                                 tickets_of(mat), 20)
        assert problem is None, (label, problem)
        assert routed.LAUNCHES[f"spmv_csr:{label}"] == 20
        if case == "empty40" and label == "A":
            got = routed.spmv_csr(mat, x)
            empty = torch.as_tensor(np.diff(csr.indptr) == 0, device=cuda)
            assert float(empty.float().mean()) > 0.35
            assert not got[empty].any()


def test_csr_kernels_are_one_launch_a_call(cuda):
    """One kernel, the port's own, per call of each CSR wrapper: no
    long-row pass and no torch.sum. The launches are counted at the
    host's launch calls (routed.LAUNCHES), since torch.profiler loses a
    share of the device records; the records it keeps are no more than
    the launches and name only the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    a, op = csr_op(cuda, "pagerank2000", True)
    assert op.a.items[:-1, 3].max() > 1  # the dense row is cut
    for key, call in csr_calls(op, cuda, *a.shape).items():
        call()
        torch.cuda.synchronize()
        routed.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        assert routed.LAUNCHES[key] == 5, (key, routed.LAUNCHES)
        assert sum(routed.LAUNCHES.values()) == 5, (key, routed.LAUNCHES)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in kernels) <= 5, (key, kernels)
        assert all("folp::" in e.key for e in kernels), key


def test_csr_sums_are_not_views_of_the_scratch(cuda):
    """The returned sums survive the next launch on the same matrix
    (the caller keeps them across iterations)."""
    a, op = csr_op(cuda, "hub", True)
    calls = csr_calls(op, cuda, *a.shape)
    first = calls["spmv_dual_step"]()
    stats = calls["spmv_rmv_stats"]()
    kept = [t.clone() for t in (*first, *stats)]
    z = torch.zeros(a.shape[1], device=cuda)
    sigma = torch.ones((), device=cuda)
    for _ in range(3):  # other inputs, other sums
        routed.spmv_dual_step(op.a, z, first[0] + 1.0, first[0], first[0],
                              sigma)
        routed.spmv_rmv_stats(op.at, first[0] + 2.0, stats[0], stats[0])
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip((*first, *stats), kept))
    for s in (first[1], stats[1], stats[2]):
        assert s.dim() == 0
        assert s.untyped_storage().data_ptr() != op.a.scratch.data_ptr()
        assert s.untyped_storage().data_ptr() != op.at.scratch.data_ptr()


# (out_strip, in_window, group): the defaults, then small strips that
# leave ragged last strips, strips with no entries (the hub matrices have
# empty rows 1 and columns 1) and a hub row cut over many tiles and steps.
GEOMETRIES = {
    "default": {},
    "small": dict(out_strip=64, in_window=256, group=32),
    "odd": dict(out_strip=1, in_window=700, group=3),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_tiled_kernels_match_plain_and_csr(cuda, name, geometry):
    check_tiled(cuda, sp.csr_matrix(MATRICES[name]()), GEOMETRIES[geometry])


def check_tiled(cuda, a, geometry):
    """The four tile-plan products against their plain versions and the
    CSR kernels, one launch counted for each, a second launch bitwise
    equal. Returns the tile-plan operator."""
    m, n = a.shape
    op = routed.build_routed_op(a, cuda, tile_aligned=True, **geometry)
    csr = routed.build_routed_op(a, cuda, tile_aligned=False)
    assert op.tile_aligned and not csr.tile_aligned
    rng = np.random.default_rng(3)

    def vec(size):
        return torch.as_tensor(rng.normal(size=size), dtype=torch.float32,
                               device=cuda)

    x, y, b, dx, old = vec(n), vec(m), vec(m), vec(n), vec(n)
    eq = torch.as_tensor((rng.random(m) < 0.3).astype(np.float32),
                         device=cuda)
    sigma = torch.full((), 0.37, dtype=torch.float32, device=cuda)
    absa = abs(a)
    scale_ax = absa @ np.abs(x.cpu().numpy().astype(np.float64))
    scale_aty = absa.T @ np.abs(y.cpu().numpy().astype(np.float64))
    scale_dual = np.abs(y.cpu().numpy()) + 0.37 * (
        np.abs(b.cpu().numpy()) + scale_ax)

    routed.reset_launch_counts()
    ax = op.mv(x)
    check(ax, routed.tiled_spmv_plain(op.a, x), scale_ax)
    check(ax, csr.mv(x), scale_ax)
    aty = op.rmv(y)
    check(aty, routed.tiled_spmv_plain(op.at, y), scale_aty)
    check(aty, csr.rmv(y), scale_aty)

    yn, _, dy2 = op.mv_dual_step(x, y, b, eq, sigma)
    yn_p, dy2_p = routed.tiled_dual_step_plain(op.a, x, y, b, eq, sigma)
    yn_c, _, dy2_c = csr.mv_dual_step(x, y, b, eq, sigma)
    check(yn, yn_p, scale_dual)
    check(yn, yn_c, scale_dual)
    assert float(dy2) == pytest.approx(float(dy2_p), rel=1e-5)
    assert float(dy2) == pytest.approx(float(dy2_c), rel=1e-5)

    got = op.rmv_stats(y, dx, old)
    want = routed.tiled_rmv_stats_plain(op.at, y, dx, old)
    want_c = csr.rmv_stats(y, dx, old)
    check(got[0], want[0], scale_aty)
    check(got[0], want_c[0], scale_aty)
    for k in (1, 2):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                              abs=1e-4)
        assert float(got[k]) == pytest.approx(float(want_c[k]), rel=1e-5,
                                              abs=1e-4)
    assert routed.LAUNCHES["tiled_spmv:A"] == 1
    assert routed.LAUNCHES["tiled_spmv:AT"] == 1
    assert routed.LAUNCHES["tiled_dual_step"] == 1
    assert routed.LAUNCHES["tiled_rmv_stats"] == 1

    # the same bits on a second launch
    again = op.rmv_stats(y, dx, old)
    yn2, _, dy2_2 = op.mv_dual_step(x, y, b, eq, sigma)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert torch.equal(yn, yn2) and torch.equal(dy2, dy2_2)
    # the tickets are back at zero for the next launch
    assert not op.a.tickets.any() and not op.at.tickets.any()
    return op


def dense_rows_matrix(m, n, dense, seed):
    """Three entries in every row, and the rows `dense` full."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=3.0 / n, random_state=rng,
                  data_rvs=rng.standard_normal).tolil()
    for r in dense:
        a[r, :] = rng.standard_normal(n)
    return sp.csr_matrix(a)


# name -> (matrix, geometry, least items of the heaviest strip of A)
BUILT = {
    # one strip of 64 rows holds two dense rows of 5,000: many blocks
    "split_strip": (lambda: dense_rows_matrix(4000, 5000, [70, 100], 0),
                    dict(out_strip=64, in_window=1024, group=32), 8),
    # strips of one row: the dense row's strip holds nothing else
    "dense_row_alone": (lambda: dense_rows_matrix(300, 40_000, [7], 1),
                        dict(out_strip=1, in_window=16384, group=128), 8),
    # groups of 3 in windows of 50: most steps of 32 cross several tiles
    "steps_cross_tiles": (lambda: dense_rows_matrix(500, 700, [0, 250], 2),
                          dict(out_strip=128, in_window=50, group=3), 2),
    # 203 x 157 at strips of 32: last strip 11 rows, last window 29 wide
    "ragged": (lambda: dense_rows_matrix(203, 157, [202], 3),
               dict(out_strip=32, in_window=32, group=8), 1),
    # fewer rows than one strip, at the card's own geometry
    "below_one_strip": (lambda: dense_rows_matrix(20, 3000, [3], 4), {}, 2),
    # one strip of A, cut into as many items as the card has SMs
    "single_strip": (lambda: dense_rows_matrix(500, 9000, [1, 2, 3], 5),
                     dict(out_strip=512), 32),
}


@pytest.mark.parametrize("case", sorted(BUILT))
def test_tiled_kernels_on_the_paths_of_the_work_items(cuda, case):
    make, geometry, least_items = BUILT[case]
    op = check_tiled(cuda, make(), geometry)
    items = op.a.items.cpu().numpy()
    assert items[:-1, 2].max() >= least_items
    sizes = np.diff(items[:, 0])
    assert sizes.max() <= 2.25 * sizes.mean() + 2


@pytest.mark.parametrize("case", sorted(BUILT) + sorted(MATRICES))
def test_tiled_kernels_repeat_bitwise(cuda, case):
    """20 launches of each tile-plan kernel on the same inputs give the
    same bits, however the blocks were scheduled; the tickets are back
    at zero after them."""
    if case in BUILT:
        make, geometry, _ = BUILT[case]
    else:
        make, geometry = MATRICES[case], {}
    a = sp.csr_matrix(make())
    m, n = a.shape
    op = routed.build_routed_op(a, cuda, tile_aligned=True, **geometry)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dx, old = (torch.randn(n, device=cuda, generator=gen)
                  for _ in range(3))
    y, b = (torch.randn(m, device=cuda, generator=gen) for _ in range(2))
    eq = (torch.rand(m, device=cuda, generator=gen) < 0.3).float()
    sigma = torch.full((), 0.37, device=cuda)
    calls = {
        "tiled_spmv:A": lambda: (routed.tiled_spmv(op.a, x),),
        "tiled_spmv:AT": lambda: (routed.tiled_spmv(op.at, y),),
        "tiled_dual_step": lambda: routed.tiled_dual_step(
            op.a, x, y, b, eq, sigma),
        "tiled_rmv_stats": lambda: routed.tiled_rmv_stats(
            op.at, y, dx, old),
    }
    for name, call in calls.items():
        problem = repeat_differs(call, (op.a.tickets, op.at.tickets), 20)
        assert problem is None, (name, problem)


def test_tiled_wrappers_reject_bad_inputs(cuda):
    a = hub_matrix(40, 30, 10, 1)
    op = routed.build_routed_op(a, cuda, tile_aligned=True)
    with pytest.raises(TypeError):
        routed.tiled_spmv(op.a, torch.zeros(30, dtype=torch.float64,
                                            device=cuda))
    with pytest.raises(ValueError):
        routed.tiled_spmv(op.a, torch.zeros(31, device=cuda))
    with pytest.raises(ValueError):
        routed.tiled_spmv(op.a, torch.zeros(30))  # a CPU vector


# A' of these has a strip split over many items (the dense columns of A
# are dense rows of A') or none (dense rows of A spread over A''s strips).
RMV_STATS_PLANS = {
    "split": (lambda: dense_rows_matrix(5000, 4000, [70, 100], 6).T.tocsr(),
              True),
    "whole": (lambda: dense_rows_matrix(4000, 5000, [70, 100], 7), False),
}


@pytest.mark.parametrize("case", sorted(RMV_STATS_PLANS))
def test_tiled_rmv_stats_on_split_and_whole_strips(cuda, case):
    """tiled_rmv_stats against its plain version and against the CSR
    spmv_rmv_stats, 20 launches bitwise equal with the tickets back at
    zero, on a plan of A' with split strips and on one without."""
    make, split = RMV_STATS_PLANS[case]
    a = make()
    m, n = a.shape
    op = routed.build_routed_op(a, cuda, tile_aligned=True)
    csr = routed.build_routed_op(a, cuda, tile_aligned=False)
    items = op.at.items.cpu().numpy()
    assert (items[:-1, 2].max() > 1) == split
    rng = np.random.default_rng(4)
    y, dx, old = (torch.as_tensor(rng.normal(size=size), dtype=torch.float32,
                                  device=cuda) for size in (m, n, n))
    got = routed.tiled_rmv_stats(op.at, y, dx, old)
    scale_aty = abs(a).T @ np.abs(y.cpu().numpy().astype(np.float64))
    for want in (routed.tiled_rmv_stats_plain(op.at, y, dx, old),
                 routed.spmv_rmv_stats(csr.at, y, dx, old)):
        check(got[0], want[0], scale_aty)
        for k in (1, 2):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                                  abs=1e-4)
    problem = repeat_differs(
        lambda: routed.tiled_rmv_stats(op.at, y, dx, old), (op.at.tickets,))
    assert problem is None, problem


def test_kernels_are_deterministic(cuda):
    a = hub_matrix(3000, 2500, 6000, 0)
    op = routed.build_routed_op(a, cuda)
    x = torch.randn(a.shape[1], device=cuda)
    y = torch.randn(a.shape[0], device=cuda)
    sigma = torch.full((), 0.5, device=cuda)
    first = routed.spmv_dual_step(op.a, x, y, y, y, sigma)
    second = routed.spmv_dual_step(op.a, x, y, y, y, sigma)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_wrappers_reject_bad_inputs_and_count(cuda):
    a = hub_matrix(40, 30, 10, 1)
    op = routed.build_routed_op(a, cuda)
    with pytest.raises(TypeError):
        routed.spmv_csr(op.a, torch.zeros(30, dtype=torch.float64,
                                          device=cuda))
    with pytest.raises(ValueError):
        routed.spmv_csr(op.a, torch.zeros(31, device=cuda))
    m, n = a.shape
    z, y = torch.zeros(n, device=cuda), torch.zeros(m, device=cuda)
    sigma = torch.ones((), device=cuda)
    bad_dual = (
        (TypeError, (z.double(), y, y, y, sigma)),  # f64 z
        (ValueError, (z, y[:-1], y, y, sigma)),  # short y
        (ValueError, (z, y, y.cpu(), y, sigma)),  # a CPU b
        (ValueError, (z, y, y, torch.zeros(2 * m, device=cuda)[::2],
                      sigma)),  # a strided is_eq
        (ValueError, (z, y, y, y, sigma.cpu())),  # a CPU sigma
    )
    for error, args in bad_dual:
        with pytest.raises(error):
            routed.spmv_dual_step(op.a, *args)
    bad_stats = (
        (TypeError, (y.half(), z, z)),
        (ValueError, (y, z[:-1], z)),
        (ValueError, (y, z, z.cpu())),
    )
    for error, args in bad_stats:
        with pytest.raises(error):
            routed.spmv_rmv_stats(op.at, *args)
    routed.reset_launch_counts()
    routed.spmv_csr(op.a, torch.zeros(30, device=cuda))
    routed.spmv_dual_step(op.a, z, y, y, y, sigma)
    routed.spmv_rmv_stats(op.at, y, z, z)
    assert routed.LAUNCHES["spmv_csr:A"] == 1
    assert routed.LAUNCHES["spmv_dual_step"] == 1
    assert routed.LAUNCHES["spmv_rmv_stats"] == 1


# ---------------------------------------------------------------------------
# The probe kernels (ops/probe_routed.py)
# ---------------------------------------------------------------------------


def probe_tensors(cuda, nnz, seed=0):
    from firstorderlp_torch.ops import probe_routed as probe

    host = probe.make_probe_inputs(nnz, seed)
    dev = {k: torch.as_tensor(a, device=cuda) for k, a in host.items()}
    dev["g"] = dev["g2"].reshape(-1, 128)
    return probe, dev


@pytest.mark.parametrize("nnz", [1024, 8192, 819_200])
def test_probe_expand_is_exact(cuda, nnz):
    probe, d = probe_tensors(cuda, nnz)
    args = (d["strip_ids"], d["x_strips"], d["hi"], d["lo"])
    probe.reset_launch_counts()
    got = probe.probe_expand(*args)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["probe_expand"] == 1
    assert torch.equal(got, probe.probe_expand_plain(*args))


def reduce_error(probe, got, meta, d, n_strips):
    """Largest |y - plain| over max |plain| + 1, the plain version in
    f64."""
    want = probe.probe_reduce_plain(meta, d["g"].double(), d["v"].double(),
                                    d["hir"], d["lor"], n_strips)
    return float((got.double() - want).abs().max() / (want.abs().max() + 1))


@pytest.mark.parametrize("nnz", [1024, 8192, 819_200])
def test_probe_reduce_matches_plain_and_repeats(cuda, nnz):
    """One kernel a call by torch.profiler, within 1e-5 of the plain
    version in f64, 20 launches bitwise equal, the tickets back at zero
    after each launch."""
    from firstorderlp_torch.ops.probe_routed import device_profile

    probe, d = probe_tensors(cuda, nnz)
    args = (d["meta"], d["g"], d["v"], d["hir"], d["lor"])
    plan = probe.plan_probe_reduce(d["meta"], probe.N_STRIPS)
    probe.reset_launch_counts()
    got = probe.probe_reduce(*args, probe.N_STRIPS, plan=plan)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["probe_reduce"] == 1
    assert not plan.tickets.any()
    assert reduce_error(probe, got, d["meta"], d, probe.N_STRIPS) <= 1e-5
    problem = repeat_differs(
        lambda: probe.probe_reduce(*args, probe.N_STRIPS, plan=plan),
        (plan.tickets,))
    assert problem is None, problem
    # the largest count of three windows: the profiler may lose a kernel
    # in one, while a second kernel a call shows in every window
    kernels = max(device_profile(
        lambda: probe.probe_reduce(*args, probe.N_STRIPS, plan=plan), 20)[1]
        for _ in range(3))
    assert kernels == 1


@pytest.mark.parametrize("target_chunks", [1, 7, 10_000])
def test_probe_reduce_strip_without_groups_is_zero(cuda, target_chunks):
    """Strips 2 and 7 of 8 are named by no group; the chunking (one
    chunk a strip, a few chunks a strip, one group a chunk) changes the
    order of summation only inside the tolerance."""
    probe, d = probe_tensors(cuda, 40 * 1024, seed=3)
    strips = np.sort(np.random.default_rng(1).choice(
        [0, 1, 3, 4, 5, 6], size=40))
    meta = np.zeros((40, 2), np.int32)
    meta[:, 0] = strips
    meta[0, 1] = 1
    meta[1:, 1] = strips[1:] != strips[:-1]
    meta = torch.as_tensor(meta, device=cuda)
    plan = probe.plan_probe_reduce(meta, 8, target_chunks=target_chunks)
    for _ in range(2):
        # y likely takes this freed block: every strip must be written
        junk = torch.full((8, probe.HR, 128), float("nan"), device=cuda)
        del junk
        got = probe.probe_reduce(meta, d["g"], d["v"], d["hir"], d["lor"],
                                 8, plan=plan)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[2]) == 0
    assert torch.count_nonzero(got[7]) == 0
    assert not plan.tickets.any()
    assert reduce_error(probe, got, meta, d, 8) <= 1e-5


@pytest.mark.parametrize("warps", [1, 2, 4, 8, 11])
@pytest.mark.parametrize("table", ["one_strip", "empty_strip"])
def test_probe_reduce_tables_and_block_sizes(cuda, table, warps):
    """A table whose groups all name one strip (that strip split over
    many chunks, the others one empty chunk each), and one where a strip
    between others is named by no group; at every block size the
    kernel allows, within 1e-5 of the plain version, and the same bits
    twice."""
    probe, d = probe_tensors(cuda, 64 * 1024, seed=4)
    strips = np.zeros(64, np.int64) + 3
    if table == "empty_strip":
        strips = np.sort(np.random.default_rng(2).choice([0, 1, 2, 4, 5],
                                                         size=64))
    meta = np.zeros((64, 2), np.int32)
    meta[:, 0] = strips
    meta[0, 1] = 1
    meta[1:, 1] = strips[1:] != strips[:-1]
    meta = torch.as_tensor(meta, device=cuda)
    plan = dataclasses.replace(
        probe.plan_probe_reduce(meta, 6, target_chunks=16), warps=warps)
    args = (meta, d["g"], d["v"], d["hir"], d["lor"], 6)
    got = probe.probe_reduce(*args, plan=plan)
    again = probe.probe_reduce(*args, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not plan.tickets.any()
    assert reduce_error(probe, got, meta, d, 6) <= 1e-5
    named = set(strips.tolist())
    for s in set(range(6)) - named:
        assert torch.count_nonzero(got[s]) == 0


def test_probe_wrappers_reject_bad_inputs(cuda):
    probe, d = probe_tensors(cuda, 8192)  # strips 0 1 1 2 3 4 5 5
    with pytest.raises(TypeError):
        probe.probe_expand(d["strip_ids"], d["x_strips"].double(), d["hi"],
                           d["lo"])
    with pytest.raises(ValueError):
        probe.probe_expand(d["strip_ids"], d["x_strips"], d["hi"][:8],
                           d["lo"])
    with pytest.raises(ValueError):  # a CPU tensor among CUDA tensors
        probe.probe_reduce(d["meta"], d["g"].cpu(), d["v"], d["hir"],
                           d["lor"], 8)
    bad = d["meta"].clone()
    bad[2, 1] = 1  # a "first group" flag inside a strip's run
    with pytest.raises(ValueError):
        probe.probe_reduce(bad, d["g"], d["v"], d["hir"], d["lor"], 8)
    with pytest.raises(ValueError):  # contiguous, not 16-byte aligned
        buf = torch.empty(d["hir"].numel() + 1, dtype=torch.int32,
                          device=cuda)
        hir = buf[1:].view(-1, 128)
        hir.copy_(d["hir"])
        probe.probe_reduce(d["meta"], d["g"], d["v"], hir, d["lor"], 8)


def test_probe_kernels_guard_out_of_range_indices(cuda):
    """An index outside the strips must not read or write outside them:
    the expand gives 0 there, the reduce drops the entry."""
    probe, d = probe_tensors(cuda, 8192)
    hi, lo, ids = d["hi"].clone(), d["lo"].clone(), d["strip_ids"].clone()
    hi[0, 0], hi[9, 5], lo[20, 7], lo[33, 1] = probe.H, -1, 128, -5
    ids[-1] = probe.N_STRIPS  # the last group names no strip
    got = probe.probe_expand(ids, d["x_strips"], hi, lo)
    torch.cuda.synchronize()
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[0, 0] = bad[9, 5] = bad[20, 7] = bad[33, 1] = True
    bad[-probe.GROUP_ROWS:] = True
    want = probe.probe_expand_plain(
        ids.clamp(max=probe.N_STRIPS - 1), d["x_strips"],
        hi.clamp(0, probe.H - 1), lo.clamp(0, 127))
    assert torch.equal(got[~bad], want[~bad])
    assert torch.count_nonzero(got[bad]) == 0

    hir, lor = d["hir"].clone(), d["lor"].clone()
    hir[0, 0], hir[9, 5], lor[20, 7], lor[33, 1] = probe.HR, -1, 128, -5
    dropped = torch.zeros_like(d["g"], dtype=torch.bool)
    dropped[0, 0] = dropped[9, 5] = dropped[20, 7] = dropped[33, 1] = True
    got = probe.probe_reduce(d["meta"], d["g"], d["v"], hir, lor,
                             probe.N_STRIPS)
    want = probe.probe_reduce_plain(
        d["meta"], torch.where(dropped, 0.0, d["g"]).double(),
        d["v"].double(), hir.clamp(0, probe.HR - 1), lor.clamp(0, 127),
        probe.N_STRIPS)
    err = (got.double() - want).abs().max() / (want.abs().max() + 1)
    assert float(err) <= 1e-5


# ---------------------------------------------------------------------------
# The lane kernel L1 (ops/lanes.py) and the fleet
# ---------------------------------------------------------------------------


def lane_case(cuda, name, lanes_count, dtype, item_entries, seed=0):
    from firstorderlp_torch.ops import lanes

    a = sp.csr_matrix(MATRICES[name](), dtype=np.float64)
    a.sum_duplicates()
    a.sort_indices()
    pattern = lanes.build_lanes_pattern(a, cuda, item_entries=item_entries)
    rng = np.random.default_rng(seed)
    vals = torch.as_tensor(rng.standard_normal((a.nnz, lanes_count)),
                           device=cuda).to(dtype)
    op = lanes.lanes_op(pattern, vals)
    x = torch.as_tensor(rng.standard_normal((a.shape[1], lanes_count)),
                        device=cuda).to(dtype)
    y = torch.as_tensor(rng.standard_normal((a.shape[0], lanes_count)),
                        device=cuda).to(dtype)
    return lanes, pattern, op, x, y


# Lane counts of the vector variant (a lane row a multiple of 16 bytes:
# 4, 128, 300 in f32; 128, 300 in f64) and of the scalar one (1, 3, 5,
# 130, and 4 in f64); item sizes that cut the hub rows into many pieces,
# the default and a large one.
LANE_COUNTS = [1, 3, 4, 5, 128, 130, 300]
LANE_ITEM_SIZES = sorted({16, 64, 256, lane_ops.LANE_ITEM_ENTRIES})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes_count", LANE_COUNTS)
@pytest.mark.parametrize("item_entries", LANE_ITEM_SIZES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lanes_spmv_matches_plain(cuda, name, item_entries, lanes_count,
                                  dtype):
    """Against the plain version in f64, both orientations: within
    1e-5 (|A||x|) + 1e-7 in f32, 1e-12 (|A||x|) + 1e-14 in f64, in the
    variant the lane count and alignment give."""
    lanes, pattern, op, x, y = lane_case(cuda, name, lanes_count, dtype,
                                         item_entries)
    rel, tiny = (1e-5, 1e-7) if dtype == torch.float32 else (1e-12, 1e-14)
    for half, vals, v in ((pattern.fwd, op.vals, x),
                          (pattern.bwd, op.vals_t, y)):
        got = lanes.lanes_spmv(half, vals, v)
        want = lanes.lanes_spmv_plain(half, vals.double(), v.double())
        scale = lanes.lanes_spmv_plain(half, vals.double().abs(),
                                       v.double().abs())
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.double() - want).abs()
        assert bool((err <= rel * scale + tiny).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes_count", [3, 128, 130])
@pytest.mark.parametrize("item_entries", [16, 256])
def test_lanes_spmv_repeats_bitwise(cuda, item_entries, lanes_count, dtype):
    lanes, pattern, op, x, y = lane_case(cuda, "hub", lanes_count,
                                         dtype, item_entries)
    for half, vals, v in ((pattern.fwd, op.vals, x),
                          (pattern.bwd, op.vals_t, y)):
        problem = repeat_differs(lambda: lanes.lanes_spmv(half, vals, v),
                                 (half.tickets,))
        assert problem is None, problem


def shifted(t):
    """`t` again, one lane row further into a larger tensor: a row slice
    whose base is B elements past an aligned one."""
    big = torch.empty((t.shape[0] + 1, t.shape[1]), dtype=t.dtype,
                      device=t.device)
    big[1:] = t
    return big[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes_count", [3, 4, 5, 128, 130])
def test_lanes_spmv_same_bits_in_every_variant_and_plan(cuda, lanes_count,
                                                        dtype):
    """The hub rows cut into pieces (items of 16 entries): the planes and
    vectors as row slices (16-byte aligned only where B s is a multiple
    of 16: the scalar variant at B = 3, 5, 130), and every plan the
    sweep may take (4, 8 or 16 entries loaded at once; 4-, 8- and
    16-byte lanes) give the default launch's bits: each lane of a row is
    summed by one thread in entry order whatever the launch. Each
    product is one count in LAUNCHES, whichever variant ran."""
    lanes, pattern, op, x, y = lane_case(cuda, "hub", lanes_count, dtype,
                                         16)
    s = x.element_size()
    for half, vals, v in ((pattern.fwd, op.vals, x),
                          (pattern.bwd, op.vals_t, y)):
        want = lanes.lanes_spmv(half, vals, v)
        assert lanes.launch_plan(half, vals, v).variant == (
            "scalar" if lanes_count * s % 16 else f"vector{16 // s}")
        vals_s, v_s = shifted(vals), shifted(v)
        plan = lanes.launch_plan(half, vals_s, v_s)
        assert plan.variant == ("scalar" if lanes_count * s % 16
                                else f"vector{16 // s}")
        lanes.reset_launch_counts()
        got = lanes.lanes_spmv(half, vals_s, v_s)
        assert lanes.LAUNCHES[f"lanes_spmv:{half.label}"] == 1
        assert torch.equal(got, want)
        for unroll in (4, 8, 16):
            for vector_bytes in sorted({s, 8, 16}):
                other = lanes.lanes_plan(half, lanes_count, s, True,
                                         unroll=unroll,
                                         vector_bytes=vector_bytes)
                got = lanes.lanes_spmv(half, vals, v, plan=other)
                assert torch.equal(got, want), other
        assert not half.tickets.any()


def test_lanes_wrapper_rejects_bad_inputs_and_counts(cuda):
    lanes, pattern, op, x, y = lane_case(cuda, "tiny", 4, torch.float32, 16)
    half = pattern.fwd
    bad = (
        (TypeError, (op.vals, x.half())),  # f16
        (TypeError, (op.vals.double(), x)),  # values of another dtype
        (ValueError, (op.vals, x[:-1])),  # short x
        (ValueError, (op.vals[:, :3].contiguous(), x)),  # fewer lanes
        (ValueError, (op.vals, x.cpu())),  # a CPU x
        (ValueError, (op.vals, x.T.contiguous().T)),  # strided x
    )
    for error, args in bad:
        with pytest.raises(error):
            lanes.lanes_spmv(half, *args)
    lanes.reset_launch_counts()
    op.mv(x)
    op.rmv(y)
    op.rmv(y)
    assert {k: v for k, v in lanes.LAUNCHES.items() if v} == {
        "lanes_spmv:A": 1, "lanes_spmv:AT": 2}


def card_params():
    """bench.py's settings in f32 to 1e-4 (chip_smoke.py's make_params)."""
    import firstorderlp_torch as tx

    return tx.PdhgParameters(
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
        dtype="float32",
    )


def test_fleet_solves_on_the_card(cuda):
    """A 4-lane FleetSpec fleet in f32 on the card ends OPTIMAL at 1e-4
    in every lane through the lane kernel, with the reasons of the same
    fleet on the CPU."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.generators import pagerank_fleet_spec
    from firstorderlp_torch.ops import lanes

    params = card_params()
    spec = pagerank_fleet_spec(500, [0.7, 0.8, 0.9, 0.99], seed=0)
    lanes.reset_launch_counts()
    on_card = batch.solve_batch_shared_pattern(params, spec, device=cuda)
    assert lanes.LAUNCHES["lanes_spmv:A"] > 0
    assert lanes.LAUNCHES["lanes_spmv:AT"] > 0
    on_cpu = batch.solve_batch_shared_pattern(params, spec, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
        assert b.termination_reason == a.termination_reason
        assert np.all(np.isfinite(a.primal_solution))


# ---------------------------------------------------------------------------
# The fleet's lane trial (ops/lanes_step.py: LF1a, L1 with the dual step,
# L1' with the step-control sums, LF1b)
# ---------------------------------------------------------------------------


def lane_trial_case(cuda, nodes, lanes_count, segments=3):
    """A PageRank damping sweep of `lanes_count` lanes at `nodes` nodes on
    the card, `segments` segments into its solve: (problem, state,
    config)."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.generators import pagerank_fleet_spec

    params = card_params()
    spec = pagerank_fleet_spec(nodes, np.linspace(0.7, 0.995, lanes_count),
                               seed=0)
    fleet = batch.prepare_shared_pattern_fleet(params, spec, device=cuda)
    config = batch._config(params)
    state = fleet.initial_state
    for _ in range(segments):
        state, _, _ = batch.run_segment(fleet.bundle, state, 0.0, config)
    return fleet.bundle.scaled, state, config


def within_an_ulp(got, want):
    """Each f32 entry equal to `want` or its neighbour on either side."""
    up = torch.nextafter(want, torch.full_like(want, float("inf")))
    down = torch.nextafter(want, torch.full_like(want, float("-inf")))
    return bool(((got == want) | (got == up) | (got == down)).all())


def lane_trial_kernels(problem, state, start, config, ws):
    """Each of the four kernels on the state, and its plain version on the
    same inputs (its own plain inputs: each kernel is held alone). Returns
    (kernel outputs, plain outputs), name -> tuple, cloned."""
    from firstorderlp_torch.models import pdhg as _pdhg
    from firstorderlp_torch.ops import lanes_step

    policy = config.step_policy
    frequency = config.termination_evaluation_frequency
    limit = config.criteria.iteration_limit
    op = problem.constraint_matrix
    x, y = state.current_primal_solution, state.current_dual_solution
    aty, step, weight = (state.current_dual_product, state.step_size,
                         state.primal_weight)
    got, want = {}, {}

    def keep(t):
        return tuple(None if v is None else v.clone() for v in t)

    primal = (x, problem.objective_vector, aty,
              problem.variable_lower_bound, problem.variable_upper_bound,
              step, weight, state.termination_reason, state.numerical_error,
              state.iteration, start, frequency, limit)
    got["primal"] = keep(lanes_step.lane_primal_step(ws, *primal))
    want["primal"] = lanes_step.lane_primal_step_plain(*primal)
    next_x, z, active = want["primal"]
    dual = (op.pattern.fwd, op.vals, z, y, problem.right_hand_side,
            problem.is_equality, step, weight)
    got["dual"] = keep(lanes_step.lanes_dual_step(ws, *dual))
    want["dual"] = lanes_step.lanes_dual_step_plain(*dual)
    next_y, dy2 = want["dual"]
    stats = (op.pattern.bwd, op.vals_t, next_y, next_x, x, aty)
    verdict_args = (active, step, weight, state.total_number_iterations,
                    policy.reduction_exponent, policy.growth_exponent)
    got["stats"] = keep(lanes_step.lanes_rmv_stats(ws, *stats, dy2,
                                                   *verdict_args))
    got["sums"] = keep(tuple(ws.stats["sums"]))
    next_aty, interaction, dx2 = lanes_step.lanes_rmv_stats_plain(*stats)
    want["sums"] = (interaction, dx2)
    want["stats"] = (next_aty, *lanes_step.lane_verdict_plain(
        dy2, interaction, dx2, *verdict_args))
    # the verdict from the kernel's own sums: bitwise the plain one
    want["verdict"] = lanes_step.lane_verdict_plain(
        dy2, *got["sums"], *verdict_args)
    take, new_step, new_error = want["stats"][1:]
    epilogue = (_pdhg._trial_fields(state), next_x, next_y, next_aty,
                active, take, new_step, new_error, state.termination_reason,
                start, frequency, limit)
    f, word = lanes_step.lane_trial_epilogue(*epilogue)
    got["epilogue"] = (*(getattr(f, fl.name).clone()
                         for fl in dataclasses.fields(f)), word.clone())
    f, word = lanes_step.lane_trial_epilogue_plain(*epilogue)
    want["epilogue"] = (*(getattr(f, fl.name) for fl in dataclasses.fields(f)),
                        word)
    return got, want


@pytest.mark.parametrize("nodes,lanes_count", [(20_000, 128),
                                               (100_000, 128), (2_000, 3)])
def test_lane_trial_kernels_are_their_plain_versions(cuda, nodes,
                                                     lanes_count):
    """At 128 x 20k and 128 x 100k (the vector variants) and 3 lanes (the
    scalar ones), mid-solve: each kernel's vectors, mask, verdict and
    selected state bitwise its plain version; the f64 step-control sums
    (dy2, the interaction, dx2) within an ulp of the plain f64 sums, and
    the verdict from the kernel's sums bitwise the plain verdict from
    them; the tickets back at zero."""
    from firstorderlp_torch.ops import lanes_step

    problem, state, config = lane_trial_case(cuda, nodes, lanes_count)
    start = state.iteration.clone()
    ws = lanes_step.trial_workspace(problem.constraint_matrix)
    got, want = lane_trial_kernels(problem, state, start, config, ws)
    torch.cuda.synchronize()
    for name in ("primal", "epilogue"):
        for k, (g, w) in enumerate(zip(got[name], want[name])):
            assert torch.equal(g, w), (name, k)
    assert torch.equal(got["dual"][0], want["dual"][0])
    assert within_an_ulp(got["dual"][1], want["dual"][1])
    assert torch.equal(got["stats"][0], want["stats"][0])
    for g, w in zip(got["sums"], want["sums"]):
        assert within_an_ulp(g, w)
    for g, w in zip(got["stats"][1:], want["verdict"]):
        assert torch.equal(g, w)
    assert bool(want["primal"][2].any())  # the trial is active somewhere
    op = problem.constraint_matrix
    for t in (ws.dual["tickets"], ws.stats["tickets"], op.pattern.fwd.tickets,
              op.pattern.bwd.tickets):
        assert not t.any()


def test_lane_trial_kernels_repeat_bitwise(cuda):
    """Two launches of each kernel on the same inputs give the same bits
    (the f64 sums in one fixed order, no floating-point atomics)."""
    from firstorderlp_torch.ops import lanes_step

    problem, state, config = lane_trial_case(cuda, 20_000, 128)
    start = state.iteration.clone()
    ws = lanes_step.trial_workspace(problem.constraint_matrix)
    first, _ = lane_trial_kernels(problem, state, start, config, ws)
    second, _ = lane_trial_kernels(problem, state, start, config, ws)
    for name in first:
        for g, w in zip(first[name], second[name]):
            assert g is None or torch.equal(g, w), name


def test_fused_lane_trial_counts_its_launches(cuda):
    """A fused trial is four launches, one in each of its entries of
    ops/lanes.LAUNCHES, and the eager trial's own state but for the
    step size, which follows the f64 sums (within an ulp here)."""
    from firstorderlp_torch import batch

    problem, state, config = lane_trial_case(cuda, 20_000, 128)
    start = state.iteration.clone()
    lane_ops.reset_launch_counts()
    got, word = batch.fused_lane_step(problem, state, start, config)
    assert {k: v for k, v in lane_ops.LAUNCHES.items() if v} == {
        "lane_primal_step": 1, "lanes_spmv:A+dual": 1,
        "lanes_spmv:AT+stats": 1, "lane_trial_epilogue": 1}
    active = batch._lane_active(state, start, config)
    want = batch.pdhg_lane_step(problem, state, active, config.step_policy)
    assert_same_bits(dataclasses.replace(got, step_size=want.step_size),
                     want)
    assert within_an_ulp(got.step_size, want.step_size)
    assert int(word) == int(batch._lane_active(got, start, config).any())


def test_constant_step_fleet_keeps_the_eager_trial(cuda):
    """Constant steps (a list fleet, the per-instance ingest) keep the
    eager trial, pdhg_lane_step_constant: a segment launches none of the
    lane trial's kernels and counts no fused trial, at 128 lanes and at
    3."""
    import firstorderlp_torch as tx
    from firstorderlp_torch import batch, spans
    from firstorderlp_torch.generators import generate_pagerank_lp_fleet

    params = dataclasses.replace(
        card_params(), step_size_policy_params=tx.ConstantStepsizeParams())
    for lanes_count in (128, 3):
        problems = generate_pagerank_lp_fleet(
            2_000, np.linspace(0.7, 0.99, lanes_count), seed=0)
        fleet = batch.prepare_shared_pattern_fleet(params, problems,
                                                   device=cuda)
        config = batch._config(params)
        assert not batch._fused_lanes(fleet.bundle.scaled,
                                      fleet.initial_state, config)
        lane_ops.reset_launch_counts()
        before = dict(spans.COUNTS)
        state = fleet.initial_state
        for _ in range(12):
            state, _, _ = batch.run_segment(fleet.bundle, state, 0.0,
                                            config)
        assert spans.COUNTS["steps"] > before["steps"]
        assert spans.COUNTS["fused_lane_trials"] == before[
            "fused_lane_trials"]
        assert {k for k, v in lane_ops.LAUNCHES.items() if v} == {
            "lanes_spmv:A", "lanes_spmv:AT"}


def plain_lane_trial(monkeypatch):
    """Routes the four wrappers of ops/lanes_step.py to their plain
    versions, so batch.fused_lane_step runs the same contract (the
    step-control sums in f64, rounded once) in PyTorch on the card."""
    from firstorderlp_torch.ops import lanes_step

    def verdict_too(ws, half, vals_t, y_next, x_next, x, aty, dy2, *rest):
        aty_next, interaction, dx2 = lanes_step.lanes_rmv_stats_plain(
            half, vals_t, y_next, x_next, x, aty)
        return (aty_next, *lanes_step.lane_verdict_plain(
            dy2, interaction, dx2, *rest))

    monkeypatch.setattr(lanes_step, "lane_primal_step",
                        lambda ws, *a: lanes_step.lane_primal_step_plain(*a))
    monkeypatch.setattr(
        lanes_step, "lanes_dual_step",
        lambda ws, *a, **k: lanes_step.lanes_dual_step_plain(*a, **k))
    monkeypatch.setattr(lanes_step, "lanes_rmv_stats", verdict_too)
    monkeypatch.setattr(lanes_step, "lane_trial_epilogue",
                        lanes_step.lane_trial_epilogue_plain)


def test_fused_fleet_solve_on_the_card(cuda, monkeypatch):
    """A 128-lane 20k-node damping sweep by the fused trial: every lane
    OPTIMAL with host-f64 residuals within the sweep cell's 1.1e-4, every
    trial fused (COUNTS["fused_lane_trials"] == COUNTS["steps"]), the
    same bits in a second solve, and each lane's iterations those of the
    plain versions of the kernels (the same contract: the step-control
    sums in f64, rounded once). Against the eager trial, whose f32 sums
    round otherwise (the trial the JAX package's fleet computes;
    test_torch_lanes_step.py holds the fused answers against that fleet
    on the CPU): each lane OPTIMAL in both, each lane's primal answer
    within the sweep cell's l1 limit of 0.01 of the eager one, and the
    fleet's lane-iterations within 5% (a lane's own count moves with its
    restarts: PERF.md §6)."""
    from firstorderlp_torch import batch, spans
    from firstorderlp_torch.generators import pagerank_fleet_spec

    params = card_params()
    damping = np.linspace(0.7, 0.995, 128)
    spec = pagerank_fleet_spec(20_000, damping, seed=0)
    fleet = batch.prepare_shared_pattern_fleet(params, spec, device=cuda)
    before = dict(spans.COUNTS)
    fused = batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
    steps = spans.COUNTS["steps"] - before["steps"]
    assert steps > 0
    assert spans.COUNTS["fused_lane_trials"] - before[
        "fused_lane_trials"] == steps
    again = batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
    for a, b in zip(fused, again):
        assert np.array_equal(a.primal_solution, b.primal_solution)
    for d, a in zip(damping, fused):
        assert a.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
        lp = generate_pagerank_lp(20_000, damping_factor=float(d), seed=0)
        assert max(host_lp_residuals(lp, a.primal_solution,
                                     a.dual_solution)) <= 1.1e-4, d
    with monkeypatch.context() as patch:
        plain_lane_trial(patch)
        plain = batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
    assert [a.iteration_count for a in fused] == [
        b.iteration_count for b in plain]
    monkeypatch.setattr(batch, "_fused_lanes", lambda *args: False)
    before = spans.COUNTS["fused_lane_trials"]
    eager = batch.solve_batch_shared_pattern(params, spec, fleet=fleet)
    assert spans.COUNTS["fused_lane_trials"] == before
    for a, b in zip(fused, eager):
        assert b.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
        assert float(np.abs(np.asarray(a.primal_solution, np.float64)
                            - b.primal_solution).sum()) <= 0.01
    total = sum(a.iteration_count for a in fused)
    eager_total = sum(b.iteration_count for b in eager)
    assert abs(total - eager_total) <= 0.05 * eager_total


def host_lp_residuals(lp, x, y):
    """The relative primal and dual residuals and the gap of (x, y) on
    the LP, in f64 (the benchmark's judge, lpbench/reference/kkt.py)."""
    a = sp.csr_matrix(lp.constraint_matrix)
    b, c = lp.right_hand_side, lp.objective_vector
    lb, ub = lp.variable_lower_bound, lp.variable_upper_bound
    meq = lp.num_equalities
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    ax = a @ x
    viol = np.concatenate([(b - ax)[:meq], np.maximum(b - ax, 0.0)[meq:],
                           np.maximum(lb - x, 0.0), np.maximum(x - ub, 0.0)])
    g = c - a.T @ y
    bound = np.where(g > 0.0, lb, ub)
    rc = np.where(np.isfinite(bound), g, 0.0)
    dual_viol = np.concatenate([np.maximum(-y[meq:], 0.0), g - rc])
    pobj = lp.objective_constant + float(c @ x)
    dobj = (float(b @ y) + lp.objective_constant
            + float(np.sum(np.where(rc != 0.0, bound, 0.0) * rc)))
    return (np.linalg.norm(viol) / (1 + np.linalg.norm(b)),
            np.linalg.norm(dual_viol) / (1 + np.linalg.norm(c)),
            abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj)))


def mixed_fleet_matrices(sizes=(300, 1000, 2500, 600), seed=3):
    """The constraint matrices of PageRank LPs of mixed sizes (each with
    its dense equality row) padded to the largest, and an empty one."""
    mats = [generate_pagerank_lp(nodes, seed=seed + i).constraint_matrix
            for i, nodes in enumerate(sizes)]
    m = max(a.shape[0] for a in mats)
    n = max(a.shape[1] for a in mats)
    padded = []
    for a in mats:
        coo = a.tocoo()
        padded.append(sp.csr_matrix((coo.data, (coo.row, coo.col)),
                                    shape=(m, n)))
    return padded + [sp.csr_matrix((m, n))]


@pytest.mark.parametrize("item_entries", [256, routed.ITEM_ENTRIES])
def test_block_lanes_spmv_matches_plain_and_repeats(cuda, item_entries):
    """B2 on the interleaved block-diagonal matrix of five lanes (every
    lane's dense row cut into pieces at 256-entry items): A x and A' y
    against the plain version on the card within the f32 rounding of
    the sums, 20 launches bitwise equal with the tickets back at zero,
    one count a product."""
    from firstorderlp_torch.ops import block_lanes

    mats = mixed_fleet_matrices()
    lanes_count = len(mats)
    op = block_lanes.build_block_lanes(mats, cuda)
    a = routed.csr_with_items(op.a, item_entries)
    at = routed.csr_with_items(op.at, item_entries)
    m, n = op.shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, lanes_count), generator=gen, device=cuda)
    y = torch.randn((m, lanes_count), generator=gen, device=cuda)
    for mat, v, rows in ((a, x, m), (at, y, n)):
        got = routed.spmv_csr(mat, v.reshape(-1)).reshape(rows, lanes_count)
        want = block_lanes.block_lanes_spmv_plain(mat, v)
        scale = block_lanes.block_lanes_spmv_plain(
            dataclasses.replace(mat, vals=mat.vals.abs()), v.abs())
        assert torch.all((got - want).abs() <= 1e-5 * scale + 1e-7)
        problem = repeat_differs(
            lambda mat=mat, v=v: routed.spmv_csr(mat, v.reshape(-1)),
            tickets_of(mat))
        assert problem is None, problem
    routed.reset_launch_counts()
    op.mv(x)
    op.rmv(y)
    assert routed.LAUNCHES["spmv_csr:A"] == 1
    assert routed.LAUNCHES["spmv_csr:AT"] == 1


def test_hetero_fleet_solves_on_the_card(cuda):
    """A 4-lane heterogeneous fleet (PageRank LPs of 300-2,500 nodes) in
    f32 on the card ends OPTIMAL at 1e-4 in every lane through B2 (and
    not L1), with the reasons of the same fleet on the CPU."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.ops import lanes

    params = card_params()
    problems = [generate_pagerank_lp(nodes, seed=10 + i)
                for i, nodes in enumerate((300, 1000, 2500, 600))]
    routed.reset_launch_counts()
    lanes.reset_launch_counts()
    on_card = batch.solve_batch(params, problems, device=cuda)
    assert routed.LAUNCHES["spmv_csr:A"] > 0
    assert routed.LAUNCHES["spmv_csr:AT"] > 0
    assert not any(lanes.LAUNCHES.values())
    on_cpu = batch.solve_batch(params, problems, device="cpu")
    for problem, a, b in zip(problems, on_card, on_cpu):
        assert a.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
        assert b.termination_reason == a.termination_reason
        assert a.primal_solution.shape == (problem.num_variables,)
        assert np.all(np.isfinite(a.primal_solution))


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_qp_fleet_solves_on_the_card(cuda, solver):
    """A 4-lane Tikhonov path (a 500-node PageRank LP plus lambda I) on
    the card ends OPTIMAL at 1e-4 in every lane, L1 launched for A, A'
    and Q, with the reasons of the same fleet on the CPU."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.models.mirror_prox import MirrorProxParameters
    from firstorderlp_torch.ops import lanes

    params = card_params()
    if solver == "mirror_prox":
        params = MirrorProxParameters(
            l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
            pock_chambolle_alpha=1.0, primal_importance=1.0,
            scale_invariant_initial_primal_weight=True,
            diagonal_scaling="l2", verbosity=0,
            record_iteration_stats=False,
            termination_evaluation_frequency=40,
            termination_criteria=params.termination_criteria,
            restart_params=params.restart_params, dtype="float32")
    base = generate_pagerank_lp(500, seed=0)
    problems = [dataclasses.replace(
        base, objective_matrix=sp.csc_matrix(w * sp.eye(base.num_variables)))
        for w in np.geomspace(1e-3, 1.0, 4)]
    lanes.reset_launch_counts()
    on_card = batch.solve_batch_shared_pattern(params, problems, device=cuda)
    for key in ("lanes_spmv:A", "lanes_spmv:AT", "lanes_spmv:Q"):
        assert lanes.LAUNCHES[key] > 0, key
    on_cpu = batch.solve_batch_shared_pattern(params, problems, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
        assert b.termination_reason == a.termination_reason
        assert np.all(np.isfinite(a.primal_solution))


@pytest.mark.parametrize("tile_aligned", [False, True])
def test_sharded_operator_on_the_card(cuda, tile_aligned):
    """The block-partitioned operator (ops/routed_sharded.py) on a (2, 2)
    mesh of the one card, with an empty block: A x and A' y against the
    same operator's blocks on the CPU (their plain versions), two calls
    bitwise equal, one launch a product for each non-empty block."""
    from firstorderlp_torch.ops.routed_sharded import (
        RoutedShardPlan, build_sharded_routed_op,
    )
    from firstorderlp_torch.parallel import solver_mesh

    rng = np.random.default_rng(4)
    a = sp.lil_matrix(sp.random(600, 500, density=0.02, random_state=rng))
    a[:300, 250:] = 0.0  # block (0, 1) empty
    a[305, :] = rng.standard_normal(500)  # a dense row across two blocks
    a = sp.csr_matrix(a)
    a.eliminate_zeros()
    ops = {
        dev.type: build_sharded_routed_op(a, RoutedShardPlan(
            mesh=solver_mesh(2, 2, [dev] * 4), tile_aligned=tile_aligned))
        for dev in (cuda, torch.device("cpu"))
    }
    assert ops["cuda"].blocks[0][1] is None
    kernel = "tiled_spmv" if tile_aligned else "spmv_csr"
    for label, n, transpose in (("A", 500, False), ("AT", 600, True)):
        v = torch.as_tensor(rng.standard_normal(n).astype(np.float32))

        def product(op, vec):
            return op.rmv(vec) if transpose else op.mv(vec)

        routed.reset_launch_counts()
        got = product(ops["cuda"], v.to(cuda))
        torch.cuda.synchronize()
        assert routed.LAUNCHES[f"{kernel}:{label}"] == 3
        want = product(ops["cpu"], v)
        dense = a.T.toarray() if transpose else a.toarray()
        scale = np.abs(dense) @ np.abs(v.double().numpy())
        err = np.abs(got.cpu().double().numpy() - want.double().numpy())
        assert np.all(err <= 1e-5 * scale + 1e-7)
        assert torch.equal(got, product(ops["cuda"], v.to(cuda)))


def test_sharded_solve_on_the_card(cuda):
    """sharded_optimize on a (2, 2) mesh of the card ends OPTIMAL at 1e-4
    with the B2 blocks launched and the fused kernels not, and gives the
    same bits twice."""
    from firstorderlp_torch.parallel import sharded_optimize, solver_mesh

    problem = generate_pagerank_lp(2_000, seed=0)
    params = dataclasses.replace(card_params(), matrix_format="routed")
    mesh = solver_mesh(2, 2, [cuda] * 4)
    routed.reset_launch_counts()
    runs = [sharded_optimize(params, problem, mesh) for _ in range(2)]
    assert routed.LAUNCHES["spmv_csr:A"] > 0
    assert routed.LAUNCHES["spmv_dual_step"] == 0
    assert runs[0].termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    assert runs[0].primal_solution.shape == (problem.num_variables,)
    assert np.array_equal(runs[0].primal_solution, runs[1].primal_solution)
    assert np.array_equal(runs[0].dual_solution, runs[1].dual_solution)


@pytest.mark.parametrize("tile_aligned", [False, True])
def test_host_sharded_solve_on_the_card(cuda, tile_aligned):
    """host_sharded_optimize (parallel/shard_ingest.py) on a (2, 2) mesh
    of the card: OPTIMAL at 1e-4, the same bits twice and the same
    rescaled problem as on the CPU (the rescale's sums are B2 with the
    block's values swapped in, one launch a non-empty row block and
    orientation); the solve's products launch B2 (or B5) once a
    non-empty cell."""
    from firstorderlp_torch.parallel import solver_mesh
    from firstorderlp_torch.parallel import shard_ingest as si

    problem = generate_pagerank_lp(2_000, seed=0)
    params = dataclasses.replace(card_params(), matrix_format="routed")
    spec = si.problem_row_shard_spec(problem)
    kernel = "tiled_spmv" if tile_aligned else "spmv_csr"
    saved = routed.DEFAULT_TILE_ALIGNED
    routed.DEFAULT_TILE_ALIGNED = tile_aligned
    try:
        runs, reports = [], []
        for _ in range(2):
            routed.reset_launch_counts()
            reports.append({})
            runs.append(si.host_sharded_optimize(
                params, spec, solver_mesh(2, 2, [cuda] * 4), reports[-1]))
    finally:
        routed.DEFAULT_TILE_ALIGNED = saved
    report = reports[-1]
    assert report["rescale_sums"] == {"spmv_csr:A": 2, "spmv_csr:AT": 2}
    for label in ("A", "AT"):
        own = routed.LAUNCHES[f"{kernel}:{label}"] - (
            report["rescale_sums"].get(f"{kernel}:{label}", 0))
        assert own > 0 and own % report["nonempty_cells"] == 0
    assert routed.LAUNCHES["spmv_dual_step"] == 0
    assert runs[0].termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    assert runs[0].primal_solution.shape == (problem.num_variables,)
    assert np.array_equal(runs[0].primal_solution, runs[1].primal_solution)
    assert np.array_equal(runs[0].dual_solution, runs[1].dual_solution)
    m_b = -(-problem.num_constraints // 2)
    rescaled = {}
    for dev in (cuda, torch.device("cpu")):
        blocks = {d: si.load_row_block(spec, d, m_b, problem.num_variables,
                                       dev, "routed") for d in range(2)}

        def vec(v, size, dev=dev):
            out = np.zeros(size)
            out[:len(v)] = v
            return torch.as_tensor(out, dtype=torch.float32, device=dev)

        got = si.sharded_rescale(
            blocks, {"b": vec(spec.right_hand_side, 2 * m_b),
                     "c": vec(spec.objective_vector, problem.num_variables),
                     "lo": vec(spec.variable_lower_bound,
                               problem.num_variables),
                     "hi": vec(spec.variable_upper_bound,
                               problem.num_variables)},
            solver_mesh(2, 1, [dev] * 2), 10, True, 1.0)
        rescaled[dev.type] = torch.cat([got.values[0], got.values[1]]).cpu()
    torch.testing.assert_close(rescaled["cuda"], rescaled["cpu"],
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The on-device segment: graph replays against the eager masked steps
# ---------------------------------------------------------------------------

INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32}


def assert_same_bits(got, want, path="state"):
    """Every field equal: tensors bitwise (NaN payloads too), other values
    by ==; a host number against a 0-d tensor by value."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same_bits(getattr(got, f.name), getattr(want, f.name),
                             f"{path}.{f.name}")
    elif isinstance(want, tuple):
        for name, u, v in zip(want._fields, got, want):
            assert_same_bits(u, v, f"{path}.{name}")
    elif isinstance(want, torch.Tensor) and isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype, path

        def bits(t):
            t = t.cpu()
            return t.view(INT_OF[t.dtype]) if t.dtype in INT_OF else t

        assert torch.equal(bits(got), bits(want)), path
    elif isinstance(want, torch.Tensor) or isinstance(got, torch.Tensor):
        assert float(got) == float(want), path
    else:
        assert got == want, path


def segment_case(cuda, solver, tile_aligned, monkeypatch):
    """(solver module, bundle, config, state at iteration 81) of the
    2,000-node PageRank LP in f32 on the kernel operator, the first 11
    segments run eagerly."""
    import firstorderlp_torch as tx
    from firstorderlp_torch.models import mirror_prox, pdhg

    monkeypatch.setattr(routed, "DEFAULT_TILE_ALIGNED", tile_aligned)
    problem = generate_pagerank_lp(2000, seed=0)
    params = dataclasses.replace(card_params(), matrix_format="routed")
    if solver == "pdhg_constant":
        params = dataclasses.replace(
            params, step_size_policy_params=tx.ConstantStepsizeParams())
    if solver == "mirror_prox":
        module = mirror_prox
        params = tx.MirrorProxParameters(
            l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
            pock_chambolle_alpha=1.0, primal_importance=1.0,
            scale_invariant_initial_primal_weight=True,
            diagonal_scaling="l2", verbosity=0, record_iteration_stats=False,
            termination_evaluation_frequency=40,
            termination_criteria=params.termination_criteria,
            restart_params=params.restart_params, dtype="float32",
            matrix_format="routed")
        config = mirror_prox._MpConfig(
            criteria=params.termination_criteria,
            restart_params=params.restart_params,
            termination_evaluation_frequency=40)
    else:
        module = pdhg
        config = pdhg._make_config(params)
    prepared = module.prepare_problem(params, problem, device=cuda)
    state = prepared.initial_state
    for _ in range(11):
        state, _ = module._segment_core(prepared.bundle, state, 0.0, config,
                                        _eager=True)
    return module, prepared.bundle, config, state


@pytest.mark.parametrize("tile_aligned", [False, True])
@pytest.mark.parametrize("solver", ["pdhg", "pdhg_constant", "mirror_prox"])
def test_graphed_segments_are_bitwise_the_eager_ones(cuda, solver,
                                                     tile_aligned,
                                                     monkeypatch):
    """Up to three segments from the same state (fewer when an
    evaluation ends the solve), the evaluation and the steps replayed
    from the bundle's graphs (captured once) and run eagerly: every
    field of the state and of the evaluation's result bitwise equal, the
    same launch counts (the replays credited; the capture's warm-up
    evaluation and step apart), one replay a trial and an evaluation,
    and the kernels' tickets back at zero after the replays."""
    from firstorderlp_torch import spans

    module, bundle, config, state = segment_case(cuda, solver,
                                                 tile_aligned, monkeypatch)
    eager = graphed = state
    spans.reset_counts()
    for _ in range(3):
        routed.reset_launch_counts()
        eager, eres = module._segment_core(bundle, eager, 0.0, config,
                                           _eager=True)
        eager_launches = dict(routed.LAUNCHES)
        routed.reset_launch_counts()
        replays = spans.COUNTS["replays"]
        captured = dict(bundle.graphs)
        graphed, gres = module._segment_core(bundle, graphed, 0.0, config)
        for key, graph in bundle.graphs.items():
            if key not in captured:  # the capture's warm-up step
                for name, count in graph.warmup_launches.items():
                    routed.LAUNCHES[name] -= count
        assert dict(routed.LAUNCHES) == eager_launches
        assert gres.termination_reason == eres.termination_reason
        assert_same_bits(graphed, eager)
        assert_same_bits(gres, eres, "result")
        if gres.termination_reason != 0:  # the evaluation ended the solve
            break
        assert spans.COUNTS["replays"] > replays
    assert len(bundle.graphs) == spans.COUNTS["captures"] == 1
    assert 2 * spans.COUNTS["replays"] == spans.COUNTS["steps"]
    assert 2 * spans.COUNTS["eval_replays"] == spans.COUNTS["evaluations"]
    torch.cuda.synchronize()
    op = bundle.scaled.constraint_matrix
    for tickets in tickets_of(op.a, op.at):
        assert not bool(tickets.any())


def test_a_capture_that_fails_raises(cuda):
    """An evaluation that reads a value back cannot be captured: the
    capture raises, and nothing is cached or replayed in its place."""
    from firstorderlp_torch.ops import graphs

    @dataclasses.dataclass(frozen=True)
    class Carry:
        x: torch.Tensor

    def syncing_evaluation(carry):
        return Carry(x=carry.x + carry.x.sum().item()), carry.x.sum()

    def step(carry):
        return Carry(x=carry.x + 1.0)

    bundle = types.SimpleNamespace(graphs={})
    with pytest.raises(RuntimeError):
        graphs.cached(bundle, "segment", lambda: graphs.SegmentGraphs(
            syncing_evaluation, step, Carry(x=torch.ones(8, device=cuda)),
            ()))
    assert bundle.graphs == {}
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=cuda).sum()) == 2.0


@pytest.mark.parametrize("layout", ["routed", "sparse"])
@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_an_eager_evaluation_does_not_synchronize(cuda, solver, layout):
    """The device evaluation (statistics, termination, bound estimates,
    restart) on the card makes no host synchronization at all, under
    torch.cuda.set_sync_debug_mode("error"): on the kernel operator in
    f32, and on the f64 CsrOp that runs it eagerly."""
    import firstorderlp_torch as tx
    from firstorderlp_torch.models import mirror_prox, pdhg

    problem = generate_pagerank_lp(2000, seed=0)
    dtype = "float32" if layout == "routed" else "float64"
    params = dataclasses.replace(card_params(), matrix_format=layout,
                                 dtype=dtype, record_iteration_stats=True)
    module = pdhg
    if solver == "mirror_prox":
        module = mirror_prox
        params = tx.MirrorProxParameters(
            l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
            pock_chambolle_alpha=1.0, primal_importance=1.0,
            scale_invariant_initial_primal_weight=True,
            diagonal_scaling="l2", verbosity=0, record_iteration_stats=True,
            termination_evaluation_frequency=40,
            termination_criteria=params.termination_criteria,
            restart_params=params.restart_params, dtype=dtype,
            matrix_format=layout)
    prepared = module.prepare_problem(params, problem, device=cuda)
    config = module._make_config(params)
    state = module._device_counters(prepared.initial_state)
    for _ in range(11):  # to iteration 81, with an average and restarts
        state, _ = module._segment_core(prepared.bundle, state, 0.0, config)
    elapsed = torch.zeros((), dtype=torch.float64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, result = module._eval_block(prepared.bundle, state, elapsed,
                                         config)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(result.iteration) == 80
    assert int(new.termination_reason) == 0


# ---------------------------------------------------------------------------
# PDLP's step trial: F1a and F1b (ops/pdhg_step.py) around B3/B4 or B6/B7
# ---------------------------------------------------------------------------

LAYOUTS = ["csr", "tiled"]
RULES = ["adaptive", "constant"]


def trial_case_states(cuda, problem, rule, layout):
    """(prepared, config, [(label, state, start)]) of tests/trial_cases.py
    on the card, every case of the problem, and each also with the mask
    off for a termination reason and for a numerical error."""
    import trial_cases as tc

    prep, config = tc.prepared(problem, rule, cuda,
                               tile_aligned=layout == "tiled")
    states = []
    for case in tc.CASES:
        if (problem, case) not in tc.PROBLEM_CASES:
            continue
        state, start = tc.case_state(prep, case)
        states.append((case, state, start))
        states.append((f"{case}+terminated", dataclasses.replace(
            state, termination_reason=torch.tensor(
                2, dtype=torch.int32, device=cuda)), start))
        states.append((f"{case}+numerical_error", dataclasses.replace(
            state, numerical_error=torch.tensor(True, device=cuda)), start))
    return prep, config, states


def primal_step_inputs(problem, config, state, start, rule):
    return (state.current_primal_solution, problem.objective_vector,
            state.current_dual_product, problem.variable_lower_bound,
            problem.variable_upper_bound, state.step_size,
            state.primal_weight, state.termination_reason,
            state.numerical_error, state.iteration, start,
            config.termination_evaluation_frequency,
            config.criteria.iteration_limit, rule == "constant")


def assert_bitwise_tuple(got, want, label):
    for i, (u, v) in enumerate(zip(got, want)):
        assert_same_bits(u, v, f"{label}[{i}]")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("problem", ["bounded", "pagerank"])
def test_pdhg_step_kernels_are_bitwise_their_plain_versions(
        cuda, problem, rule, layout):
    """F1a and F1b, each against its plain version on the card from the
    same inputs, over every case (accept, reject, numerical error,
    interaction 0, inactive, the first step with an empty average) and
    the mask off for each reason: every output bitwise, one launch a
    call. F1b's inputs are B3/B4's (B6/B7's) outputs on F1a's."""
    from firstorderlp_torch.models import pdhg
    from firstorderlp_torch.ops import pdhg_step

    prep, config, states = trial_case_states(cuda, problem, rule, layout)
    p = prep.bundle.scaled
    policy = config.step_policy
    exponents = ((0.0, 0.0) if rule == "constant" else
                 (policy.reduction_exponent, policy.growth_exponent))
    for label, state, start in states:
        args = primal_step_inputs(p, config, state, start, rule)
        routed.reset_launch_counts()
        got = pdhg_step.primal_step(*args)
        assert routed.LAUNCHES["primal_step"] == 1
        assert_bitwise_tuple(got, pdhg_step.primal_step_plain(*args),
                             f"{label}: primal_step")
        x_next, z, dx, sigma, active = got
        if rule == "constant":
            y_next, aty_next = pdhg._next_dual_at(
                p, z, state.current_dual_solution, sigma)
            sums = (None, None, None)
        else:
            op = p.constraint_matrix
            y_next, layout_y, dy2 = op.mv_dual_step(
                z, state.current_dual_solution, p.right_hand_side,
                p.is_equality_f32, sigma)
            aty_next, inter, dx2 = op.rmv_stats(
                layout_y, dx, state.current_dual_product)
            sums = (dy2, inter, dx2)
        fields = pdhg._trial_fields(state)
        tail = (x_next, dx, y_next, aty_next, *sums, active, *exponents,
                rule == "constant")
        routed.reset_launch_counts()
        got = pdhg_step.trial_epilogue(fields, *tail)
        assert routed.LAUNCHES["trial_epilogue"] == 1
        assert_same_bits(got, pdhg_step.trial_epilogue_plain(fields, *tail),
                         f"{label}: trial_epilogue")


# (reduction, growth) exponents whose negatives take every route of
# PyTorch's pow(tensor, scalar): powf, reciprocal and rsqrt, 1 / (t t)
# and t t, fill and copy, t t t and sqrt
POW_EXPONENTS = [(0.3, 0.6), (1.0, 0.5), (2.0, -2.0), (0.0, -1.0),
                 (-3.0, -0.5)]
EPILOGUE_SUMS = [0.0, -0.0, 1e-30, 1e-3, 0.7, 3.0, 1e30, float("inf"),
                 float("-inf"), float("nan")]


@pytest.mark.parametrize("exponents", POW_EXPONENTS)
def test_trial_epilogue_scalars_are_bitwise_their_plain_version(cuda,
                                                                exponents):
    """F1b's scalar part against its plain version over sums with zeros
    of both signs, tiny and huge values, infinities and NaN (the NaN
    rules of torch.clamp and torch.minimum), counters from 0 to 2^40 and
    both masks: the new step size, flag, counters and weights bitwise."""
    from firstorderlp_torch.models import pdhg
    from firstorderlp_torch.ops import pdhg_step
    import trial_cases as tc

    prep, config = tc.prepared("bounded", "adaptive", cuda)
    state, _ = tc.case_state(prep, "accept")
    vec = state.current_primal_solution
    yvec = state.current_dual_solution
    rng = np.random.default_rng(7)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=cuda)

    for total in (0, 1, 7, 12345, 2 ** 40):
        fields = dataclasses.replace(
            pdhg._trial_fields(state),
            total=torch.tensor(total, device=cuda))
        for _ in range(40):
            dy2, inter, dx2 = rng.choice(EPILOGUE_SUMS, 3)
            active = torch.tensor(bool(rng.random() < 0.8), device=cuda)
            tail = (vec, vec, yvec, vec, f32(dy2), f32(inter), f32(dx2),
                    active, *exponents, False)
            assert_same_bits(
                pdhg_step.trial_epilogue(fields, *tail),
                pdhg_step.trial_epilogue_plain(fields, *tail),
                f"total {total}, sums {(dy2, inter, dx2)}")


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("problem", ["bounded", "pagerank"])
def test_trial_epilogue_reads_views_at_any_offset(cuda, problem, rule):
    """F1b reads 16 bytes at a time from an input that starts on a
    16-byte boundary and 4 at a time from one that does not, and the
    last n mod 4 and m mod 4 entries alone (pagerank: m = 1,001). Over
    the states of tests/trial_cases.py, with its eleven input vectors
    copied into views at element offsets 1-3 (each vector its own, so
    aligned and unaligned inputs mix): bitwise the plain version on the
    same views and the contiguous inputs' result, and every output
    vector 16-byte aligned."""
    from firstorderlp_torch.models import pdhg
    from firstorderlp_torch.ops import pdhg_step

    prep, config, states = trial_case_states(cuda, problem, rule, "csr")
    p = prep.bundle.scaled
    policy = config.step_policy
    exponents = ((0.0, 0.0) if rule == "constant" else
                 (policy.reduction_exponent, policy.growth_exponent))
    names = ("x", "y", "delta_x", "delta_y", "aty", "sum_x", "sum_y")

    def at_offset(t, offset):
        buf = torch.full((t.numel() + 4,), float("nan"), device=cuda)
        view = buf[offset:offset + t.numel()]
        view.copy_(t)
        return view

    for label, state, start in states:
        x_next, z, dx, sigma, active = pdhg_step.primal_step(
            *primal_step_inputs(p, config, state, start, rule))
        if rule == "constant":
            y_next, aty_next = pdhg._next_dual_at(
                p, z, state.current_dual_solution, sigma)
            sums = (None, None, None)
        else:
            op = p.constraint_matrix
            y_next, layout_y, dy2 = op.mv_dual_step(
                z, state.current_dual_solution, p.right_hand_side,
                p.is_equality_f32, sigma)
            aty_next, inter, dx2 = op.rmv_stats(
                layout_y, dx, state.current_dual_product)
            sums = (dy2, inter, dx2)
        fields = pdhg._trial_fields(state)
        tail = (*sums, active, *exponents, rule == "constant")
        whole = pdhg_step.trial_epilogue(fields, x_next, dx, y_next,
                                         aty_next, *tail)
        for shift in (1, 2, 3):
            vectors = [at_offset(t, (shift + i) % 4) for i, t in enumerate(
                (x_next, dx, y_next, aty_next,
                 *(getattr(fields, name) for name in names)))]
            moved = dataclasses.replace(fields, **dict(zip(names,
                                                           vectors[4:])))
            mask = pdhg_step.aligned_mask(vectors)
            assert 0 < mask < 2 ** 11 - 1, mask
            got = pdhg_step.trial_epilogue(moved, *vectors[:4], *tail)
            assert_same_bits(got, pdhg_step.trial_epilogue_plain(
                moved, *vectors[:4], *tail), f"{label} shift {shift}")
            assert_same_bits(got, whole, f"{label} shift {shift}: whole")
            for name in names:
                assert getattr(got, name).data_ptr() % 16 == 0, name


def test_primal_step_keeps_torch_clamp_nan_rules(cuda):
    """F1a against its plain version where x, the bounds, c and A'y hold
    NaN, infinities and signed zeros, and where the bounds cross: x+, z
    and dx bitwise."""
    from firstorderlp_torch.ops import pdhg_step

    rng = np.random.default_rng(11)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e30, np.inf, -np.inf, np.nan],
                       np.float32)
    n = 4096

    def pick():
        v = rng.normal(size=n).astype(np.float32)
        mask = rng.random(n) < 0.3
        v[mask] = rng.choice(special, int(mask.sum()))
        return torch.as_tensor(v, device=cuda)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=cuda)

    for step, weight in ((0.5, 2.0), (0.0, 1.0), (3.0, 1e-30)):
        args = (pick(), pick(), pick(), pick(), pick(),
                scalar(step, torch.float32), scalar(weight, torch.float32),
                scalar(0, torch.int32), scalar(False, torch.bool),
                scalar(57, torch.int64), scalar(57, torch.int64), 40, 100)
        for constant in (False, True):
            assert_bitwise_tuple(
                pdhg_step.primal_step(*args, constant),
                pdhg_step.primal_step_plain(*args, constant),
                f"step {step}, weight {weight}, constant {constant}")


@pytest.mark.parametrize("n", [4096, 4097, 4098, 4099])
def test_primal_step_reads_views_at_odd_offsets(cuda, n):
    """F1a at every n mod 4, its five inputs each a view at its own
    offset 0-3 (16 bytes at a time where a view starts on a 16-byte
    boundary, 4 elsewhere), constant and adaptive, the mask on and
    off: bitwise its plain version and the contiguous inputs'
    result; x+, z and dx each 16-byte aligned; one launch a call."""
    from firstorderlp_torch.ops import pdhg_step

    rng = np.random.default_rng(n)

    def at_offset(v, offset):
        buf = torch.full((n + 4,), float("nan"), device=cuda)
        view = buf[offset:offset + n]
        view.copy_(torch.as_tensor(v, device=cuda))
        return view

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=cuda)

    lower = np.where(rng.random(n) < 0.3, -np.inf, -rng.random(n))
    upper = np.where(rng.random(n) < 0.3, np.inf, rng.random(n))
    x = np.clip(rng.standard_normal(n), lower, upper)
    vectors = [np.asarray(v, np.float32) for v in (
        x, rng.standard_normal(n), rng.standard_normal(n), lower, upper)]
    whole = [torch.as_tensor(v, device=cuda) for v in vectors]
    for shift in (1, 2, 3):
        views = [at_offset(v, (shift + i) % 4) for i, v in enumerate(
            vectors)]
        assert 0 < pdhg_step.aligned_mask(views) < 2 ** 5 - 1
        for iteration, constant in ((57, False), (57, True), (81, False)):
            tail = (scalar(0.7, torch.float32), scalar(1.3, torch.float32),
                    scalar(0, torch.int32), scalar(False, torch.bool),
                    scalar(iteration, torch.int64), scalar(57, torch.int64),
                    40, 100, constant)
            want = pdhg_step.primal_step_plain(*views, *tail)
            assert bool(want[4]) == (iteration == 57)
            contiguous = pdhg_step.primal_step(*whole, *tail)
            routed.reset_launch_counts()
            got = pdhg_step.primal_step(*views, *tail)
            assert routed.LAUNCHES["primal_step"] == 1
            label = f"n {n} shift {shift} {iteration} {constant}"
            assert_bitwise_tuple(got, want, label)
            assert_bitwise_tuple(got, contiguous, f"{label}: whole")
            for t in got[:3]:
                assert t.data_ptr() % 16 == 0, label


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rule", RULES)
def test_replayed_trial_is_bitwise_the_eager_trial(cuda, rule, layout):
    """One trial captured as a CUDA graph (ops/graphs.SegmentGraphs, the
    solver's own capture) and replayed from each case's state gives
    every field of the eager trial's state bitwise and the same launches
    (the replay credited): F1a, B3 and B4 (B6 and B7) and F1b for
    adaptive steps, F1a, two B2 products and F1b for constant ones, and
    no other kernel of the port."""
    from firstorderlp_torch.models import pdhg
    from firstorderlp_torch.ops import graphs

    prep, config, states = trial_case_states(cuda, "pagerank", rule, layout)
    problem = prep.bundle.scaled

    def evaluate(state, start):
        return state, ()

    def step(state, start):
        return pdhg._masked_trial(problem, config, state, start)

    captured = graphs.SegmentGraphs(evaluate, step, states[0][1],
                                    (states[0][2],))
    dual = ("tiled_dual_step", "tiled_rmv_stats") if layout == "tiled" \
        else ("spmv_dual_step", "spmv_rmv_stats")
    products = ({"tiled_spmv:A": 1, "tiled_spmv:AT": 1} if layout == "tiled"
                else {"spmv_csr:A": 1, "spmv_csr:AT": 1})
    want = {"primal_step": 1, "trial_epilogue": 1, **(
        products if rule == "constant" else dict.fromkeys(dual, 1))}
    for label, state, start in states:
        routed.reset_launch_counts()
        eager = step(state, start)
        eager_launches = {k: v for k, v in routed.LAUNCHES.items() if v}
        assert eager_launches == want, label
        captured.static.load(state)
        captured.static.extras[0].copy_(start)
        routed.reset_launch_counts()
        captured.steps(1)
        assert {k: v for k, v in routed.LAUNCHES.items() if v} == want
        assert_same_bits(captured.static.unload(), eager, label)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rule", RULES)
def test_a_trial_is_captured_without_synchronizing(cuda, rule, layout):
    """The fused trial reads nothing back: run eagerly and captured into
    a CUDA graph under torch.cuda.set_sync_debug_mode("error"), the
    replay gives the eager trial's bits; eagerly, an adaptive trial is
    four host launch calls (torch.profiler): F1a, B3, B4 and F1b (B6 and
    B7 on the tile plan)."""
    from torch.profiler import ProfilerActivity, profile

    from firstorderlp_torch.models import pdhg
    from firstorderlp_torch.ops.probe_routed import LAUNCH_CALLS
    import trial_cases as tc

    prep, config = tc.prepared("pagerank", rule, cuda,
                               tile_aligned=layout == "tiled")
    state, start = tc.case_state(prep, "accept")
    problem = prep.bundle.scaled
    pdhg._masked_trial(problem, config, state, start)  # kernels built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pdhg._masked_trial(problem, config, state, start)
        torch.cuda.synchronize()
    calls = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
    if rule == "adaptive":
        assert calls == 4, calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = pdhg._masked_trial(problem, config, state, start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.graph(graph, stream=side):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pdhg._masked_trial(problem, config, state, start)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    graph.replay()
    torch.cuda.synchronize()
    assert_same_bits(out, eager)


# ---------------------------------------------------------------------------
# The f32 exact trust region: F2b tr_search and F2c tr_solution
# (ops/trust_region_search.py)
# ---------------------------------------------------------------------------

# (rows, n, bounds): the 100k-node LP's restart scheme (3 x 200,001,
# bounds (N,)), the 128-lane fleet's (384 x 40,001, bounds (B, N)), rows
# past what 8 blocks stage (staged by 16-block clusters), a row too long
# to stage (the whole-card path) and the 1M-node LP's restart scheme
# (3 x 2,000,001, the LP's bound pattern: trust_region_cases.lp_inputs)
TR_SHAPES = {"main_path": (3, 200_001, "shared"),
             "fleet": (384, 40_001, "rows"),
             "past_eight_blocks": (2, 250_000, "shared"),
             "unstaged": (1, 500_000, "shared"),
             "million": (3, 2_000_001, "lp")}


def tr_shape_inputs(shape):
    """TR_SHAPES[shape]'s inputs as numpy arrays."""
    import trust_region_cases as tc

    rows, n, bounds = TR_SHAPES[shape]
    if bounds == "lp":
        return tc.lp_inputs(n // 2, rows=rows, seed=rows)
    return tc.case_inputs("mixed", bounds, rows=rows, n=n, seed=rows)


def tr_on_card(args, cuda, split, plan=None):
    """(t*, solution, parts, value) of the kernels (F2b under `plan`,
    by default the card's) and of the plain versions on the same CUDA
    tensors."""
    from firstorderlp_torch.ops import trust_region_search as trs

    c, g, lower, upper, weight, radius = (torch.as_tensor(v, device=cuda)
                                          for v in args)
    t_star = trs.tr_search(c, g, lower, upper, weight, radius, plan=plan)
    got = (t_star, *trs.tr_solution(c, g, lower, upper, weight, t_star,
                                    split))
    plain_t = trs.tr_search_plain(
        trs.tr_prologue_plain(c, g, lower, upper, weight), radius)
    want = (plain_t, *trs.tr_solution_plain(c, g, lower, upper, weight,
                                            plain_t, split))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("bounds", ["shared", "rows"])
@pytest.mark.parametrize("case", ["mixed", "radius_zero", "g_zero",
                                  "all_frozen", "infinite_bounds",
                                  "beyond_every_knot", "duplicate_knots",
                                  "negative_zero_tau"])
def test_trust_region_kernels_are_bitwise_their_plain_versions(cuda, case,
                                                               bounds):
    """F2b and F2c on the trust-region cases (tests/trust_region_cases.py),
    at N = 400 and 2,000: t*, the solution, the split sums and the value
    bitwise those of the plain versions, and one launch each."""
    import trust_region_cases as tc

    for n in (400, 2000):
        args = tc.case_inputs(case, bounds, n=n, seed=n)
        routed.reset_launch_counts()
        got, want = tr_on_card(args, cuda, n // 3)
        assert routed.LAUNCHES["tr_search"] == 1
        assert routed.LAUNCHES["tr_solution"] == 1
        assert_bitwise_tuple(got, want, f"{case} n={n}")


@pytest.mark.parametrize("shape", sorted(TR_SHAPES))
def test_trust_region_kernels_at_the_paths_shapes(cuda, shape):
    """The main path's, the fleet's, a row too long to stage and the 1M
    LP's shapes: bitwise the plain versions, and the same bits again on
    a second launch; the rows too long for a cluster take the whole-card
    path."""
    from firstorderlp_torch.ops import trust_region_search as trs

    rows, n, _ = TR_SHAPES[shape]
    plan = trs.device_search_plan(rows, n, cuda)
    wide = trs.search_cluster_limit(cuda) == trs.WIDE_CLUSTER
    assert (plan == trs.WHOLE_CARD) == (shape in ("unstaged", "million") or (
        not wide and shape == "past_eight_blocks"))
    args = tr_shape_inputs(shape)
    got, want = tr_on_card(args, cuda, n // 2)
    assert_bitwise_tuple(got, want, shape)
    again, _ = tr_on_card(args, cuda, n // 2)
    assert_bitwise_tuple(again, got, f"{shape} again")


def test_tr_search_plans_give_the_plain_bits(cuda):
    """F2b under 8- and 16-block plans and on the whole-card path, at
    the main path's shape and on the cases with repeated knots and
    infinite bounds: t* bitwise the plain version's, the same bits on a
    second launch, each launch counted in its kernels' entries. The
    card's co-scheduled clusters of 8 and 16 blocks
    (cudaOccupancyMaxActiveClusters) are cached per device."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    clusters = trs.active_clusters(cuda)
    assert clusters[trs.MAX_CLUSTER] >= 1
    assert trs.search_cluster_limit(cuda) == (
        trs.WIDE_CLUSTER if clusters[trs.WIDE_CLUSTER] >= 1
        else trs.MAX_CLUSTER)
    assert trs.active_clusters(cuda) == clusters
    for case, rows, n in (("mixed", 3, 200_001),
                          ("duplicate_knots", 3, 20_000),
                          ("infinite_bounds", 3, 20_000)):
        c, g, lower, upper, weight, radius = (
            torch.as_tensor(v, device=cuda)
            for v in tc.case_inputs(case, "shared", rows=rows, n=n, seed=9))
        want = trs.tr_search_plain(
            trs.tr_prologue_plain(c, g, lower, upper, weight), radius)
        for limit in (trs.MAX_CLUSTER, trs.WIDE_CLUSTER):
            if clusters[limit] < 1:
                continue
            staged = trs.search_plan(rows, n, limit)
            assert staged.cluster == limit
            for plan in (staged, trs.WHOLE_CARD):
                routed.reset_launch_counts()
                got = trs.tr_search(c, g, lower, upper, weight, radius,
                                    plan=plan)
                again = trs.tr_search(c, g, lower, upper, weight, radius,
                                      plan=plan)
                whole = plan == trs.WHOLE_CARD
                assert routed.LAUNCHES["tr_search"] == (0 if whole else 2)
                assert routed.LAUNCHES["tr_knots"] == (2 if whole else 0)
                assert routed.LAUNCHES["tr_trip"] == (
                    2 * trs.SEARCH_TRIPS if whole else 0)
                label = f"{case} {plan}"
                assert_same_bits(got, want, label)
                assert_same_bits(again, got, f"{label} again")


@pytest.mark.parametrize("bounds", ["shared", "rows"])
def test_whole_card_path_is_bitwise_on_the_cases(cuda, bounds):
    """The whole-card path forced on every trust-region case at N = 400
    and 2,000 (runs of a warp with no entry, lists of a few knots) and on
    the edge rows (no live knot, radius 0, g = 0, NaN inputs): t*, the
    solution, the split sums and the value bitwise the plain versions',
    one tr_knots and SEARCH_TRIPS tr_trip launches a call, no tr_search,
    the tickets back at zero."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    sets = [(f"{case} n={n}", tc.case_inputs(case, bounds, n=n, seed=n))
            for case in tc.CASES for n in (400, 2000)]
    if bounds == "rows":
        sets += [(f"edge {i}", args)
                 for i, args in enumerate(tc.edge_inputs())]
    for label, args in sets:
        routed.reset_launch_counts()
        got, want = tr_on_card(args, cuda, args[0].shape[1] // 3,
                               plan=trs.WHOLE_CARD)
        assert routed.LAUNCHES["tr_knots"] == 1
        assert routed.LAUNCHES["tr_trip"] == trs.SEARCH_TRIPS
        assert routed.LAUNCHES["tr_search"] == 0
        assert_bitwise_tuple(got, want, label)
    assert not trs.solution_tickets(cuda).any()


def test_whole_card_path_replays_bitwise(cuda):
    """The whole-card path at a row too long to stage, captured in a CUDA
    graph and replayed three times on new inputs (copied into the
    captured ones): each replay bitwise the eager call on those inputs,
    so no replay reads the last call's bracket or lists, and the tickets
    are back at zero after each."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    rows, n, bounds = TR_SHAPES["unstaged"]

    def inputs(seed):
        return [torch.as_tensor(v, device=cuda) for v in tc.case_inputs(
            "mixed", bounds, rows=rows, n=n, seed=seed)]

    static = inputs(1)
    assert trs.device_search_plan(rows, n, cuda) == trs.WHOLE_CARD
    first = trs.tr_search(*static)  # warm-up before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trs.tr_search(*static)
    for seed in (2, 3, 1):
        new = inputs(seed)
        for t, v in zip(static, new):
            t.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        want = trs.tr_search_plain(trs.tr_prologue_plain(*new[:5]), new[5])
        assert_same_bits(out, trs.tr_search(*new), f"replay {seed}")
        assert_same_bits(out, want, f"replay {seed} plain")
        assert not trs.solution_tickets(cuda).any()
    assert_same_bits(out, first, "the first inputs again")


def test_whole_card_path_runs_in_row_chunks(cuda, monkeypatch):
    """A call of more long rows than a launch takes (MAX_ROWS cut to 2,
    three rows too long to stage) runs the whole-card path once a chunk,
    in row_chunks' order: bitwise the plain version and the uncut call,
    one tr_knots launch a chunk."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    c, g, lower, upper, weight, radius = (
        torch.as_tensor(v, device=cuda)
        for v in tc.case_inputs("mixed", "rows", rows=3, n=450_000, seed=6))
    whole = trs.tr_search(c, g, lower, upper, weight, radius)
    monkeypatch.setattr(trs, "MAX_ROWS", 2)
    routed.reset_launch_counts()
    got = trs.tr_search(c, g, lower, upper, weight, radius)
    assert routed.LAUNCHES["tr_knots"] == 2
    assert routed.LAUNCHES["tr_trip"] == 2 * trs.SEARCH_TRIPS
    want = trs.tr_search_plain(
        trs.tr_prologue_plain(c, g, lower, upper, weight), radius)
    assert_same_bits(got, want, "chunked")
    assert_same_bits(got, whole, "chunked against one launch")


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
@pytest.mark.parametrize("nodes", [2_000, 220_000, 440_000])
def test_f2b_launches_follow_the_evaluations(cuda, solver, nodes):
    """A warm solve of a PageRank LP on the graphed path runs F2b once an
    evaluation (the restart scheme's 3 rows of n + m entries) and once
    for its final bound estimates (2 rows of max(n, m)), each call on the
    whole-card path (one tr_knots and SEARCH_TRIPS tr_trip launches)
    where its rows are too long for a cluster to stage, else on
    tr_search: at 440,000 nodes both take the whole card, as at the 1M
    cells' shape; at 220,000 only the evaluations'; at 2,000 neither."""
    import firstorderlp_torch as tx
    from firstorderlp_torch import spans
    from firstorderlp_torch.models import mirror_prox, pdhg
    from firstorderlp_torch.ops import trust_region_search as trs

    problem = generate_pagerank_lp(nodes, seed=0)
    params = dataclasses.replace(card_params(), matrix_format="routed")
    module = pdhg
    if solver == "mirror_prox":
        module = mirror_prox
        params = tx.MirrorProxParameters(
            l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
            pock_chambolle_alpha=1.0, primal_importance=1.0,
            scale_invariant_initial_primal_weight=True,
            diagonal_scaling="l2", verbosity=0, record_iteration_stats=False,
            termination_evaluation_frequency=40,
            termination_criteria=params.termination_criteria,
            restart_params=params.restart_params, dtype="float32",
            matrix_format="routed")
    prepared = module.prepare_problem(params, problem, device=cuda)
    module.optimize(params, problem, prepared=prepared)  # the captures
    spans.reset_counts()
    routed.reset_launch_counts()
    out = module.optimize(params, problem, prepared=prepared)
    assert out.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    assert spans.COUNTS["captures"] == 0
    evaluations = spans.COUNTS["evaluations"]
    by_eval = trs.device_search_plan(3, 2 * nodes + 1, cuda) == trs.WHOLE_CARD
    by_final = trs.device_search_plan(2, nodes + 1, cuda) == trs.WHOLE_CARD
    assert (by_eval, by_final) == (nodes > 200_000, nodes > 400_000)
    whole = evaluations * by_eval + by_final
    assert routed.LAUNCHES["tr_knots"] == whole
    assert routed.LAUNCHES["tr_trip"] == trs.SEARCH_TRIPS * whole
    assert routed.LAUNCHES["tr_search"] == evaluations + 1 - whole
    assert routed.LAUNCHES["tr_solution"] == evaluations + 1


@pytest.mark.parametrize("case", ["mixed", "duplicate_knots",
                                  "infinite_bounds"])
def test_trust_region_kernels_repeat_bitwise(cuda, case):
    import trust_region_cases as tc

    args = tc.case_inputs(case, "rows", rows=7, n=3001, seed=5)
    first, _ = tr_on_card(args, cuda, 1000)
    for _ in range(10):
        again, _ = tr_on_card(args, cuda, 1000)
        assert_bitwise_tuple(again, first, case)


def test_trust_region_kernels_take_strided_inputs(cuda):
    """A fleet's lane bound estimates hand the solve transposed (n, B)
    state: the kernels read it in place through its row and column
    strides and give the contiguous inputs' bits."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    c, g, lower, upper, weight, radius = (
        torch.as_tensor(v, device=cuda)
        for v in tc.case_inputs("mixed", "rows", rows=5, n=700, seed=4))
    strided = [t.T.contiguous().T for t in (c, g, lower, upper, weight)]
    t_star = trs.tr_search(*strided, radius)
    assert_bitwise_tuple(
        (t_star, *trs.tr_solution(*strided, t_star, 300)),
        (trs.tr_search(c, g, lower, upper, weight, radius),
         *trs.tr_solution(c, g, lower, upper, weight, t_star, 300)),
        "strided")


@pytest.mark.parametrize("rows,n", [(1, 2_003), (3, 200_001),
                                    (384, 4_001)])
def test_tr_solution_splits_and_strides(cuda, rows, n):
    """F2c at 1, 3 and 384 rows, on the knot search's t*: the solution
    bitwise its plain version's and the split sums and the value equal
    to them, with the split at 0, at n and inside a 16-byte slot, on
    contiguous inputs (c and g rows at odd offsets, bounds (N,)) and on
    a fleet's transposed (n, B) views, read in place; at more and fewer
    blocks a row than solution_blocks gives, the same bits."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    for bounds in ("shared", "rows"):
        c, g, lower, upper, weight, radius = (
            torch.as_tensor(v, device=cuda) for v in tc.case_inputs(
                "mixed", bounds, rows=rows, n=n, seed=rows + n))
        inputs = (c, g, lower, upper, weight)
        t_star = trs.tr_search(*inputs, radius)
        strided = [t.T.contiguous().T if t.dim() == 2 else t
                   for t in inputs]
        sms, depth = trs.solution_wave(cuda)
        assert sms == torch.cuda.get_device_properties(
            cuda).multi_processor_count and depth >= 1
        assert trs.solution_wave(cuda) == (sms, depth)  # cached
        blocks = trs.solution_blocks(rows, n, sms, depth)
        for split in (0, n, 4 * (n // 8) + 2):
            want = trs.tr_solution_plain(*inputs, t_star, split)
            for label, args, b in (("contiguous", inputs, None),
                                   ("strided", strided, None),
                                   ("one block", inputs, 1),
                                   ("more blocks", inputs, 4 * blocks)):
                routed.reset_launch_counts()
                got = trs.tr_solution(*args, t_star, split, blocks=b)
                assert routed.LAUNCHES["tr_solution"] == 1
                assert_bitwise_tuple(got, want,
                                     f"{bounds} split {split} {label}")
    torch.cuda.synchronize()
    assert not trs.solution_tickets(cuda).any()


def test_tr_solution_repeats_and_replays(cuda):
    """F2c at the main path's shape: two launches bitwise equal, and a
    CUDA graph of one launch replayed on new inputs (copied into the
    captured ones) bitwise the eager call on them, the tickets back at
    zero after each."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    rows, n = 3, 200_001

    def inputs(seed):
        c, g, lower, upper, weight, radius = (
            torch.as_tensor(v, device=cuda) for v in tc.case_inputs(
                "mixed", "shared", rows=rows, n=n, seed=seed))
        return (c, g, lower, upper, weight,
                trs.tr_search(c, g, lower, upper, weight, radius))

    first = inputs(1)
    got = trs.tr_solution(*first, n // 2)
    assert_bitwise_tuple(trs.tr_solution(*first, n // 2), got, "again")
    static = [t.clone() for t in first]
    trs.tr_solution(*static, n // 2)  # warm-up before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trs.tr_solution(*static, n // 2)
    for seed in (2, 3):
        new = inputs(seed)
        for t, v in zip(static, new):
            t.copy_(v)
        routed.reset_launch_counts()
        graph.replay()
        torch.cuda.synchronize()
        assert_bitwise_tuple(out, trs.tr_solution(*new, n // 2),
                             f"replay {seed}")
        assert not trs.solution_tickets(cuda).any()


def test_trust_region_kernels_launch_on_a_second_card(cuda):
    """The staged search at the main path's shape takes about 100 KB of
    shared memory a block (200 KB with 8-block clusters) and 16-block
    clusters, which each device must allow (both attributes hold per
    device, so they are set on every launch, and the cluster query is
    cached per device): launches on cuda:0, cuda:1 and cuda:0 again in
    one process give the plain versions' bits on each card, with the
    plan of each card's own query. The solution's wave (SMs and blocks an
    SM) and tickets are each card's own too, and every card's tickets
    are back at zero after its launch."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rows, n, bounds = TR_SHAPES["main_path"]
    args = tc.case_inputs("mixed", bounds, rows=rows, n=n, seed=rows)
    for index in (0, 1, 0):
        device = torch.device("cuda", index)
        plan = trs.device_search_plan(rows, n, device)
        assert plan.cluster == trs.search_cluster_limit(device)
        got, want = tr_on_card(args, device, n // 2)
        assert got[0].device.index == index
        assert_bitwise_tuple(got, want, f"cuda:{index} {plan}")
        sms, depth = trs.solution_wave(device)
        assert sms == torch.cuda.get_device_properties(
            index).multi_processor_count and depth >= 1
        tickets = trs.solution_tickets(device)
        assert tickets.device == device
        torch.cuda.synchronize(device)
        assert not tickets.any(), f"cuda:{index} tickets"
    assert set(trs._ACTIVE_CLUSTERS) >= {0, 1}
    assert set(trs._WAVE) >= {("tr_solution", 0), ("tr_solution", 1)}
    assert trs.solution_tickets("cuda:0").data_ptr() != \
        trs.solution_tickets("cuda:1").data_ptr()


def test_trust_region_wrappers_reject_bad_inputs(cuda):
    from firstorderlp_torch.ops import trust_region_search as trs

    c = torch.zeros(3, 50, device=cuda)
    bounds = torch.zeros(50, device=cuda)
    radius = torch.ones(3, device=cuda)
    with pytest.raises(TypeError):
        trs.tr_search(c.double(), c, bounds, bounds, bounds, radius)
    with pytest.raises(ValueError):
        trs.tr_search(c, c, bounds[:49], bounds, bounds, radius)
    with pytest.raises(ValueError):
        trs.tr_search(c, c, bounds, bounds, bounds, radius[:2])
    with pytest.raises(ValueError):
        trs.tr_search(c, c, bounds.cpu(), bounds, bounds, radius)
    with pytest.raises(ValueError):
        trs.tr_solution(c, c, bounds, bounds, bounds, radius, 51)


def test_trust_region_kernels_past_a_launchs_rows(cuda):
    """65,536 rows of 9 entries, one more than a launch's grid takes:
    tr_search and tr_solution each run two launches (MAX_ROWS rows, then
    one), bitwise the plain versions, with bounds (N,) and (B, N); the
    tickets are back at zero."""
    import trust_region_cases as tc

    from firstorderlp_torch.ops import trust_region_search as trs

    rows = trs.MAX_ROWS + 1
    for bounds in ("shared", "rows"):
        args = tc.case_inputs("mixed", bounds, rows=rows, n=9, seed=7)
        routed.reset_launch_counts()
        got, want = tr_on_card(args, cuda, 4)
        assert routed.LAUNCHES["tr_search"] == 2
        assert routed.LAUNCHES["tr_solution"] == 2
        assert_bitwise_tuple(got, want, f"{rows} rows, bounds {bounds}")
    assert not trs.solution_tickets(cuda).any()


def test_fleet_past_a_launchs_rows_restarts_on_the_card(cuda):
    """A FleetSpec fleet of 21,846 ten-node PageRank lanes under the
    adaptive normalized restart scheme, whose restart solves one trust
    region of 3 x 21,846 = 65,538 rows (past the 65,535 a launch takes):
    it runs its evaluations on the card, and every lane ends with the
    reason, the iterations and the solution bits of the same lane in the
    two fleets of its halves."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.generators import pagerank_fleet_spec
    from firstorderlp_torch.ops import trust_region_search as trs

    lanes = trs.MAX_ROWS // 3 + 1
    params = card_params()
    params = dataclasses.replace(params, termination_criteria=(
        dataclasses.replace(params.termination_criteria,
                            iteration_limit=120)))
    damping = np.linspace(0.5, 0.99, lanes)
    routed.reset_launch_counts()
    whole = batch.solve_batch_shared_pattern(
        params, pagerank_fleet_spec(10, damping, seed=0), device=cuda)
    assert routed.LAUNCHES["tr_search"] >= 2
    assert routed.LAUNCHES["tr_solution"] == routed.LAUNCHES["tr_search"]
    half = lanes // 2
    halves = [out for part in (damping[:half], damping[half:])
              for out in batch.solve_batch_shared_pattern(
                  params, pagerank_fleet_spec(10, part, seed=0),
                  device=cuda)]
    assert len(whole) == len(halves) == lanes
    for i, (a, b) in enumerate(zip(whole, halves)):
        assert a.termination_reason == b.termination_reason, i
        assert a.iteration_count == b.iteration_count, i
        for u, v in ((a.primal_solution, b.primal_solution),
                     (a.dual_solution, b.dual_solution)):
            assert u.tobytes() == v.tobytes(), i


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_replayed_evaluation_is_bitwise_the_eager_one(cuda, solver,
                                                      monkeypatch):
    """One evaluation from the state at iteration 81, replayed from the
    bundle's graph and run eagerly: every field of the state and of the
    result bitwise equal, the same launches, each exact trust region
    (the restart scheme's, and the bound estimates' where the config
    asks for them) one tr_search and one tr_solution."""
    module, bundle, config, state = segment_case(cuda, solver, False,
                                                 monkeypatch)
    state = module._device_counters(state)
    out = {}
    for mode in ("graphed", "eager"):
        runner = module._runner(bundle, state, 0.0, config, mode == "eager")
        routed.reset_launch_counts()
        result = runner.detach(runner.evaluate())
        launches = dict(routed.LAUNCHES)
        out[mode] = (runner.unload(), result, launches)
    assert out["graphed"][2] == out["eager"][2]
    assert out["eager"][2]["tr_search"] >= 1  # Mirror Prox: bounds too
    assert out["eager"][2]["tr_solution"] == out["eager"][2]["tr_search"]
    assert_same_bits(out["graphed"][0], out["eager"][0])
    assert_same_bits(out["graphed"][1], out["eager"][1], "result")


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_an_evaluation_is_captured_without_synchronizing(cuda, solver,
                                                         monkeypatch):
    """The evaluation, trust-region kernels included, captured into a
    CUDA graph under torch.cuda.set_sync_debug_mode("error"); its replay
    gives the eager evaluation's bits."""
    module, bundle, config, state = segment_case(cuda, solver, False,
                                                 monkeypatch)
    state = module._device_counters(state)
    elapsed = torch.zeros((), dtype=torch.float64, device=cuda)
    eager = module._eval_block(bundle, state, elapsed, config)
    module._eval_block(bundle, state, elapsed, config)  # pool primed
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.graph(graph, stream=side):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = module._eval_block(bundle, state, elapsed, config)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    graph.replay()
    torch.cuda.synchronize()
    assert_same_bits(out[0], eager[0])
    assert_same_bits(out[1], eager[1], "result")


# ---------------------------------------------------------------------------
# An evaluation's statistics: F2d, F2e, F2f (ops/eval_stats.py)
# ---------------------------------------------------------------------------

STATS_KERNELS = ("stats_point", "stats_primal", "stats_dual")
# (n, m): one entry each, part slots at both ends, the 100k-node and the
# million-node PageRank LP's, and (set on the card, None here) twice the
# slots of one wave of F2e's and F2f's grid
STATS_SHAPES = {"one": (1, 1), "tails": (1_029, 2_051),
                "100k": (100_000, 100_001), "1M": (1_000_000, 1_000_001),
                "past_one_wave": None}
# the reason each case of tests/eval_stats_cases.py reaches
STATS_REASONS = {"numerical_error": 7, "optimal_linf": 1, "limits": 5}


def assert_equal_or_nan(got, want, label):
    """Equal values, a NaN against a NaN (the finalize's NaN payloads
    follow the operations that made them)."""
    g, w = got.detach().cpu(), want.detach().cpu()
    assert g.dtype == w.dtype and g.shape == w.shape, label
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    assert bool(same.all()), f"{label}: {g} against {w}"


def off_alignment(t):
    """`t` (1-D) copied into a view that starts one element past a
    16-byte boundary: 4 bytes for f32, 1 for bool."""
    if t is None or t.dim() != 1:
        return t
    view = torch.empty(t.shape[0] + 4, dtype=t.dtype, device=t.device)[1:]
    view = view[:t.shape[0]]
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def stats_launches(inp, shift=lambda t: t):
    """One pass of the three kernels on `inp` (eval_stats_cases), each
    vector passed through `shift` (F2e's and F2f's point too)."""
    from firstorderlp_torch.ops import eval_stats as es

    rules = inp["criteria"]
    point = es.stats_point(inp["x"], inp["y"], inp["variable_rescaling"],
                           inp["constraint_rescaling"], inp["average"])
    primal, dual = shift(point.primal), shift(point.dual)
    ray, primal_totals = es.stats_primal(
        primal, inp["aty"], inp["objective"], inp["lower"],
        inp["upper"], point.primal_norm, rules.ray)
    dual_out = es.stats_dual(dual, inp["ax"],
                             inp["aray"] if rules.ray else None, inp["rhs"],
                             inp["is_equality"], primal_totals,
                             point.primal_norm, inp["scalars"], rules)
    return point, ray, primal_totals, dual_out


def stats_inputs(cuda, shape, case, offset):
    """eval_stats_cases' inputs at `shape` on the card, every vector off
    its 16-byte alignment where `offset`; past_one_wave: n and m twice
    the slots of one wave of the larger of F2e's and F2f's."""
    import eval_stats_cases as esc
    from firstorderlp_torch.ops import eval_stats as es

    if STATS_SHAPES[shape] is None:
        wave = max(sms * depth for sms, depth in (
            es.stats_wave(cuda, k) for k in ("stats_primal", "stats_dual")))
        n = 2 * wave * es.THREADS * es.SLOT_FLOATS + 3
        n, m = n, n + 2
    else:
        n, m = STATS_SHAPES[shape]
    inp = esc.kernel_inputs(n, m, case, seed=5, device=cuda)
    if offset:
        inp = {k: off_alignment(v) if isinstance(v, torch.Tensor) else v
               for k, v in inp.items()}
        inp["average"] = type(inp["average"])(
            *(off_alignment(v) for v in inp["average"]))
    return inp, n, m


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("case", ["mixed", "empty_average",
                                  "numerical_error", "non_finite", "zero",
                                  "no_ray", "optimal_linf", "limits"])
@pytest.mark.parametrize("shape", sorted(STATS_SHAPES))
def test_eval_stats_kernels_are_bitwise_their_plain_versions(cuda, shape,
                                                             case, offset):
    """Each statistics kernel against its plain version on the card, over
    the cases of eval_stats_cases (the ray on and off) from one entry to
    past one wave of F2e's and F2f's grid, on aligned vectors and on
    views 4 bytes off (is_equality 1 byte): the point, the ray, every
    maximum and flag bitwise, each sum within the order bound of its
    terms, the finalize bitwise the plain finalize of the kernels' own
    totals; a second launch bitwise the first, the tickets at zero."""
    import eval_stats_cases as esc
    from firstorderlp_torch.ops import eval_stats as es

    inp, n, m = stats_inputs(cuda, shape, case, offset)
    shift = off_alignment if offset else (lambda t: t)
    rules = inp["criteria"]
    for kernel, items in (("stats_primal", n), ("stats_dual", m)):
        sms, depth = es.stats_wave(cuda, kernel)
        assert sms == torch.cuda.get_device_properties(
            cuda).multi_processor_count and depth >= 1
        assert 1 <= es.stats_grid(items, sms, depth) <= sms * depth
    routed.reset_launch_counts()
    first = stats_launches(inp, shift)
    second = stats_launches(inp, shift)
    torch.cuda.synchronize()
    assert {k: routed.LAUNCHES[k] for k in STATS_KERNELS} == dict.fromkeys(
        STATS_KERNELS, 2)
    assert not bool(es.tickets(cuda).any())
    point, ray, primal_totals, (dual_totals, conv, infeas, reason) = first
    for label, got, again in zip(("point", "ray", "primal totals", "dual"),
                                 first, second):
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        for i, (u, v) in enumerate(zip(got, again)):
            assert (u is None) == (v is None), label
            if u is not None:
                assert_same_bits(u, v, f"second launch: {label}[{i}]")
    assert_same_bits(point, es.stats_point_plain(
        inp["x"], inp["y"], inp["variable_rescaling"],
        inp["constraint_rescaling"], inp["average"]), "point")
    plain_ray, sums, other = es.primal_terms(
        point.primal, inp["aty"], inp["objective"], inp["lower"],
        inp["upper"], point.primal_norm, rules.ray)
    if rules.ray:
        assert_same_bits(ray, plain_ray, "ray")
    else:
        assert ray is None
    esc.assert_totals_match(
        primal_totals, es.totals_from_terms(es.PRIMAL_TOTALS, sums, other,
                                            point.primal),
        sums, es.PRIMAL_TOTALS, "primal")
    dual_sums, dual_other = es.dual_terms(
        point.dual, inp["ax"], inp["aray"] if rules.ray else None,
        inp["rhs"], inp["is_equality"])
    esc.assert_totals_match(
        dual_totals, es.totals_from_terms(es.DUAL_TOTALS, dual_sums,
                                          dual_other, point.dual),
        dual_sums, es.DUAL_TOTALS, "dual")
    want = es.stats_finalize_plain(primal_totals, dual_totals,
                                   point.primal_norm, inp["scalars"], rules)
    assert_equal_or_nan(conv, want[0], "conv")
    assert_equal_or_nan(infeas, want[1], "infeas")
    assert int(reason) == int(want[2])
    if shape in ("100k", "1M"):  # at a few entries a ray may be a certificate
        assert int(reason) == STATS_REASONS.get(case, 0)


# F2d's cases: the average (None: no average) and the point's entries
POINT_CASES = ("none", "average", "numerical_error", "count_x_zero",
               "count_y_zero", "weight_zero", "non_finite",
               "non_finite_average")


def point_inputs(cuda, shape, case, offset):
    """stats_point's arguments (x, y, the rescaling, the average or None)
    made with numpy from seed 6 on the card, every vector 4 bytes off its
    16-byte alignment where `offset`; "past_one_wave": n and m about one
    wave of F2d's chunks each. non_finite: +inf, -inf and a NaN in the
    point x (in the sums with an average)."""
    from firstorderlp_torch.ops import eval_stats as es

    if shape == "past_one_wave":
        sms, depth = es.stats_wave(cuda, "stats_point")
        wave = sms * depth * es.CHUNK_FLOATS
        n, m = wave - 1, wave + 2
    else:
        n, m = shape
    rng = np.random.default_rng(6)
    x, y = rng.normal(size=n), rng.normal(size=m)
    sum_x, sum_y = rng.normal(size=n) * 3.5, rng.normal(size=m) * 2.5
    if case.startswith("non_finite"):
        target = sum_x if case == "non_finite_average" else x
        for i, v in zip((n // 2, n - 1, 0), (np.inf, -np.inf, np.nan)):
            target[i] = v

    def f32(v):
        return off_alignment(torch.as_tensor(np.asarray(v, np.float32),
                                             device=cuda)) if offset else (
            torch.as_tensor(np.asarray(v, np.float32), device=cuda))

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=cuda)

    average = None
    if case not in ("none", "non_finite"):
        average = es.Average(
            f32(sum_x), f32(sum_y),
            scalar(0 if case == "count_x_zero" else 5, torch.int64),
            scalar(0 if case == "count_y_zero" else 5, torch.int64),
            scalar(0.0 if case == "weight_zero" else 3.5, torch.float32),
            scalar(0.0 if case == "weight_zero" else 2.5, torch.float32),
            scalar(case == "numerical_error", torch.bool))
    return (f32(x), f32(y), f32(rng.uniform(0.5, 2.0, n)),
            f32(rng.uniform(0.5, 2.0, m)), average)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("case", POINT_CASES)
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (1_023, 1_026),
                                   (100_000, 100_001), (100_003, 100_002),
                                   "past_one_wave"])
def test_stats_point_is_bitwise_its_plain_version(cuda, shape, case,
                                                  offset):
    """F2d against stats_point_plain on the card: the point, the scaled
    point and the norm's bits (a NaN in the point shows in the norm),
    every output starting on 16 bytes, a second launch bitwise the first,
    the ticket and the word of the maximum back at zero."""
    from firstorderlp_torch.ops import eval_stats as es

    args = point_inputs(cuda, shape, case, offset)
    routed.reset_launch_counts()
    first = es.stats_point(*args)
    second = es.stats_point(*args)
    torch.cuda.synchronize()
    assert routed.LAUNCHES["stats_point"] == 2
    assert not bool(es.tickets(cuda).any())
    assert_same_bits(second, first, "second launch")
    assert_same_bits(first, es.stats_point_plain(*args), "point")
    for t in first:
        assert t is None or t.data_ptr() % 16 == 0
    assert (first.scaled_primal is None) == (args[-1] is None)
    if case.startswith("non_finite"):
        assert bool(torch.isnan(first.primal_norm))


def statistics_case(cuda, solver, monkeypatch):
    """(module, bundle, config, state, evaluation point) at iteration 81
    of segment_case, the point as evaluation_point gives it."""
    from firstorderlp_torch.models import common

    module, bundle, config, state = segment_case(cuda, solver, False,
                                                 monkeypatch)
    state = module._device_counters(state)
    if solver == "mirror_prox":
        current = state.current_primal, state.current_dual
    else:
        current = state.current_primal_solution, state.current_dual_solution
    return (module, bundle, config, state,
            common.evaluation_point(state, *current))


@pytest.mark.parametrize("tile_aligned", [False, True])
@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_replayed_evaluation_runs_the_fused_statistics(cuda, solver,
                                                       tile_aligned,
                                                       monkeypatch):
    """One evaluation from the state at iteration 81, replayed and run
    eagerly, on CSR and on the tile plan: each statistics kernel launched
    once, the same launches, every field bitwise equal."""
    module, bundle, config, state = segment_case(cuda, solver, tile_aligned,
                                                 monkeypatch)
    state = module._device_counters(state)
    out = {}
    for mode in ("graphed", "eager"):
        runner = module._runner(bundle, state, 0.0, config, mode == "eager")
        routed.reset_launch_counts()
        result = runner.detach(runner.evaluate())
        out[mode] = (runner.unload(), result, dict(routed.LAUNCHES))
    assert out["graphed"][2] == out["eager"][2]
    assert all(out["eager"][2][k] == 1 for k in STATS_KERNELS)
    assert_same_bits(out["graphed"][0], out["eager"][0])
    assert_same_bits(out["graphed"][1], out["eager"][1], "result")


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_fused_statistics_match_the_eager_ones_on_the_card(cuda, solver,
                                                          monkeypatch):
    """The kernels against the eager statistics (the previous release's
    route) on the card at iteration 81, with infeasibility detection off
    (the path's criteria) and on: the same reason, the maxima bitwise,
    every other field within 1e-5 of its magnitude."""
    from firstorderlp_torch.iteration_stats import DeviceConvergenceInfo
    from firstorderlp_torch.models import common

    module, bundle, config, state, (x, y) = statistics_case(
        cuda, solver, monkeypatch)
    kkt = state.cumulative_kkt_passes + 2.0
    iteration = state.iteration - 1
    elapsed = torch.zeros((), dtype=torch.float64, device=cuda)
    maxima = ("l_inf_primal_residual", "l_inf_dual_residual",
              "l_inf_primal_variable", "l_inf_dual_variable",
              "max_primal_ray_infeasibility", "max_dual_ray_infeasibility")
    for criteria in (config.criteria, dataclasses.replace(
            config.criteria, eps_primal_infeasible=1e-8,
            eps_dual_infeasible=1e-8)):
        args = (bundle, criteria, x, y, state.numerical_error, iteration,
                kkt, elapsed)
        assert common.fused_statistics(bundle, x)
        routed.reset_launch_counts()
        fused = common.evaluate_unscaled_stats(*args)
        assert all(routed.LAUNCHES[k] == 1 for k in STATS_KERNELS)
        with monkeypatch.context() as patch:
            patch.setattr(common, "fused_statistics", lambda *a: False)
            eager = common.evaluate_unscaled_stats(*args)
        assert int(fused[2]) == int(eager[2])
        for part in (0, 1):
            for name, g, w in zip(fused[part]._fields, fused[part],
                                  eager[part]):
                g, w = float(g), float(w)
                if name in maxima:
                    assert g == w, name
                elif not (np.isinf(w) and g == w):
                    assert abs(g - w) <= 1e-5 * abs(w) + 1e-7, name
        assert isinstance(fused[0], DeviceConvergenceInfo)
