"""The port's operators and per-evaluation modules against the JAX
package, on the CPU.

- The kernel operator's plain versions (mv, rmv, mv_dual_step,
  rmv_stats) against the JAX package's RoutedOp in Pallas interpret
  mode, which is what the reference runs off the TPU. Tolerance, the f32
  rounding class (the two sum in different orders):
  |d| <= 1e-5 (|A||x|)_i + 1e-7 per entry, rtol 1e-5 on the sums.
- The CSR kernels' work items (csr_work_items): every entry and row in
  one item, in row order, the caps, long rows cut into pieces and short
  rows never; the kernels' walk over the items, emulated in f64 in
  their order of items and tickets, against the same reference and
  against scipy (1e-12).
- DenseOp/CsrOp, the device problem, termination, iteration_stats,
  trust_region and run_restart_scheme in f64 at rtol 1e-12 (trust_region
  also in f32, at the f32 rounding class).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import iteration_stats as jx_stats
from firstorderlp_tpu import saddle_point as jx_sp
from firstorderlp_tpu import termination as jx_term
from firstorderlp_tpu import trust_region as jx_tr
from firstorderlp_tpu.generators import generate_pagerank_lp
from firstorderlp_tpu.ops import device_problem as jx_dev
from firstorderlp_tpu.ops.routed import build_routed_op as jx_build_routed

import firstorderlp_torch as tx
from firstorderlp_torch import iteration_stats as tx_stats
from firstorderlp_torch import saddle_point as tx_sp
from firstorderlp_torch import termination as tx_term
from firstorderlp_torch import trust_region as tx_tr
from firstorderlp_torch.convert import problem_from_arrays
from firstorderlp_torch.ops import device_problem as tx_dev
from firstorderlp_torch.ops import linops as tx_linops
from firstorderlp_torch.ops import routed as tx_routed

import fixtures

CPU = torch.device("cpu")
RTOL64 = 1e-12


def random_matrix(rng, m, n, nnz):
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    a = sp.coo_matrix((rng.normal(size=nnz), (r, c)), shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


def pathological_matrix():
    """Hub row, hub column, empty rows and columns (as in
    tests/test_routed.py)."""
    rng = np.random.default_rng(7)
    m, n = 400, 300
    rows = np.concatenate([np.zeros(200, int), rng.integers(5, 100, 300)])
    cols = np.concatenate([rng.integers(0, n, 200), np.full(300, 7)])
    a = sp.coo_matrix((rng.normal(size=500), (rows, cols)), shape=(m, n))
    a = a.tocsr()
    a.sum_duplicates()
    return a


def pagerank_matrix():
    """A small PageRank LP: row 0 is dense (300 entries)."""
    return generate_pagerank_lp(num_nodes=300, seed=0).constraint_matrix


MATRICES = {
    "300x500": lambda: random_matrix(np.random.default_rng(800), 300, 500,
                                     4000),
    "129x257": lambda: random_matrix(np.random.default_rng(386), 129, 257,
                                     600),
    "50x60": lambda: random_matrix(np.random.default_rng(110), 50, 60, 200),
    "1000x90": lambda: random_matrix(np.random.default_rng(1090), 1000, 90,
                                     5000),
    "pathological": pathological_matrix,
    "pagerank300": pagerank_matrix,
}


def s64(v):
    return torch.tensor(float(v), dtype=torch.float64)


def t(v, dtype=None):
    out = torch.as_tensor(np.asarray(v))
    return out.to(dtype) if dtype is not None else out


def assert_entrywise(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = 1e-5 * scale + 1e-7
    assert np.all(err <= bound), float(np.max(err - bound))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernel_op_matches_routed_interpret(name):
    a = sp.csr_matrix(MATRICES[name]())
    m, n = a.shape
    rng = np.random.default_rng(m * 7 + n)
    ref = jx_build_routed(a, group_rows=4)
    op = tx_routed.build_routed_op(a, CPU)
    a32 = abs(a.astype(np.float32).astype(np.float64))

    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    assert_entrywise(op.mv(t(x)).numpy(), ref.mv(jnp.asarray(x)),
                     a32 @ np.abs(x))
    assert_entrywise(op.rmv(t(y)).numpy(), ref.rmv(jnp.asarray(y)),
                     a32.T @ np.abs(y))

    z = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)
    eq = (rng.random(m) < 0.4).astype(np.float32)
    sigma = np.float32(0.37)
    yn, yn_layout, dy2 = op.mv_dual_step(
        t(z), t(y), t(b), t(eq), torch.tensor(sigma)
    )
    ryn, ryns, rdy2 = ref.mv_dual_step(
        jnp.asarray(z),
        ref.pad_dual_strips(jnp.asarray(y)),
        ref.pad_dual_strips(jnp.asarray(b)),
        ref.pad_dual_strips(jnp.asarray(eq)),
        float(sigma),
    )
    assert yn_layout is yn
    scale = np.abs(y) + sigma * (np.abs(b) + a32 @ np.abs(z))
    assert_entrywise(yn.numpy(), ryn, scale)
    np.testing.assert_allclose(float(dy2), float(rdy2), rtol=1e-5)

    dx = rng.normal(size=n).astype(np.float32)
    aty_old = rng.normal(size=n).astype(np.float32)
    aty, inter, dx2 = op.rmv_stats(yn, t(dx), t(aty_old))
    raty, rinter, rdx2 = ref.rmv_stats(
        ryns,
        ref.pad_primal_strips(jnp.asarray(dx)),
        ref.pad_primal_strips(jnp.asarray(aty_old)),
    )
    assert_entrywise(aty.numpy(), raty, a32.T @ np.abs(yn.numpy()))
    np.testing.assert_allclose(float(inter), float(rinter), rtol=1e-5)
    np.testing.assert_allclose(float(dx2), float(rdx2), rtol=1e-5)


def test_kernel_op_keeps_dtype_and_rejects_cuda_mismatch():
    a = random_matrix(np.random.default_rng(5), 100, 100, 900)
    op = tx_routed.build_routed_op(a, CPU)
    x64 = torch.as_tensor(np.random.default_rng(1).normal(size=100))
    assert op.mv(x64).dtype == torch.float64
    with pytest.raises(ValueError):
        tx_routed.build_routed_op(sp.csr_matrix((3, 3)), CPU)


# ---------------------------------------------------------------------------
# The work items of the CSR kernels (csrc/csr_spmv.cuh)
# ---------------------------------------------------------------------------


def rows_matrix(lengths, n, seed):
    """Rows of the given lengths, in order, over `n` columns."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate(
        [np.sort(rng.choice(n, size=k, replace=False)) for k in lengths]
        + [np.zeros(0, int)]
    )
    return sp.csr_matrix((rng.normal(size=indptr[-1]), indices, indptr),
                         shape=(len(lengths), n))


# name -> (matrix, item_entries): structures that reach every kind of
# item and every cut of csr_work_items
ITEM_CASES = {
    # long runs of empty rows between short rows, and trailing empties
    "empty_rows": (lambda: rows_matrix([0] * 700 + [3, 0, 5] + [0] * 900,
                                       40, 0), 64),
    # every row long (past 16 trips of 32 lanes) and longer than the
    # item size: all pieces
    "all_rows_long": (lambda: rows_matrix([600, 1000, 513, 700], 1200, 1),
                      128),
    # a long row of exactly the item size: one block, not cut
    "row_of_exactly_e": (lambda: rows_matrix([2] * 200 + [256] + [1] * 200,
                                             300, 2), 256),
    # a dense row among short rows, cut into many pieces
    "dense_row": (lambda: rows_matrix([3] * 50 + [5000] + [4] * 60, 6000,
                                      3), 256),
    # more short rows than a run may stage
    "many_short_rows": (lambda: rows_matrix([1] * 5000, 30, 4), 100_000),
}


def item_matrix(case):
    """(csr, CsrKernelMatrix) of a MATRICES name (default item size, or
    `name:e` for item size e) or of an ITEM_CASES name."""
    name, _, size = case.partition(":")
    if name in ITEM_CASES:
        make, entries = ITEM_CASES[name]
    else:
        make, entries = MATRICES[name], int(size) if size else None
    a = sp.csr_matrix(make())
    a.sum_duplicates()
    return a, csr_matrix_of(a, "A", entries)


def csr_matrix_of(a, label, entries=None):
    """The kernel matrix of `a`, its items cut to `entries` (default:
    ITEM_ENTRIES)."""
    mat = tx_routed.build_csr_kernel_matrix(a, CPU, label)
    return tx_routed.csr_with_items(mat, entries) if entries else mat


ITEM_MATRICES = (sorted(MATRICES) + [f"{k}:16" for k in sorted(MATRICES)]
                 + sorted(ITEM_CASES))


def check_items(mat, a, split_rows=True):
    """The item table's invariants (csr_work_items' contract)."""
    items = mat.items.numpy().astype(np.int64)
    indptr = a.indptr.astype(np.int64)
    lens = np.diff(indptr)
    rows, e = a.shape[0], mat.item_entries
    threshold = tx_routed.LONG_ROW_TRIPS * mat.tpr
    assert items.shape == (mat.nitems + 1, 4)
    assert items[-1].tolist() == [a.nnz, rows, 0, 0]
    assert items[0, 0] == 0 and items[0, 1] == 0
    assert np.all(np.diff(items[:, 0]) >= 0)
    assert np.all(np.diff(items[:, 1]) >= 0)
    covered = np.zeros(rows, dtype=int)
    i = 0
    while i < mat.nitems:
        e0, r0, index, pieces = items[i]
        if pieces == 0:  # a run of whole short rows
            r1 = items[i + 1, 1]
            assert 0 < r1 - r0 <= tx_routed.MAX_ITEM_ROWS
            assert e0 == indptr[r0] and items[i + 1, 0] == indptr[r1]
            assert np.all(lens[r0:r1] <= threshold)
            assert indptr[r1] - e0 <= e + threshold
            assert index == 0
            covered[r0:r1] += 1
            i += 1
            continue
        # a long row: its pieces together, in order, from its first
        # entry to its last, none above the item size
        assert lens[r0] > threshold
        want = max(-(-lens[r0] // e), 1) if split_rows else 1
        assert pieces == want
        np.testing.assert_array_equal(items[i:i + pieces, 1], r0)
        np.testing.assert_array_equal(items[i:i + pieces, 2],
                                      np.arange(pieces))
        np.testing.assert_array_equal(items[i:i + pieces, 3], pieces)
        bounds = items[i:i + pieces + 1, 0]
        assert bounds[0] == indptr[r0] and bounds[-1] == indptr[r0 + 1]
        sizes = np.diff(bounds)
        assert np.all(sizes > 0)
        if split_rows:
            assert sizes.max() <= e and sizes.max() - sizes.min() <= 1
        covered[r0] += 1
        i += pieces
    np.testing.assert_array_equal(covered, 1)  # every row in one item
    assert mat.scratch.shape == (3 * max(mat.nitems, 1),)
    assert mat.scratch.dtype == torch.float32
    assert mat.tickets.shape == (mat.nitems + 1,)
    assert mat.tickets.dtype == torch.int32 and not mat.tickets.any()
    return items


@pytest.mark.parametrize("case", ITEM_MATRICES)
def test_work_items_cover_the_rows(case):
    """Every stored entry and every row lies in exactly one item, in row
    order; a run holds whole short rows, at most MAX_ITEM_ROWS of them
    and the item size plus one short row's entries; a long row is one
    item or pieces of floor or ceil of equal shares, none above the
    item size; both orientations."""
    a, mat = item_matrix(case)
    check_items(mat, a)
    at = sp.csr_matrix(a.T)
    check_items(csr_matrix_of(at, "AT", mat.item_entries), at)


def test_a_dense_row_is_cut_into_many_items_and_a_short_row_never():
    a, mat = item_matrix("dense_row")
    items = check_items(mat, a)
    dense = items[:-1, 1] == 50
    assert dense.sum() == 20 and np.all(items[:-1][dense, 3] == 20)
    short = items[:-1, 3] == 0
    assert not np.any(items[:-1][~dense, 3])  # every other row in runs
    assert np.all(np.diff(items[:, 1])[short] >= 1)
    stats = tx_routed.csr_item_stats(mat)
    assert stats["split_rows"] == 1 and stats["long_rows"] == 1
    assert stats["blocks"] == mat.nitems
    assert stats["entries_per_block_max"] == np.diff(items[:, 0]).max()
    # the same rows with no row cut: the dense row is one block
    whole = tx_routed.csr_with_items(mat, split_rows=False)
    items = check_items(whole, a, split_rows=False)
    assert np.sum(items[:-1, 1] == 50) == 1
    assert tx_routed.csr_item_stats(whole)["split_rows"] == 0
    assert whole.scratch.data_ptr() != mat.scratch.data_ptr()


def test_edge_structures_of_the_items():
    # empty rows: runs of at most the row cap, the empty rows included
    a, mat = item_matrix("empty_rows")
    items = check_items(mat, a)
    assert not items[:-1, 3].any()
    # 1,603 rows and 8 entries: 1,611 units in runs of 64
    assert mat.nitems == 26 and np.diff(items[:, 1]).max() == 64
    assert np.diff(items[:, 1])[:10].tolist() == [64] * 10
    # every row longer than E: pieces only
    a, mat = item_matrix("all_rows_long")
    items = check_items(mat, a)
    assert np.all(items[:-1, 3] > 1)
    assert mat.tpr == 32
    assert [int(np.sum(items[:-1, 1] == r)) for r in range(4)] == [
        5, 8, 5, 6]
    # a row of exactly E entries is one whole-row item
    a, mat = item_matrix("row_of_exactly_e")
    items = check_items(mat, a)
    mine = np.flatnonzero(items[:-1, 1] == 200)
    assert len(mine) == 1 and items[mine[0]].tolist() == [400, 200, 0, 1]
    assert items[mine[0] + 1].tolist()[:2] == [656, 201]
    # more short rows than a run may stage
    a, mat = item_matrix("many_short_rows")
    items = check_items(mat, a)
    runs = np.diff(items[:, 1])
    assert 1000 <= runs.max() <= tx_routed.MAX_ITEM_ROWS and len(runs) == 5


def test_item_size_and_bytes_bound():
    """Items of ITEM_ENTRIES units whatever the matrix; the bytes bound
    counts the CSR arrays a product needs, not the kernels' item table."""
    for case in ("dense_row", "many_short_rows"):
        a = sp.csr_matrix(ITEM_CASES[case][0]())
        mat = tx_routed.build_csr_kernel_matrix(a, CPU, "A")
        assert mat.item_entries == tx_routed.ITEM_ENTRIES == 2048
        m, nnz = a.shape[0], a.nnz
        assert tx_routed.csr_kernel_bytes(mat) == 4 * (m + 1) + 8 * nnz
        stats = tx_routed.csr_item_stats(mat)
        assert stats["matrix_bytes"] == 4 * (m + 1) + 8 * nnz
        assert stats["item_table_bytes"] == 16 * (mat.nitems + 1)
    with pytest.raises(ValueError):
        tx_routed.csr_work_items(np.array([0, 1]), 2, 0)


@pytest.mark.parametrize("layout", ["csr", "tiled"])
def test_compare_tool_drives_every_kernel_of_its_layout(layout):
    """ops/compare_kernels' table of products calls each wrapper of the
    layout on that layout's operator (on the CPU: the plain versions),
    each under its LAUNCHES name, with the results of scipy in f64."""
    from firstorderlp_torch.ops import compare_kernels

    a = sp.csr_matrix(ITEM_CASES["dense_row"][0]())
    m, n = a.shape
    op = tx_routed.build_routed_op(a, CPU, tile_aligned=layout == "tiled")
    rng = np.random.default_rng(5)
    host = {k: rng.normal(size=size).astype(np.float32) for k, size in (
        ("x", n), ("y", m), ("b", m), ("dx", n), ("aty_old", n))}
    host["eq"] = (rng.random(m) < 0.3).astype(np.float32)
    v = {k: torch.as_tensor(h) for k, h in host.items()}
    v["sigma"] = torch.full((), 0.37)
    h = {k: x.astype(np.float64) for k, x in host.items()}
    ax, aty = a @ h["x"], a.T @ h["y"]
    cand = h["y"] + 0.37 * (h["b"] - ax)
    y_next = np.where(h["eq"] != 0, cand, np.maximum(cand, 0.0))
    spmv, dual, stats = compare_kernels.KERNELS[layout]
    want = {
        f"{spmv}:A": (ax,), f"{spmv}:AT": (aty,),
        dual: (y_next, np.sum((y_next - h["y"]) ** 2)),
        stats: (aty, np.sum(h["dx"] * (aty - h["aty_old"])),
                np.sum(h["dx"] ** 2)),
    }
    calls = compare_kernels.products(tx_routed, op, v, layout)
    assert set(calls) == set(want) and set(calls) <= set(tx_routed.LAUNCHES)
    for name, call in calls.items():
        got = call()
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want[name]), name
        for g, w in zip(got, want[name]):
            np.testing.assert_allclose(g.double().numpy(), w, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def tree(values, width):
    """The shuffle-down tree over `width` lanes (lane 0's total)."""
    v = list(values) + [0.0] * (width - len(values))
    off = width // 2
    while off:
        v = [v[j] + v[j + off] if j + off < width else v[j]
             for j in range(width)]
        off //= 2
    return v[0]


def block_tree(values):
    """block_sum (csrc/fixed_order.cuh): a tree in each warp of 32, then
    the warps' sums in warp order."""
    threads = tx_routed.ITEM_BLOCK_THREADS
    v = list(values) + [0.0] * (threads - len(values))
    total = 0.0
    for w in range(threads // 32):
        total += tree(v[32 * w:32 * w + 32], 32)
    return total


def strided(values, start, stop, step):
    """Thread t's sum of values[start + t], values[start + t + step],
    ... below `stop`, for every thread of a block."""
    return [float(np.sum(values[start + t:stop:step])) for t in range(step)]


def emulate_csr_walk(mat, x, epilogue=None, parts=0):
    """csr_item_kernel (csrc/csr_spmv.cuh) item by item in f64, in the
    kernel's order of items and tickets: a run's rows by groups of TPR
    lanes in turn, lane-strided, then the group's tree; a long row or a
    piece by the whole block's threads, then block_sum; a cut row's
    piece sums added in item order by the block that draws its last
    ticket; each item's epilogue partials (a cut row's in its first
    item's slot), then their sums in item order by the block that draws
    the launch's last ticket. `epilogue(row,
    sum)` returns the row's `parts` terms. Returns (row sums, sums)."""
    indptr = mat.indptr.numpy().astype(np.int64)
    prod = (mat.vals.numpy().astype(np.float64)
            * np.asarray(x, np.float64)[mat.indices.numpy()])
    items = mat.items.numpy().astype(np.int64)
    threads, tpr, nitems = tx_routed.ITEM_BLOCK_THREADS, mat.tpr, mat.nitems
    y = np.full(mat.num_rows, np.nan)
    scratch = np.full(nitems, np.nan)
    tickets = np.zeros(nitems + 1, dtype=np.int64)
    item_parts = np.zeros((parts, nitems))
    for it in range(nitems):
        e0, r0, index, pieces = items[it]
        e1, r1 = items[it + 1, :2]
        finished = []  # (row, sum) in the order the threads hold them
        if pieces == 0:
            groups = threads // tpr
            for base in range(0, r1 - r0, groups):
                for r in range(r0 + base, min(r0 + base + groups, r1)):
                    lanes = strided(prod, indptr[r], indptr[r + 1], tpr)
                    finished.append((r, tree(lanes, tpr)))
        else:
            total = block_tree(strided(prod, e0, e1, threads))
            if pieces > 1:
                scratch[it] = total
                first = it - index
                tickets[first] += 1
                if tickets[first] == pieces:
                    tickets[first] = 0
                    finished.append((r0, block_tree(strided(
                        scratch, first, first + pieces, threads))))
            else:
                finished.append((r0, total))
        part = np.zeros(parts)
        for r, total in finished:
            assert np.isnan(y[r]), "a row finished twice"
            y[r] = total
            if parts:
                part += epilogue(r, total)
        # a cut row's terms in its first item's slot, 0 in its others'
        if pieces > 1:
            if index:
                item_parts[:, it] = 0.0
            if finished:
                item_parts[:, it - index] = part
        else:
            item_parts[:, it] = part
        tickets[nitems] += 1
    assert not np.isnan(y).any(), "a row never finished"
    assert tickets[:nitems].sum() == 0 and tickets[nitems] == nitems
    sums = [block_tree(strided(item_parts[k], 0, nitems, threads))
            for k in range(parts)]
    return y, sums


def walk_products(a, mat, mat_t, v):
    """The port's four products by emulate_csr_walk, in f64."""
    ax, _ = emulate_csr_walk(mat, v["x"])
    aty, _ = emulate_csr_walk(mat_t, v["y"])
    sigma = float(v["sigma"])
    yn = np.zeros(a.shape[0])

    def dual(row, az):
        cand = v["y"][row] + sigma * (v["b"][row] - az)
        yn[row] = cand if v["eq"][row] != 0 else max(cand, 0.0)
        return [(yn[row] - v["y"][row]) ** 2]

    _, (dy2,) = emulate_csr_walk(mat, v["z"], dual, 1)

    def stats(row, s):
        d = float(v["dx"][row])
        return [d * (s - v["aty_old"][row]), d * d]

    aty_next, (inter, dx2) = emulate_csr_walk(mat_t, yn, stats, 2)
    return ax, aty, yn, dy2, aty_next, inter, dx2


@functools.lru_cache(maxsize=None)
def routed_reference(name):
    """The JAX package's RoutedOp products in interpret mode, on
    walk_vectors(name); computed once per matrix."""
    a = sp.csr_matrix(WALK_MATRICES[name]())
    v = walk_vectors(a)
    ref = jx_build_routed(a, group_rows=4)
    ryn, ryns, rdy2 = ref.mv_dual_step(
        jnp.asarray(v["z"]), ref.pad_dual_strips(jnp.asarray(v["y"])),
        ref.pad_dual_strips(jnp.asarray(v["b"])),
        ref.pad_dual_strips(jnp.asarray(v["eq"])), float(v["sigma"]),
    )
    raty, rinter, rdx2 = ref.rmv_stats(
        ryns, ref.pad_primal_strips(jnp.asarray(v["dx"])),
        ref.pad_primal_strips(jnp.asarray(v["aty_old"])),
    )
    return (np.asarray(ref.mv(jnp.asarray(v["x"]))),
            np.asarray(ref.rmv(jnp.asarray(v["y"]))), np.asarray(ryn),
            float(rdy2), np.asarray(raty), float(rinter), float(rdx2))


def walk_vectors(a):
    m, n = a.shape
    rng = np.random.default_rng(m * 3 + n)
    f32 = np.float32
    return dict(
        x=rng.normal(size=n).astype(f32), y=rng.normal(size=m).astype(f32),
        z=rng.normal(size=n).astype(f32), b=rng.normal(size=m).astype(f32),
        eq=(rng.random(m) < 0.4).astype(f32),
        dx=rng.normal(size=n).astype(f32),
        aty_old=rng.normal(size=n).astype(f32), sigma=f32(0.37),
    )


# The shapes and structures of tests/test_routed.py:33,51,195, plus a
# small PageRank LP; each at the default item size and at 16, which cuts
# every row past 16 trips of its group into pieces.
WALK_MATRICES = dict(
    MATRICES,
    **{"700x500": lambda: random_matrix(np.random.default_rng(1200), 700,
                                        500, 6000)},
)


@pytest.mark.parametrize("entries", [None, 16])
@pytest.mark.parametrize("name", sorted(WALK_MATRICES))
def test_kernel_walk_over_the_items_matches_routed_interpret(name, entries):
    """The kernels' walk over the items (emulate_csr_walk, f64) gives the
    four products of the JAX package's RoutedOp in interpret mode, in
    the f32 rounding class (the interaction sum, which cancels, to 1e-5
    of the sum of its terms' magnitudes), and scipy's products to
    1e-12."""
    a = sp.csr_matrix(WALK_MATRICES[name]())
    a.sum_duplicates()
    v = walk_vectors(a)
    mat = csr_matrix_of(a, "A", entries)
    at = sp.csr_matrix(a.T)
    mat_t = csr_matrix_of(at, "AT", entries)
    got = walk_products(a, mat, mat_t, v)
    want = routed_reference(name)
    a32 = abs(a.astype(np.float32).astype(np.float64))
    assert_entrywise(got[0], want[0], a32 @ np.abs(v["x"]))
    assert_entrywise(got[1], want[1], a32.T @ np.abs(v["y"]))
    scale = np.abs(v["y"]) + v["sigma"] * (np.abs(v["b"])
                                           + a32 @ np.abs(v["z"]))
    assert_entrywise(got[2], want[2], scale)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    assert_entrywise(got[4], want[4], a32.T @ np.abs(got[2]))
    inter_scale = np.sum(np.abs(v["dx"]) * (a32.T @ np.abs(got[2])
                                            + np.abs(v["aty_old"])))
    assert abs(got[5] - want[5]) <= 1e-5 * inter_scale + 1e-7
    np.testing.assert_allclose(got[6], want[6], rtol=1e-5)
    f32 = a.astype(np.float32).astype(np.float64)
    for product, mat_, vec in ((got[0], f32, v["x"]), (got[1], f32.T,
                                                       v["y"])):
        exact = mat_ @ vec.astype(np.float64)
        assert np.all(np.abs(product - exact)
                      <= 1e-12 * (abs(mat_) @ np.abs(vec)) + 1e-300)


def test_kernel_wrappers_reject_mismatched_inputs():
    a = random_matrix(np.random.default_rng(4), 30, 40, 200)
    op = tx_routed.build_routed_op(a, CPU)
    with pytest.raises(ValueError):
        tx_routed._check("x", torch.zeros(41), (40,), CPU)
    with pytest.raises(TypeError):
        tx_routed._check("x", torch.zeros(40, dtype=torch.float64), (40,),
                         CPU)
    with pytest.raises(ValueError):
        tx_routed._check("x", torch.zeros(80)[::2], (40,), CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tx_routed._launch("spmv_csr", op.a)


@pytest.mark.parametrize("fmt", ["dense", "sparse", "ell", "coo"])
def test_linops_match_scipy_f64(fmt):
    rng = np.random.default_rng(12)
    a = random_matrix(rng, 70, 50, 600)
    op = tx_linops.build_linop(a, torch.float64, fmt, CPU)
    x, y = rng.normal(size=50), rng.normal(size=70)
    np.testing.assert_allclose(op.mv(t(x)).numpy(), a @ x, rtol=RTOL64,
                               atol=1e-13)
    np.testing.assert_allclose(op.rmv(t(y)).numpy(), a.T @ y, rtol=RTOL64,
                               atol=1e-13)


def test_build_linop_format_rules():
    a = random_matrix(np.random.default_rng(9), 300, 300, 4000)
    assert isinstance(
        tx_linops.build_linop(a, torch.float32, "routed", CPU),
        tx_routed.RoutedOp,
    )
    with pytest.raises(ValueError, match="f32"):
        tx_linops.build_linop(a, torch.float64, "routed", CPU)
    big = random_matrix(np.random.default_rng(3), 3000, 3000, 60_000)
    # auto: dense when small, the kernel operator only on a CUDA device.
    assert isinstance(
        tx_linops.build_linop(a, torch.float32, "auto", CPU),
        tx_linops.DenseOp,
    )
    assert isinstance(
        tx_linops.build_linop(big, torch.float32, "auto", CPU),
        tx_linops.CsrOp,
    )


def port_problem(p):
    return problem_from_arrays(
        p.variable_lower_bound, p.variable_upper_bound, p.objective_matrix,
        p.objective_vector, p.objective_constant, p.constraint_matrix,
        p.right_hand_side, p.num_equalities,
    )


def bundles(name, fmt="dense"):
    p = getattr(fixtures, name)()
    want = jx_dev.to_device_scaled(
        jx.rescale_problem(3, True, 1.0, 0, p), jnp.float64, fmt
    )
    got = tx_dev.to_device_scaled(
        tx.rescale_problem(3, True, 1.0, 0, port_problem(p)),
        torch.float64, fmt, CPU,
    )
    return want, got


STAT_FIXTURES = ["example_lp", "example_qp", "example_cc_lp",
                 "example_lp_without_bounds", "example_qp2"]


@pytest.mark.parametrize("name", STAT_FIXTURES)
def test_device_problem_matches(name):
    want, got = bundles(name, "ell")
    for part in ("scaled", "original"):
        w, g = getattr(want, part), getattr(got, part)
        for field in ("variable_lower_bound", "variable_upper_bound",
                      "objective_vector", "right_hand_side", "is_equality"):
            np.testing.assert_array_equal(
                getattr(g, field).numpy(), np.asarray(getattr(w, field))
            )
        x = np.random.default_rng(0).normal(size=g.num_variables)
        np.testing.assert_allclose(
            g.ax(t(x)).numpy(), w.ax(jnp.asarray(x)), rtol=RTOL64,
            atol=1e-13,
        )
    for a, b in zip(got.qp_cache, want.qp_cache):
        assert float(a) == float(b)


def random_point(got, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=got.original.num_variables),
            rng.normal(size=got.original.num_constraints))


@pytest.mark.parametrize("name", STAT_FIXTURES)
def test_iteration_stats_and_termination_match(name):
    want, got = bundles(name)
    x, y = random_point(got, 1)
    conv_w = jx_stats.compute_convergence_information(
        want.original, want.qp_cache, jnp.asarray(x), jnp.asarray(y), 1.0
    )
    conv_g = tx_stats.compute_convergence_information(
        got.original, got.qp_cache, t(x), t(y), 1.0
    )
    inf_w = jx_stats.compute_infeasibility_information(
        want.original, jnp.asarray(x), jnp.asarray(y)
    )
    inf_g = tx_stats.compute_infeasibility_information(
        got.original, t(x), t(y)
    )
    for w, g in ((conv_w, conv_g), (inf_w, inf_g)):
        for field in w._fields:
            np.testing.assert_allclose(
                float(getattr(g, field)), float(getattr(w, field)),
                rtol=RTOL64, atol=1e-14, err_msg=field,
            )
    for norm in (jx_term.OptimalityNorm.L2, jx_term.OptimalityNorm.L_INF):
        for eps, limit, kkt in ((1e8, 10, 1.0), (1e-8, 10, 1.0),
                                (1e-8, 3, 1.0), (1e-8, 10, 20.0)):
            crit_w = jx_term.TerminationCriteria(
                optimality_norm=norm, eps_optimal_absolute=eps,
                eps_optimal_relative=eps, iteration_limit=limit,
                kkt_matrix_pass_limit=10.0,
            )
            crit_g = tx_term.TerminationCriteria(
                optimality_norm=tx_term.OptimalityNorm(norm.value),
                eps_optimal_absolute=eps, eps_optimal_relative=eps,
                iteration_limit=limit, kkt_matrix_pass_limit=10.0,
            )
            r_w = jx_term.check_termination_criteria(
                crit_w, want.qp_cache, conv_w, inf_w, 5, kkt, 0.0
            )
            r_g = tx_term.check_termination_criteria(
                crit_g, got.qp_cache, conv_g, inf_g, 5, kkt, 0.0
            )
            assert int(r_g) == int(r_w)


def trust_region_inputs(seed, size, dtype):
    rng = np.random.default_rng(seed)
    lb = np.where(rng.random(size) < 0.2, -np.inf, -rng.random(size))
    ub = np.where(rng.random(size) < 0.2, np.inf, rng.random(size))
    center = np.clip(rng.normal(size=size) * 0.5, lb, ub)
    center[:5] = lb[:5]  # some components at a bound
    g = rng.normal(size=size)
    w = rng.uniform(0.5, 2.0, size)
    return [v.astype(dtype) for v in (center, g, lb, ub, w)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("radius", [0.0, 0.05, 0.7, 50.0])
@pytest.mark.parametrize("approx", [False, True])
def test_trust_region_matches(dtype, radius, approx):
    args = trust_region_inputs(int(radius * 100) + 3, 200, dtype)
    r = dtype(radius)
    want = jx_tr.solve_bound_constrained_trust_region(
        *[jnp.asarray(v) for v in args], jnp.asarray(r), approx
    )
    got = tx_tr.solve_bound_constrained_trust_region(
        *[t(v) for v in args], torch.tensor(r), approx
    )
    rtol = RTOL64 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got.solution.numpy(), want.solution,
                               rtol=rtol, atol=rtol * 1e-2)
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=rtol, atol=rtol * 1e-2)


@pytest.mark.parametrize("use_max_norm", [False, True])
@pytest.mark.parametrize("name", ["example_lp", "example_qp"])
def test_bound_optimal_objective_matches(name, use_max_norm):
    want, got = bundles(name)
    x, y = random_point(got, 4)
    pw = np.full(x.size, 1.3)
    dw = np.full(y.size, 0.7)
    bw = jx_tr.bound_optimal_objective(
        want.scaled, jnp.asarray(x), jnp.asarray(y), jnp.asarray(pw),
        jnp.asarray(dw), 0.8, use_max_norm=use_max_norm,
    )
    bg = tx_tr.bound_optimal_objective(
        got.scaled, t(x), t(y), t(pw), t(dw), 0.8, use_max_norm=use_max_norm,
    )
    for a, b in zip(bg, bw):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL64)


def restart_states(got, seed, has_gap):
    rng = np.random.default_rng(seed)
    n, m = got.scaled.num_variables, got.scaled.num_constraints
    v = {
        "avg_x": rng.normal(size=n), "avg_y": np.abs(rng.normal(size=m)),
        "cur_x": rng.normal(size=n), "cur_y": np.abs(rng.normal(size=m)),
        "rx": rng.normal(size=n), "ry": np.abs(rng.normal(size=m)),
        "wx": rng.uniform(1, 3), "wy": rng.uniform(1, 3),
        "gap": rng.uniform(0.1, 1.0), "pd": rng.uniform(0.1, 1.0),
        "dd": rng.uniform(0.1, 1.0), "ratio": rng.uniform(0.2, 1.0),
    }
    j_avg = jx_sp.SolutionWeightedAverage(
        jnp.asarray(v["avg_x"] * v["wx"]), jnp.asarray(v["avg_y"] * v["wy"]),
        jnp.int64(17), jnp.int64(17), jnp.asarray(v["wx"]),
        jnp.asarray(v["wy"]),
    )
    t_avg = tx_sp.SolutionWeightedAverage(
        t(v["avg_x"] * v["wx"]), t(v["avg_y"] * v["wy"]), torch.tensor(17),
        torch.tensor(17), s64(v["wx"]), s64(v["wy"]),
    )
    j_info = jx_sp.RestartInfo(
        jnp.asarray(v["rx"]), jnp.asarray(v["ry"]), jnp.asarray(has_gap),
        jnp.asarray(v["gap"]), jnp.int64(9), jnp.asarray(v["pd"]),
        jnp.asarray(v["dd"]), jnp.asarray(v["ratio"]),
    )
    t_info = tx_sp.RestartInfo(
        t(v["rx"]), t(v["ry"]), torch.tensor(has_gap), s64(v["gap"]),
        torch.tensor(9),
        s64(v["pd"]), s64(v["dd"]),
        s64(v["ratio"]),
    )
    return v, (j_avg, j_info), (t_avg, t_info)


@pytest.mark.parametrize("scheme", list(jx_sp.RestartScheme))
@pytest.mark.parametrize("metric", list(jx_sp.RestartToCurrentMetric))
@pytest.mark.parametrize("seed,iters,has_gap", [(0, 100, True),
                                                (1, 20, False)])
def test_run_restart_scheme_matches(scheme, metric, seed, iters, has_gap):
    want, got = bundles("example_lp")
    v, (j_avg, j_info), (t_avg, t_info) = restart_states(got, seed, has_gap)
    n, m = got.scaled.num_variables, got.scaled.num_constraints
    pnorm, dnorm, pw = np.full(n, 2.0), np.full(m, 0.5), 1.7
    params_j = jx_sp.construct_restart_parameters(
        scheme, metric, 10, 0.5, 0.2, 0.8, 0.5, False
    )
    params_t = tx_sp.construct_restart_parameters(
        tx_sp.RestartScheme(scheme.value),
        tx_sp.RestartToCurrentMetric(metric.value), 10, 0.5, 0.2, 0.8, 0.5,
        False,
    )
    rj = jx_sp.run_restart_scheme(
        want.scaled, j_avg, jnp.asarray(v["cur_x"]), jnp.asarray(v["cur_y"]),
        j_info, iters, jnp.asarray(pnorm), jnp.asarray(dnorm),
        jnp.asarray(pw), params_j,
    )
    rt = tx_sp.run_restart_scheme(
        got.scaled, t_avg, t(v["cur_x"]), t(v["cur_y"]), t_info,
        torch.tensor(iters),
        t(pnorm), t(dnorm), s64(pw), params_t,
    )
    assert rt.restart_choice == int(rj.restart_choice)
    for a, b in ((rt.primal_solution, rj.primal_solution),
                 (rt.dual_solution, rj.dual_solution)):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL64)
    for field in dataclasses.fields(rt.restart_info):
        a = getattr(rt.restart_info, field.name)
        b = np.asarray(getattr(rj.restart_info, field.name))
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, b, rtol=RTOL64, err_msg=field.name)
    assert rt.avg.sum_primal_solutions_count == int(
        rj.avg.sum_primal_solutions_count
    )
    np.testing.assert_allclose(rt.avg.sum_primal_solutions.numpy(),
                               rj.avg.sum_primal_solutions, rtol=RTOL64)
    new_pw_t = tx_sp.compute_new_primal_weight(rt.restart_info,
                                               s64(pw), 0.5)
    new_pw_j = jx_sp.compute_new_primal_weight(rj.restart_info,
                                               jnp.asarray(pw), 0.5)
    np.testing.assert_allclose(float(new_pw_t), float(new_pw_j), rtol=RTOL64)
