"""B2's staged walk (csrc/spmv_csr.cu) on the CPU: its item table
(routed.csr_stage_items), its shared memory (routed.stage_slots) and its
copies (routed.stage_copies), and its order of sums emulated item by
item in f64 (emulate_stage_walk) against the JAX package's RoutedOp in
Pallas interpret mode (the f32 rounding class: the two sum in different
orders, |d| <= 1e-5 (|A||x|)_i + 1e-7) and against scipy (1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_tpu.generators import generate_pagerank_lp
from firstorderlp_tpu.ops.routed import build_routed_op as jx_build_routed

from firstorderlp_torch.ops import block_lanes
from firstorderlp_torch.ops import routed as tx_routed
from test_torch_ops import (
    ITEM_MATRICES,
    WALK_MATRICES,
    assert_entrywise,
    block_tree,
    csr_matrix_of,
    item_matrix,
    strided,
)

CPU = torch.device("cpu")
THREADS = tx_routed.ITEM_BLOCK_THREADS


def check_stage_items(mat, a, split_rows=True):
    """B2's item table: every stored entry and every row in exactly one
    item, in row order; a run holds whole rows of at most STAGE_LONG_ROW
    entries, at most item_entries plus one row's entries and at most
    item_entries + 1 rows; a long row is one item or pieces of floor or
    ceil of equal shares, none above the item size; every item's
    entries (at any offset in its 16-byte word) and row pointers fit the
    stage (long rows are not staged); scratch and tickets one a
    block."""
    items = mat.stage_items.numpy().astype(np.int64)
    indptr = a.indptr.astype(np.int64)
    lens = np.diff(indptr)
    rows, e = a.shape[0], mat.item_entries
    long_row = tx_routed.STAGE_LONG_ROW
    assert items.shape == (mat.nstage + 1, 4)
    assert items[-1].tolist() == [a.nnz, rows, 0, 0]
    assert items[0, 0] == 0 and items[0, 1] == 0
    assert mat.stage_entries % 4 == 0 and mat.stage_rows % 4 == 0
    covered = np.zeros(rows, dtype=int)
    i = 0
    while i < mat.nstage:
        e0, r0, index, pieces = items[i]
        if pieces == 0:
            assert items[i + 1, 0] - e0 + 3 <= mat.stage_entries
            r1 = items[i + 1, 1]
            assert 0 < r1 - r0 <= e + 1
            assert r1 - r0 + 1 <= mat.stage_rows
            assert e0 == indptr[r0] and items[i + 1, 0] == indptr[r1]
            assert np.all(lens[r0:r1] <= long_row)
            assert indptr[r1] - e0 <= e + long_row
            assert index == 0
            covered[r0:r1] += 1
            i += 1
            continue
        assert lens[r0] > long_row
        want = max(-(-lens[r0] // e), 1) if split_rows else 1
        assert pieces == want
        np.testing.assert_array_equal(items[i:i + pieces, 1], r0)
        np.testing.assert_array_equal(items[i:i + pieces, 2],
                                      np.arange(pieces))
        bounds = items[i:i + pieces + 1, 0]
        assert bounds[0] == indptr[r0] and bounds[-1] == indptr[r0 + 1]
        sizes = np.diff(bounds)
        assert np.all(sizes > 0)
        if split_rows:
            assert sizes.max() <= e and sizes.max() - sizes.min() <= 1
        covered[r0] += 1
        i += pieces
    np.testing.assert_array_equal(covered, 1)
    assert mat.stage_scratch.shape == (max(mat.nstage, 1),)
    assert mat.stage_tickets.shape == (max(mat.nstage, 1),)
    assert mat.stage_tickets.dtype == torch.int32
    assert not mat.stage_tickets.any()
    return items


@pytest.mark.parametrize("case", ITEM_MATRICES)
def test_stage_items_cover_the_rows(case):
    """csr_stage_items' contract on every structure of the CSR item tests
    (empty rows, all rows long, a row of exactly the item size, a dense
    row among short ones, many short rows), both orientations, and with
    no row cut; the table does not depend on the group width."""
    a, mat = item_matrix(case)
    check_stage_items(mat, a)
    at = sp.csr_matrix(a.T)
    check_stage_items(csr_matrix_of(at, "AT", mat.item_entries), at)
    whole = tx_routed.csr_with_items(mat, split_rows=False)
    check_stage_items(whole, a, split_rows=False)
    other = tx_routed.csr_with_items(mat, tpr=32 if mat.tpr != 32 else 2)
    assert torch.equal(other.stage_items, mat.stage_items)


def test_stage_items_charge_an_empty_row_one_step():
    """A run's work is its entries plus one a row, so an empty row costs
    one unit: 700 empty rows, three short rows and 900 empty rows
    (1,611 units) at items of 64 units are 26 runs of up to 64 rows. A
    row past STAGE_LONG_ROW entries is its own item, and a row past the
    item size is cut into pieces of equal shares."""
    lengths = [0] * 700 + [3, 0, 5] + [0] * 900
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    items = tx_routed.csr_stage_items(indptr, 64)
    runs = np.diff(items[:, 1])
    assert items[:-1, 3].sum() == 0
    # 1,603 rows, 8 entries: 1,611 units, cut where they pass 64 k
    assert len(runs) == 26 and runs.max() == 64
    long_len = tx_routed.STAGE_LONG_ROW + 1
    indptr = np.concatenate([[0], np.cumsum([3, long_len, 3, 5000, 2])])
    items = tx_routed.csr_stage_items(indptr, 2048)
    assert items[:-1].tolist() == [
        [0, 0, 0, 0], [3, 1, 0, 1], [3 + long_len, 2, 0, 0],
        [6 + long_len, 3, 0, 3], [6 + long_len + 1666, 3, 1, 3],
        [6 + long_len + 3333, 3, 2, 3], [6 + long_len + 5000, 4, 0, 0]]
    # only the runs are staged: their largest holds 3 entries and 1 row
    assert tx_routed.stage_slots(items) == (8, 4)


@pytest.mark.parametrize("word", [0, 1, 2, 3])
def test_stage_copies_cover_the_item_at_every_offset(word):
    """The bulk copy's aligned middle plus the head and the tail are
    exactly [e0, e1), in order and disjoint, for an array whose entry 0
    sits at 4-byte slot `word` of its 16-byte word: the middle starts
    on a 16-byte boundary, in a slot that is a multiple of 4, and is a
    whole number of 16-byte words; head and tail are under four entries
    each; every slot is under stage_slots' room for the item."""
    for e0 in range(0, 12):
        for e1 in range(e0, e0 + 40):
            cut = tx_routed.stage_copies(e0, e1, word)
            (h0, h1), (m0, m1), (t0, t1) = (cut["head"], cut["middle"],
                                            cut["tail"])
            lo = cut["lo"][0]
            assert h0 == e0 and h1 == m0 and m1 == t0 and t1 == e1
            assert h1 - h0 < 4 and t1 - t0 < 4
            assert (m1 - m0) % 4 == 0
            if m1 > m0:
                assert (word + m0) % 4 == 0
                assert (m0 - e0 + lo) % 4 == 0
            assert (word + e0) % 4 == lo
            room, _ = tx_routed.stage_slots(np.array([[e0, 0, 0, 0],
                                                      [e1, 1, 0, 0]]))
            assert e1 - e0 - 1 + lo < room or e1 == e0


def test_item_starts_fall_at_every_offset():
    """The tables the walk and the card tests use start items at every
    entry offset mod 4, so each of the stage's heads is exercised."""
    a, mat = item_matrix("300x500:16")
    starts = mat.stage_items[:-1, 0].numpy() % 4
    assert set(starts.tolist()) == {0, 1, 2, 3}


def emulate_stage_walk(mat, x):
    """B2's walk over csr_stage_items in f64, in the kernel's order of
    items and tickets: a run's rows each by one thread, from zero over
    its products in entry order (an empty row 0); a long row or a piece
    by the block's threads (thread t its products t, t + 256, ...), then
    block_sum; a cut row's piece sums added in item order by the block
    that draws its last ticket. Returns the row sums."""
    indptr = mat.indptr.numpy().astype(np.int64)
    prod = (mat.vals.numpy().astype(np.float64)
            * np.asarray(x, np.float64)[mat.indices.numpy()])
    items = mat.stage_items.numpy().astype(np.int64)
    y = np.full(mat.num_rows, np.nan)
    scratch = np.full(mat.nstage, np.nan)
    tickets = np.zeros(max(mat.nstage, 1), dtype=np.int64)
    for it in range(mat.nstage):
        e0, r0, index, pieces = items[it]
        e1, r1 = items[it + 1, :2]
        if pieces == 0:
            for r in range(r0, r1):
                total = 0.0
                for k in range(indptr[r], indptr[r + 1]):
                    total += prod[k]
                assert np.isnan(y[r]), "a row finished twice"
                y[r] = total
            continue
        total = block_tree(strided(prod, e0, e1, THREADS))
        if pieces > 1:
            scratch[it] = total
            first = it - index
            tickets[first] += 1
            if tickets[first] < pieces:
                continue
            tickets[first] = 0
            total = block_tree(strided(scratch, first, first + pieces,
                                       THREADS))
        assert np.isnan(y[r0]), "a row finished twice"
        y[r0] = total
    assert not np.isnan(y).any(), "a row never finished"
    assert not tickets.any()
    return y


def assert_stage_walk(a, entries, want_ax, want_aty, x, y):
    """The staged walk's A x and A' y against `want_*` (the f32 rounding
    class) and against scipy on the f32 matrix (1e-12)."""
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    at = sp.csr_matrix(a.T)
    a32 = abs(a.astype(np.float32).astype(np.float64))
    f32 = a.astype(np.float32).astype(np.float64)
    for mat, vec, want, exact in (
            (csr_matrix_of(a, "A", entries), x, want_ax, f32),
            (csr_matrix_of(at, "AT", entries), y, want_aty, f32.T)):
        got = emulate_stage_walk(mat, vec)
        scale = (a32 if exact is f32 else a32.T) @ np.abs(vec)
        assert_entrywise(got, want, scale)
        ref = exact @ vec.astype(np.float64)
        assert np.all(np.abs(got - ref) <= 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("entries", [None, 16])
@pytest.mark.parametrize("name", sorted(WALK_MATRICES))
def test_stage_walk_matches_routed_interpret(name, entries):
    """B2's walk over its items gives the JAX package's RoutedOp mv and
    rmv in interpret mode and scipy's products, at the default item
    size and at 16, which cuts every long row into pieces."""
    a = sp.csr_matrix(WALK_MATRICES[name]())
    a.sum_duplicates()
    m, n = a.shape
    rng = np.random.default_rng(m * 5 + n)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    ref = jx_build_routed(a, group_rows=4)
    assert_stage_walk(a, entries, np.asarray(ref.mv(jnp.asarray(x))),
                      np.asarray(ref.rmv(jnp.asarray(y))), x, y)


def block_lanes_matrix():
    """The interleaved block-diagonal matrix of four PageRank LPs of mixed
    sizes, each padded to the largest (so 30-60% of the rows of the
    smaller lanes are empty), and an empty lane."""
    mats = [generate_pagerank_lp(k, seed=k).constraint_matrix
            for k in (300, 700, 150, 450)]
    m = max(a.shape[0] for a in mats)
    n = max(a.shape[1] for a in mats)
    padded = [sp.csr_matrix((a.tocoo().data, (a.tocoo().row,
                                              a.tocoo().col)), shape=(m, n))
              for a in mats]
    return block_lanes.block_matrix(padded + [sp.csr_matrix((m, n))])


@pytest.mark.parametrize("entries", [None, 64, 256])
def test_stage_walk_on_a_block_lanes_matrix(entries):
    """The heterogeneous fleet's interleaved block matrix, with its empty
    padded rows and every lane's dense row (a long row, cut into pieces
    at items of 64 and 256 units), against the JAX package's RoutedOp in
    interpret mode and scipy; an empty row is written 0 without a
    gather."""
    a = block_lanes_matrix()
    lens = np.diff(a.indptr)
    assert np.mean(lens == 0) > 0.3
    m, n = a.shape
    rng = np.random.default_rng(17)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    ref = jx_build_routed(a, group_rows=4)
    assert_stage_walk(a, entries, np.asarray(ref.mv(jnp.asarray(x))),
                      np.asarray(ref.rmv(jnp.asarray(y))), x, y)
    mat = csr_matrix_of(a, "A", entries)
    stats = tx_routed.stage_item_stats(mat)
    # the dense rows of the lanes of 300, 700 and 450 nodes
    assert stats["long_rows"] == np.sum(lens > tx_routed.STAGE_LONG_ROW) == 3
    assert stats["split_rows"] == (3 if entries else 0)
    assert stats["empty_rows"] == int(np.sum(lens == 0))
    assert stats["blocks"] == mat.nstage
    runs = mat.stage_items[:-1, 3].numpy() == 0
    sizes = np.diff(mat.stage_items[:, 0].numpy())
    rows = np.diff(mat.stage_items[:, 1].numpy())
    assert stats["bytes_staged"] == np.sum(8 * sizes[runs]
                                           + 4 * (rows[runs] + 1))
    assert stats["smem_bytes"] == 4 * (2 * mat.stage_entries
                                       + mat.stage_rows)
