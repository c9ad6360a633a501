"""The port's tile-plan operator (tile_aligned=True) on the CPU.

- Its plain versions (mv, rmv, mv_dual_step, rmv_stats on the plan's
  tensors) against the JAX package's tile-aligned RoutedOp in Pallas
  interpret mode, which is what the reference runs off the TPU.
  Tolerance, the f32 rounding class (the two sum in different orders):
  |d| <= 1e-5 (|A||x|)_i + 1e-7 per entry, rtol 1e-5 on the sums of
  squares. The interaction sum, sum(dx (aty+ - aty_old)), cancels, so
  it is held to 1e-5 of the sum of its terms' magnitudes (tighter than
  the rtol 2e-3 tests/test_routed.py allows it).
- Both layouts of the port agree to the same tolerance, and unpacking
  the plan gives back the matrix exactly.
- The plan's structure: one tile per group, row-major order inside a
  tile, zero padding, the group table's flags, one all-padding group
  for a strip without entries.
- The work items of the kernels: every group in exactly one item, a
  strip's items contiguous and in plan order, no item above 2.25 times
  the mean plus two groups, an item for every empty strip; the kernels' walk
  over the items (warps' shares, padding rule, runs keyed by window and
  row, partial strips added in item order) emulated in numpy.
- share_plan_with reuses the index tensors for both layouts; the
  layout switch is read when the operator is built; the device rule of
  build_linop, to_device and to_device_scaled.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_tpu.ops.routed import build_routed_op as jx_build_routed

import firstorderlp_torch as tx
from firstorderlp_torch.ops import device_problem as tx_dev
from firstorderlp_torch.ops import linops as tx_linops
from firstorderlp_torch.ops import routed as tx_routed

from test_torch_ops import MATRICES as BASE_MATRICES
from test_torch_ops import assert_entrywise, port_problem, random_matrix, t
from test_torch_cuda import hub_matrix
import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def ragged_empty_matrix():
    """203 x 157: at strips of 32 the last row strip holds 11 rows and
    the last window 29 columns; rows 64..127 and columns 64..95 are
    empty, so two output strips of A and one of A' have no entries."""
    rng = np.random.default_rng(21)
    a = random_matrix(rng, 203, 157, 1500).tolil()
    a[64:128, :] = 0.0
    a[:, 64:96] = 0.0
    a = sp.csr_matrix(a)
    a.eliminate_zeros()
    return a


def one_dense_row():
    a = sp.lil_matrix((90, 333))
    a[41, :] = np.random.default_rng(1).normal(size=333)
    return sp.csr_matrix(a)


def one_dense_column():
    return sp.csr_matrix(one_dense_row().T)


def single_entry():
    return sp.csr_matrix(([2.5], ([37], [101])), shape=(70, 130))


def hub_2000():
    """2,000 x 2,000 with a hub row and a hub column of 4,000 draws."""
    return hub_matrix(2000, 2000, 4000, 0)


MATRICES = dict(
    BASE_MATRICES,
    hub_2000=hub_2000,
    ragged_empty=ragged_empty_matrix,
    dense_row=one_dense_row,
    dense_column=one_dense_column,
    single_entry=single_entry,
)

# (out_strip, in_window, group) of the port's plan. "card": the sizes
# picked for the card. The small ones cut these matrices into many
# strips and windows, with ragged last strips.
GEOMETRIES = {
    "card": {},
    "s32": dict(out_strip=32, in_window=32, group=8),
    "odd": dict(out_strip=7, in_window=50, group=3),
}


def vectors(a, seed):
    m, n = a.shape
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.normal(size=n).astype(f32), y=rng.normal(size=m).astype(f32),
        z=rng.normal(size=n).astype(f32), b=rng.normal(size=m).astype(f32),
        eq=(rng.random(m) < 0.4).astype(f32),
        dx=rng.normal(size=n).astype(f32),
        aty_old=rng.normal(size=n).astype(f32),
        sigma=f32(0.37),
    )


def run_port(op, v):
    """(A x, A' y, y+, dy2, aty+, interaction, dx2) of a port operator."""
    ax = op.mv(t(v["x"]))
    aty = op.rmv(t(v["y"]))
    yn, yn_layout, dy2 = op.mv_dual_step(
        t(v["z"]), t(v["y"]), t(v["b"]), t(v["eq"]),
        torch.tensor(v["sigma"]),
    )
    assert yn_layout is yn
    aty_next, inter, dx2 = op.rmv_stats(yn, t(v["dx"]), t(v["aty_old"]))
    return (ax.numpy(), aty.numpy(), yn.numpy(), float(dy2),
            aty_next.numpy(), float(inter), float(dx2))


def assert_same_products(got, want, a, v):
    a32 = abs(a.astype(np.float32).astype(np.float64))
    assert_entrywise(got[0], want[0], a32 @ np.abs(v["x"]))
    assert_entrywise(got[1], want[1], a32.T @ np.abs(v["y"]))
    scale = np.abs(v["y"]) + v["sigma"] * (
        np.abs(v["b"]) + a32 @ np.abs(v["z"])
    )
    assert_entrywise(got[2], want[2], scale)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    assert_entrywise(got[4], want[4], a32.T @ np.abs(got[2]))
    inter_scale = np.sum(np.abs(v["dx"]) * (
        a32.T @ np.abs(got[2]) + np.abs(v["aty_old"])
    ))
    assert abs(got[5] - want[5]) <= 1e-5 * inter_scale + 1e-7
    np.testing.assert_allclose(got[6], want[6], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_tile_op_matches_routed_interpret(name):
    a = sp.csr_matrix(MATRICES[name]())
    m, n = a.shape
    v = vectors(a, m * 7 + n)
    ref = jx_build_routed(a, group_rows=4, tile_aligned=True)
    assert ref.tile_aligned
    ryn, ryns, rdy2 = ref.mv_dual_step(
        jnp.asarray(v["z"]),
        ref.pad_dual_strips(jnp.asarray(v["y"])),
        ref.pad_dual_strips(jnp.asarray(v["b"])),
        ref.pad_dual_strips(jnp.asarray(v["eq"])),
        float(v["sigma"]),
    )
    raty, rinter, rdx2 = ref.rmv_stats(
        ryns,
        ref.pad_primal_strips(jnp.asarray(v["dx"])),
        ref.pad_primal_strips(jnp.asarray(v["aty_old"])),
    )
    want = (np.asarray(ref.mv(jnp.asarray(v["x"]))),
            np.asarray(ref.rmv(jnp.asarray(v["y"]))),
            np.asarray(ryn), float(rdy2), np.asarray(raty), float(rinter),
            float(rdx2))
    op = tx_routed.build_routed_op(a, CPU, tile_aligned=True,
                                   **GEOMETRIES["s32"])
    assert op.tile_aligned and isinstance(op.a, tx_routed.TilePlan)
    assert_same_products(run_port(op, v), want, a, v)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_both_layouts_agree(name, geometry):
    a = sp.csr_matrix(MATRICES[name]())
    v = vectors(a, 11)
    tiled = tx_routed.build_routed_op(a, CPU, tile_aligned=True,
                                      **GEOMETRIES[geometry])
    csr = tx_routed.build_routed_op(a, CPU, tile_aligned=False)
    assert isinstance(csr.a, tx_routed.CsrKernelMatrix)
    assert tiled.shape == csr.shape == a.shape
    assert_same_products(run_port(tiled, v), run_port(csr, v), a, v)


def unpack(plan):
    rows, cols = tx_routed.tile_plan_coordinates(plan)
    return sp.csr_matrix(
        (plan.vals.numpy(), (rows.numpy(), cols.numpy())),
        shape=(plan.num_rows, plan.num_cols),
    )


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_round_trip_and_structure(name, geometry):
    a = sp.csr_matrix(MATRICES[name]())
    a.sum_duplicates()
    op = tx_routed.build_routed_op(a, CPU, tile_aligned=True,
                                   **GEOMETRIES[geometry])
    a32 = a.astype(np.float32)
    for plan, mat in ((op.a, a32), (op.at, sp.csr_matrix(a32.T))):
        assert abs(unpack(plan) - mat).max() == 0.0
        assert plan.nnz == a.nnz
        assert 0.0 <= plan.padding_share < 1.0
        assert plan.out_strip <= 16384 and plan.in_window <= 16384

        g = plan.group
        loc = plan.loc.numpy().astype(np.int64)
        vals = plan.vals.numpy()
        meta = plan.meta.numpy()
        tile_ptr = plan.tile_ptr.numpy()
        strip_tile_ptr = plan.strip_tile_ptr.numpy()
        ngroups = meta.shape[0]
        assert loc.shape == vals.shape == (ngroups * g,)
        nstrips = -(-plan.num_rows // plan.out_strip)
        assert plan.nstrips == nstrips

        # the group table: strips in order, every strip present, flags
        # at the strip's first and last group
        out = meta[:, 0]
        assert np.all(np.diff(out) >= 0)
        assert set(out) == set(range(nstrips))
        first = np.r_[True, out[1:] != out[:-1]]
        last = np.r_[out[1:] != out[:-1], True]
        np.testing.assert_array_equal(meta[:, 1], first)
        np.testing.assert_array_equal(meta[:, 2], last)
        assert meta[:, 3].max() < -(-plan.num_cols // plan.in_window)

        # tiles: contiguous runs of groups, one (out, in) strip pair
        # each, in (out, in) order; strip_tile_ptr cuts them by strip
        assert tile_ptr[0] == 0 and tile_ptr[-1] == ngroups
        assert np.all(np.diff(tile_ptr) > 0)
        assert strip_tile_ptr[0] == 0
        assert strip_tile_ptr[-1] == len(tile_ptr) - 1
        pairs = []
        for k in range(len(tile_ptr) - 1):
            rows_of = meta[tile_ptr[k]:tile_ptr[k + 1]]
            assert len(set(map(tuple, rows_of[:, [0, 3]]))) == 1
            pairs.append((rows_of[0, 0], rows_of[0, 3]))
            lo, hi = tile_ptr[k] * g, tile_ptr[k + 1] * g
            # real entries first, in row-major order; then padding with
            # packed index 0 and value 0
            pad = (loc[lo:hi] == 0) & (np.arange(lo, hi) > lo)
            if pad.any():
                start = int(np.argmax(pad))
                assert pad[start:].all()
                assert not vals[lo + start:hi].any()
                assert hi - lo - start < g or start <= 1
            key = loc[lo:hi][~pad]  # (row << 16 | col) sorts row-major
            assert np.all(np.diff(key) > 0)
        assert pairs == sorted(set(pairs))
        for s in range(nstrips):
            tiles = range(strip_tile_ptr[s], strip_tile_ptr[s + 1])
            assert len(tiles) >= 1
            assert all(pairs[k][0] == s for k in tiles)


def plans_of(name, geometry):
    a = sp.csr_matrix(MATRICES[name]())
    a.sum_duplicates()
    op = tx_routed.build_routed_op(a, CPU, tile_aligned=True,
                                   **GEOMETRIES[geometry])
    return a, ((op.a, a), (op.at, sp.csr_matrix(a.T)))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_work_items_cover_the_plan(name, geometry):
    """Every group lies in exactly one item; an item stays inside one
    strip; a strip's items are contiguous, in plan order and numbered
    0..k-1; split strips get scratch slots of their own; the largest
    item is at most 2.25 times the mean plus two groups."""
    _, plans = plans_of(name, geometry)
    for plan, csr in plans:
        items = plan.items.numpy().astype(np.int64)
        meta = plan.meta.numpy()
        assert items.shape == (plan.nitems + 1, 4)
        first = items[:, 0]
        assert first[0] == 0 and first[-1] == plan.ngroups
        sizes = np.diff(first)
        assert np.all(sizes > 0)  # a partition of range(ngroups)
        assert sizes.max() <= 2.25 * sizes.mean() + 2
        strip_of_item = meta[first[:-1], 0]
        for i in range(plan.nitems):
            assert np.all(meta[first[i]:first[i + 1], 0] == strip_of_item[i])
        assert np.all(np.diff(strip_of_item) >= 0)
        assert set(strip_of_item) == set(range(plan.nstrips))
        used_slots = []
        for s in range(plan.nstrips):
            mine = np.flatnonzero(strip_of_item == s)
            k = len(mine)
            assert np.all(np.diff(mine) == 1)
            np.testing.assert_array_equal(items[mine, 1], np.arange(k))
            np.testing.assert_array_equal(items[mine, 2], k)
            assert len(set(items[mine, 3])) == 1
            # the strip's first and last group open and close its items
            assert meta[first[mine[0]], 1] == 1
            assert meta[first[mine[-1] + 1] - 1, 2] == 1
            if k > 1:
                used_slots.extend(items[mine[0], 3] + np.arange(k))
        assert used_slots == list(range(len(used_slots)))
        assert plan.scratch.shape == (max(len(used_slots), 1),
                                      plan.out_strip)
        assert plan.scratch.dtype == torch.float32
        assert plan.tickets.shape == (plan.nstrips + 1,)
        assert plan.tickets.dtype == torch.int32
        assert not plan.tickets.any()
        assert plan.warps == tx_routed.pick_block_warps(plan.out_strip)
        stats = tx_routed.tile_plan_stats(plan)
        assert stats["blocks"] == plan.nitems
        assert stats["entries_per_block_max"] == sizes.max() * plan.group
        assert stats["max_over_mean"] == pytest.approx(
            sizes.max() / sizes.mean())
        assert stats["tiles_staged"] == 0 and stats["bytes_staged"] == 0
        assert stats["tiles_gathered"] == len(plan.tile_ptr) - 1
        assert stats["plan_bytes"] == (
            8 * plan.loc.numel() + 4 * plan.meta.numel()
            + 4 * plan.items.numel())
        # the bound's bytes are the matrix's in CSR, not the plan's
        assert tx_routed.csr_kernel_bytes(plan) == (
            4 * (csr.shape[0] + 1) + 8 * csr.nnz)


def emulate_kernel_walk(plan, x):
    """tiled_item_kernel (csrc/tiled_spmv.cuh) step by step in f64: one
    block per item, the warps' contiguous shares of 32-entry steps, the
    padding rule, runs keyed by (window, row), warp copies added in warp
    order, a split strip's partial strips added in item order."""
    loc = plan.loc.numpy().astype(np.int64) & 0xFFFFFFFF
    vals = plan.vals.numpy().astype(np.float64)
    meta = plan.meta.numpy().astype(np.int64)
    items = plan.items.numpy().astype(np.int64)
    warps, group, strip_len = plan.warps, plan.group, plan.out_strip
    y = np.full(plan.nstrips * strip_len, np.nan)
    scratch = {}
    tickets = np.zeros(plan.nstrips, dtype=np.int64)
    for it in range(plan.nitems):
        g_begin, index, nsplit, first_slot = items[it]
        g_end = items[it + 1, 0]
        strip = meta[g_begin, 0]
        acc = np.zeros((warps, strip_len))
        e0, e1 = g_begin * group, g_end * group
        share = -(-(-(-(e1 - e0) // 32)) // warps)
        for w in range(warps):
            w_begin = min(e0 + 32 * share * w, e1)
            w_end = min(w_begin + 32 * share, e1)
            for base in range(w_begin, w_end, 32):
                e = np.arange(base, min(base + 32, w_end))
                g = e // group
                real = (loc[e] != 0) | (e == g * group)
                win, row, col = meta[g, 3], loc[e] >> 16, loc[e] & 0xFFFF
                keys = list(zip(win[real], row[real]))
                # equal keys are neighbours: the segmented scan's premise
                runs = [k for i, k in enumerate(keys)
                        if i == 0 or keys[i - 1] != k]
                assert len(runs) == len(set(runs))
                source = win[real] * plan.in_window + col[real]
                assert np.all(source < plan.num_cols)
                assert np.all(row[real] < strip_len)
                np.add.at(acc[w], row[real], vals[e][real] * x[source])
        total = acc.sum(axis=0)
        if nsplit > 1:
            scratch[first_slot + index] = total
            tickets[strip] += 1
            if tickets[strip] < nsplit:
                continue
            total = sum(scratch[first_slot + k] for k in range(nsplit))
        assert np.isnan(y[strip * strip_len]), "a strip finished twice"
        y[strip * strip_len:(strip + 1) * strip_len] = total
    assert not np.isnan(y).any(), "a strip never finished"
    return y[:plan.num_rows]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernel_walk_over_the_items_gives_the_product(name, geometry):
    """In f64 the walk is exact up to rounding of sums: rtol 1e-12
    against scipy on the f32 values."""
    _, plans = plans_of(name, geometry)
    for plan, mat in plans:
        x = np.random.default_rng(5).normal(size=mat.shape[1])
        mat32 = mat.astype(np.float32).astype(np.float64)
        want = mat32 @ x
        scale = abs(mat32) @ np.abs(x)
        got = emulate_kernel_walk(plan, x)
        assert np.all(np.abs(got - want) <= 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("name", ["dense_row", "dense_column", "hub_2000"])
def test_a_dense_row_is_cut_into_many_items(name):
    """The strip of a dense row is split over blocks, and no block holds
    more than 2.25 times the mean plus two groups."""
    _, plans = plans_of(name, "s32")
    split_somewhere = False
    for plan, _ in plans:
        items = plan.items.numpy()
        sizes = np.diff(items[:, 0])
        assert sizes.max() <= 2.25 * sizes.mean() + 2
        per_strip = np.bincount(plan.meta.numpy()[items[:-1, 0], 0])
        split_somewhere |= per_strip.max() >= 4
    assert split_somewhere


def test_work_items_of_given_strip_sizes():
    items = tx_routed.work_items(np.array([1, 1, 1, 1000, 1, 2]))
    sizes = np.diff(items[:, 0])
    cap = int(np.ceil(1.25 * 1006 / tx_routed.NUM_SMS))
    assert sizes.max() <= cap and sizes.sum() == 1006
    k = -(-1000 // cap)
    np.testing.assert_array_equal(items[3:3 + k, 1], np.arange(k))
    np.testing.assert_array_equal(items[3:3 + k, 2], k)
    np.testing.assert_array_equal(items[:3, 2], 1)
    assert items[-1].tolist() == [1006, 0, 0, 0]
    # more strips than SMs, all equal: one item each
    items = tx_routed.work_items(np.full(500, 3))
    np.testing.assert_array_equal(items[:-1, 0], 3 * np.arange(500))
    assert not items[:-1, 1:].any() or np.all(items[:-1, 2] == 1)


@pytest.mark.parametrize("out_strip,want", [
    (32, 16), (512, 16), (1024, 16), (2048, 8), (4096, 4), (16384, 1),
    (7, 16),
])
def test_block_warps_fit_the_shared_budget(out_strip, want):
    warps = tx_routed.pick_block_warps(out_strip)
    assert warps == want
    assert warps == 1 or 4 * warps * out_strip <= tx_routed.SHARED_BUDGET


def test_too_many_windows_raise():
    a = sp.csr_matrix(([1.0], ([0], [0])),
                      shape=(4, 32 * tx_routed.MAX_WINDOWS + 1))
    with pytest.raises(ValueError, match="windows"):
        tx_routed.build_routed_op(a, CPU, tile_aligned=True, in_window=32)


def test_pagerank_like_matrix_has_the_pagerank_structure():
    from firstorderlp_torch.generators import pagerank_like_matrix

    n = 500
    a = pagerank_like_matrix(n, seed=3)
    assert a.shape == (n + 1, n)
    np.testing.assert_allclose(a[0].toarray().ravel(), np.sqrt(n))
    lower = a[1:]
    assert np.all(lower.diagonal() > 0)
    per_row = np.diff(lower.indptr)
    assert 2 <= per_row.min() and per_row.max() <= 8
    # columns of S sum to 1 where the column is hit at all
    s = (sp.identity(n) - lower) / 0.99
    sums = np.asarray(s.sum(axis=0)).ravel()
    assert np.all((np.abs(sums - 1.0) < 1e-12) | (np.abs(sums) < 1e-12))
    b = pagerank_like_matrix(n, seed=3)
    assert (a != b).nnz == 0


def test_empty_strip_gets_one_padding_group_and_its_epilogue():
    a = ragged_empty_matrix()
    op = tx_routed.build_routed_op(a, CPU, tile_aligned=True,
                                   **GEOMETRIES["s32"])
    meta = op.a.meta.numpy()
    for strip in (2, 3):  # rows 64..127
        groups = np.flatnonzero(meta[:, 0] == strip)
        assert len(groups) == 1
        lo = groups[0] * op.a.group
        assert not op.a.loc[lo:lo + op.a.group].any()
        assert not op.a.vals[lo:lo + op.a.group].any()
    assert len(np.flatnonzero(op.at.meta.numpy()[:, 0] == 2)) == 1
    # and an item of its own, so a block runs its epilogue
    items = op.a.items.numpy()
    for strip in (2, 3):
        group = int(np.flatnonzero(meta[:, 0] == strip)[0])
        at = np.flatnonzero(items[:-1, 0] == group)
        assert len(at) == 1 and items[at[0] + 1, 0] == group + 1
        assert items[at[0], 2] == 1
    # the dual step on an empty strip is proj(y + sigma b), not zero
    v = vectors(a, 5)
    yn = run_port(op, v)[2]
    cand = v["y"] + v["sigma"] * v["b"]
    want = np.where(v["eq"] != 0, cand, np.maximum(cand, 0.0))
    np.testing.assert_allclose(yn[64:128], want[64:128], rtol=1e-6)


def test_card_geometry():
    """At the 100k-node size there are at least as many output strips as
    the card has SMs, and a window and a strip fit the 16-bit packing."""
    assert tx_routed.pick_out_strip(100_001) == 512
    assert -(-100_001 // 512) >= tx_routed.NUM_SMS
    assert tx_routed.pick_out_strip(20_001) == 128
    assert tx_routed.pick_out_strip(10) == tx_routed.MIN_STRIP
    assert tx_routed.pick_out_strip(10**8) == tx_routed.MAX_PICKED_STRIP
    assert tx_routed.pick_out_strip(1_000_001) == 1024
    assert tx_routed.pick_group((100_001, 100_000), 799_982, 512,
                                16384) == tx_routed.TILE_GROUP
    assert tx_routed.pick_group((1_000_001, 1_000_000), 8_999_968, 1024,
                                16384) == tx_routed.MIN_GROUP
    assert tx_routed.pick_group((70, 130), 1, 32, 32) == tx_routed.MIN_GROUP
    assert tx_routed.pick_in_window(100_000) == tx_routed.MAX_STRIP
    assert tx_routed.pick_in_window(300) == 512
    assert tx_routed.pick_in_window(3) == tx_routed.MIN_STRIP
    with pytest.raises(ValueError, match="16-bit"):
        tx_routed.build_routed_op(single_entry(), CPU, tile_aligned=True,
                                  in_window=32768)


@pytest.mark.parametrize("tile_aligned", [False, True])
def test_share_plan_with(tile_aligned):
    """A rescaled copy (same pattern, other values) reuses the donor's
    index tensors; another pattern raises."""
    rng = np.random.default_rng(3)
    a = random_matrix(rng, 200, 300, 3000)
    op = tx_routed.build_routed_op(a, CPU, tile_aligned=tile_aligned)
    d = sp.diags(rng.uniform(0.5, 2.0, 200))
    e = sp.diags(rng.uniform(0.5, 2.0, 300))
    b = sp.csr_matrix(d @ a @ e)
    op2 = tx_routed.build_routed_op(b, share_plan_with=op)
    assert op2.tile_aligned == tile_aligned
    assert op2.pattern_hash == op.pattern_hash
    index_fields = (
        ("loc", "meta", "tile_ptr", "strip_tile_ptr", "items", "scratch",
         "tickets") if tile_aligned
        else ("indptr", "indices", "items", "scratch", "tickets")
    )
    for half in ("a", "at"):
        for field in index_fields:
            assert (getattr(getattr(op2, half), field).data_ptr()
                    == getattr(getattr(op, half), field).data_ptr())
        assert (getattr(op2, half).vals.data_ptr()
                != getattr(op, half).vals.data_ptr())
    x = rng.normal(size=300).astype(np.float32)
    y = rng.normal(size=200).astype(np.float32)
    b32 = abs(b.astype(np.float32).astype(np.float64))
    assert_entrywise(op2.mv(t(x)).numpy(), b.astype(np.float32) @ x,
                     b32 @ np.abs(x))
    assert_entrywise(op2.rmv(t(y)).numpy(), b.astype(np.float32).T @ y,
                     b32.T @ np.abs(y))

    c = random_matrix(rng, 200, 300, 2999)  # another pattern
    with pytest.raises(ValueError, match="pattern"):
        tx_routed.build_routed_op(c, share_plan_with=op)


@pytest.mark.parametrize("tile_aligned", [False, True])
def test_build_linop_shares_the_plan_of_a_same_pattern_operator(
        tile_aligned, monkeypatch):
    monkeypatch.setattr(tx_routed, "DEFAULT_TILE_ALIGNED", tile_aligned)
    rng = np.random.default_rng(8)
    a = random_matrix(rng, 60, 80, 500)
    donor = tx_linops.build_linop(a, torch.float32, "routed", CPU)
    assert donor.tile_aligned == tile_aligned
    same = tx_linops.build_linop(2.0 * a, torch.float32, "routed", CPU,
                                 share_plan_with=donor)
    index = "loc" if tile_aligned else "indices"
    assert (getattr(same.a, index).data_ptr()
            == getattr(donor.a, index).data_ptr())
    other = tx_linops.build_linop(
        random_matrix(rng, 60, 80, 400), torch.float32, "routed", CPU,
        share_plan_with=donor,
    )
    assert (getattr(other.a, index).data_ptr()
            != getattr(donor.a, index).data_ptr())


def test_layout_switch_is_read_when_the_operator_is_built(monkeypatch):
    a = random_matrix(np.random.default_rng(9), 40, 50, 300)
    assert not tx_routed.build_routed_op(a, CPU).tile_aligned
    monkeypatch.setattr(tx_routed, "DEFAULT_TILE_ALIGNED", True)
    assert tx_routed.build_routed_op(a, CPU).tile_aligned
    assert tx_linops.build_linop(a, torch.float32, "routed",
                                 CPU).tile_aligned
    assert not tx_routed.build_routed_op(
        a, CPU, tile_aligned=False
    ).tile_aligned


@pytest.mark.parametrize("value,want", [("1", True), ("0", False),
                                        (None, False)])
def test_layout_switch_comes_from_the_environment_at_import(value, want):
    env = {k: v for k, v in os.environ.items() if k != "FOLP_TILE_ALIGNED"}
    if value is not None:
        env["FOLP_TILE_ALIGNED"] = value
    out = subprocess.run(
        [sys.executable, "-c",
         "from firstorderlp_torch.ops import routed; "
         "print(routed.DEFAULT_TILE_ALIGNED)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)


def test_solve_reaches_the_tile_plan_through_build_linop(monkeypatch):
    """optimize -> prepare_problem -> to_device_scaled -> build_linop ->
    build_routed_op picks the tile plan up from the module attribute,
    and the fused step runs on its plain versions; the original copy
    shares the scaled copy's index tensors."""
    monkeypatch.setattr(tx_routed, "DEFAULT_TILE_ALIGNED", True)
    calls = {"dual": 0, "stats": 0}
    dual_plain = tx_routed.tiled_dual_step_plain
    stats_plain = tx_routed.tiled_rmv_stats_plain

    def dual(*args):
        calls["dual"] += 1
        return dual_plain(*args)

    def stats(*args):
        calls["stats"] += 1
        return stats_plain(*args)

    monkeypatch.setattr(tx_routed, "tiled_dual_step_plain", dual)
    monkeypatch.setattr(tx_routed, "tiled_rmv_stats_plain", stats)
    from test_torch_pdhg import port_params
    from utils import optimality_criteria, pdhg_params
    import dataclasses

    params = dataclasses.replace(
        port_params(pdhg_params(optimality_criteria(1e-4),
                                ruiz_iterations=10)),
        dtype="float32", matrix_format="routed",
    )
    problem = port_problem(fixtures.example_lp())
    prepared = tx.prepare_problem(params, problem, device="cpu")
    scaled_op = prepared.bundle.scaled.constraint_matrix
    original_op = prepared.bundle.original.constraint_matrix
    assert scaled_op.tile_aligned and original_op.tile_aligned
    assert original_op.a.loc.data_ptr() == scaled_op.a.loc.data_ptr()
    out = tx.optimize(params, problem, device="cpu")
    assert out.termination_reason == (
        tx.TerminationReason.TERMINATION_REASON_OPTIMAL
    )
    assert calls["dual"] > 0 and calls["dual"] == calls["stats"]


def test_device_rule_of_build_linop_and_to_device():
    """device=None means CUDA and raises without a GPU; the CPU only
    when asked."""
    a = random_matrix(np.random.default_rng(2), 30, 40, 200)
    problem = port_problem(fixtures.example_lp())
    scaled = tx.rescale_problem(3, False, 1.0, 0, problem)
    constructors = (
        lambda **kw: tx_linops.build_linop(a, torch.float64, "sparse", **kw),
        lambda **kw: tx_linops.build_linop(a, torch.float64, "dense", **kw),
        lambda **kw: tx_linops.build_linop(a, torch.float32, "routed", **kw),
        lambda **kw: tx_routed.build_routed_op(a, **kw),
        lambda **kw: tx_dev.to_device(problem, torch.float64, "auto", **kw),
        lambda **kw: tx_dev.to_device_scaled(scaled, torch.float64, "auto",
                                             **kw),
    )
    for build in constructors:
        if torch.cuda.is_available():
            build()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        build(device="cpu")
    bundle = tx_dev.to_device_scaled(scaled, torch.float64, "auto",
                                     device="cpu")
    for qp in (bundle.scaled, bundle.original):
        assert qp.objective_vector.device.type == "cpu"
        assert qp.is_equality.device.type == "cpu"
    assert bundle.qp_cache.l2_norm_primal_right_hand_side.device.type == "cpu"
    # "auto" picks the kernel operator only for a CUDA device
    big = random_matrix(np.random.default_rng(6), 3000, 3000, 60_000)
    assert isinstance(
        tx_linops.build_linop(big, torch.float32, "auto", "cpu"),
        tx_linops.CsrOp,
    )
