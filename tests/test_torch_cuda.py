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
back at zero, are one kernel a call by torch.profiler, return sums that
outlive the next launch, and reject bad inputs. The
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
plain version in f32 and f64 at 1 to 300 lanes, with the dense rows cut
into pieces and walked whole, repeats its bits with the tickets back at
zero, rejects bad inputs, and carries a small fleet to OPTIMAL.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_torch.generators import generate_pagerank_lp
from firstorderlp_torch.ops import routed
from firstorderlp_torch.ops.compare_kernels import repeat_differs

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
        problem = repeat_differs(call, (op.a.tickets, op.at.tickets), 20)
        assert problem is None, (key, problem)


def test_csr_kernels_are_one_launch_a_call(cuda):
    """torch.profiler sees one kernel, the port's own, per call of each
    CSR wrapper: no long-row pass and no torch.sum."""
    from torch.profiler import ProfilerActivity, profile

    a, op = csr_op(cuda, "pagerank2000", True)
    assert op.a.items[:-1, 3].max() > 1  # the dense row is cut
    for key, call in csr_calls(op, cuda, *a.shape).items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in kernels) == 5, (key, kernels)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes_count", [1, 3, 128, 300])
@pytest.mark.parametrize("item_entries", [16, 64, 256])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lanes_spmv_matches_plain(cuda, name, item_entries, lanes_count,
                                  dtype):
    """Against the plain version in f64, both orientations: within
    1e-5 (|A||x|) + 1e-7 in f32, 1e-12 (|A||x|) + 1e-14 in f64."""
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


@pytest.mark.parametrize("lanes_count", [3, 128])
@pytest.mark.parametrize("item_entries", [16, 256])
def test_lanes_spmv_repeats_bitwise(cuda, item_entries, lanes_count):
    lanes, pattern, op, x, y = lane_case(cuda, "hub", lanes_count,
                                         torch.float32, item_entries)
    for half, vals, v in ((pattern.fwd, op.vals, x),
                          (pattern.bwd, op.vals_t, y)):
        problem = repeat_differs(lambda: lanes.lanes_spmv(half, vals, v),
                                 (half.tickets,))
        assert problem is None, problem


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
    assert lanes.LAUNCHES == {"lanes_spmv:A": 1, "lanes_spmv:AT": 2}


def test_fleet_solves_on_the_card(cuda):
    """A 4-lane FleetSpec fleet in f32 on the card ends OPTIMAL at 1e-4
    in every lane through the lane kernel, with the reasons of the same
    fleet on the CPU."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.generators import pagerank_fleet_spec
    from firstorderlp_torch.ops import lanes

    import firstorderlp_torch as tx

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
        dtype="float32",
    )
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
