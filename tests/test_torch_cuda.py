"""The CUDA kernels of firstorderlp_torch on the card.

Marked `cuda`: each test skips where no CUDA device is present (the
decision is made in the fixture, when the test runs). On a machine with
a card, from the root of the repository:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use.) Each kernel is held against its plain PyTorch version on the
card, on shapes with the structures that stress the layout: hub rows
and columns past the long-row threshold, empty rows and columns. The
tile-plan kernels are held against their plain versions and against the
CSR kernels, at the card's own strip sizes and at small ones that force
ragged and empty strips and runs of one row across many steps.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_torch.generators import generate_pagerank_lp
from firstorderlp_torch.ops import routed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def hub_matrix(m, n, hub_len, seed):
    """Random entries plus a dense-ish row 0 and column 0 of `hub_len`
    entries (past the long-row threshold), and empty rows/columns."""
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


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernels_match_plain(cuda, name, split):
    a = sp.csr_matrix(MATRICES[name]())
    m, n = a.shape
    op = routed.build_routed_op(a, cuda)
    if not split:
        op = routed.RoutedOp(a=routed._without_long_row_pass(op.a),
                             at=routed._without_long_row_pass(op.at))
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
    a = sp.csr_matrix(MATRICES[name]())
    m, n = a.shape
    op = routed.build_routed_op(a, cuda, tile_aligned=True,
                                **GEOMETRIES[geometry])
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
    routed.reset_launch_counts()
    routed.spmv_csr(op.a, torch.zeros(30, device=cuda))
    assert routed.LAUNCHES["spmv_csr:A"] == 1


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


@pytest.mark.parametrize("nnz", [1024, 8192, 819_200])
def test_probe_reduce_matches_plain_and_repeats(cuda, nnz):
    probe, d = probe_tensors(cuda, nnz)
    args = (d["meta"], d["g"], d["v"], d["hir"], d["lor"])
    probe.reset_launch_counts()
    got = probe.probe_reduce(*args, probe.N_STRIPS)
    again = probe.probe_reduce(*args, probe.N_STRIPS)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["probe_reduce"] == 2
    assert torch.equal(got, again)  # one fixed order of summation
    want = probe.probe_reduce_plain(
        d["meta"], d["g"].double(), d["v"].double(), d["hir"], d["lor"],
        probe.N_STRIPS,
    )
    err = (got.double() - want).abs().max() / (want.abs().max() + 1)
    assert float(err) <= 1e-5


@pytest.mark.parametrize("target_chunks", [1, 7, 10_000])
def test_probe_reduce_strip_without_groups_is_zero(cuda, target_chunks):
    """Strips 2 and 7 of 8 are named by no group; the chunking (one
    chunk a strip, ragged chunks, one group a chunk) changes the order
    of summation only inside the tolerance."""
    probe, d = probe_tensors(cuda, 40 * 1024, seed=3)
    strips = np.sort(np.random.default_rng(1).choice(
        [0, 1, 3, 4, 5, 6], size=40))
    meta = np.zeros((40, 2), np.int32)
    meta[:, 0] = strips
    meta[0, 1] = 1
    meta[1:, 1] = strips[1:] != strips[:-1]
    meta = torch.as_tensor(meta, device=cuda)
    plan = probe.plan_probe_reduce(meta, 8, target_chunks=target_chunks)
    got = probe.probe_reduce(meta, d["g"], d["v"], d["hir"], d["lor"], 8,
                             plan=plan)
    want = probe.probe_reduce_plain(
        meta, d["g"].double(), d["v"].double(), d["hir"], d["lor"], 8)
    assert torch.count_nonzero(got[2]) == 0
    assert torch.count_nonzero(got[7]) == 0
    err = (got.double() - want).abs().max() / (want.abs().max() + 1)
    assert float(err) <= 1e-5


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
