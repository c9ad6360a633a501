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
