"""The shared-pattern lane operator (ops/lanes.py) on the CPU.

- The plain lane product against numpy per lane, and against the JAX
  package's fleet operator (its ELL SparseOp under jax.vmap with the
  minor batch axis, from its prepare_shared_pattern_fleet) in f64 at
  rtol 1e-12, for A and A', with the dense row walked whole and cut
  into pieces.
- The pattern's A' permutation and work items.
- lanes_kernel_bytes against the formula of the kernel's bound; the
  library yardstick's block-diagonal layout against the lane product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_tpu import batch as jx_batch
from firstorderlp_tpu.generators import generate_pagerank_lp_fleet

from firstorderlp_torch.ops import lanes

from utils import optimality_criteria, pdhg_params

CPU = torch.device("cpu")


def canonical(matrix):
    csr = sp.csr_matrix(matrix, dtype=np.float64)
    csr.sum_duplicates()
    csr.sort_indices()
    return csr


def random_pattern(m, n, seed, dense_row=True):
    """Random entries, a dense row 0 (a long row), an empty row and an
    empty column."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=0.15, random_state=seed, format="lil")
    if dense_row:
        a[0, :] = rng.uniform(0.5, 1.5, n)
    a[m // 2, :] = 0
    a[:, n // 2] = 0
    return canonical(a)


def per_lane(matrix, vals, x, transpose=False):
    """numpy's product of each lane's matrix."""
    out = []
    for b in range(vals.shape[1]):
        a = sp.csr_matrix((vals[:, b], matrix.indices, matrix.indptr),
                          shape=matrix.shape)
        out.append((a.T if transpose else a) @ x[:, b])
    return np.stack(out, axis=1)


# item sizes: the default, and small enough to cut row 0 into pieces
@pytest.mark.parametrize("item_entries", [4, 16, lanes.LANE_ITEM_ENTRIES])
@pytest.mark.parametrize("lanes_count", [1, 3])
def test_plain_product_matches_numpy(item_entries, lanes_count):
    a = random_pattern(40, 30, seed=1)
    pattern = lanes.build_lanes_pattern(a, CPU, item_entries=item_entries)
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((a.nnz, lanes_count))
    op = lanes.lanes_op(pattern, torch.as_tensor(vals))
    x = rng.standard_normal((30, lanes_count))
    y = rng.standard_normal((40, lanes_count))
    np.testing.assert_allclose(op.mv(torch.as_tensor(x)).numpy(),
                               per_lane(a, vals, x), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(op.rmv(torch.as_tensor(y)).numpy(),
                               per_lane(a, vals, y, transpose=True),
                               rtol=1e-12, atol=1e-12)


def test_pattern_permutation_and_items():
    a = random_pattern(40, 30, seed=3)
    pattern = lanes.build_lanes_pattern(a, CPU, item_entries=8)
    at = canonical(a.T)
    assert np.array_equal(pattern.bwd.indptr.numpy(), at.indptr)
    assert np.array_equal(pattern.bwd.indices.numpy(), at.indices)
    # A' entry k holds A's entry perm_t[k]
    np.testing.assert_array_equal(a.data[pattern.perm_t.numpy()], at.data)
    for half, csr in ((pattern.fwd, a), (pattern.bwd, at)):
        items = half.items.numpy()
        assert items[0, 0] == 0 and items[-1, 0] == csr.nnz
        assert np.all(np.diff(items[:, 0]) >= 0)
        assert half.nitems == len(items) - 1
        assert not half.tickets.any()
    # row 0 of A (30 entries) is cut into pieces of at most 8 entries
    row0 = pattern.fwd.items.numpy()[:-1]
    row0 = row0[(row0[:, 1] == 0) & (row0[:, 3] > 0)]
    assert row0[0, 3] == len(row0) == 4


def test_pattern_rejects_a_non_canonical_matrix():
    a = sp.csr_matrix((np.ones(2), np.array([1, 0]), np.array([0, 2])),
                      shape=(1, 2))
    with pytest.raises(ValueError, match="canonical"):
        lanes.build_lanes_pattern(a, CPU)


@pytest.mark.parametrize("item_entries", [16, lanes.LANE_ITEM_ENTRIES])
def test_plain_product_matches_the_jax_fleet_operator(item_entries):
    """The JAX package's fleet operator (ELL planes, vmapped with the
    minor batch axis) on the original (unscaled) copy of a PageRank
    fleet, f64, rtol 1e-12."""
    problems = generate_pagerank_lp_fleet(60, [0.8, 0.9, 0.97], seed=1)
    params = dataclasses.replace(
        pdhg_params(optimality_criteria(1e-6)), matrix_format="ell")
    fleet = jx_batch.prepare_shared_pattern_fleet(params, problems)
    bundle_axes, _ = fleet.axes_box.trees()
    jop = fleet.batched_bundle.original.constraint_matrix
    op_axes = bundle_axes.original.constraint_matrix

    a = canonical(problems[0].constraint_matrix)
    vals = np.stack([canonical(p.constraint_matrix).data for p in problems],
                    axis=1)
    pattern = lanes.build_lanes_pattern(a, CPU, item_entries=item_entries)
    op = lanes.lanes_op(pattern, torch.as_tensor(vals))
    rng = np.random.default_rng(0)
    m, n = a.shape
    x = rng.standard_normal((n, 3))
    y = rng.standard_normal((m, 3))

    def vmapped(method, v):
        return np.asarray(jax.vmap(
            lambda o, u: getattr(o, method)(u), in_axes=(op_axes, -1),
            out_axes=-1,
        )(jop, jnp.asarray(v)))

    np.testing.assert_allclose(op.mv(torch.as_tensor(x)).numpy(),
                               vmapped("mv", x), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(op.rmv(torch.as_tensor(y)).numpy(),
                               vmapped("rmv", y), rtol=1e-12, atol=1e-13)


def test_kernel_bytes_formula():
    a = random_pattern(40, 30, seed=4)
    pattern = lanes.build_lanes_pattern(a, CPU)
    nnz, m, n = a.nnz, 40, 30
    for b, s in ((128, 4), (3, 8)):
        assert lanes.lanes_kernel_bytes(pattern.fwd, b, s) == (
            nnz * b * s + nnz * 4 + (m + 1) * 4 + n * b * s + m * b * s)
        assert lanes.lanes_kernel_bytes(pattern.bwd, b, s) == (
            nnz * b * s + nnz * 4 + (n + 1) * 4 + m * b * s + n * b * s)


def test_kernel_bytes_at_the_fleet_width():
    """The slice's figure: the 128-lane fleet of the 20,000-node PageRank
    LP (m 20,001, n 20,000, nnz 159,982) moves about 103 MB a product in
    f32, 0.031 ms at 3.35 TB/s."""
    half = lanes.LanesHalf(
        indptr=torch.zeros(20_002, dtype=torch.int32),
        indices=torch.zeros(159_982, dtype=torch.int32),
        rows=torch.zeros(0, dtype=torch.int64),
        items=torch.zeros((1, 4), dtype=torch.int32),
        tickets=torch.zeros(1, dtype=torch.int32),
        num_rows=20_001, num_cols=20_000, label="A", item_entries=256,
    )
    nbytes = lanes.lanes_kernel_bytes(half, 128, 4)
    assert 102e6 < nbytes < 104e6
    assert 0.030 < nbytes / 3.35e9 < 0.032


def test_library_layout_matches_the_lane_product():
    a = random_pattern(25, 20, seed=5)
    pattern = lanes.build_lanes_pattern(a, CPU, item_entries=8)
    rng = np.random.default_rng(6)
    b = 4
    op = lanes.lanes_op(pattern, torch.as_tensor(rng.standard_normal(
        (a.nnz, b))))
    x = torch.as_tensor(rng.standard_normal((20, b)))
    y = torch.as_tensor(rng.standard_normal((25, b)))
    lib = lanes.library_lanes_matrix(pattern.fwd, op.vals)
    lib_t = lanes.library_lanes_matrix(pattern.bwd, op.vals_t)
    assert lib.shape == (25 * b, 20 * b)
    assert lib._nnz() == a.nnz * b
    np.testing.assert_allclose((lib @ x.reshape(-1)).reshape(25, b).numpy(),
                               op.mv(x).numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(
        (lib_t @ y.reshape(-1)).reshape(20, b).numpy(), op.rmv(y).numpy(),
        rtol=1e-12, atol=1e-13)


def test_cpu_wrapper_uses_the_plain_version_and_counts_nothing():
    a = random_pattern(25, 20, seed=7)
    pattern = lanes.build_lanes_pattern(a, CPU)
    rng = np.random.default_rng(8)
    vals = torch.as_tensor(rng.standard_normal((a.nnz, 2)))
    x = torch.as_tensor(rng.standard_normal((20, 2)))
    lanes.reset_launch_counts()
    assert torch.equal(lanes.lanes_spmv(pattern.fwd, vals, x),
                       lanes.lanes_spmv_plain(pattern.fwd, vals, x))
    assert all(v == 0 for v in lanes.LAUNCHES.values())


@pytest.mark.parametrize("label", ["A", "AT"])
def test_compare_tool_checks_the_lane_kernel(label, monkeypatch):
    """compare_kernels.check_lanes, the check that chip_smoke.py's
    kernels_lanes and compare_kernels --layout lanes share: on the CPU
    (the plain version) every error within its tolerance; an output off
    the f64 product by more than the tolerance, or a launch that gives
    other bits, raises KernelMismatch."""
    from firstorderlp_torch.ops import compare_kernels

    a = random_pattern(60, 40, seed=9)
    pattern = lanes.build_lanes_pattern(a, CPU, item_entries=16)
    rng = np.random.default_rng(10)
    op = lanes.lanes_op(pattern, torch.as_tensor(
        rng.standard_normal((a.nnz, 3)).astype(np.float32)))
    half, vals = ((pattern.fwd, op.vals) if label == "A"
                  else (pattern.bwd, op.vals_t))
    v = torch.as_tensor(rng.standard_normal(
        (half.num_cols, 3)).astype(np.float32))
    row = compare_kernels.check_lanes(label, half, vals, v)
    assert row["name"] == f"lanes_spmv:{label}"
    assert row["max_abs_err_vs_plain"] == 0.0
    assert row["max_rel_err"] <= compare_kernels.TOL_ENTRY
    assert row["library_max_abs_err"] <= 1e-5

    plain = lanes.lanes_spmv_plain
    off = {"by": 1e-3}
    monkeypatch.setattr(lanes, "lanes_spmv",
                        lambda h, w, x: plain(h, w, x) + off["by"])
    with pytest.raises(compare_kernels.KernelMismatch, match="f64 product"):
        compare_kernels.check_lanes(label, half, vals, v)
    calls = {"n": 0}

    def drifts(h, w, x):
        calls["n"] += 1
        out = plain(h, w, x)
        return out if calls["n"] < 4 else out + 1e-9 * out.abs().max()

    monkeypatch.setattr(lanes, "lanes_spmv", drifts)
    with pytest.raises(compare_kernels.KernelMismatch, match="differs"):
        compare_kernels.check_lanes(label, half, vals, v)
