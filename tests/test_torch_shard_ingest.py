"""The port's row-sharded ingest (parallel/shard_ingest.py) against the
JAX package's, on the CPU.

The cases of tests/test_shard_ingest.py, each solved by the port on
meshes of `cpu` devices with the kernels' plain versions and held to
the JAX test's tolerance against the JAX package's f64 optimize (atol
2e-4 in f64, 2e-3 in f32; never to equal iteration counts, since the
f32 trajectory is chaotic). Besides:
- the specs (mps_row_shard_spec, problem_row_shard_spec) field by field
  and loader call by loader call exactly equal to the JAX package's, and
  the same exception for RANGES and quadratic sections;
- the on-device rescale against the JAX package's _sharded_rescale_coo
  on its virtual CPU mesh (alpha = 1; rtol 1e-12 in f64, 1e-5 in f32),
  and with alpha = 2 or 0 against the host f64 rescale_problem, where
  the JAX package's padded entries add 0 ** 0 = 1 to row 0's or
  column 0's sums (a fault of the reference, ROADMAP queue C);
- the f64 row-block path against the JAX package's
  host_sharded_optimize on the same mesh shape (XLA, no Pallas);
- the operator built from cells (routed_sharded.
  build_sharded_op_from_blocks), the ordered row-block reductions and
  fetch_global;
- two gloo processes on a (2, 1) mesh and four on a (2, 2) mesh
  streaming one MPS file: each loads exactly its row block's entries,
  and every rank gives the single-process mesh's bits.
"""

import dataclasses
import gzip
import os
import pickle
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu.io.mps_writer import write_mps
from firstorderlp_tpu.parallel import shard_ingest as jx_ingest
from firstorderlp_tpu.parallel.mesh import solver_mesh as jx_solver_mesh

import firstorderlp_torch as tx
from firstorderlp_torch import saddle_point as tx_saddle
from firstorderlp_torch.io.mps import MpsParseError
from firstorderlp_torch.ops.routed_sharded import (
    blocks_fingerprint,
    build_sharded_op_from_blocks,
    build_sharded_routed_op,
    plan_routed_shards,
)
from firstorderlp_torch.parallel import distributed as tx_distributed
from firstorderlp_torch.parallel import shard_ingest as tx_ingest
from firstorderlp_torch.parallel import solver_mesh

from test_shard_ingest import _params, _random_lp, _routed_params
from test_torch_distributed import free_port
from test_torch_pdhg import port_params, port_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WORKER_TIMEOUT = 120  # seconds; a rank that waits longer fails the test
OPTIMAL = "TERMINATION_REASON_OPTIMAL"


def cpu_mesh(shape):
    return solver_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))


def port_solve(params, problem, shape, **kw):
    return tx_ingest.host_sharded_optimize(
        port_params(params),
        tx_ingest.problem_row_shard_spec(port_problem(problem)),
        cpu_mesh(shape), **kw)


def assert_close_solve(got, want, atol):
    assert got.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=atol)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               atol=atol)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

# Every row type (the L row flipped), a right-hand side on the objective
# row (the constant), an integer marker and every bound type.
MIXED_MPS = """NAME mixed
ROWS
 N  COST
 L  lim1
 G  lim2
 E  eq1
 L  lim3
 E  eq2
COLUMNS
    MARKER                 'MARKER'                 'INTORG'
    x1        COST         1.5   lim1         2.0
    x1        eq1          -1.0
    MARKER                 'MARKER'                 'INTEND'
    x2        lim2         3.0   eq2          4.5
    x3        COST         -2.0  lim3         1.0
    x3        lim1         0.5
    x4        eq1          2.0   lim2         -1.25
    x5        eq2          1.0   COST         0.75
    x6        lim3         -3.0
    x7        lim1         1.0
    x8        eq2          -2.0
    x9        lim2         1.0
RHS
    rhs       COST         -4.0  lim1         5.0
    rhs       lim2         1.0   eq1          2.0
    rhs       lim3         -1.0  eq2          0.5
BOUNDS
 UP bnd       x1           4.0
 LO bnd       x2           -1.0
 UP bnd       x3           -2.0
 FX bnd       x4           1.5
 FR bnd       x5
 MI bnd       x6
 PL bnd       x7
 BV bnd       x8
 UI bnd       x9           7
ENDATA
"""

RANGES_MPS = """NAME ranged
ROWS
 N  COST
 L  lim1
COLUMNS
    x1        COST         1.0   lim1         1.0
RHS
    rhs       lim1         4.0
RANGES
    rng       lim1         2.0
ENDATA
"""

QUADOBJ_MPS = """NAME quad
ROWS
 N  COST
 G  lim1
COLUMNS
    x1        COST         1.0   lim1         1.0
RHS
    rhs       lim1         1.0
QUADOBJ
    x1        x1           2.0
ENDATA
"""

SPEC_FIELDS = ("num_constraints", "num_variables", "num_equalities",
               "objective_constant", "nnz")
SPEC_ARRAYS = ("objective_vector", "variable_lower_bound",
               "variable_upper_bound", "right_hand_side")


def assert_same_spec(got, want, ranges):
    for name in SPEC_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for name in SPEC_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for lo, hi in ranges:
        for g, w in zip(got.row_loader(lo, hi), want.row_loader(lo, hi)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def write_text(tmp_path, name, text):
    path = os.path.join(tmp_path, name)
    if name.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


@pytest.mark.parametrize("case", ["random_gz", "random", "mixed",
                                  "trivial_lp"])
def test_mps_spec_matches_jax_spec(tmp_path, case):
    """Every field and every loader call exactly the JAX package's, on
    files from the writer (gzipped or not), a hand-made file with every
    row and bound type and markers, and the repo's trivial LP (an L row,
    an empty RANGES section)."""
    if case.startswith("random"):
        path = os.path.join(tmp_path, "inst.mps" + (
            ".gz" if case == "random_gz" else ""))
        write_mps(_random_lp(m=33, n=21, k_eq=5, seed=1), path)
    elif case == "mixed":
        path = write_text(tmp_path, "mixed.mps", MIXED_MPS)
    else:
        path = os.path.join(REPO, "tests", "test_data", "trivial_lp.mps")
    got = tx_ingest.mps_row_shard_spec(path)
    want = jx_ingest.mps_row_shard_spec(path)
    m = want.num_constraints
    ranges = [(0, m), (0, 1), (1, m), (m // 2, m + 3), (m, m + 1)]
    ranges += [(lo, min(lo + 9, m)) for lo in range(0, m, 9)]
    assert_same_spec(got, want, ranges)


def test_problem_spec_matches_jax_spec():
    problem = _random_lp(m=45, n=30, k_eq=11, seed=3)
    got = tx_ingest.problem_row_shard_spec(port_problem(problem))
    want = jx_ingest.problem_row_shard_spec(problem)
    assert_same_spec(got, want, [(0, 45), (0, 6), (42, 48), (6, 12)])


@pytest.mark.parametrize("text", [RANGES_MPS, QUADOBJ_MPS],
                         ids=["ranges", "quadobj"])
def test_spec_rejects_ranges_and_quadratic_sections(tmp_path, text):
    path = write_text(tmp_path, "bad.mps", text)
    with pytest.raises(Exception) as want:
        jx_ingest.mps_row_shard_spec(path)
    with pytest.raises(MpsParseError) as got:
        tx_ingest.mps_row_shard_spec(path)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_mps_row_shard_spec_matches_reader(tmp_path):
    problem = _random_lp(m=33, n=21, k_eq=5, seed=1)
    path = os.path.join(tmp_path, "inst.mps.gz")
    write_mps(problem, path)
    ref = tx.qps_reader_to_standard_form(path)
    spec = tx_ingest.mps_row_shard_spec(path)
    assert spec.num_constraints == ref.num_constraints
    assert spec.num_variables == ref.num_variables
    assert spec.num_equalities == ref.num_equalities
    np.testing.assert_array_equal(spec.right_hand_side, ref.right_hand_side)
    np.testing.assert_array_equal(spec.objective_vector,
                                  ref.objective_vector)
    np.testing.assert_array_equal(spec.variable_lower_bound,
                                  ref.variable_lower_bound)
    np.testing.assert_array_equal(spec.variable_upper_bound,
                                  ref.variable_upper_bound)
    assert spec.objective_constant == ref.objective_constant
    parts = [spec.row_loader(lo, min(lo + 9, 33)) for lo in range(0, 33, 9)]
    rebuilt = sp.csr_matrix(
        (np.concatenate([p[2] for p in parts]),
         (np.concatenate([p[0] for p in parts]),
          np.concatenate([p[1] for p in parts]))), shape=(33, 21))
    assert rebuilt.nnz == ref.constraint_matrix.nnz == spec.nnz
    assert abs(rebuilt - ref.constraint_matrix).max() == 0.0


def test_mps_loader_memory_stays_sharded(tmp_path):
    """The loader's peak allocation for ONE block of eight stays under
    0.6 of the full COO's bytes."""
    problem = _random_lp(m=600, n=400, k_eq=100, seed=2)
    path = os.path.join(tmp_path, "big.mps")
    write_mps(problem, path)
    nnz = problem.constraint_matrix.nnz
    full_coo_bytes = nnz * (8 + 8 + 8)  # vals + int64 rows/cols
    spec = tx_ingest.mps_row_shard_spec(path)
    m_b = -(-600 // 8)
    tracemalloc.start()
    rows, cols, vals = spec.row_loader(0, m_b)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert len(vals) < nnz / 4
    assert peak < 0.6 * full_coo_bytes, (peak, full_coo_bytes)


# ---------------------------------------------------------------------------
# The on-device rescale
# ---------------------------------------------------------------------------


def jax_rescale(problem, n_blocks, dtype, ruiz, l2, alpha):
    """The JAX package's _sharded_rescale_coo on its CPU mesh, fed as its
    host_sharded_routed_optimize feeds it (blocks padded to the largest
    block's entries)."""
    import jax.numpy as jnp

    m, n = problem.constraint_matrix.shape
    m_b = -(-m // n_blocks)
    m_pad = m_b * n_blocks
    csr = sp.csr_matrix(problem.constraint_matrix)
    csr.sum_duplicates()
    csr = sp.csr_matrix(sp.vstack([csr, sp.csr_matrix((m_pad - m, n))]))
    blocks = [sp.csr_matrix(csr[d * m_b:(d + 1) * m_b]).tocoo()
              for d in range(n_blocks)]
    nnz_b = max(max(b.nnz for b in blocks), 1)

    def field(fn, kind):
        out = np.zeros((n_blocks, nnz_b), kind)
        for d, b in enumerate(blocks):
            out[d, :b.nnz] = fn(b)
        return jnp.asarray(out)

    b = np.zeros(m_pad)
    b[:m] = problem.right_hand_side
    out = jx_ingest._sharded_rescale_coo(
        field(lambda c: c.data, dtype), field(lambda c: c.row, np.int32),
        field(lambda c: c.col, np.int32),
        jnp.asarray(b.reshape(n_blocks, m_b).astype(dtype)),
        jnp.asarray(np.asarray(problem.objective_vector, dtype)),
        jnp.asarray(np.asarray(problem.variable_lower_bound, dtype)),
        jnp.asarray(np.asarray(problem.variable_upper_bound, dtype)),
        mesh=jx_solver_mesh(n_blocks, 1), m_b=m_b, n=n,
        ruiz_iterations=ruiz, l2_flag=l2, pc_alpha=alpha,
    )
    (v, b_s, c_s, lo_s, hi_s, cum_con, cum_var, step, norm_c, norm_b,
     linf_b, l2_b) = (np.asarray(x) for x in out)
    return {
        "values": [v[d, :blk.nnz] for d, blk in enumerate(blocks)],
        "constraint_rescaling": cum_con.reshape(-1),
        "variable_rescaling": cum_var, "right_hand_side": b_s.reshape(-1),
        "objective_vector": c_s, "variable_lower_bound": lo_s,
        "variable_upper_bound": hi_s, "step_size": step, "norm_c": norm_c,
        "norm_b": norm_b, "linf_b": linf_b, "l2_b": l2_b,
    }


def port_rescale(problem, n_blocks, dtype, ruiz, l2, alpha):
    """The port's sharded_rescale on a (D, 1) mesh of `cpu` devices: the
    routed layout's sums (B2's plain version) in f32, CsrOp's in f64."""
    spec = tx_ingest.problem_row_shard_spec(port_problem(problem))
    m, n = spec.num_constraints, spec.num_variables
    m_b = -(-m // n_blocks)
    tdtype = getattr(torch, np.dtype(dtype).name)
    layout = "routed" if tdtype == torch.float32 else "sparse"
    blocks = {d: tx_ingest.load_row_block(spec, d, m_b, n, CPU, layout,
                                          tdtype)
              for d in range(n_blocks)}

    def vec(v, size):
        out = np.zeros(size)
        out[:len(v)] = v
        return torch.as_tensor(out).to(tdtype)

    got = tx_ingest.sharded_rescale(
        blocks, {"b": vec(spec.right_hand_side, m_b * n_blocks),
                 "c": vec(spec.objective_vector, n),
                 "lo": vec(spec.variable_lower_bound, n),
                 "hi": vec(spec.variable_upper_bound, n)},
        cpu_mesh((n_blocks, 1)), ruiz, l2, alpha, tdtype)
    out = {k: np.asarray(getattr(got, k)) for k in got._fields
           if k != "values"}
    out["values"] = [got.values[d].numpy() for d in range(n_blocks)]
    return out


def assert_rescale_close(got, want, rtol):
    assert len(got["values"]) == len(want["values"])
    for g, w in zip(got["values"], want["values"]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
    for key, w in want.items():
        if key != "values":
            np.testing.assert_allclose(got[key], w, rtol=rtol, atol=0,
                                       err_msg=key)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n_blocks", [1, 4, 8])
def test_rescale_matches_jax_sharded_rescale(n_blocks, dtype, rtol):
    """45 rows on 4 or 8 blocks: an uneven last block (and padded rows);
    10 Ruiz steps, the l2 step and Pock-Chambolle with alpha = 1."""
    problem = _random_lp(m=45, n=30, k_eq=11, seed=3)
    args = (problem, n_blocks, dtype, 10, True, 1.0)
    assert_rescale_close(port_rescale(*args), jax_rescale(*args), rtol)


@pytest.mark.parametrize("alpha", [2.0, 0.0])
def test_rescale_has_no_pad_entries(alpha):
    """Pock-Chambolle with alpha = 2 (column sums of |a|^0) or 0 (row
    sums) on 4 uneven blocks: the port equals the host f64
    rescale_problem. The JAX package's sharded rescale pads every
    block's entries with zeros at its row 0, column 0, and 0 ** 0 = 1
    adds one per pad to column 0's sum (or to the sum of each block's
    first row): it differs there, and only there."""
    problem = _random_lp(m=45, n=30, k_eq=11, seed=3)
    args = (problem, 4, np.float64, 10, False, alpha)
    got = port_rescale(*args)
    host = tx.rescale_problem(10, False, alpha, 0, port_problem(problem))
    np.testing.assert_allclose(got["variable_rescaling"],
                               host.variable_rescaling, rtol=1e-12)
    np.testing.assert_allclose(got["constraint_rescaling"][:45],
                               host.constraint_rescaling, rtol=1e-12)
    scaled = sp.csr_matrix(host.scaled_qp.constraint_matrix)
    scaled.sum_duplicates()
    np.testing.assert_allclose(np.concatenate(got["values"]), scaled.data,
                               rtol=1e-12)
    want = jax_rescale(*args)
    key = "variable_rescaling" if alpha == 2.0 else "constraint_rescaling"
    host_vec = getattr(host, key)
    jax_err = np.abs(want[key][:len(host_vec)] / host_vec - 1.0)
    faulty = {0} if alpha == 2.0 else {0, 12, 24, 36}  # blocks of 12
    assert 0 < len(set(np.flatnonzero(jax_err > 1e-3))) <= len(faulty)
    assert set(np.flatnonzero(jax_err > 1e-3)) <= faulty


# ---------------------------------------------------------------------------
# Solves (the cases of tests/test_shard_ingest.py)
# ---------------------------------------------------------------------------


def test_host_sharded_matches_full_ingest():
    """f64 CsrOp blocks on (4, 1) against the JAX package's optimize
    (2e-4, the JAX test's) and against its host_sharded_optimize on
    the same mesh shape."""
    problem = _random_lp()
    params = _params()
    got = port_solve(params, problem, (4, 1))
    assert_close_solve(got, jx.optimize(params, problem), 2e-4)
    ref = jx_ingest.host_sharded_optimize(
        params, jx_ingest.problem_row_shard_spec(problem),
        jx_solver_mesh(4, 1))
    assert ref.termination_reason.name == OPTIMAL
    assert_close_solve(got, ref, 2e-4)


def test_host_sharded_uneven_rows_and_8_blocks():
    problem = _random_lp(m=45, n=30, k_eq=11, seed=3)
    params = _params()
    got = port_solve(params, problem, (8, 1))  # blocks of 6, last padded
    assert_close_solve(got, jx.optimize(params, problem), 2e-4)


def test_mps_solve_via_sharded_ingest(tmp_path):
    problem = _random_lp(m=29, n=18, k_eq=4, seed=5)
    path = os.path.join(tmp_path, "inst.mps")
    write_mps(problem, path)
    params = _params()
    full = jx.optimize(params, jx.qps_reader_to_standard_form(path))
    out = tx_ingest.host_sharded_optimize(
        port_params(params), tx_ingest.mps_row_shard_spec(path),
        cpu_mesh((4, 1)))
    assert out.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(out.primal_solution, full.primal_solution,
                               atol=2e-4)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_host_sharded_routed_matches_full_ingest(shape):
    problem = _random_lp(m=45, n=60, k_eq=9, seed=5)
    full = jx.optimize(_params(), problem)  # f64 reference
    out = tx_ingest.host_sharded_routed_optimize(
        port_params(_routed_params()),
        tx_ingest.problem_row_shard_spec(port_problem(problem)),
        cpu_mesh(shape))
    assert_close_solve(out, full, 2e-3)


def test_host_sharded_dispatches_routed_on_2d_mesh():
    problem = _random_lp(m=30, n=24, k_eq=6, seed=11)
    out = port_solve(_routed_params(), problem, (2, 2))
    assert out.termination_reason.name == OPTIMAL


def test_host_sharded_is_bitwise_deterministic():
    """The same routed (2, 2) solve twice: the same bits."""
    problem = _random_lp(m=45, n=60, k_eq=9, seed=5)
    runs = [port_solve(_routed_params(), problem, (2, 2)) for _ in range(2)]
    assert runs[0].iteration_count == runs[1].iteration_count
    np.testing.assert_array_equal(runs[0].primal_solution,
                                  runs[1].primal_solution)
    np.testing.assert_array_equal(runs[0].dual_solution,
                                  runs[1].dual_solution)


def test_report_counts_the_loaded_entries():
    problem = _random_lp(m=45, n=30, k_eq=11, seed=3)
    report = {}
    port_solve(_params(), problem, (4, 1), report=report)
    csr = sp.csr_matrix(problem.constraint_matrix)
    row_nnz = np.diff(csr.indptr)
    assert report["block_nnz"] == [int(row_nnz[lo:lo + 12].sum())
                                   for lo in range(0, 48, 12)]
    assert report["loaded_nnz"] == csr.nnz
    for key in ("load_seconds", "rescale_seconds", "build_seconds",
                "solve_seconds"):
        assert report[key] >= 0.0


@pytest.mark.parametrize("case,match", [
    ("2d_mesh", "rows only"),
    ("routed_f64", "computes in f32"),
    ("constant_steps", "adaptive step rule"),
    ("checkpoint", "checkpointing"),
    ("verbosity", "verbosity >= 7"),
    ("bound_width", "bound_width_rescaling"),
    ("wrong_nnz", "the spec"),
])
def test_sharded_ingest_rejects_unsupported(case, match):
    problem = _random_lp()
    spec = tx_ingest.problem_row_shard_spec(port_problem(problem))
    params = port_params(_params())
    shape = (4, 1)
    if case == "2d_mesh":
        shape = (2, 2)
    elif case == "routed_f64":
        params = dataclasses.replace(params, matrix_format="routed")
    elif case == "constant_steps":
        params = dataclasses.replace(
            params, step_size_policy_params=tx.ConstantStepsizeParams())
    elif case == "checkpoint":
        params = dataclasses.replace(params, checkpoint_path="ckpt.npz")
    elif case == "verbosity":
        params = dataclasses.replace(params, verbosity=7)
    elif case == "bound_width":
        params = dataclasses.replace(params, bound_width_rescaling=True)
    else:
        spec.nnz += 1
    with pytest.raises(ValueError, match=match):
        tx_ingest.host_sharded_optimize(params, spec, cpu_mesh(shape))


# ---------------------------------------------------------------------------
# The layer beneath: blocks, reductions, fetch_global
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["routed", "sparse"])
def test_operator_from_cells_matches_whole_matrix_build(fmt):
    """build_sharded_op_from_blocks on the (d, p) cells gives the
    products of build_sharded_routed_op on the whole matrix; its
    fingerprint is the cells'; an unscaled copy shares the index
    tensors."""
    rng = np.random.default_rng(0)
    a = sp.random(12, 10, density=0.3, random_state=1, format="csr")
    mesh = cpu_mesh((2, 2))
    plan = plan_routed_shards(12, 10, a.nnz, mesh)
    cells = {(d, p): a[6 * d:6 * (d + 1), 5 * p:5 * (p + 1)]
             for d in range(2) for p in range(2)}
    dtype = torch.float32 if fmt == "routed" else torch.float64
    got = build_sharded_op_from_blocks(cells, plan, (12, 10), dtype=dtype,
                                       format=fmt)
    want = build_sharded_routed_op(a, plan, dtype=dtype, format=fmt)
    assert got.pattern_hash == blocks_fingerprint(
        {k: sp.csr_matrix(v) for k, v in cells.items()})
    x = torch.as_tensor(rng.standard_normal(10)).to(dtype)
    y = torch.as_tensor(rng.standard_normal(12)).to(dtype)
    torch.testing.assert_close(got.mv(x), want.mv(x), rtol=0, atol=0)
    torch.testing.assert_close(got.rmv(y), want.rmv(y), rtol=0, atol=0)
    if fmt == "routed":
        twice = {k: 2.0 * v for k, v in cells.items()}
        copy = build_sharded_op_from_blocks(twice, plan, (12, 10),
                                            share_plan_with=got)
        assert copy.blocks[1][0].a.indices is got.blocks[1][0].a.indices
        torch.testing.assert_close(copy.mv(x), 2.0 * got.mv(x))
    with pytest.raises(ValueError, match="shape"):
        build_sharded_op_from_blocks({(0, 0): a[:5, :5]}, plan, (12, 10),
                                     dtype=dtype, format=fmt)


def test_row_block_reductions_fold_in_block_order():
    mesh = cpu_mesh((3, 1))
    parts = {d: torch.tensor([0.1 * (d + 1), -1.0 * d, 1e16 * (d == 1)],
                             dtype=torch.float64) for d in range(3)}
    got = tx_distributed.reduce_row_blocks(parts, mesh, "sum")
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(got, want)
    assert torch.equal(tx_distributed.reduce_row_blocks(parts, mesh, "max"),
                       torch.stack(list(parts.values())).amax(0))
    assert torch.equal(tx_distributed.concat_row_blocks(parts, mesh),
                       torch.cat([parts[0], parts[1], parts[2]]))
    with pytest.raises(ValueError, match="reduction"):
        tx_distributed.reduce_row_blocks(parts, mesh, "min")
    vec = np.array([3, 1, 2])
    np.testing.assert_array_equal(tx_distributed.allmax_int(vec), vec)
    whole = torch.arange(5.0)
    np.testing.assert_array_equal(tx_saddle.fetch_global(whole),
                                  whole.numpy())
    np.testing.assert_array_equal(tx_saddle.fetch_global(whole, mesh),
                                  whole.numpy())


# ---------------------------------------------------------------------------
# Two gloo processes streaming one MPS file
# ---------------------------------------------------------------------------

WORKER = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from firstorderlp_torch.parallel import distributed as D
from firstorderlp_torch.parallel import shard_ingest as S
from firstorderlp_torch.saddle_point import fetch_global

rank, world, port = (int(a) for a in sys.argv[1:4])
case_path, out_path = sys.argv[4:6]
with open(case_path, "rb") as f:
    case = pickle.load(f)
D.initialize(f"localhost:{port}", world, rank)
mesh = D.global_solver_mesh(*case["mesh"], device="cpu")
spec = S.mps_row_shard_spec(case["path"])
ranges, loaded = [], []
inner = spec.row_loader
def counting(lo, hi):
    out = inner(lo, hi)
    ranges.append((lo, hi))
    loaded.append(len(out[2]))
    return out
spec.row_loader = counting
report = {}
out = S.host_sharded_optimize(case["params"], spec, mesh, report=report)
pieces = fetch_global(torch.full((2,), float(rank)), mesh)
np.savez(out_path, primal=out.primal_solution, dual=out.dual_solution,
         iterations=out.iteration_count,
         reason=out.termination_reason.name, ranges=np.array(ranges),
         loaded=np.array(loaded), block_nnz=np.array(report["block_nnz"]),
         pieces=pieces)
dist.destroy_process_group()
assert "jax" not in sys.modules, "a worker imported jax"
print("RESULT", rank, out.termination_reason.name, out.iteration_count)
"""


def run_ranks(tmp_path, params, path, mesh):
    """One process a cell of the `mesh` shape, each solving from the MPS
    file at `path`; returns each rank's saved result."""
    world = mesh[0] * mesh[1]
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    case = tmp_path / "case.pkl"
    with open(case, "wb") as f:
        pickle.dump({"params": params, "path": path, "mesh": mesh}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(rank), str(world), port,
             str(case), str(tmp_path / f"rank{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path),
        )
        for rank in range(world)
    ]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the ranks did not finish: a rank waited forever")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "RESULT" in out, out[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("routed_layout", [False, True],
                         ids=["f64_csr_blocks", "f32_routed"])
def test_two_gloo_ranks_stream_their_rows(tmp_path, routed_layout):
    """Two processes on a (2, 1) mesh stream one MPS file: each loads
    exactly the entries of its own row block (together, the matrix),
    and both give the bits of the single-process (2, 1) mesh."""
    problem = _random_lp(m=160, n=100, k_eq=32, seed=9)
    path = os.path.join(tmp_path, "dist.mps")
    write_mps(problem, path)
    params = port_params(_routed_params() if routed_layout else _params())
    ranks = run_ranks(tmp_path, params, path, (2, 1))
    csr = sp.csr_matrix(problem.constraint_matrix)
    row_nnz = np.diff(csr.indptr)
    for rank, got in enumerate(ranks):
        (lo, hi), = got["ranges"]
        assert (lo, hi) == (80 * rank, 80 * (rank + 1))
        assert got["loaded"].tolist() == [int(row_nnz[lo:hi].sum())]
        assert got["block_nnz"].tolist() == [int(row_nnz[:80].sum()),
                                             int(row_nnz[80:].sum())]
        np.testing.assert_array_equal(got["pieces"], [0.0, 0.0, 1.0, 1.0])
    assert sum(int(r["loaded"].sum()) for r in ranks) == csr.nnz
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = tx_ingest.host_sharded_optimize(
            params, tx_ingest.mps_row_shard_spec(path), cpu_mesh((2, 1)))
    finally:
        torch.set_num_threads(threads)
    assert single.termination_reason.name == OPTIMAL
    for got in ranks:
        assert str(got["reason"]) == OPTIMAL
        assert int(got["iterations"]) == single.iteration_count
        np.testing.assert_array_equal(got["primal"], single.primal_solution)
        np.testing.assert_array_equal(got["dual"], single.dual_solution)


def test_four_gloo_ranks_on_a_2x2_mesh(tmp_path):
    """Four processes on a (2, 2) mesh: ranks (d, 0) and (d, 1) each
    stream row block d, the column reductions keep the (d, 0) pieces
    only, and every rank gives the bits of the single-process (2, 2)
    mesh (the routed f32 layout, the one that cuts columns)."""
    problem = _random_lp(m=160, n=100, k_eq=32, seed=9)
    path = os.path.join(tmp_path, "dist.mps")
    write_mps(problem, path)
    params = port_params(_routed_params())
    ranks = run_ranks(tmp_path, params, path, (2, 2))
    row_nnz = np.diff(sp.csr_matrix(problem.constraint_matrix).indptr)
    for rank, got in enumerate(ranks):
        d = rank // 2
        (lo, hi), = got["ranges"]
        assert (lo, hi) == (80 * d, 80 * (d + 1))
        assert got["loaded"].tolist() == [int(row_nnz[lo:hi].sum())]
        np.testing.assert_array_equal(got["pieces"], [0.0, 0.0, 2.0, 2.0])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = tx_ingest.host_sharded_optimize(
            params, tx_ingest.mps_row_shard_spec(path), cpu_mesh((2, 2)))
    finally:
        torch.set_num_threads(threads)
    assert single.termination_reason.name == OPTIMAL
    for got in ranks:
        assert str(got["reason"]) == OPTIMAL
        np.testing.assert_array_equal(got["primal"], single.primal_solution)
        np.testing.assert_array_equal(got["dual"], single.dual_solution)
