"""The port's block-partitioned kernel operator (ops/routed_sharded.py)
on meshes of CPU devices, where each routed block runs its kernels'
plain versions.

The cases of tests/test_routed_sharded.py: mv / rmv against scipy at
f32 tolerance on (8, 1), (4, 2), (2, 4) and (1, 8) meshes, CSR (B2) and
tile-plan (B5) blocks; share_plan_with transferring only values; the
original (stats) operator sharing the scaled operator's index tensors;
the f64 ValueError; the routed sharded solve of the 301-node PageRank LP
on (4, 2) and (2, 4) against the JAX package's (its Pallas kernels in
interpret mode): the same reason, solutions within 2e-4. Besides: empty
blocks, the padding rule, and build_linop's layout rule under a plan.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import parallel as jx_parallel
from firstorderlp_tpu.generators import generate_pagerank_lp

import firstorderlp_torch as tx
from firstorderlp_torch import parallel as tx_parallel
from firstorderlp_torch.models import pdhg as tx_pdhg
from firstorderlp_torch.ops import routed
from firstorderlp_torch.ops.linops import CsrOp, DenseOp, build_linop
from firstorderlp_torch.ops.routed_sharded import (
    RoutedShardPlan,
    ShardedRoutedOp,
    build_sharded_routed_op,
    plan_routed_shards,
)

from test_mirror_prox import mp_params
from test_torch_mirror_prox import port_mp_params
from test_torch_pdhg import port_params, port_problem
from utils import optimality_criteria, pdhg_params

CPU = torch.device("cpu")
F32_RTOL = 1e-5  # |got - want| / max|want|, f32 sums of ~15 terms
SOLVE_ATOL = 2e-4  # f32 routed solves to 1e-5 against each other


def cpu_mesh(shape):
    return tx_parallel.solver_mesh(*shape, devices=[CPU] * 8)


def padded_random(m0, n0, density, plan, rng):
    a = sp.random(m0, n0, density=density, random_state=rng, format="csr")
    m = -(-m0 // plan.row_multiple) * plan.row_multiple
    n = -(-n0 // plan.col_multiple) * plan.col_multiple
    a.resize((m, n))
    return sp.csr_matrix(a)


def f32(v):
    return torch.as_tensor(np.asarray(v, np.float32))


def rel_err(got, want):
    got = got.double().numpy()
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


@pytest.mark.parametrize("tile_aligned", [False, True])
@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_matvecs_match_scipy(mesh_shape, tile_aligned):
    mesh = cpu_mesh(mesh_shape)
    rng = np.random.default_rng(0)
    m0, n0 = 913, 1531
    plan = plan_routed_shards(m0, n0, int(0.01 * m0 * n0), mesh)
    plan = dataclasses.replace(plan, tile_aligned=tile_aligned)
    a = padded_random(m0, n0, 0.01, plan, rng)
    op = build_sharded_routed_op(a, plan)
    assert op.shape == a.shape
    kind = routed.TilePlan if tile_aligned else routed.CsrKernelMatrix
    for row in op.blocks:
        for block in row:
            assert isinstance(block, routed.RoutedOp)
            assert isinstance(block.a, kind)
            assert block.shape == (a.shape[0] // mesh_shape[0],
                                   a.shape[1] // mesh_shape[1])
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = rng.standard_normal(a.shape[0]).astype(np.float32)
    assert rel_err(op.mv(f32(x)), a @ x.astype(np.float64)) < F32_RTOL
    assert rel_err(op.rmv(f32(y)), a.T @ y.astype(np.float64)) < F32_RTOL


def test_matvecs_roundtrip():
    mesh = cpu_mesh((2, 4))
    rng = np.random.default_rng(1)
    m0, n0 = 700, 450
    plan = plan_routed_shards(m0, n0, int(0.02 * m0 * n0), mesh)
    a = padded_random(m0, n0, 0.02, plan, rng)
    op = build_sharded_routed_op(a, plan)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    got = op.rmv(op.mv(f32(x)))
    assert rel_err(got, a.T @ (a @ x.astype(np.float64))) < 1e-4
    assert torch.equal(got, op.rmv(op.mv(f32(x))))  # the same bits again


def test_share_plan_values_only():
    mesh = cpu_mesh((4, 2))
    rng = np.random.default_rng(2)
    m0, n0 = 500, 500
    plan = plan_routed_shards(m0, n0, int(0.02 * m0 * n0), mesh)
    a = padded_random(m0, n0, 0.02, plan, rng)
    donor = build_sharded_routed_op(a, plan)
    b = sp.csr_matrix(a)
    b.data = b.data * 2.0
    op2 = build_sharded_routed_op(b, plan, share_plan_with=donor)
    for d in range(4):
        for p in range(2):
            new, old = op2.blocks[d][p], donor.blocks[d][p]
            # indices reused, not transferred again; values new
            assert new.a.indices is old.a.indices
            assert new.at.items is old.at.items
            assert new.a.vals is not old.a.vals
    x = f32(rng.standard_normal(a.shape[1]))
    np.testing.assert_allclose(op2.mv(x).numpy(), 2.0 * donor.mv(x).numpy(),
                               rtol=1e-6, atol=1e-6)
    other = a.tolil()
    other[0, 0] = 5.0 if a[0, 0] == 0 else 0.0
    other = sp.csr_matrix(other)
    other.eliminate_zeros()
    with pytest.raises(ValueError, match="identical block plan"):
        build_sharded_routed_op(other, plan, share_plan_with=donor)


def test_sharded_optimize_builds_routed_op():
    """prepare_problem with a plan builds both copies' constraint
    operators as ShardedRoutedOps of kernel blocks on their cells, and
    the original (stats) copy's blocks share the scaled copy's index
    tensors."""
    problem = port_problem(generate_pagerank_lp(num_nodes=301, seed=2))
    mesh = cpu_mesh((4, 2))
    params = dataclasses.replace(
        port_params(pdhg_params(optimality_criteria(1e-4),
                                ruiz_iterations=10)),
        dtype="float32", matrix_format="routed",
    )
    plan = plan_routed_shards(problem.num_constraints,
                              problem.num_variables,
                              problem.constraint_matrix.nnz, mesh)
    padded, _, _ = tx_parallel.pad_problem(problem, plan.row_multiple,
                                           plan.col_multiple)
    prepared = tx_pdhg.prepare_problem(params, padded, _shard_plan=plan)
    scaled_op = prepared.bundle.scaled.constraint_matrix
    orig_op = prepared.bundle.original.constraint_matrix
    assert isinstance(scaled_op, ShardedRoutedOp)
    assert isinstance(orig_op, ShardedRoutedOp)
    assert scaled_op.format == orig_op.format == "routed"
    shared = 0
    for d in range(4):
        for p in range(2):
            s_block, o_block = scaled_op.blocks[d][p], orig_op.blocks[d][p]
            assert (s_block is None) == (o_block is None)
            if s_block is None:
                continue
            assert s_block.a.device == mesh.devices[d][p]
            assert o_block.a.indices is s_block.a.indices
            assert o_block.at.indptr is s_block.at.indptr
            assert o_block.a.vals is not s_block.a.vals
            shared += 1
    assert shared > 0


def test_empty_blocks_give_exact_zeros():
    """A block with no stored entry is None: no operator, no launch, an
    exact-zero partial. Here A is block-diagonal on a (2, 2) mesh."""
    rng = np.random.default_rng(3)
    top = sp.random(40, 30, density=0.2, random_state=rng, format="csr")
    bottom = sp.random(40, 30, density=0.2, random_state=rng, format="csr")
    a = sp.csr_matrix(sp.block_diag([top, bottom]))
    plan = plan_routed_shards(80, 60, a.nnz, cpu_mesh((2, 2)))
    op = build_sharded_routed_op(a, plan)
    assert op.blocks[0][1] is None and op.blocks[1][0] is None
    assert isinstance(op.blocks[0][0], routed.RoutedOp)
    x = rng.standard_normal(60).astype(np.float32)
    y = rng.standard_normal(80).astype(np.float32)
    got_mv, got_rmv = op.mv(f32(x)), op.rmv(f32(y))
    # with the off-diagonal partials exact zeros, each piece is the
    # diagonal block's own product, bit for bit
    np.testing.assert_array_equal(
        got_mv.numpy(),
        torch.cat([op.blocks[0][0].mv(f32(x[:30])),
                   op.blocks[1][1].mv(f32(x[30:]))]).numpy())
    np.testing.assert_array_equal(
        got_rmv.numpy(),
        torch.cat([op.blocks[0][0].rmv(f32(y[:40])),
                   op.blocks[1][1].rmv(f32(y[40:]))]).numpy())
    assert rel_err(got_mv, a @ x.astype(np.float64)) < F32_RTOL
    # an all-empty operator: zeros of the right shape
    empty = build_sharded_routed_op(sp.csr_matrix((80, 60)), plan)
    assert all(b is None for row in empty.blocks for b in row)
    assert torch.equal(empty.mv(f32(x)), torch.zeros(80))
    assert torch.equal(empty.rmv(f32(y)), torch.zeros(60))


def test_matrix_must_be_padded_to_the_mesh():
    plan = plan_routed_shards(9, 10, 20, cpu_mesh((4, 2)))
    assert (plan.row_multiple, plan.col_multiple) == (4, 2)
    a = sp.random(9, 10, density=0.3, random_state=0, format="csr")
    with pytest.raises(ValueError, match="must be padded"):
        build_sharded_routed_op(a, plan)


def test_layout_rule_under_a_plan():
    """build_linop chooses the blocks' layout on the whole matrix, as it
    chooses a single-device operator's."""
    mesh = cpu_mesh((2, 2))
    plan = RoutedShardPlan(mesh=mesh)
    a = sp.random(400, 300, density=0.05, random_state=4, format="csr")
    dense = build_linop(a, torch.float64, "auto", shard_plan=plan)
    assert dense.format == "dense"
    assert isinstance(dense.blocks[0][0], DenseOp)
    sparse = build_linop(a, torch.float64, "sparse", shard_plan=plan)
    assert isinstance(sparse.blocks[1][1], CsrOp)
    kernel = build_linop(a, torch.float32, "routed", shard_plan=plan)
    assert isinstance(kernel.blocks[0][1], routed.RoutedOp)
    # "auto" asks for a CUDA home device before it picks the kernels
    big = sp.random(3000, 3000, density=0.006, random_state=5,
                    format="csr")
    assert build_linop(big, torch.float32, "auto",
                       shard_plan=plan).format == "sparse"
    with pytest.raises(ValueError, match="f32"):
        build_linop(a, torch.float64, "routed", shard_plan=plan)
    # the stats copy shares the scaled copy's index tensors only when
    # the kernel layout is chosen for it too
    shared = build_linop(a * 3.0, torch.float32, "routed",
                         share_plan_with=kernel, shard_plan=plan)
    assert shared.blocks[0][0].a.indices is kernel.blocks[0][0].a.indices
    other = build_linop(a, torch.float64, "sparse", share_plan_with=kernel,
                        shard_plan=plan)
    assert isinstance(other.blocks[0][0], CsrOp)


def test_sharded_routed_requires_f32():
    problem = generate_pagerank_lp(num_nodes=64, seed=0)
    params = dataclasses.replace(
        port_params(pdhg_params(optimality_criteria(1e-4))),
        dtype="float64", matrix_format="routed",
    )
    with pytest.raises(ValueError, match="float32"):
        tx_parallel.sharded_optimize(params, port_problem(problem),
                                     cpu_mesh((4, 2)))


def routed_params():
    params = pdhg_params(
        optimality_criteria(1e-5), ruiz_iterations=10,
        pock_chambolle_alpha=1.0,
    )
    return dataclasses.replace(params, dtype="float32",
                               matrix_format="routed")


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_sharded_optimize_routed_matches_jax(mesh_shape):
    problem = generate_pagerank_lp(num_nodes=301, seed=2)
    params = routed_params()
    want = jx_parallel.sharded_optimize(
        params, problem, jx_parallel.solver_mesh(*mesh_shape)
    )
    got = tx_parallel.sharded_optimize(
        port_params(params), port_problem(problem), cpu_mesh(mesh_shape)
    )
    assert (got.termination_reason
            == tx.TerminationReason.TERMINATION_REASON_OPTIMAL)
    assert got.termination_reason.name == want.termination_reason.name
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               atol=SOLVE_ATOL)
    single = jx.optimize(
        dataclasses.replace(params, dtype="float64", matrix_format="auto"),
        problem,
    )
    np.testing.assert_allclose(got.primal_solution, single.primal_solution,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(got.dual_solution, single.dual_solution,
                               atol=SOLVE_ATOL)


def test_sharded_mirror_prox_routed_matches_jax():
    problem = generate_pagerank_lp(num_nodes=301, seed=2)
    params = dataclasses.replace(
        mp_params(optimality_criteria(1e-5), diagonal_scaling="l2",
                  ruiz_iterations=10, pock_chambolle_alpha=1.0),
        dtype="float32", matrix_format="routed",
    )
    want = jx_parallel.sharded_optimize(
        params, problem, jx_parallel.solver_mesh(2, 2)
    )
    got = tx_parallel.sharded_optimize(
        port_mp_params(params), port_problem(problem), cpu_mesh((2, 2))
    )
    assert (got.termination_reason
            == tx.TerminationReason.TERMINATION_REASON_OPTIMAL)
    assert got.termination_reason.name == want.termination_reason.name
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               atol=SOLVE_ATOL)
