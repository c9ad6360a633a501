"""The port's multi-device solve (parallel/sharded.py) against the JAX
package's, on meshes of CPU devices.

The cases of tests/test_sharding.py: the port's sharded_optimize on
(8, 1), (4, 2) and (2, 4) meshes of `cpu` devices against the JAX
package's sharded_optimize on its virtual 8-device mesh (the same
termination reason, f64 solutions within 1e-7), the 64-node PageRank LP
on (4, 2), pad_problem solving identically, the blocks really
partitioning A, and make_placement putting every vector on the home
device. Mirror Prox as well, and a QP against the JAX package's
single-device solve.
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
from firstorderlp_torch.ops.linops import CsrOp, DenseOp
from firstorderlp_torch.ops.routed_sharded import (
    ShardedRoutedOp,
    plan_routed_shards,
)

from fixtures import example_lp, example_qp
from test_mirror_prox import mp_params
from test_torch_mirror_prox import port_mp_params
from test_torch_pdhg import port_params, port_problem
from utils import (
    optimality_criteria,
    pdhg_params,
    terminate_on_iteration_limit,
)

CPU = torch.device("cpu")
F64_ATOL = 1e-7


def cpu_mesh(shape):
    return tx_parallel.solver_mesh(*shape, devices=[CPU] * 8)


def assert_same_solve(got, want, atol=F64_ATOL):
    assert got.termination_reason.name == want.termination_reason.name
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=atol)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               atol=atol)


def test_pad_problem_solves_identically():
    problem = example_lp()
    got, m, n = tx_parallel.pad_problem(port_problem(problem), 4, 8)
    want, _, _ = jx_parallel.pad_problem(problem, 4, 8)
    assert got.constraint_matrix.shape == (4, 8) and (m, n) == (3, 4)
    assert (got.constraint_matrix != want.constraint_matrix).nnz == 0
    np.testing.assert_array_equal(got.right_hand_side, want.right_hand_side)
    np.testing.assert_array_equal(got.variable_upper_bound,
                                  want.variable_upper_bound)
    params = port_params(pdhg_params(terminate_on_iteration_limit(200)))
    out_orig = tx.optimize(params, port_problem(problem), device=CPU)
    out_pad = tx.optimize(params, got, device=CPU)
    np.testing.assert_allclose(out_pad.primal_solution[:n],
                               out_orig.primal_solution, atol=1e-12)
    np.testing.assert_allclose(out_pad.dual_solution[:m],
                               out_orig.dual_solution, atol=1e-12)
    np.testing.assert_allclose(out_pad.primal_solution[n:], 0.0)
    np.testing.assert_allclose(out_pad.dual_solution[m:], 0.0)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_solve_matches_jax(mesh_shape):
    problem = example_lp()
    params = pdhg_params(optimality_criteria(1e-9))
    want = jx_parallel.sharded_optimize(
        params, problem, jx_parallel.solver_mesh(*mesh_shape)
    )
    got = tx_parallel.sharded_optimize(
        port_params(params), port_problem(problem), cpu_mesh(mesh_shape)
    )
    assert got.termination_reason == tx.TerminationReason.TERMINATION_REASON_OPTIMAL
    assert_same_solve(got, want)
    single = tx.optimize(port_params(params), port_problem(problem),
                         device=CPU)
    assert_same_solve(got, single)


def test_sharded_pagerank_lp():
    problem = generate_pagerank_lp(num_nodes=64, seed=3)
    params = pdhg_params(
        optimality_criteria(1e-7), ruiz_iterations=10, pock_chambolle_alpha=1.0
    )
    got = tx_parallel.sharded_optimize(
        port_params(params), port_problem(problem), cpu_mesh((4, 2))
    )
    assert got.termination_reason == tx.TerminationReason.TERMINATION_REASON_OPTIMAL
    # PageRank vector: nonnegative, sums to one.
    assert got.primal_solution.sum() == pytest.approx(1.0, abs=1e-4)
    assert got.primal_solution.min() >= -1e-8
    want = jx_parallel.sharded_optimize(
        params, problem, jx_parallel.solver_mesh(4, 2)
    )
    assert_same_solve(got, want)


@pytest.mark.parametrize("fmt", ["auto", "sparse"])
def test_blocks_partition_the_matrix(fmt):
    """Every block holds m/D rows and n/P columns of A on its cell, and
    the blocks' entries add up to A's: nothing is replicated. The layout
    is build_linop's rule on the whole matrix (dense for this small LP
    under "auto", CsrOp for "sparse")."""
    problem = port_problem(generate_pagerank_lp(num_nodes=301, seed=2))
    mesh = cpu_mesh((4, 2))
    plan = plan_routed_shards(problem.num_constraints,
                              problem.num_variables,
                              problem.constraint_matrix.nnz, mesh)
    padded, _, _ = tx_parallel.pad_problem(problem, plan.row_multiple,
                                           plan.col_multiple)
    params = dataclasses.replace(
        port_params(pdhg_params(optimality_criteria(1e-4),
                                ruiz_iterations=10)),
        matrix_format=fmt,
    )
    prepared = tx_pdhg.prepare_problem(params, padded, _shard_plan=plan)
    op = prepared.bundle.scaled.constraint_matrix
    assert isinstance(op, ShardedRoutedOp) and op.mesh == mesh
    kind = DenseOp if fmt == "auto" else CsrOp
    m, n = padded.constraint_matrix.shape
    a = sp.csr_matrix(prepared.scaled_problem.scaled_qp.constraint_matrix)
    total = 0
    for d in range(4):
        for p in range(2):
            block = op.blocks[d][p]
            assert isinstance(block, kind)
            assert block.shape == (m // 4, n // 2)
            dense = (block.a if kind is DenseOp
                     else torch.sparse_csr_tensor(
                         block.fwd.indptr, block.fwd.indices,
                         block.fwd.vals, size=block.shape).to_dense())
            want = a[d * (m // 4):(d + 1) * (m // 4),
                     p * (n // 2):(p + 1) * (n // 2)].toarray()
            np.testing.assert_array_equal(dense.numpy(), want)
            total += int((dense != 0).sum())
    assert total == a.nnz


def test_make_placement_puts_every_vector_on_the_home_device():
    """The bundle's and the state's tensors go to the mesh's home device
    (here the `meta` device, so that a move shows); the operators stay
    where they were built."""
    problem = port_problem(generate_pagerank_lp(num_nodes=64, seed=0))
    mesh = cpu_mesh((2, 2))
    plan = plan_routed_shards(problem.num_constraints,
                              problem.num_variables,
                              problem.constraint_matrix.nnz, mesh)
    padded, _, _ = tx_parallel.pad_problem(problem, 2, 2)
    params = port_params(pdhg_params(optimality_criteria(1e-4)))
    prepared = tx_pdhg.prepare_problem(params, padded, _shard_plan=plan)
    home = tx_parallel.solver_mesh(1, 1, [torch.device("meta")])
    bundle, state = tx_parallel.make_placement(home)(
        prepared.bundle, prepared.initial_state
    )
    assert (bundle.scaled.constraint_matrix
            is prepared.bundle.scaled.constraint_matrix)
    assert (bundle.original.constraint_matrix
            is prepared.bundle.original.constraint_matrix)

    def tensors(obj, path="."):
        if isinstance(obj, torch.Tensor):
            yield path, obj
        elif isinstance(obj, ShardedRoutedOp):
            return
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                yield from tensors(getattr(obj, f.name), f"{path}.{f.name}")
        elif isinstance(obj, tuple):
            for i, v in enumerate(obj):
                yield from tensors(v, f"{path}[{i}]")

    moved = list(tensors(bundle)) + list(tensors(state))
    assert len(moved) > 20
    for path, t in moved:
        assert t.device.type == "meta", path
    for path, t in tensors(prepared.initial_state):
        assert t.device == CPU, path


def test_sharded_mirror_prox_matches_jax():
    problem = generate_pagerank_lp(num_nodes=64, seed=3)
    params = mp_params(optimality_criteria(1e-7), diagonal_scaling="l2",
                       ruiz_iterations=10, pock_chambolle_alpha=1.0)
    want = jx_parallel.sharded_optimize(
        params, problem, jx_parallel.solver_mesh(4, 2)
    )
    got = tx_parallel.sharded_optimize(
        port_mp_params(params), port_problem(problem), cpu_mesh((4, 2))
    )
    assert got.termination_reason == tx.TerminationReason.TERMINATION_REASON_OPTIMAL
    assert_same_solve(got, want)


def test_sharded_qp_matches_single_device():
    """A QP: the objective matrix stays whole on the home device. The
    JAX package's sharded_optimize cannot place a QP (its objective
    matrix's PartitionSpec('primal', 'primal') names one mesh axis
    twice, which NamedSharding refuses), so the port's sharded solve is
    held to the JAX package's single-device solve."""
    problem = example_qp()
    params = pdhg_params(optimality_criteria(1e-9))
    want = jx.optimize(params, problem)
    got = tx_parallel.sharded_optimize(
        port_params(params), port_problem(problem), cpu_mesh((2, 2))
    )
    assert got.termination_reason == tx.TerminationReason.TERMINATION_REASON_OPTIMAL
    assert_same_solve(got, want)
    np.testing.assert_allclose(got.primal_solution, [0.2, 0.8], atol=1e-7)


def test_mesh_rules():
    with pytest.raises(ValueError, match="need 8 devices"):
        tx_parallel.solver_mesh(4, 2, devices=[CPU] * 7)
    mesh = tx_parallel.default_solver_mesh([CPU] * 3)
    assert mesh.shape == (3, 1) and mesh.axis_names == ("dual", "primal")
    assert mesh.home_device == CPU and mesh.rank is None
    assert all(mesh.owns(d, 0) for d in range(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx_parallel.solver_mesh(1, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx_parallel.sharded_optimize(
                port_params(pdhg_params(optimality_criteria(1e-4))),
                port_problem(example_lp()),
                tx_parallel.default_solver_mesh(),
            )
