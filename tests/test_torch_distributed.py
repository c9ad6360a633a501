"""The port's torch.distributed layer (parallel/distributed.py) on the
CPU: two gloo processes form one process group, each owns one block of
a (2, 1) or (1, 2) mesh, and distributed_optimize solves the 150-node
PageRank LP. Both ranks must give the same bits, and those bits must be
the single-process mesh's (sharded_optimize on a mesh of `cpu` devices
in this process). The workers import no JAX.

Besides: a two-rank solve stopped by time_sec_limit, with one rank's
clock running three times as fast, stops both ranks at the same
iteration (rank 0's clock decides) and does not hang; the
single-process entry (initialize() is a no-op) against the JAX
package's; and the import rule of the multi-device modules.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import TerminationCriteria
from firstorderlp_tpu.generators import generate_pagerank_lp
from firstorderlp_tpu.parallel import distributed as jx_distributed

from firstorderlp_torch import parallel as tx_parallel
from firstorderlp_torch.parallel import distributed as tx_distributed

from test_mirror_prox import mp_params
from test_torch_mirror_prox import port_mp_params
from test_torch_pdhg import port_params, port_problem
from utils import optimality_criteria, pdhg_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WORKER_TIMEOUT = 240  # seconds; a rank that waits forever fails the test

WORKER = r"""
import pickle, sys, time
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from firstorderlp_torch.models import common
from firstorderlp_torch.parallel import distributed as D

rank, world, port = (int(a) for a in sys.argv[1:4])
case_path, out_path = sys.argv[4:6]
with open(case_path, "rb") as f:
    case = pickle.load(f)
if case["fast_clock_rank"] == rank:
    start, real = time.time(), time.time

    class FastClock:
        @staticmethod
        def time():
            return start + 3.0 * (real() - start)

    common.time = FastClock
D.initialize(f"localhost:{port}", world, rank)
n_dual, n_primal = case["mesh"]
out = D.distributed_optimize(case["params"], case["problem"], n_dual,
                             n_primal, device="cpu")
np.savez(out_path, primal=out.primal_solution, dual=out.dual_solution,
         iterations=out.iteration_count,
         reason=out.termination_reason.name)
dist.destroy_process_group()
assert "jax" not in sys.modules, "a worker imported jax"
print("RESULT", rank, out.termination_reason.name, out.iteration_count)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, params, problem, mesh, fast_clock_rank=None):
    """Runs the two-rank solve; returns each rank's saved result."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    case = tmp_path / "case.pkl"
    with open(case, "wb") as f:
        pickle.dump({"params": params, "problem": problem, "mesh": mesh,
                     "fast_clock_rank": fast_clock_rank}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(rank), "2", port, str(case),
             str(tmp_path / f"rank{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path),
        )
        for rank in range(2)
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
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]


def assert_bitwise(a, b):
    assert str(a["reason"]) == str(b["reason"])
    assert int(a["iterations"]) == int(b["iterations"])
    np.testing.assert_array_equal(a["primal"], b["primal"])
    np.testing.assert_array_equal(a["dual"], b["dual"])


def as_record(out):
    return {"primal": out.primal_solution, "dual": out.dual_solution,
            "iterations": out.iteration_count,
            "reason": out.termination_reason.name}


def single_process(params, problem, mesh):
    """The same solve on a single-process mesh of `cpu` devices, with one
    intra-op thread as the workers have."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return as_record(tx_parallel.sharded_optimize(
            params, problem,
            tx_parallel.solver_mesh(*mesh, devices=[CPU] * 2),
        ))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("solver,mesh", [
    ("pdhg", (2, 1)), ("pdhg", (1, 2)), ("mirror_prox", (2, 1)),
])
def test_two_gloo_ranks_match_the_single_process_mesh(tmp_path, solver,
                                                      mesh):
    problem = port_problem(generate_pagerank_lp(num_nodes=150, seed=0))
    criteria = optimality_criteria(1e-6)
    if solver == "pdhg":
        params = port_params(pdhg_params(criteria, ruiz_iterations=10))
    else:
        params = port_mp_params(mp_params(criteria, diagonal_scaling="l2",
                                          ruiz_iterations=10))
    params = dataclasses.replace(params, matrix_format="sparse")
    ranks = run_ranks(tmp_path, params, problem, mesh)
    assert str(ranks[0]["reason"]) == "TERMINATION_REASON_OPTIMAL"
    assert_bitwise(ranks[0], ranks[1])
    assert_bitwise(ranks[0], single_process(params, problem, mesh))


def test_time_limit_stops_both_ranks_together(tmp_path):
    """Rank 1's clock runs three times as fast. Alone it would stop at a
    third of the limit while rank 0 waits in a gather; with rank 0's
    reading on both, both stop at the same evaluation."""
    problem = port_problem(generate_pagerank_lp(num_nodes=150, seed=0))
    criteria = TerminationCriteria(
        eps_optimal_absolute=0.0, eps_optimal_relative=0.0,
        eps_primal_infeasible=0.0, eps_dual_infeasible=0.0,
        time_sec_limit=1.5, iteration_limit=10**9,
    )
    params = dataclasses.replace(
        port_params(pdhg_params(criteria, ruiz_iterations=10)),
        matrix_format="sparse",
    )
    ranks = run_ranks(tmp_path, params, problem, (2, 1), fast_clock_rank=1)
    assert str(ranks[0]["reason"]) == "TERMINATION_REASON_TIME_LIMIT"
    assert int(ranks[0]["iterations"]) > 0
    assert_bitwise(ranks[0], ranks[1])


def test_distributed_single_process_entry(monkeypatch):
    """With no process group and no torchrun environment initialize()
    does nothing, and the global mesh is the local one."""
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    tx_distributed.initialize()
    assert not torch.distributed.is_initialized()
    mesh = tx_distributed.global_solver_mesh(n_dual=4, n_primal=2,
                                             device="cpu")
    assert mesh.shape == (4, 2) and mesh.rank is None
    problem = generate_pagerank_lp(num_nodes=150, seed=0)
    params = pdhg_params(optimality_criteria(1e-6), ruiz_iterations=10)
    got = tx_distributed.distributed_optimize(
        port_params(params), port_problem(problem), n_dual=4, n_primal=2,
        device="cpu",
    )
    jx_distributed.initialize()
    want = jx_distributed.distributed_optimize(params, problem, n_dual=4,
                                               n_primal=2)
    assert got.termination_reason.name == want.termination_reason.name
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=1e-7)
    single = jx.optimize(params, problem)
    np.testing.assert_allclose(got.primal_solution, single.primal_solution,
                               atol=1e-7)


def test_multi_device_modules_import_no_jax():
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import firstorderlp_torch.parallel.distributed, "
         "firstorderlp_torch.ops.routed_sharded, "
         "firstorderlp_torch.parallel.shard_ingest"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    modules = [line.split("|")[-1].strip()
               for line in proc.stderr.splitlines()
               if line.startswith("import time:")]
    assert "firstorderlp_torch.parallel.distributed" in modules
    assert "firstorderlp_torch.parallel.shard_ingest" in modules
    assert not [m for m in modules
                if m.split(".")[0] in ("jax", "jaxlib", "firstorderlp_tpu")]
