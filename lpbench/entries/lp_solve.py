"""One LP, ingested once at set-up, solved to the end again and again:
a closed loop of one client. The timed call is the solver's own
optimize on the prepared problem (models/pdhg.optimize or
models/mirror_prox.optimize; models/api.optimize takes no prepared
problem)."""

from __future__ import annotations

import firstorderlp_torch as pkg
from firstorderlp_torch.models import mirror_prox, pdhg

from lpbench import solver_params
from lpbench.port_io import port_problem, reported, status

SOLVERS = {"pdhg": pdhg, "mirror-prox": mirror_prox}


class Session:
    """`spans(name)`: a context that times a set-up step on the host
    clock up to a device synchronize, under the per-layer metric's
    name."""

    expected = 1  # answers a solve owes

    def __init__(self, config, traffic, lp, device, spans):
        self.lp = lp
        self.module = SOLVERS[traffic["solver"]]
        self.params = solver_params.build(pkg, traffic, config)
        self.problem = port_problem(lp)
        with spans("ingest_s.lp"):
            self.prepared = self.module.prepare_problem(
                self.params, self.problem, device=device)
        with spans("first_solve_s.lp"):
            self.first = self._solve()

    def _solve(self):
        out = self.module.optimize(self.params, self.problem,
                                   prepared=self.prepared)
        stats = out.iteration_stats[-1]
        return {
            "iterations": int(out.iteration_count),
            "kkt_passes": float(stats.cumulative_kkt_matrix_passes),
            "answers": [(0, status(out), out.primal_solution,
                         out.dual_solution)],
            "reported": [reported(out)],
        }

    def solve(self):
        return self._solve()

    def lp_of(self, index: int):
        return self.lp

    def close(self):
        self.prepared = None
