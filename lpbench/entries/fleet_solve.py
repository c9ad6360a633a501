"""A fleet of LPs that share one sparsity pattern (a PageRank damping
sweep, lpbench/generators/pagerank_sweep.py), ingested once at set-up
and solved whole again and again: a closed loop of one client. The timed
call is the port's batch.solve_batch_shared_pattern(params, spec,
fleet=prepared), `spec` the port's generators.pagerank_fleet_spec over
the benchmark's graph with the lanes in the sweep's order, `prepared`
its batch.prepare_shared_pattern_fleet.

A solve owes one answer a lane, indexed by its damping factor's place in
the sweep. Its `iterations` are the sum of every lane's own iterations
(a lane is a solve), its `kkt_passes` the sum of their passes. Beside
them: each lane's iterations and passes (in lane order), the call's
batch.FleetRunStats, and the change of the program's counters
(firstorderlp_torch.spans.COUNTS) over the call, empty for a program
without them. At close, one line on standard output: each damping
factor's iterations in the warm solve, and the window's fleet counts."""

from __future__ import annotations

import dataclasses
import json

import firstorderlp_torch as pkg
from firstorderlp_torch import batch, generators

from lpbench import solver_params
from lpbench.port_io import reported, status


def _counts() -> dict:
    try:
        from firstorderlp_torch.spans import COUNTS
    except ImportError:
        return {}
    return dict(COUNTS)


class Session:
    """`spans(name)`: a context that times a set-up step on the host
    clock up to a device synchronize."""

    def __init__(self, config, traffic, sweep, device, spans):
        self.sweep = sweep
        self.expected = sweep.lanes  # answers a solve owes
        self.params = solver_params.build(pkg, traffic, config)
        with spans("spec_s.fleet"):
            self.spec = generators.pagerank_fleet_spec(
                config["num_nodes"], sweep.dampings[sweep.order],
                approx_num_edges=config["approx_num_edges"],
                seed=config["graph_seed"], _adjacency=sweep.adjacency)
        with spans("ingest_s.fleet"):
            self.prepared = batch.prepare_shared_pattern_fleet(
                self.params, self.spec, device=device)
        self.window = []
        with spans("first_solve_s.fleet"):
            self.first = self._solve()

    def _solve(self):
        run_stats = batch.FleetRunStats()
        before = _counts()
        outs = batch.solve_batch_shared_pattern(
            self.params, self.spec, fleet=self.prepared,
            run_stats=run_stats)
        after = _counts()
        answers, reports, iterations, passes = [], [], [], []
        for lane, out in enumerate(outs):
            answers.append((int(self.sweep.order[lane]), status(out),
                            out.primal_solution, out.dual_solution))
            reports.append(reported(out))
            iterations.append(int(out.iteration_count))
            passes.append(float(
                out.iteration_stats[-1].cumulative_kkt_matrix_passes))
        return {
            "iterations": sum(iterations),
            "kkt_passes": sum(passes),
            "lane_iterations": iterations,
            "lane_kkt_passes": passes,
            "run_stats": dataclasses.asdict(run_stats),
            "counts": {k: v - before.get(k, 0) for k, v in after.items()},
            "answers": answers,
            "reported": reports,
        }

    def solve(self):
        out = self._solve()
        self.window.append(out)
        return out

    def lp_of(self, index: int):
        return self.sweep.lp(index)

    def close(self):
        by_damping = [0] * self.sweep.lanes
        for k, iterations in zip(self.sweep.order,
                                 self.first["lane_iterations"]):
            by_damping[int(k)] = iterations
        window = {}
        for s in self.window:
            for key, value in {**s["run_stats"], **s["counts"]}.items():
                window[key] = window.get(key, 0) + value
        print(json.dumps({
            "fleet": {
                "damping": [float(self.sweep.dampings[0]),
                            float(self.sweep.dampings[-1]),
                            self.sweep.lanes],
                "warm_lane_iterations_by_damping": by_damping,
                "warm_run_stats": self.first["run_stats"],
                "window_solves": len(self.window),
                "window_counts": window,
            }}), flush=True)
        self.prepared = None
