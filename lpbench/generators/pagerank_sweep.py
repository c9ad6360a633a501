"""A PageRank damping sweep from a configuration's num_nodes,
approx_num_edges, graph_seed, lanes, damping_min and damping_max: one
graph (lpbench/pagerank.adjacency) and, for each damping factor of
linspace(damping_min, damping_max, lanes), its PageRank LP in f64, built
as lpbench/pagerank.pagerank_lp builds it. The graph is the
configuration's own; a run's seed only permutes the damping factors over
the lanes, which leaves every lane's work as it is."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lpbench import pagerank
from lpbench.lp import Lp


class LaneLp(Lp):
    """One damping factor's LP, with the factor the reference needs."""

    def __init__(self, *, damping_factor: float, **fields):
        super().__init__(**fields)
        self.damping_factor = damping_factor


class Sweep:
    """The sweep a cell solves. Damping k is dampings[k] (index k is the
    answer's index); lane j of the fleet solves damping order[j]. Each
    damping's LP is built on first use and kept."""

    def __init__(self, adjacency, degrees, dampings, order):
        self.adjacency = adjacency
        self.dampings = np.asarray(dampings, dtype=np.float64)
        self.order = np.asarray(order, dtype=np.int64)
        self.lanes = int(self.dampings.size)
        n = adjacency.shape[0]
        self._s = adjacency @ sp.diags(1.0 / np.maximum(degrees, 1.0))
        self._top = sp.csr_matrix(np.full((1, n), np.sqrt(n)))
        self._lps = {}

    @property
    def shape(self):
        n = self.adjacency.shape[0]
        return (n + 1, n)

    @property
    def constraint_matrix(self):
        """The pattern every lane shares (damping 0's values)."""
        return self.lp(0).constraint_matrix

    def lp(self, index: int) -> LaneLp:
        if index not in self._lps:
            d = float(self.dampings[index])
            n = self.adjacency.shape[0]
            lower = (sp.identity(n, format="csr") - d * self._s).tocsr()
            lower.sort_indices()
            self._lps[index] = LaneLp(
                constraint_matrix=sp.vstack([self._top, lower],
                                            format="csr"),
                right_hand_side=np.concatenate(
                    [[np.sqrt(n)], np.full(n, (1.0 - d) / n)]),
                objective_vector=np.zeros(n),
                variable_lower_bound=np.zeros(n),
                variable_upper_bound=np.full(n, np.inf),
                objective_constant=0.0,
                num_equalities=1,
                damping_factor=d)
        return self._lps[index]


def dampings(config: dict) -> np.ndarray:
    return np.linspace(float(config["damping_min"]),
                       float(config["damping_max"]), int(config["lanes"]))


def make(config: dict, seed: int) -> Sweep:
    adj, deg = pagerank.adjacency(config["num_nodes"],
                                  config["approx_num_edges"],
                                  config["graph_seed"])
    rng = np.random.default_rng(int(seed) % 2**64)  # any whole number
    return Sweep(adj, deg, dampings(config),
                 rng.permutation(int(config["lanes"])))


def solution(config: dict, lp: LaneLp, device):
    """The reference's x of `lp`: its PageRank vector in f64."""
    from lpbench.reference import pagerank as reference

    return reference.solution(lp, lp.damping_factor, device)
