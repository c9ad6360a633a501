"""PageRank feasibility LPs (Nesterov 2014, "Subgradient methods for
huge-scale optimization problems"), assembled as FirstOrderLp.jl's
benchmarking/generate_pagerank_lp.jl assembles them:

    find x  s.t.  sqrt(n) sum_i x_i = sqrt(n),
                  x_i - d (S x)_i >= (1 - d) / n,   x >= 0,

S the column-stochastic transition matrix of an undirected
Barabasi-Albert graph (S_ij = adj_ij / degree_j). One equality row
first, then the n rows of I - d S. Feasible x is the PageRank vector.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import barabasi_albert
from .lp import Lp


def adjacency(num_nodes: int, approx_num_edges: int, seed: int):
    """The graph's symmetric 0/1 adjacency (CSR) and its degrees."""
    n = int(num_nodes)
    degree = max(1, round(approx_num_edges / n))
    rng = np.random.default_rng(int(seed) % 2**64)  # any whole number
    src, dst = barabasi_albert.edges(n, degree, rng)
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    adj = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    adj.sum_duplicates()
    adj.sort_indices()
    deg = np.diff(adj.indptr).astype(np.float64)
    return adj, deg


def pagerank_lp(num_nodes: int, approx_num_edges: int, damping: float,
                seed: int) -> Lp:
    adj, deg = adjacency(num_nodes, approx_num_edges, seed)
    n = adj.shape[0]
    s = adj @ sp.diags(1.0 / np.maximum(deg, 1.0))
    lower = (sp.identity(n, format="csr") - damping * s).tocsr()
    lower.sort_indices()
    top = sp.csr_matrix(np.full((1, n), np.sqrt(n)))
    return Lp(constraint_matrix=sp.vstack([top, lower], format="csr"),
              right_hand_side=np.concatenate(
                  [[np.sqrt(n)], np.full(n, (1.0 - damping) / n)]),
              objective_vector=np.zeros(n),
              variable_lower_bound=np.zeros(n),
              variable_upper_bound=np.full(n, np.inf),
              objective_constant=0.0,
              num_equalities=1)
