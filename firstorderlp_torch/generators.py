"""Synthetic LP instance generators (benchmark problem families).

Reference semantics:
- PageRank LP from Nesterov (2014) "Subgradient methods for huge-scale
  optimization problems" on Barabasi-Albert random graphs
  (benchmarking/generate_pagerank_lp.jl:35-73).
- L1-SVM LP from Zhu et al. (2003) "1-norm support vector machines",
  eq. (5), with column-normalized features and an intercept column
  (benchmarking/generate_l1_svm_lp.jl:45-72, 141-167).

Both produce canonical standard-form problems directly (no MPS round
trip needed). Copied from the JAX package's generators.py; its
device-generated fleet spec (pagerank_fleet_spec) builds a batch.FleetSpec
whose generators are torch functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .problem import QuadraticProgrammingProblem, linear_programming_problem


def barabasi_albert_graph(num_nodes: int, degree: int, seed: int = 0):
    """Preferential-attachment graph; returns a symmetric adjacency matrix
    (the reference uses LightGraphs' undirected barabasi_albert)."""
    if degree < 1 or degree >= num_nodes:
        raise ValueError("need 1 <= degree < num_nodes")
    rng = np.random.default_rng(seed)
    num_new = num_nodes - degree
    max_edges = degree * num_new
    sources = np.empty(max_edges, dtype=np.int64)
    targets = np.empty(max_edges, dtype=np.int64)
    # Attachment pool: nodes repeated once per incident edge. Preallocated;
    # the per-node work is a constant number of vectorized numpy calls
    # (oversample with replacement, keep the first `degree` distinct picks).
    pool = np.empty(2 * max_edges, dtype=np.int64)
    pool_len = 0
    num_edges = 0
    for v in range(degree, num_nodes):
        if pool_len == 0:
            # First new node connects to all initial nodes.
            chosen = np.arange(degree, dtype=np.int64)
        else:
            oversample = 4 * degree + 8
            picks = rng.integers(0, pool_len, size=oversample)
            cand = pool[picks]
            _, first_idx = np.unique(cand, return_index=True)
            if first_idx.size >= degree:
                chosen = cand[np.sort(first_idx)[:degree]]
            else:  # rare: fall back to exact without-replacement sampling
                uniq = np.unique(pool[:pool_len])
                chosen = rng.choice(
                    uniq, size=min(degree, uniq.size), replace=False
                )
        k = chosen.size
        sources[num_edges : num_edges + k] = v
        targets[num_edges : num_edges + k] = chosen
        pool[pool_len : pool_len + k] = v
        pool[pool_len + k : pool_len + 2 * k] = chosen
        pool_len += 2 * k
        num_edges += k
    sources = sources[:num_edges]
    targets = targets[:num_edges]
    rows = np.concatenate([sources, targets])
    cols = np.concatenate([targets, sources])
    data = np.ones(rows.shape[0])
    adj = sp.csr_matrix((data, (rows, cols)), shape=(num_nodes, num_nodes))
    adj.sum_duplicates()
    adj.data[:] = 1.0
    return adj


def pagerank_like_matrix(num_nodes: int, per_row: int = 7,
                         damping_factor: float = 0.99,
                         seed: int = 0) -> sp.csr_matrix:
    """A matrix with the structure of generate_pagerank_lp's constraint
    matrix, made in bulk with numpy (the graph above is a Python loop
    over the nodes): one dense row of sqrt(n), then I - d S for a random
    S with `per_row` entries in every row, at uniformly random columns
    (not by preferential attachment), each column scaled to sum 1.
    Shape (n + 1, n); about (per_row + 2) n entries."""
    n = int(num_nodes)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rng.integers(0, n, size=rows.size)
    adj = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    adj.sum_duplicates()
    col_sum = np.maximum(np.asarray(adj.sum(axis=0)).ravel(), 1.0)
    lower = sp.identity(n, format="csr") - damping_factor * (
        adj @ sp.diags(1.0 / col_sum)
    )
    top = sp.csr_matrix(np.full((1, n), np.sqrt(n)))
    return sp.vstack([top, lower], format="csr")


def generate_pagerank_lp(
    num_nodes: int,
    approx_num_edges: int | None = None,
    damping_factor: float = 0.99,
    seed: int = 0,
    _adjacency=None,
) -> QuadraticProgrammingProblem:
    """PageRank feasibility LP:

        find x s.t. d (S x)_i + (1-d)/n <= x_i,
                    sqrt(n) sum_i x_i = sqrt(n),  x >= 0

    where S is the column-stochastic transition matrix of the graph.
    Standard form: one equality row first, then n ">=" rows (I - d S).
    """
    if approx_num_edges is None:
        approx_num_edges = 3 * num_nodes
    degree = max(1, round(approx_num_edges / num_nodes))
    adj = (
        _adjacency
        if _adjacency is not None
        else barabasi_albert_graph(num_nodes, degree, seed)
    )
    degrees = np.asarray(adj.sum(axis=1)).ravel()
    degrees[degrees == 0] = 1.0
    # S[i, j] = adj[i, j] / degree(j).
    s = adj @ sp.diags(1.0 / degrees)
    n = num_nodes
    pagerank_rows = sp.identity(n, format="csc") - damping_factor * s
    equality_row = sp.csc_matrix(np.sqrt(n) * np.ones((1, n)))
    constraint_matrix = sp.vstack([equality_row, pagerank_rows], format="csc")
    right_hand_side = np.concatenate(
        [[np.sqrt(n)], ((1 - damping_factor) / n) * np.ones(n)]
    )
    return linear_programming_problem(
        np.zeros(n),
        np.full(n, np.inf),
        np.zeros(n),
        0.0,
        constraint_matrix,
        right_hand_side,
        1,
    )


def generate_pagerank_lp_fleet(
    num_nodes: int,
    damping_factors,
    approx_num_edges: int | None = None,
    seed: int = 0,
):
    """A fleet of PageRank LPs on ONE graph with varying damping factors.

    All instances share the sparsity pattern of A = [sqrt(n) 1'; I - d S]
    (the pattern of I - d S is independent of d for d != 0), which makes
    the fleet eligible for the shared-pattern batched solver
    (batch.solve_batch_shared_pattern): one gather schedule serves every
    instance. Typical scenario sweep for PageRank sensitivity analysis.
    """
    if approx_num_edges is None:
        approx_num_edges = 3 * num_nodes
    degree = max(1, round(approx_num_edges / num_nodes))
    adjacency = barabasi_albert_graph(num_nodes, degree, seed)
    return [
        generate_pagerank_lp(
            num_nodes=num_nodes,
            approx_num_edges=approx_num_edges,
            damping_factor=float(d),
            seed=seed,
            _adjacency=adjacency,
        )
        for d in damping_factors
    ]


def pagerank_fleet_spec(
    num_nodes: int,
    damping_factors,
    approx_num_edges: "int | None" = None,
    seed: int = 0,
):
    """A PageRank damping sweep generated on the device (a
    batch.FleetSpec).

    The whole fleet is an affine function of the damping factor d:
    A(d) = [sqrt(n) 1'; I - d S] and b(d) = [sqrt(n); (1-d)/n 1], so the
    spec holds ONE base problem plus the per-entry coefficients (p, q)
    with A(d).data = p + d q, O(nnz) numbers instead of the (nnz, B)
    value planes. The coefficients come from two instances of the same
    constructor (same CSR entry order), as in the JAX package's
    pagerank_fleet_spec, and the generators compute in f32 as it does.
    Damping 0 is refused: I - 0 S loses the S entries, so the pattern
    changes.
    """
    from .batch import FleetSpec

    damping = np.asarray(list(damping_factors), dtype=np.float64)
    if damping.ndim != 1 or damping.size == 0:
        raise ValueError("damping_factors must be a nonempty 1-D list")
    if np.any(damping == 0.0):
        raise ValueError(
            "damping factor 0 changes the sparsity pattern (I - d S "
            "loses the S entries); use generate_pagerank_lp_fleet"
        )
    if approx_num_edges is None:
        approx_num_edges = 3 * num_nodes
    degree = max(1, round(approx_num_edges / num_nodes))
    adjacency = barabasi_albert_graph(num_nodes, degree, seed)

    def instance(d):
        return generate_pagerank_lp(
            num_nodes=num_nodes,
            approx_num_edges=approx_num_edges,
            damping_factor=float(d),
            seed=seed,
            _adjacency=adjacency,
        )

    d1, d2 = 0.5, 0.75
    base = instance(float(damping[0]))
    a1 = sp.csr_matrix(instance(d1).constraint_matrix)
    a1.sum_duplicates()
    a2 = sp.csr_matrix(instance(d2).constraint_matrix)
    a2.sum_duplicates()
    q = (a2.data - a1.data) / (d2 - d1)
    p = a1.data - d1 * q
    n = num_nodes
    rhs_p = np.concatenate([[np.sqrt(n)], np.full(n, 1.0 / n)])
    rhs_q = np.concatenate([[0.0], np.full(n, -1.0 / n)])
    # host (numpy) constants, moved to the lane's device when generated
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    rhs_p32, rhs_q32 = rhs_p.astype(np.float32), rhs_q.astype(np.float32)

    def affine(p_host, q_host):
        def generate(d):
            dev = d.device
            return (torch.as_tensor(p_host, device=dev)
                    + d.to(torch.float32) * torch.as_tensor(q_host,
                                                            device=dev))
        return generate

    return FleetSpec(
        base_problem=base,
        thetas=damping,
        matrix_values=affine(p32, q32),
        right_hand_side=affine(rhs_p32, rhs_q32),
    )


@dataclasses.dataclass
class SvmTrainingData:
    feature_matrix: sp.csc_matrix  # (n_samples, n_features)
    labels: np.ndarray  # +-1


def load_libsvm_file(file_name: str) -> SvmTrainingData:
    """Parses LIBSVM sparse format; labels mapped to {-1, +1}
    (reference generate_l1_svm_lp.jl:103-139)."""
    labels = []
    rows, cols, vals = [], [], []
    found_label_one = False
    with open(file_name) as f:
        for row_index, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            label = float(parts[0])
            if label == 1.0:
                found_label_one = True
            else:
                label = -1.0
            labels.append(label)
            for item in parts[1:]:
                col, val = item.split(":")
                rows.append(row_index)
                cols.append(int(col) - 1)
                vals.append(float(val))
    assert found_label_one, "no +1 labels found"
    n = len(labels)
    d = max(cols) + 1 if cols else 0
    return SvmTrainingData(
        feature_matrix=sp.csc_matrix((vals, (rows, cols)), shape=(n, d)),
        labels=np.asarray(labels),
    )


def preprocess_training_data(data: SvmTrainingData) -> SvmTrainingData:
    """Drop empty feature columns, add an intercept column, normalize
    columns to unit L2 norm (reference l.141-168)."""
    x = sp.csc_matrix(data.feature_matrix)
    nnz_per_col = np.diff(x.indptr)
    x = x[:, nnz_per_col > 0]
    intercept = sp.csc_matrix(np.ones((x.shape[0], 1)))
    x = sp.hstack([intercept, x], format="csc")
    col_norms = np.sqrt(np.asarray(x.multiply(x).sum(axis=0)).ravel())
    col_norms[col_norms == 0] = 1.0
    x = sp.csc_matrix(x @ sp.diags(1.0 / col_norms))
    return SvmTrainingData(feature_matrix=x, labels=data.labels)


def random_svm_data(
    n_samples: int, n_features: int, density: float = 0.1, seed: int = 0
) -> SvmTrainingData:
    """Synthetic LIBSVM-style dataset (separable with noise) for tests and
    benchmarks in a zero-egress environment."""
    rng = np.random.default_rng(seed)
    true_beta = rng.standard_normal(n_features)
    x = sp.random(
        n_samples,
        n_features,
        density=density,
        random_state=np.random.RandomState(seed),
        data_rvs=rng.standard_normal,
        format="csc",
    )
    margin = x @ true_beta + 0.3 * rng.standard_normal(n_samples)
    labels = np.where(margin >= 0, 1.0, -1.0)
    return SvmTrainingData(feature_matrix=x, labels=labels)


def generate_l1_svm_lp(
    data: SvmTrainingData, regularizer_weight: float = 1.0
) -> QuadraticProgrammingProblem:
    """L1-SVM LP (Zhu et al. 2003, eq. (5)):

        min  sum_i w_i + lambda sum_j z_j
        s.t. w >= 1 - diag(y) X beta,  w >= 0,  z >= beta,  z >= -beta

    Variables ordered [beta (d); w (n); z (d)]; all rows are ">=".
    """
    data = preprocess_training_data(data)
    x = data.feature_matrix
    n, d = x.shape
    yx = sp.diags(data.labels) @ x  # (n, d)

    eye_d = sp.identity(d, format="csc")
    zeros_nd = sp.csc_matrix((n, d))
    zeros_dn = sp.csc_matrix((d, n))
    eye_n = sp.identity(n, format="csc")

    # Rows: [z - beta >= 0], [z + beta >= 0], [w + diag(y) X beta >= 1].
    block = sp.vstack(
        [
            sp.hstack([-eye_d, zeros_dn, eye_d]),
            sp.hstack([eye_d, zeros_dn, eye_d]),
            sp.hstack([yx, eye_n, zeros_nd]),
        ],
        format="csc",
    )
    rhs = np.concatenate([np.zeros(d), np.zeros(d), np.ones(n)])
    lower = np.concatenate(
        [np.full(d, -np.inf), np.zeros(n), np.full(d, -np.inf)]
    )
    upper = np.full(2 * d + n, np.inf)
    objective = np.concatenate(
        [np.zeros(d), np.ones(n), regularizer_weight * np.ones(d)]
    )
    return linear_programming_problem(
        lower, upper, objective, 0.0, block, rhs, 0
    )
