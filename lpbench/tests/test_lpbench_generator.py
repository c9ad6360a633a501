import numpy as np
import pytest
import scipy.sparse as sp

from lpbench import barabasi_albert, pagerank


def _lower_s(lp, damping):
    n = lp.shape[1]
    return (sp.identity(n) - lp.constraint_matrix[1:]) / damping


@pytest.mark.parametrize("n", [50, 2000, 20000])
def test_shape_nonzeros_and_stochastic(n):
    lp = pagerank.pagerank_lp(n, 3 * n, 0.99, seed=2**31 + 11)
    a = lp.constraint_matrix
    assert a.shape == (n + 1, n)
    # dense row, diagonal, two entries an edge
    assert a.nnz == n + n + 2 * 3 * (n - 3)
    s = _lower_s(lp, 0.99)
    np.testing.assert_allclose(np.asarray(s.sum(axis=0)).ravel(), 1.0,
                               rtol=1e-12)
    assert lp.num_equalities == 1
    np.testing.assert_allclose(lp.right_hand_side[0], np.sqrt(n))
    np.testing.assert_allclose(lp.right_hand_side[1:], 0.01 / n)


def test_edges_per_node_distinct_and_earlier():
    rng = np.random.default_rng(5)
    src, dst = barabasi_albert.edges(5000, 3, rng)
    assert src.size == 3 * (5000 - 3)
    assert np.all(dst < src)
    per = dst.reshape(-1, 3)
    assert np.all(np.sort(per, axis=1)[:, 1:] != np.sort(per, axis=1)[:, :-1])
    np.testing.assert_array_equal(per[0], [0, 1, 2])


def test_same_seed_same_lp_other_seed_other_lp():
    a = pagerank.pagerank_lp(3000, 9000, 0.99, seed=4294967297)
    b = pagerank.pagerank_lp(3000, 9000, 0.99, seed=4294967297)
    c = pagerank.pagerank_lp(3000, 9000, 0.99, seed=4294967298)
    assert (a.constraint_matrix != b.constraint_matrix).nnz == 0
    assert (a.constraint_matrix != c.constraint_matrix).nnz > 0


def test_degree_tail_matches_the_ports_generator():
    from firstorderlp_torch import generators

    n, seeds = 10000, range(4)
    ks = np.array([5, 10, 20, 40])

    def tail(adj_degrees):
        return np.array([(adj_degrees >= k).mean() for k in ks])

    ours, ports = [], []
    for seed in seeds:
        lp = pagerank.pagerank_lp(n, 3 * n, 0.99, seed=seed)
        ours.append(tail(np.diff(lp.constraint_matrix.indptr)[1:] - 1))
        port = generators.generate_pagerank_lp(n, seed=seed)
        ports.append(tail(np.diff(port.constraint_matrix.tocsr().indptr)[1:]
                          - 1))
    ours, ports = np.mean(ours, axis=0), np.mean(ports, axis=0)
    # the share of nodes of degree >= k, the tail's noise growing with k
    assert np.all(np.abs(ours / ports - 1) <= [0.03, 0.05, 0.1, 0.2]), (
        ours, ports)


def test_the_cells_graph_is_the_configurations_not_the_runs_seed():
    from lpbench import registry

    config = {**registry.config("pagerank-1m"), "num_nodes": 1500,
              "approx_num_edges": 4500}
    make = registry.generator(config["generator"]).make
    a, b = make(config, 1), make(config, 2**33 + 5)
    c = make({**config, "graph_seed": 1}, 1)
    assert (a.constraint_matrix != b.constraint_matrix).nnz == 0
    assert (a.constraint_matrix != c.constraint_matrix).nnz > 0
