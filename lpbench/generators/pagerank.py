"""One PageRank LP (lpbench/pagerank.py) from a configuration's
num_nodes, approx_num_edges, damping_factor and graph_seed. The graph is
the configuration's own, as a deployment solves its one graph: a run's
seed draws nothing, since a relabelling of the nodes (the only order a
single LP has) changes the PDHG iterations a solve, and so the work."""

from lpbench import pagerank


def make(config: dict, seed: int):
    del seed
    return pagerank.pagerank_lp(config["num_nodes"],
                                config["approx_num_edges"],
                                config["damping_factor"],
                                config["graph_seed"])


def solution(config: dict, lp, device):
    """The reference's x of `lp`: its PageRank vector in f64."""
    from lpbench.reference import pagerank as reference

    return reference.solution(lp, config["damping_factor"], device)
