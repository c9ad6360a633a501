"""Generates a PageRank LP (.mps/.mps.gz) on a Barabasi-Albert graph.

Mirrors the reference benchmarking/generate_pagerank_lp.jl CLI and the
JAX package's cli/generate_pagerank_lp.py (the same bytes for the same
flags):
    python -m firstorderlp_torch.cli.generate_pagerank_lp \
        --num_nodes 10000 --approx_num_edges 30000 \
        --output_filename /tmp/pagerank.10k.mps.gz
"""

import argparse


def main(argv=None):
    """Runs the generator on `argv` (default: the command line)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_nodes", type=int, required=True)
    p.add_argument("--approx_num_edges", type=int, required=True)
    p.add_argument("--output_filename", required=True)
    p.add_argument("--damping_factor", type=float, default=0.99)
    p.add_argument("--random_seed", type=int, default=0)
    args = p.parse_args(argv)

    from firstorderlp_torch.generators import generate_pagerank_lp
    from firstorderlp_torch.io.mps_writer import write_mps

    problem = generate_pagerank_lp(
        num_nodes=args.num_nodes,
        approx_num_edges=args.approx_num_edges,
        damping_factor=args.damping_factor,
        seed=args.random_seed,
    )
    write_mps(problem, args.output_filename, name="pagerank")


if __name__ == "__main__":
    main()
