"""Generates an L1-SVM LP (.mps/.mps.gz) from a LIBSVM file.

Mirrors the reference benchmarking/generate_l1_svm_lp.jl CLI and the
JAX package's cli/generate_l1_svm_lp.py (the same bytes for the same
flags):
    python -m firstorderlp_torch.cli.generate_l1_svm_lp \
        --input_filename data/duke.tr --output_filename /tmp/duke.mps.gz \
        --regularizer_weight 1.5

With --synthetic n_samples,n_features a random dataset is generated
instead (for machines without LIBSVM downloads).
"""

import argparse


def main(argv=None):
    """Runs the generator on `argv` (default: the command line)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_filename", default=None)
    p.add_argument("--synthetic", default=None,
                   help="n_samples,n_features for a synthetic dataset")
    p.add_argument("--output_filename", required=True)
    p.add_argument("--regularizer_weight", type=float, required=True)
    p.add_argument("--random_seed", type=int, default=0)
    args = p.parse_args(argv)

    from firstorderlp_torch.generators import (
        generate_l1_svm_lp,
        load_libsvm_file,
        random_svm_data,
    )
    from firstorderlp_torch.io.mps_writer import write_mps

    if args.input_filename:
        data = load_libsvm_file(args.input_filename)
    elif args.synthetic:
        n_samples, n_features = map(int, args.synthetic.split(","))
        data = random_svm_data(n_samples, n_features, seed=args.random_seed)
    else:
        raise SystemExit("provide --input_filename or --synthetic")

    problem = generate_l1_svm_lp(data, args.regularizer_weight)
    write_mps(problem, args.output_filename, name="l1_svm")


if __name__ == "__main__":
    main()
