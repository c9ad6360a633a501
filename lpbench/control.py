"""Reads the two ends a limit of `correct` is set between, at a cell's
own size, on the graph each seed draws (the cell itself solves the
configuration's one graph): the control (reference/control.py: the
reference in bfloat16 put in the program's place), its f32 twin, and
the program's sound answers, solved as the cell's set-up solves them.
One line a seed and answer, each number judged beside its limit as a
run's checks are:

    python3 lpbench/control.py --workload <cell> --seeds 1 2 3 \
        [--answers bfloat16 float32 program]

The benchmark's own runs do not run it."""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import argparse
    import json
    import time

    import torch

    from lpbench import harness, registry
    from lpbench.reference import control, judge

    p = argparse.ArgumentParser(prog="lpbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--answers", nargs="+", default=["bfloat16"],
                   choices=["bfloat16", "float32", "program"])
    args = p.parse_args(argv)
    cell = registry.cell(args.workload)
    traffic = registry.traffic(cell["traffic"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        config = {**registry.config(cell["config"]), "graph_seed": seed}
        generator = registry.generator(config["generator"])
        lp = generator.make(config, seed)
        x_ref = generator.solution(config, lp, device)
        for who in args.answers:
            t0 = time.time()
            extra = {}
            if who == "program":
                entry = registry.entry(traffic["entry"])
                spans = harness.Spans(torch.cuda.synchronize
                                      if device == "cuda" else lambda: None)
                session = entry.Session(config, traffic, lp, device, spans)
                answers = session.first["answers"]
                extra = {"iterations": session.first["iterations"],
                         "spans_s": spans.seconds}
                session.close()
            else:
                x, y = control.answer(lp, config["damping_factor"],
                                      getattr(torch, who), device)
                answers = [(0, "OPTIMAL", x, y)]
            verdict = judge.judge(
                [answers], 1, lambda i: lp, float(traffic["residual_limit"]),
                lambda i: x_ref, float(traffic["l1_error_limit"]))
            print(json.dumps({
                "workload": args.workload, "seed": seed, "answers": who,
                "device": device, "correct": judge.passed(verdict["checks"]),
                "seconds": time.time() - t0, **extra,
                "checks": verdict["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
