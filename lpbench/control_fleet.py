"""The fleet twin of lpbench/control.py: reads the two ends a limit of
`correct` is set between for a damping-sweep cell, at its own size, on
the graph each seed draws (the cell itself solves the configuration's
one graph, graph_seed 0): the control (reference/control.py: the
reference in bfloat16 put in the program's place) in every lane, its f32
twin, and the program's sound answers, the fleet solved as the cell's
set-up solves it. One line a seed and answer: every lane judged as a
run's checks are, and each lane's primal_l1_error and
rel_primal_residual in the sweep's order of damping factors:

    python3 lpbench/control_fleet.py --workload <cell> --seeds 0 1 \\
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

    p = argparse.ArgumentParser(prog="lpbench/control_fleet.py")
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
        sweep = generator.make(config, seed)
        t0 = time.time()
        x_ref = [generator.solution(config, sweep.lp(k), device)
                 for k in range(sweep.lanes)]
        reference_s = time.time() - t0
        for who in args.answers:
            t0 = time.time()
            extra = {}
            if who == "program":
                entry = registry.entry(traffic["entry"])
                spans = harness.Spans(torch.cuda.synchronize
                                      if device == "cuda" else lambda: None)
                session = entry.Session(config, traffic, sweep, device,
                                        spans)
                answers = session.first["answers"]
                by_damping = [0] * sweep.lanes
                for lane, k in enumerate(sweep.order):
                    by_damping[int(k)] = session.first["lane_iterations"][
                        lane]
                extra = {"iterations_by_damping": by_damping,
                         "spans_s": spans.seconds}
                session.prepared = None
            else:
                answers = [
                    (k, "OPTIMAL", *control.answer(
                        sweep.lp(k), float(sweep.dampings[k]),
                        getattr(torch, who), device))
                    for k in range(sweep.lanes)]
            verdict = judge.judge(
                [answers], sweep.lanes, sweep.lp,
                float(traffic["residual_limit"]), lambda k: x_ref[k],
                float(traffic["l1_error_limit"]))
            per_lane = {}
            for (k, _), res in verdict["residuals"].items():
                per_lane[k] = res
            print(json.dumps({
                "workload": args.workload, "seed": seed, "answers": who,
                "device": device, "correct": judge.passed(verdict["checks"]),
                "seconds": time.time() - t0, "reference_s": reference_s,
                **extra, "checks": verdict["checks"],
                "l1_by_damping": [per_lane[k][judge.L1]
                                  for k in range(sweep.lanes)],
                "rel_primal_by_damping": [
                    per_lane[k]["rel_primal_residual"]
                    for k in range(sweep.lanes)],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
