"""The benchmark of firstorderlp_torch on one H100: cells of LP solves,
their inputs made from a seed, a plain reference that judges every
answer, and readers of the per-layer metrics. `python3 lpbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` runs one cell
once (see run.py)."""
