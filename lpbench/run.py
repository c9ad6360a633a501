"""Runs one cell of the benchmark once:

    python3 lpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (firstorderlp_torch)
beside this folder, on a machine with the CUDA devices the cell asks
for (BENCHMARK.json). Exits 2 without a result when they are missing.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this folder: the port and lpbench
# import from there, and no file here shadows a module of the library
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the configurations state the CSR layout; this would ask for the tile plan
os.environ.pop("FOLP_TILE_ALIGNED", None)

if __name__ == "__main__":
    from lpbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
