"""Runs on the card at a small size: each cell's run is correct and
reports the device, and a traced run reads the device's time. Skips
without a CUDA device."""

import time

import pytest

from lpbench import harness
from lpbench.tests.small import SMALL

CELLS = ["pagerank-1m.pdhg", "pagerank-1m.mirror-prox"]


def _run(cell, trace, device):
    return harness.run_cell(cell, 2**31 + 99, 0.5, trace, device,
                            time.time(), overrides=SMALL)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, cuda_device):
    result, details = _run(cell, 0, cuda_device)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    assert details["window_bits_as_warm_solve"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_device(cell, cuda_device):
    result, _ = _run(cell, 1, cuda_device)
    device = result["device"]
    assert 0 < device["busy_s"] <= device["window_s"]
    for name in ("idle_share.lp", "host_calls_per_iter.lp",
                 "spmv_roofline.lp"):
        assert name in result["metrics"], result["metrics"]
    assert 0 < result["metrics"]["spmv_roofline.lp"]["value"] <= 105
    assert 0 < len(result["breakdown"]["device_ops"]) <= 10
