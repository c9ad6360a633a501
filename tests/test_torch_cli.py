"""The port's CLIs (firstorderlp_torch/cli) against the JAX
package's (cli/), in-process with `--device cpu`:

- solve_qp on tests/test_data/trivial_lp.mps and trivial_qp.mps, PDHG and
  Mirror Prox, in f64 (the default) and in f32 on the kernel operator
  (`--matrix_format routed`, its plain versions here): the four files,
  the summary's keys and termination reason equal to the JAX CLI's on
  the same flags, primal and dual within 1e-6;
- `--two_phase_refinement` and `--redirect_stdio`;
- cli/process_json_to_csv.py and cli/analyze_results.py on the port's
  logs;
- both generator CLIs: the same decompressed bytes as the JAX CLIs';
- solve_lp_external with admm and with HiGHS: the JAX CLI's reason,
  residuals within 1e-9;
- with no GPU and no --device, the CLIs raise the port's CUDA error;
- one subprocess run of `python -m firstorderlp_torch.cli.solve_qp`
  imports neither jax nor firstorderlp_tpu.
"""

import csv
import gzip
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from firstorderlp_torch.cli import (
    generate_l1_svm_lp,
    generate_pagerank_lp,
    solve_lp_external,
    solve_qp,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "test_data")
OUTPUTS = ("_summary.json", "_full_log.json.gz", "_primal.txt", "_dual.txt")
TOLS = ["--absolute_optimality_tol", "1e-8", "--relative_optimality_tol",
        "1e-8", "--verbosity", "0"]


def jax_cli(name):
    """The JAX package's CLI cli/<name>.py, loaded by path."""
    path = os.path.join(REPO, "cli", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_cli(monkeypatch, name, argv):
    """Runs a JAX CLI's main() on `argv` (it reads sys.argv)."""
    module = jax_cli(name)
    monkeypatch.setattr(sys, "argv", [f"cli/{name}.py", *argv])
    return module.main()


def read_outputs(out_dir, instance):
    for suffix in OUTPUTS:
        assert os.path.exists(os.path.join(out_dir, instance + suffix)), \
            suffix
    with open(os.path.join(out_dir, instance + "_summary.json")) as f:
        summary = json.load(f)
    primal = np.loadtxt(os.path.join(out_dir, instance + "_primal.txt"))
    dual = np.loadtxt(os.path.join(out_dir, instance + "_dual.txt"))
    return summary, np.atleast_1d(primal), np.atleast_1d(dual)


def keys(tree):
    """Every key path of a JSON object."""
    if isinstance(tree, dict):
        return {(k, *sub) for k, v in tree.items() for sub in keys(v)} | {
            (k,) for k in tree}
    if isinstance(tree, list) and tree:
        return {("[]", *sub) for sub in keys(tree[0])}
    return set()


SOLVE_CASES = [
    (instance, method, dtype)
    for instance in ("trivial_lp", "trivial_qp")
    for method in ("pdhg", "mirror-prox")
    for dtype in ("float64", "float32")
]


@pytest.mark.parametrize("instance,method,dtype", SOLVE_CASES)
def test_solve_qp_matches_the_jax_cli(instance, method, dtype, tmp_path,
                                      monkeypatch):
    flags = ["--method", method, "--instance_path",
             os.path.join(DATA, instance + ".mps"), *TOLS]
    if dtype == "float32":
        flags += ["--dtype", "float32", "--matrix_format", "routed"]
    run_jax_cli(monkeypatch, "solve_qp",
                flags + ["--output_dir", str(tmp_path / "jx")])
    solve_qp.main(flags + ["--output_dir", str(tmp_path / "tx"),
                           "--device", "cpu"])
    want, want_x, want_y = read_outputs(str(tmp_path / "jx"), instance)
    got, got_x, got_y = read_outputs(str(tmp_path / "tx"), instance)
    assert keys(got) == keys(want)
    assert got["termination_reason"] == want["termination_reason"]
    assert got["termination_reason"] == "TERMINATION_REASON_OPTIMAL"
    assert got["instance_name"] == instance
    with gzip.open(tmp_path / "tx" / f"{instance}_full_log.json.gz",
                   "rt") as f:
        full = json.load(f)
    assert full["iteration_stats"]
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-6)


def test_two_phase_refinement(tmp_path):
    """--two_phase_refinement: an f32 phase on the kernel operator, then
    the f64 tail to 1e-8 (refine.optimize_split_precision)."""
    flags = ["--method", "pdhg", "--instance_path",
             os.path.join(DATA, "trivial_lp.mps"), *TOLS, "--device", "cpu"]
    solve_qp.main(flags + ["--output_dir", str(tmp_path / "plain")])
    solve_qp.main(flags + ["--output_dir", str(tmp_path / "two"),
                           "--two_phase_refinement", "true",
                           "--refinement_switch_tol", "1e-3"])
    plain, px, py = read_outputs(str(tmp_path / "plain"), "trivial_lp")
    two, tx_, ty = read_outputs(str(tmp_path / "two"), "trivial_lp")
    assert two["termination_reason"] == "TERMINATION_REASON_OPTIMAL"
    assert keys(two) == keys(plain)
    np.testing.assert_allclose(tx_, px, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ty, py, rtol=0, atol=1e-6)


def test_redirect_stdio(tmp_path, capsys):
    out_dir = tmp_path / "out"
    solve_qp.main(["--method", "pdhg", "--instance_path",
                   os.path.join(DATA, "trivial_lp.mps"), "--verbosity", "1",
                   "--output_dir", str(out_dir), "--device", "cpu",
                   "--redirect_stdio", "true"])
    read_outputs(str(out_dir), "trivial_lp")
    stdout = (out_dir / "trivial_lp_stdout.txt").read_text()
    assert "Elapsed time" in stdout
    assert "Instance: trivial_lp" in stdout
    assert (out_dir / "trivial_lp_stderr.txt").exists()
    assert "Elapsed time" not in capsys.readouterr().out


def test_log_tools_read_the_ports_logs(tmp_path, monkeypatch, capsys):
    """cli/process_json_to_csv.py and cli/analyze_results.py (they read
    logs, not the solver) on the port's solve_qp logs."""
    logs = tmp_path / "logs"
    solve_qp.main(["--method", "pdhg", "--instance_path",
                   os.path.join(DATA, "trivial_lp.mps"), *TOLS,
                   "--output_dir", str(logs), "--device", "cpu"])
    layout = tmp_path / "layout.json"
    layout.write_text(json.dumps({
        "datasets": [{"config": {"solver": "pdhg", "tolerance": "1e-8"},
                      "logs_directory": str(logs)}],
        "config_labels": ["solver", "tolerance"],
    }))
    csv_path = tmp_path / "dataset.csv"
    run_jax_cli(monkeypatch, "process_json_to_csv",
                [str(layout), str(csv_path)])
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert rows[0]["experiment_label"] == "pdhg,1e-8"
    assert rows[0]["instance_name"] == "trivial_lp"
    assert rows[0]["termination_reason"] == "TERMINATION_REASON_OPTIMAL"
    assert float(rows[0]["cumulative_kkt_matrix_passes"]) > 0
    capsys.readouterr()
    run_jax_cli(monkeypatch, "analyze_results", [str(csv_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("experiment_label")
    assert lines[1].startswith('"pdhg,1e-8",1,1,')


GENERATOR_CASES = {
    "generate_pagerank_lp": (
        generate_pagerank_lp,
        ["--num_nodes", "40", "--approx_num_edges", "120",
         "--damping_factor", "0.9", "--random_seed", "3"],
    ),
    "generate_l1_svm_lp": (
        generate_l1_svm_lp,
        ["--synthetic", "20,5", "--regularizer_weight", "1.5",
         "--random_seed", "2"],
    ),
}


@pytest.mark.parametrize("name", sorted(GENERATOR_CASES))
def test_generator_writes_the_jax_clis_bytes(name, tmp_path, monkeypatch):
    port_module, flags = GENERATOR_CASES[name]
    run_jax_cli(monkeypatch, name,
                flags + ["--output_filename", str(tmp_path / "jx.mps.gz")])
    port_module.main(flags + ["--output_filename",
                            str(tmp_path / "tx.mps.gz")])
    with gzip.open(tmp_path / "jx.mps.gz", "rb") as f:
        want = f.read()
    with gzip.open(tmp_path / "tx.mps.gz", "rb") as f:
        assert f.read() == want
    assert want.endswith(b"ENDATA\n")


RESIDUALS = ("l_inf_primal_residual", "l2_primal_residual",
             "l_inf_dual_residual", "l2_dual_residual", "primal_objective",
             "dual_objective", "relative_optimality_gap")


@pytest.mark.parametrize("solver", ["admm", "highs"])
def test_solve_lp_external_matches_the_jax_cli(solver, tmp_path,
                                                  monkeypatch):
    flags = ["--solver", solver, "--instance_path",
             os.path.join(DATA, "trivial_lp.mps")]
    run_jax_cli(monkeypatch, "solve_lp_external",
                flags + ["--output_dir", str(tmp_path / "jx")])
    solve_lp_external.main(flags + ["--output_dir", str(tmp_path / "tx"),
                                    "--device", "cpu"])
    summaries = {}
    for who in ("jx", "tx"):
        with open(tmp_path / who / "trivial_lp_summary.json") as f:
            summaries[who] = json.load(f)
        assert (tmp_path / who / "trivial_lp_primal.txt").exists()
        assert (tmp_path / who / "trivial_lp_dual.txt").exists()
    want, got = summaries["jx"], summaries["tx"]
    assert keys(got) == keys(want)
    assert got["termination_reason"] == want["termination_reason"]
    assert got["termination_reason"] == "TERMINATION_REASON_OPTIMAL"
    assert got["iteration_count"] == want["iteration_count"]
    ci_g = got["solution_stats"]["convergence_information"][0]
    ci_w = want["solution_stats"]["convergence_information"][0]
    for field in RESIDUALS:
        assert abs(ci_g[field] - ci_w[field]) <= 1e-9, field
    assert ci_g["l2_primal_residual"] < 1e-9
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "tx" / "trivial_lp_primal.txt"),
        np.loadtxt(tmp_path / "jx" / "trivial_lp_primal.txt"),
        rtol=0, atol=1e-9,
    )


def test_clis_raise_without_a_gpu(tmp_path):
    flags = ["--instance_path", os.path.join(DATA, "trivial_lp.mps"),
             "--output_dir", str(tmp_path)]
    if torch.cuda.is_available():
        from firstorderlp_torch.ops.device import resolve_device

        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_qp.main(["--method", "pdhg", *flags])
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_lp_external.main(flags)
    assert not os.listdir(tmp_path)


def test_module_entry_imports_no_jax(tmp_path):
    """`python -m firstorderlp_torch.cli.solve_qp` solves and writes its
    files without importing jax or firstorderlp_tpu (every import is
    listed by -X importtime)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "firstorderlp_torch.cli.solve_qp", "--method", "pdhg",
         "--instance_path", os.path.join(DATA, "trivial_lp.mps"),
         "--output_dir", str(tmp_path), "--device", "cpu", *TOLS],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in result.stderr.splitlines()
                if line.startswith("import time:")]
    assert "firstorderlp_torch.cli.solve_qp" in imported or any(
        name.startswith("firstorderlp_torch") for name in imported)
    leaked = [name for name in imported
              if name.split(".")[0] in ("jax", "jaxlib", "firstorderlp_tpu")]
    assert not leaked, leaked
    summary, _, _ = read_outputs(str(tmp_path), "trivial_lp")
    assert summary["termination_reason"] == "TERMINATION_REASON_OPTIMAL"
