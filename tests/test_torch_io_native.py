"""The port's MPS input and output against the JAX package's.

- Every MPS text of tests/test_mps_native.py goes through the port's
  native tokenizer, the port's pure-Python parser and the JAX package's
  pure-Python parser: every MpsData field exactly equal.
- Both packages raise MpsParseError on the same malformed texts.
- `.gz` input, FIRSTORDERLP_NO_NATIVE_MPS, and a machine without g++.
- The build: two processes building into one empty directory at once
  both load a whole library (a temporary file renamed onto the final
  name); a build that fails raises; the library loaded is the port's,
  under firstorderlp_torch/_build; compile_meter reads the g++ seconds
  of a cold build and none of a warm one.
- mps_writer: both packages write the same bytes for the same problems.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

import firstorderlp_tpu.generators as jx_gen
from firstorderlp_tpu.io import mps as jx_mps
from firstorderlp_tpu.io.mps_writer import write_mps as jx_write_mps

import firstorderlp_torch.generators as tx_gen
from firstorderlp_torch import compile_meter
from firstorderlp_torch.convert import problem_from_arrays
from firstorderlp_torch.io import mps as tx_mps
from firstorderlp_torch.io import native as tx_native
from firstorderlp_torch.io.mps_writer import write_mps as tx_write_mps

import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The MPS texts of tests/test_mps_native.py, one corner of the format
# each.
BASE = """NAME          test
ROWS
 N  COST
 E  R1
 L  R2
 G  R3
COLUMNS
    X1  COST  1.5  R1  1.0
    X1  R2  2.0
    X2  COST  -2.0  R1  1.0
    X2  R3  3.0
RHS
    RHS1  R1  4.0  R2  10.0
    RHS1  R3  -1.0
BOUNDS
 UP BND X1 5.0
 LO BND X2 -1.0
ENDATA
"""

_BOUND_COLS = "\n".join(f"    x{i}  obj  1.0  r  1.0" for i in range(9))

TEXTS = {
    "base": BASE,
    "ranges_all_row_types": """NAME r
ROWS
 N  obj
 E  e1
 E  e2
 L  l1
 G  g1
COLUMNS
    x  obj  1.0  e1  1.0
    x  e2  1.0  l1  1.0
    x  g1  1.0
RHS
    r  e1  2.0  e2  2.0
    r  l1  5.0  g1  1.0
RANGES
    rng  e1  3.0  e2  -3.0
    rng  l1  -4.0  g1  -2.0
ENDATA
""",
    "bounds_all_types": f"""NAME b
ROWS
 N  obj
 G  r
COLUMNS
{_BOUND_COLS}
RHS
    rhs  r  1.0
BOUNDS
 LO BND x0 -2.0
 UP BND x1 7.0
 FX BND x2 3.0
 FR BND x3
 MI BND x4
 PL BND x5
 BV BND x6
 LI BND x7 1
 UI BND x8 9
ENDATA
""",
    "negative_upper_bound_rule": """NAME n
ROWS
 N  obj
 G  r
COLUMNS
    x  obj  1.0  r  1.0
    y  obj  1.0  r  1.0
RHS
    rhs  r  1.0
BOUNDS
 UP BND x -2.0
 LO BND y -9.0
 UP BND y -2.0
ENDATA
""",
    "quadobj_and_marker": """* a comment line
NAME q
ROWS
 N  obj
 G  r
COLUMNS
    x  obj  1.0  r  1.0
    M1  'MARKER'  'INTORG'
    y  obj  2.0  r  1.0
    M2  'MARKER'  'INTEND'
RHS
    rhs  r  1.0
    rhs  obj  -2.5
QUADOBJ
    x  x  4.0
    y  x  1.0
    y  y  2.0
ENDATA
""",
    "qmatrix_keeps_lower_triangle": """NAME q
ROWS
 N  obj
 G  r
COLUMNS
    x  obj  1.0  r  1.0
    y  obj  2.0  r  1.0
QMATRIX
    x  x  4.0
    x  y  1.0
    y  x  1.0
    y  y  2.0
RHS
    rhs  r  1.0
ENDATA
""",
    "objsense_next_line_and_extra_free_rows": """NAME s
OBJSENSE
    MAXIMIZE
ROWS
 N  obj
 N  free2
 G  r
COLUMNS
    x  obj  1.0  r  1.0
RHS
    rhs  r  1.0
ENDATA
""",
    "duplicate_objective_entries_accumulate": """NAME d
ROWS
 N  obj
 G  r
COLUMNS
    x  obj  1.0  r  1.0
    x  obj  2.5
RHS
    rhs  r  1.0
ENDATA
""",
}

BAD_TEXTS = {
    "garbage_section": "GARBAGE SECTION\n",
    "unknown_row": (
        "NAME x\nROWS\n N obj\n G r\nCOLUMNS\n    x  nosuchrow  1.0\n"
        "ENDATA\n"
    ),
    "duplicate_row": "NAME x\nROWS\n N obj\n G r\n G r\nENDATA\n",
    "unknown_column_bound": (
        "NAME x\nROWS\n N obj\n G r\nCOLUMNS\n    x  r  1.0\n"
        "BOUNDS\n UP BND nosuchcol 1.0\nENDATA\n"
    ),
}

SCALARS = ("name", "objsense", "nvar", "ncon", "c0")
ARRAYS = ("c", "lvar", "uvar", "lcon", "ucon", "arows", "acols", "avals",
          "qrows", "qcols", "qvals")


@pytest.fixture(scope="module")
def lib():
    """The port's tokenizer, built into firstorderlp_torch/_build."""
    handle = tx_native.load()
    assert handle is not None, "g++ or the built tokenizer is missing"
    return handle


def assert_same_data(got, want):
    for f in SCALARS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, f
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b, equal_nan=True), f
    assert got.varnames == want.varnames
    assert got.connames == want.connames


@pytest.mark.parametrize("case", sorted(TEXTS) + ["generated_pagerank"])
def test_parsers_agree_field_exactly(case, lib, tmp_path):
    """tests/test_mps_native.py's texts: the port's tokenizer, the
    port's Python parser and the port's dispatcher give the JAX
    package's Python parse, field for field."""
    path = tmp_path / "m.mps"
    if case == "generated_pagerank":
        jx_write_mps(jx_gen.generate_pagerank_lp(num_nodes=300, seed=3),
                     str(path))
        text = path.read_text()
    else:
        text = TEXTS[case]
        path.write_text(text)
    want = jx_mps._read_mps_python(str(path))
    assert_same_data(tx_native.parse_bytes(lib, text.encode()), want)
    assert_same_data(tx_mps._read_mps_python(str(path)), want)
    assert_same_data(tx_mps.read_mps(str(path)), want)


@pytest.mark.parametrize("case", sorted(BAD_TEXTS))
def test_error_parity(case, lib, tmp_path):
    text = BAD_TEXTS[case]
    path = tmp_path / "bad.mps"
    path.write_text(text)
    with pytest.raises(jx_mps.MpsParseError):
        jx_mps._read_mps_python(str(path))
    with pytest.raises(tx_mps.MpsParseError):
        tx_mps._read_mps_python(str(path))
    with pytest.raises(tx_mps.MpsParseError):
        tx_native.parse_bytes(lib, text.encode())
    with pytest.raises(tx_mps.MpsParseError):
        tx_mps.read_mps(str(path))


def test_gz_input(lib, tmp_path):
    path = tmp_path / "m.mps.gz"
    with gzip.open(path, "wt") as f:
        f.write(BASE)
    want = jx_mps._read_mps_python(str(path))
    assert_same_data(tx_mps.read_mps(str(path)), want)
    assert_same_data(tx_mps._read_mps_python(str(path)), want)


def test_no_native_switch_takes_the_python_parser(lib, tmp_path,
                                                  monkeypatch):
    path = tmp_path / "m.mps"
    path.write_text(BASE)
    monkeypatch.setenv("FIRSTORDERLP_NO_NATIVE_MPS", "1")
    assert tx_native.load() is None

    def refuse(*_):
        raise AssertionError("the native tokenizer was used")

    monkeypatch.setattr(tx_native, "parse_bytes", refuse)
    assert_same_data(tx_mps.read_mps(str(path)),
                     jx_mps._read_mps_python(str(path)))


def test_without_gxx(lib, tmp_path, monkeypatch):
    """No g++ and no built library: the Python parser. No g++ but the
    library built: the library."""
    monkeypatch.setattr(tx_native.shutil, "which", lambda _: None)
    assert tx_native.load(build_dir=str(tmp_path / "empty")) is None
    assert tx_native.load() is lib


_BUILD_AND_PARSE = """
import os, sys, time
from firstorderlp_torch.io import native
build_dir, text, wait = sys.argv[1], sys.argv[2], sys.argv[3] == "wait"
if wait:  # start once the other process is writing its library
    target = os.path.dirname(native.library_path(build_dir))
    deadline = time.time() + 120
    while not (os.path.isdir(target) and os.listdir(target)):
        assert time.time() < deadline, "the other process wrote nothing"
        time.sleep(0.01)
lib = native.load(build_dir=build_dir)
data = native.parse_bytes(lib, text.encode())
print(lib._name, data.nvar, data.ncon, float(data.avals.sum()))
"""

# A slow compiler: it writes the real library to its -o path in two
# halves, 3 s apart, so that a second process finds a half-written file
# wherever the build writes it.
_SLOW_GXX = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
head -c 20000 "{real}" > "$out"
sleep 3
tail -c +20001 "{real}" >> "$out"
"""


def test_two_processes_build_one_directory_at_once(lib, tmp_path):
    """ROADMAP C2 not copied: of two processes that build into one
    empty directory, the second starts while the first is writing its
    library, and both load a whole library (the build writes a
    temporary file and renames it onto the final name)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text(_SLOW_GXX.format(real=lib._name))
    gxx.chmod(0o755)
    build_dir = tmp_path / "build"
    env = {k: v for k, v in os.environ.items()
           if k != "FIRSTORDERLP_NO_NATIVE_MPS"}
    env["PATH"] = f"{bin_dir}{os.pathsep}{env.get('PATH', '')}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_AND_PARSE, str(build_dir), BASE,
             mode],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env,
        )
        for mode in ("first", "wait")
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    want_path = tx_native.library_path(str(build_dir))
    assert [ln[0] for ln in lines] == [want_path, want_path]
    assert all(ln[1:] == ["2", "3", "7.0"] for ln in lines)
    left = os.listdir(os.path.dirname(want_path))
    assert left == [os.path.basename(want_path)], left


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tx_native, "_SRC", str(bad))
    with pytest.raises(tx_native.NativeBuildError, match="g\\+\\+ failed"):
        tx_native.load(build_dir=str(tmp_path / "build"))
    left = os.listdir(os.path.dirname(
        tx_native.library_path(str(tmp_path / "build"))))
    assert left == []


def test_loads_the_ports_library(lib):
    port_build = os.path.join(REPO, "firstorderlp_torch", "_build")
    assert lib._name.startswith(port_build + os.sep)
    assert lib._name == tx_native.library_path()
    assert "firstorderlp_tpu" not in lib._name
    assert os.path.dirname(tx_native._SRC) == os.path.join(
        REPO, "firstorderlp_torch", "io")


def test_compile_meter_reads_the_gxx_build(tmp_path):
    build_dir = str(tmp_path / "build")
    with compile_meter.CompileWindow() as cold:
        tx_native.load(build_dir=build_dir)
    assert cold.backend_seconds > 0.0
    assert cold.seconds >= cold.backend_seconds
    with compile_meter.CompileWindow() as warm:
        tx_native.load(build_dir=build_dir)
    assert warm.backend_seconds == 0.0
    # A new process finds the library built: no compiler seconds, only
    # the load.
    del tx_native._libs[tx_native.library_path(build_dir)]
    with compile_meter.CompileWindow() as found:
        tx_native.load(build_dir=build_dir)
    assert found.backend_seconds == 0.0
    assert found.seconds > 0.0


def _to_port(p):
    return problem_from_arrays(
        p.variable_lower_bound, p.variable_upper_bound, p.objective_matrix,
        p.objective_vector, p.objective_constant, p.constraint_matrix,
        p.right_hand_side, p.num_equalities,
    )


WRITER_CASES = [
    "example_lp", "example_lp_without_bounds", "example_qp", "example_qp2",
    "example_cc_lp", "example_cc_star_lp", "example_lp_dependent_rows",
    "example_lp_easy_primal_infeasible", "example_lp_dual_infeasible",
    "pagerank", "l1_svm",
]


def _writer_problems(case):
    """(JAX problem, port problem): the port's problem built by the
    port's own generator where there is one."""
    if case == "pagerank":
        return (jx_gen.generate_pagerank_lp(num_nodes=200, seed=5),
                tx_gen.generate_pagerank_lp(num_nodes=200, seed=5))
    if case == "l1_svm":
        return (
            jx_gen.generate_l1_svm_lp(jx_gen.random_svm_data(30, 6, seed=2),
                                      1.0),
            tx_gen.generate_l1_svm_lp(tx_gen.random_svm_data(30, 6, seed=2),
                                      1.0),
        )
    p = getattr(fixtures, case)()
    return p, _to_port(p)


@pytest.mark.parametrize("case", WRITER_CASES)
def test_writer_writes_the_same_bytes(case, tmp_path):
    jp, tp = _writer_problems(case)
    jx_write_mps(jp, str(tmp_path / "jx.mps.gz"), name=case)
    tx_write_mps(tp, str(tmp_path / "tx.mps.gz"), name=case)
    tx_write_mps(tp, str(tmp_path / "tx.mps"), name=case)
    with gzip.open(tmp_path / "jx.mps.gz", "rb") as f:
        want = f.read()
    with gzip.open(tmp_path / "tx.mps.gz", "rb") as f:
        assert f.read() == want
    assert (tmp_path / "tx.mps").read_bytes() == want
