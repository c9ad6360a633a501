"""The ctypes bindings of firstorderlp_torch.ops.kernels_build against
the C entry points of the kernels' sources, on the CPU: each library's
argument list (a pointer or an int, in order, then the stream) must be
the one its `extern "C"` function takes, or a launch would pass its
arguments in the wrong places. No compiler is needed: the sources are
read as text.
"""

import ctypes
import os
import re
import types

import pytest

from firstorderlp_torch.ops import kernels_build


def macro_params(name: str) -> str:
    """The parameter list that a `#define name ...` in csrc stands for."""
    for file in os.listdir(kernels_build.CSRC_DIR):
        with open(os.path.join(kernels_build.CSRC_DIR, file)) as f:
            text = f.read()
        found = re.search(rf"#define {name}((?:.*\\\n)*.*)", text)
        if found:
            return found.group(1).replace("\\\n", " ")
    raise AssertionError(f"no #define {name}")


def c_parameters(lib: str):
    """'p' or 'i' for each parameter of folp_<lib>, in order."""
    path = os.path.join(kernels_build.CSRC_DIR,
                        kernels_build.KERNEL_SOURCES[lib])
    with open(path) as f:
        text = f.read()
    found = re.search(rf'extern "C" int folp_{lib}\((.*?)\)\s*{{', text,
                      re.DOTALL)
    assert found, f"no extern C entry point folp_{lib} in {path}"
    params = found.group(1)
    params = re.sub(r"FOLP_\w+", lambda m: macro_params(m.group(0)),
                    params)
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        assert param, params
        if "*" in param:
            kinds.append("p")
        else:
            assert param.split()[0] == "int", param
            kinds.append("i")
    return kinds


@pytest.mark.parametrize("lib", sorted(kernels_build.KERNEL_SOURCES))
def test_bindings_match_the_c_entry_points(lib):
    fn = types.SimpleNamespace()
    dll = types.SimpleNamespace(**{f"folp_{lib}": fn})
    assert kernels_build._bind(lib, dll) is dll
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i"}
    assert [kind[t] for t in fn.argtypes] == c_parameters(lib)
    assert fn.argtypes[-1] is ctypes.c_void_p  # the stream
    assert fn.restype is ctypes.c_int


def c_struct_fields(name: str):
    """(member, 'p' or 'i') of `struct name { ... };` in csrc, in order."""
    for file in sorted(os.listdir(kernels_build.CSRC_DIR)):
        with open(os.path.join(kernels_build.CSRC_DIR, file)) as f:
            text = f.read()
        found = re.search(rf"struct {name} {{(.*?)\n}};", text, re.DOTALL)
        if found:
            break
    else:
        raise AssertionError(f"no struct {name} in csrc")
    fields = []
    for line in found.group(1).splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        assert decl.endswith(";"), decl
        member = decl[:-1].split()[-1].lstrip("*")
        fields.append((member, "p" if "*" in decl else "i"))
    return fields


@pytest.mark.parametrize("struct", ["CsrArgs", "LanesArgs", "StageArgs"])
def test_argument_structs_match_the_c_structs(struct):
    """The ctypes structures the wrappers pass by address (routed's
    CsrArgs and B2's StageArgs, lanes' LanesArgs) have the C structure's
    members, in order and of the same kind, so a kernel reads each
    argument where the wrapper put it."""
    from firstorderlp_torch.ops import lanes, routed

    cls = {"CsrArgs": routed._CsrArgs, "LanesArgs": lanes._LanesArgs,
           "StageArgs": routed._StageArgs}[struct]
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i"}
    assert [(n, kind[t]) for n, t in cls._fields_] == c_struct_fields(struct)


def test_ptxas_usage_reads_each_kernel_of_a_build_log(monkeypatch):
    """compare_kernels.ptxas_usage, which chip_smoke.py's kernels_lanes
    and compare_kernels --layout lanes report: each entry function's
    registers, static shared memory and spilled bytes from nvcc's
    `-Xptxas -v` log; nothing for a library loaded from the cache."""
    from firstorderlp_torch.ops import compare_kernels

    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1aIfEv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1aIfEv",
        "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads",
        "ptxas info    : Used 167 registers, used 1 barriers, 16 bytes "
        "cumulative stack size, 4 bytes smem",
        "ptxas info    : Compiling entry function '_Z1bIdEv' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers, 4 bytes smem",
    ])
    monkeypatch.setattr(kernels_build, "last_build_log", {"lanes_spmv": log})
    assert compare_kernels.ptxas_usage("lanes_spmv") == {
        "_Z1aIfEv": {"spill_bytes": 12, "registers": 167, "smem_bytes": 4},
        "_Z1bIdEv": {"spill_bytes": 0, "registers": 122, "smem_bytes": 4},
    }
    monkeypatch.setattr(kernels_build, "last_build_log", {})
    assert compare_kernels.ptxas_usage("lanes_spmv") == {}
