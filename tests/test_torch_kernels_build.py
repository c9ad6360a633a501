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
