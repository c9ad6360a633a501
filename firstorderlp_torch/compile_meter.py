"""Process-wide build-time accounting for the port's native libraries.

The port compiles two kinds of code ahead of a solve: the CUDA kernels
(`ops/kernels_build.build_kernels`, one `nvcc` process a source) and the
C++ MPS tokenizer (`io/native.py`, `g++`). Both report here, so that a
caller can split a phase's wall clock into "build" and "work", as the
JAX package's compile_meter does for XLA compiles (an unamortized build
silently absorbed into an ingest or solve number misstates both).

Two components:
- backend: the seconds `nvcc` and `g++` actually spent compiling. It is
  0 when `firstorderlp_torch/_build/` already holds the libraries, as the
  JAX package's backend compile is 0 on a persistent-cache hit;
- load: the seconds spent loading the libraries (`ctypes.CDLL`) and
  binding their entry points, which every process pays once.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_TOTALS = {"backend_compile": 0.0, "load": 0.0}


def install() -> None:
    """Kept for the JAX package's callers: kernels_build and io/native
    report directly, so there is nothing to register."""


def record(kind: str, seconds: float) -> None:
    """Adds `seconds` to `kind` ("backend_compile" or "load")."""
    with _LOCK:
        _TOTALS[kind] += float(seconds)


def compile_seconds() -> float:
    """Total build seconds so far: compiling plus loading and binding."""
    with _LOCK:
        return _TOTALS["backend_compile"] + _TOTALS["load"]


def backend_compile_seconds() -> float:
    """Compiler seconds only (nvcc and g++): zero when every library was
    found built."""
    with _LOCK:
        return _TOTALS["backend_compile"]


class CompileWindow:
    """Context manager measuring build seconds inside a phase:
    `seconds` (all) and `backend_seconds` (compilers only)."""

    def __enter__(self):
        install()
        self._start = compile_seconds()
        self._start_backend = backend_compile_seconds()
        return self

    def __exit__(self, *exc):
        self.seconds = compile_seconds() - self._start
        self.backend_seconds = (
            backend_compile_seconds() - self._start_backend
        )
        return False
