"""Loader for the native MPS tokenizer (_mps_native.cpp).

Compiles the C++ source with ``g++ -O2 -std=c++17 -shared -fPIC`` into
``firstorderlp_torch/_build/<source hash>/libmps_native.so`` on first
use and wraps it with ctypes. The compiler writes a temporary file in
that directory, which is then renamed onto the final name
(``os.replace``), so a process that finds the library finds all of it,
however many processes build at once.

No silent fallback: `load()` returns None, and mps.read_mps takes the
pure-Python parser, only when FIRSTORDERLP_NO_NATIVE_MPS is set or when
the library is not built and there is no ``g++`` on PATH. A build or a
load that fails raises NativeBuildError with the compiler's output.
Parity between the two parsers is asserted field-exactly by
tests/test_torch_io_native.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import numpy as np

from .. import compile_meter

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "_mps_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # library path -> bound handle


class NativeBuildError(RuntimeError):
    """The tokenizer did not compile or load although g++ is present."""


def library_path(build_dir: Optional[str] = None) -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir or BUILD_DIR, h.hexdigest()[:16],
                        "libmps_native.so")


def _build(so_path: str, gxx: str) -> None:
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [gxx, *CXX_FLAGS, _SRC, "-o", tmp],
            capture_output=True, text=True, timeout=300,
        )
    finally:
        compile_meter.record("backend_compile", time.perf_counter() - start)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(
            f"g++ failed to build the MPS tokenizer ({_SRC}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so_path)


def load(build_dir: Optional[str] = None):
    """Returns the bound ctypes library, building it first if needed.

    None when FIRSTORDERLP_NO_NATIVE_MPS is set, or when the library is
    not built and there is no g++ on PATH. `build_dir` (default
    ``firstorderlp_torch/_build``) is where the library is looked for and
    built."""
    if os.environ.get("FIRSTORDERLP_NO_NATIVE_MPS"):
        return None
    so_path = library_path(build_dir)
    with _lock:
        if so_path in _libs:
            return _libs[so_path]
        if not os.path.exists(so_path):
            gxx = shutil.which("g++")
            if gxx is None:
                return None
            _build(so_path, gxx)
        start = time.perf_counter()
        try:
            lib = _bind(ctypes.CDLL(so_path))
        except (OSError, AttributeError) as exc:
            raise NativeBuildError(
                f"cannot load the MPS tokenizer {so_path}: {exc}"
            ) from exc
        finally:
            compile_meter.record("load", time.perf_counter() - start)
        _libs[so_path] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.POINTER
    lib.folp_mps_parse.restype = ctypes.c_void_p
    lib.folp_mps_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.folp_mps_error.restype = ctypes.c_char_p
    lib.folp_mps_error.argtypes = [ctypes.c_void_p]
    for fn in ("nvar", "ncon", "annz", "qnnz",
               "varnames_len", "connames_len"):
        g = getattr(lib, f"folp_mps_{fn}")
        g.restype = ctypes.c_int64
        g.argtypes = [ctypes.c_void_p]
    lib.folp_mps_c0.restype = ctypes.c_double
    lib.folp_mps_c0.argtypes = [ctypes.c_void_p]
    for fn in ("name", "objsense"):
        g = getattr(lib, f"folp_mps_{fn}")
        g.restype = ctypes.c_char_p
        g.argtypes = [ctypes.c_void_p]
    f64p = p(ctypes.c_double)
    i64p = p(ctypes.c_int64)
    lib.folp_mps_copy.restype = None
    lib.folp_mps_copy.argtypes = [ctypes.c_void_p] + [f64p] * 5 + [
        i64p, i64p, f64p, i64p, i64p, f64p]
    for fn in ("varnames", "connames"):
        g = getattr(lib, f"folp_mps_{fn}")
        g.restype = None
        g.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.folp_mps_destroy.restype = None
    lib.folp_mps_destroy.argtypes = [ctypes.c_void_p]
    return lib


def parse_bytes(lib, text: bytes):
    """Parses decompressed MPS bytes; returns an mps.MpsData.

    Raises mps.MpsParseError on malformed input (same condition set as
    the pure-Python parser; messages may differ in wording).
    """
    from . import mps  # deferred: mps imports this module lazily too

    handle = lib.folp_mps_parse(text, len(text))
    try:
        err = lib.folp_mps_error(handle)
        if err:
            raise mps.MpsParseError(err.decode())

        nvar = lib.folp_mps_nvar(handle)
        ncon = lib.folp_mps_ncon(handle)
        annz = lib.folp_mps_annz(handle)
        qnnz = lib.folp_mps_qnnz(handle)

        c = np.empty(nvar)
        lvar = np.empty(nvar)
        uvar = np.empty(nvar)
        lcon = np.empty(ncon)
        ucon = np.empty(ncon)
        arows = np.empty(annz, dtype=np.int64)
        acols = np.empty(annz, dtype=np.int64)
        avals = np.empty(annz)
        qrows = np.empty(qnnz, dtype=np.int64)
        qcols = np.empty(qnnz, dtype=np.int64)
        qvals = np.empty(qnnz)

        def ptr(a, ty):
            return a.ctypes.data_as(ctypes.POINTER(ty))

        lib.folp_mps_copy(
            handle,
            ptr(c, ctypes.c_double), ptr(lvar, ctypes.c_double),
            ptr(uvar, ctypes.c_double), ptr(lcon, ctypes.c_double),
            ptr(ucon, ctypes.c_double),
            ptr(arows, ctypes.c_int64), ptr(acols, ctypes.c_int64),
            ptr(avals, ctypes.c_double),
            ptr(qrows, ctypes.c_int64), ptr(qcols, ctypes.c_int64),
            ptr(qvals, ctypes.c_double),
        )

        def names(fn_len, fn_copy, count):
            n = fn_len(handle)
            if count == 0:
                return []
            buf = ctypes.create_string_buffer(n)
            fn_copy(handle, buf)
            return buf.raw[:n].decode().split("\n")

        varnames = names(lib.folp_mps_varnames_len,
                         lib.folp_mps_varnames, nvar)
        connames = names(lib.folp_mps_connames_len,
                         lib.folp_mps_connames, ncon)

        return mps.MpsData(
            name=lib.folp_mps_name(handle).decode(),
            objsense=lib.folp_mps_objsense(handle).decode(),
            nvar=int(nvar),
            ncon=int(ncon),
            c0=lib.folp_mps_c0(handle),
            c=c,
            lvar=lvar,
            uvar=uvar,
            lcon=lcon,
            ucon=ucon,
            arows=arows,
            acols=acols,
            avals=avals,
            qrows=qrows,
            qcols=qcols,
            qvals=qvals,
            varnames=varnames,
            connames=connames,
        )
    finally:
        lib.folp_mps_destroy(handle)
