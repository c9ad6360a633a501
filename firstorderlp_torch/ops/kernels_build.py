"""Builds the CUDA kernels under ``firstorderlp_torch/csrc`` and loads
them with ctypes.

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface; all files compile at once, one
``nvcc`` process each. The libraries go to ``firstorderlp_torch/_build/
<hash>/``, keyed by a hash of every source in ``csrc`` and of the
compiler flags, so a later call with the same sources loads them
without compiling. Nothing here runs at import time: the CPU tests
import the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")

# kernel library name -> its source file in csrc/
KERNEL_SOURCES = {
    "spmv_csr": "spmv_csr.cu",
    "spmv_dual_step": "spmv_dual_step.cu",
    "spmv_rmv_stats": "spmv_rmv_stats.cu",
    "tiled_spmv": "tiled_spmv.cu",
    "tiled_dual_step": "tiled_dual_step.cu",
    "tiled_rmv_stats": "tiled_rmv_stats.cu",
    "probe_expand": "probe_expand.cu",
    "probe_reduce": "probe_reduce.cu",
    "lanes_spmv": "lanes_spmv.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds the last build_kernels() call spent compiling (0 when cached)
last_build_seconds = 0.0
# nvcc's stderr per library from the last compile (ptxas register use)
last_build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_kernels() -> Dict[str, ctypes.CDLL]:
    """Compiles (or finds cached) and loads every kernel library.

    Raises RuntimeError when nvcc is missing or a compile fails."""
    global last_build_seconds
    with _lock:
        if len(_libs) == len(KERNEL_SOURCES):
            return dict(_libs)
        out_dir = os.path.join(BUILD_DIR, _source_hash())
        os.makedirs(out_dir, exist_ok=True)
        todo = {
            lib: os.path.join(out_dir, f"lib{lib}.so")
            for lib in KERNEL_SOURCES
        }
        missing = {k: v for k, v in todo.items() if not os.path.exists(v)}
        start = time.time()
        if missing:
            nvcc = _nvcc()
            procs = {}
            for lib, so_path in missing.items():
                tmp = f"{so_path}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
                       os.path.join(CSRC_DIR, KERNEL_SOURCES[lib])]
                procs[lib] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True,
                    ),
                    tmp,
                    so_path,
                )
            failures = []
            for lib, (proc, tmp, so_path) in procs.items():
                out, err = proc.communicate()
                last_build_log[lib] = out + err
                if proc.returncode != 0:
                    failures.append(f"{lib}:\n{out}{err}")
                else:
                    os.replace(tmp, so_path)
            if failures:
                raise RuntimeError(
                    "nvcc failed:\n" + "\n".join(failures)
                )
        last_build_seconds = time.time() - start
        for lib, so_path in todo.items():
            _libs[lib] = _bind(lib, ctypes.CDLL(so_path))
        return dict(_libs)


def _bind(lib: str, dll: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    csr = [p]  # the matrix's CsrArgs, built once (routed._CsrArgs)
    # loc vals meta items scratch tickets, then nitems nstrips group
    # out_strip in_window num_rows num_cols warps
    plan = [p, p, p, p, p, p, i, i, i, i, i, i, i, i]
    spmv = [p, p]  # x, y
    # then the sums (CSR) or the partials and sums (tile plan)
    dual_step = [p, p, p, p, p, p, p]  # z y b eq sigma y+ sums
    rmv_stats = [p, p, p, p, p]  # y dx aty_old aty sums
    # strip_ids x_strips hi lo g, then ngroups n_strips h groups_per_block
    probe_expand = [p, p, p, p, p, i, i, i, i]
    # chunks g v hi lo scratch tickets y, then nchunks hr warps
    probe_reduce = [p, p, p, p, p, p, p, p, i, i, i]
    # indptr indices vals items nitems x y scratch tickets lanes elem_bytes
    lanes_spmv = [p, p, p, p, i, p, p, p, p, i, i]
    arguments = {
        "spmv_csr": csr + spmv,
        "spmv_dual_step": csr + dual_step,
        "spmv_rmv_stats": csr + rmv_stats,
        "tiled_spmv": plan + spmv,
        "tiled_dual_step": plan + dual_step,
        "tiled_rmv_stats": plan + rmv_stats,
        "probe_expand": probe_expand,
        "probe_reduce": probe_reduce,
        "lanes_spmv": lanes_spmv,
    }[lib]
    fn = getattr(dll, f"folp_{lib}")
    fn.argtypes = arguments + [p]  # trailing: the CUDA stream
    fn.restype = ctypes.c_int
    return dll


def kernel_function(lib: str):
    """The C entry point ``folp_<lib>`` (builds on first use)."""
    libs = _libs if lib in _libs else build_kernels()
    return getattr(libs[lib], f"folp_{lib}")
