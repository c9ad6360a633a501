"""Solver-state checkpoint / resume.

The reference has no checkpointing (both solvers always start from zero
vectors, src/primal_dual_hybrid_gradient.jl:806-810); on a machine that
can be taken away mid-solve it is required infrastructure. The full
solver state is small (iterates, A'y cache, weighted averages, restart
info, step-size scalars), so a checkpoint is one .npz file written from
the host loop between segments.

Format (the JAX package's, so a file written by either package resumes
in the other): numpy .npz with one entry per state leaf, keyed by the
leaf's path of dataclass field names joined by "/" (for example
``avg/sum_primal_solutions``), plus a `__meta__` JSON string (schema
version, wall-clock already spent, user metadata, problem fingerprint).
Loading restores into a template state (the solver's initial state),
which gives every leaf its type, dtype and device; shape mismatches
raise.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SCHEMA_VERSION = 1


def problem_fingerprint(problem) -> str:
    """Cheap content hash of a QuadraticProgrammingProblem.

    Checkpoints written against one problem must not silently resume
    another problem with identical shapes; the fingerprint covers the
    shapes, nnz, and value checksums of every data field.
    """
    import hashlib

    h = hashlib.sha256()
    a = problem.constraint_matrix.tocoo()
    h.update(
        repr(
            (
                a.shape,
                a.nnz,
                int(problem.num_equalities),
            )
        ).encode()
    )
    for arr in (
        a.row,
        a.col,
        a.data,
        problem.right_hand_side,
        problem.objective_vector,
        problem.variable_lower_bound,
        problem.variable_upper_bound,
        np.asarray(problem.objective_constant),
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    if problem.objective_matrix is not None:
        q = problem.objective_matrix.tocoo()
        for arr in (q.row, q.col, q.data):
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _leaves(state, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf of a state dataclass, nested
    dataclasses walked by field name in field order."""
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, key + "/")
        else:
            yield key, value


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the JAX package stores for it: a tensor as it
    is; a host flag as bool, a host counter as int64, a host float as
    float64."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(bool(leaf))
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(int(leaf), dtype=np.int64)
    if isinstance(leaf, (float, np.floating)):
        return np.asarray(float(leaf), dtype=np.float64)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)!r}")


def _like(template, arr: np.ndarray):
    """`arr` as a leaf of the template's kind: a tensor on the template's
    device with its dtype, or the same Python type."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.array(arr), device=template.device).to(
            template.dtype
        )
    if isinstance(template, (bool, np.bool_)):
        return bool(arr)
    if isinstance(template, (int, np.integer)):
        return int(arr)
    return float(arr)


def save_state(
    path: str,
    state,
    elapsed_time: float = 0.0,
    metadata: Optional[Dict[str, Any]] = None,
    fingerprint: Optional[str] = None,
) -> None:
    """Writes `state` (a solver-state dataclass) atomically to `path`
    (.npz).

    `fingerprint` (see problem_fingerprint) binds the checkpoint to the
    problem instance; load_state raises on mismatch.
    """
    arrays = {key: _to_numpy(leaf) for key, leaf in _leaves(state)}
    meta = {
        "schema_version": _SCHEMA_VERSION,
        "elapsed_time": float(elapsed_time),
        "metadata": metadata or {},
        "fingerprint": fingerprint,
    }
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    # Atomic replace so an interruption mid-write never corrupts the file.
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _restore(template, data, prefix: str = ""):
    changes = {}
    for f in dataclasses.fields(template):
        leaf = getattr(template, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(leaf):
            changes[f.name] = _restore(leaf, data, key + "/")
            continue
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        want_shape = tuple(np.shape(_to_numpy(leaf)))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {arr.shape} != "
                f"state shape {want_shape}"
            )
        changes[f.name] = _like(leaf, arr)
    return dataclasses.replace(template, **changes)


def load_state(
    path: str, template, fingerprint: Optional[str] = None
) -> Tuple[Any, float, Dict[str, Any]]:
    """Loads a checkpoint into the structure of `template`.

    Returns (state, elapsed_time, metadata). Leaf types, dtypes and
    devices follow the template (so a checkpoint can be resumed under a
    different compute dtype); shapes must match exactly. When
    `fingerprint` is given and the checkpoint recorded one, a mismatch
    raises: identical shapes do not make it the same problem.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("schema_version") != _SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint schema {meta.get('schema_version')} != "
                f"{_SCHEMA_VERSION}"
            )
        saved_fp = meta.get("fingerprint")
        if fingerprint is not None and saved_fp is not None:
            if saved_fp != fingerprint:
                raise ValueError(
                    "checkpoint was written for a different problem "
                    f"(fingerprint {saved_fp[:12]}... != "
                    f"{fingerprint[:12]}...)"
                )
        state = _restore(template, data)
    return state, float(meta.get("elapsed_time", 0.0)), meta.get(
        "metadata", {}
    )
