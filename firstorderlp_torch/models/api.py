"""Single `optimize` entry point dispatching on the parameter type
(mirrors the reference's multiple dispatch on optimize): PDHG for
PdhgParameters, Mirror Prox for MirrorProxParameters."""

from __future__ import annotations

from ..problem import QuadraticProgrammingProblem
from ..saddle_point import SaddlePointOutput
from . import mirror_prox as _mirror_prox
from . import pdhg as _pdhg
from .mirror_prox import MirrorProxParameters

__all__ = ["MirrorProxParameters", "optimize"]


def optimize(
    params, problem: QuadraticProgrammingProblem, device=None
) -> SaddlePointOutput:
    """Runs on CUDA unless `device` names another device (raises when no
    GPU is present and no device was asked for)."""
    if isinstance(params, _pdhg.PdhgParameters):
        return _pdhg.optimize(params, problem, device=device)
    if isinstance(params, MirrorProxParameters):
        return _mirror_prox.optimize(params, problem, device=device)
    raise TypeError(f"Unknown parameter type: {type(params)!r}")
