"""Single `prepare_problem` and `optimize` entry points dispatching on
the parameter type (mirrors the reference's multiple dispatch on
optimize): PDHG for PdhgParameters, Mirror Prox for
MirrorProxParameters. The port's callers that take either solver's
parameters (refine.py, parallel/sharded.py) choose the solver here."""

from __future__ import annotations

from ..problem import QuadraticProgrammingProblem
from ..saddle_point import SaddlePointOutput
from . import mirror_prox as _mirror_prox
from . import pdhg as _pdhg
from .common import PreparedProblem
from .mirror_prox import MirrorProxParameters

__all__ = ["MirrorProxParameters", "optimize", "prepare_problem"]


def _solver(params):
    """The solver module whose parameters `params` are."""
    if isinstance(params, _pdhg.PdhgParameters):
        return _pdhg
    if isinstance(params, MirrorProxParameters):
        return _mirror_prox
    raise TypeError(f"Unknown parameter type: {type(params)!r}")


def prepare_problem(
    params, problem: QuadraticProgrammingProblem, warm_start=None,
    device=None, _reuse=None, _shard_plan=None,
) -> PreparedProblem:
    """The solver's prepare_problem (pdhg.prepare_problem,
    mirror_prox.prepare_problem)."""
    return _solver(params).prepare_problem(
        params, problem, warm_start=warm_start, device=device,
        _reuse=_reuse, _shard_plan=_shard_plan)


def optimize(
    params, problem: QuadraticProgrammingProblem, prepared=None,
    device=None, _elapsed_offset: float = 0.0, _placement=None,
    _shard_plan=None,
) -> SaddlePointOutput:
    """The solver's optimize (pdhg.optimize, mirror_prox.optimize). Runs
    on CUDA unless `device` names another device (raises when no GPU is
    present and no device was asked for)."""
    return _solver(params).optimize(
        params, problem, prepared=prepared, device=device,
        _elapsed_offset=_elapsed_offset, _placement=_placement,
        _shard_plan=_shard_plan)
