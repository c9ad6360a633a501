"""firstorderlp_torch: the PDHG/PDLP LP/QP solver in PyTorch and CUDA.

A port of the JAX package `firstorderlp_tpu` (which stays the reference)
to PyTorch on an NVIDIA H100. Module names follow the JAX package's.
Both solvers (PDHG and Mirror Prox) run their f32 products through
hand-written CUDA kernels for Hopper (`csrc/`, bound in `ops/routed.py`
and `ops/probe_routed.py`); host-side data handling (problem, MPS input,
rescaling, generators, checkpoints) is plain numpy/scipy.

Entry points run on CUDA unless the caller passes `device="cpu"`, and
raise when no GPU is present and no device was asked for. This package
imports neither `jax` nor `firstorderlp_tpu`.
"""

from .problem import (
    QuadraticProgrammingProblem,
    ScaledQpProblem,
    linear_programming_problem,
    is_linear_programming_problem,
    validate,
)
from .io.mps import read_mps
from .io.standard_form import (
    TwoSidedQpProblem,
    transform_to_standard_form,
    two_sided_rows_to_slacks,
    qps_reader_to_standard_form,
)
from .preprocess import (
    presolve,
    undo_presolve,
    rescale_problem,
    ruiz_rescaling,
    pock_chambolle_rescaling,
    l2_norm_rescaling,
    scale_problem,
    unscale_problem,
)
from .termination import (
    TerminationCriteria,
    construct_termination_criteria,
    validate_termination_criteria,
    OptimalityNorm,
)
from .solve_log import TerminationReason, RestartChoice, PointType, SolveLog
from .saddle_point import (
    RestartScheme,
    RestartToCurrentMetric,
    RestartParameters,
    construct_restart_parameters,
    SaddlePointOutput,
)
from .models.pdhg import (
    PdhgParameters,
    AdaptiveStepsizeParams,
    MalitskyPockStepsizeParameters,
    ConstantStepsizeParams,
)
from .models.mirror_prox import MirrorProxParameters
from .models.api import optimize, prepare_problem
from .refine import (
    optimize_split_precision,
    optimize_iterative_refinement,
    phase1_params,
)

__all__ = [
    "QuadraticProgrammingProblem",
    "ScaledQpProblem",
    "linear_programming_problem",
    "is_linear_programming_problem",
    "validate",
    "read_mps",
    "TwoSidedQpProblem",
    "transform_to_standard_form",
    "two_sided_rows_to_slacks",
    "qps_reader_to_standard_form",
    "presolve",
    "undo_presolve",
    "rescale_problem",
    "ruiz_rescaling",
    "pock_chambolle_rescaling",
    "l2_norm_rescaling",
    "scale_problem",
    "unscale_problem",
    "TerminationCriteria",
    "construct_termination_criteria",
    "validate_termination_criteria",
    "OptimalityNorm",
    "TerminationReason",
    "RestartChoice",
    "PointType",
    "SolveLog",
    "RestartScheme",
    "RestartToCurrentMetric",
    "RestartParameters",
    "construct_restart_parameters",
    "SaddlePointOutput",
    "PdhgParameters",
    "AdaptiveStepsizeParams",
    "MalitskyPockStepsizeParameters",
    "ConstantStepsizeParams",
    "MirrorProxParameters",
    "prepare_problem",
    "optimize",
    "optimize_split_precision",
    "optimize_iterative_refinement",
    "phase1_params",
]

__version__ = "0.1.0"
