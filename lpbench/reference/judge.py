"""Judges the answers of a window against the LPs the benchmark made.

Every answer of the window is judged: answers with the same bits (the
same LP, status, x and y) are judged once. What is compared, each with
its limit:

- answers_missing: answers due and not returned (a solve owes
  `expected`), limit 0;
- not_optimal: answers whose status is not OPTIMAL, limit 0;
- rel_primal_residual, rel_dual_residual, rel_gap: the worst of the
  answers (reference/kkt.py), each limited by the traffic's
  `residual_limit`: the tolerance it states for OPTIMAL with room for
  the rounding of the solver's own f32 reading of it (PERF.md);
- primal_l1_error: where the reference knows the LP's answer
  (`solution_of`), the worst of the answers' ||x - x*||_1, limited by
  the traffic's `l1_error_limit`, set between the program's sound runs
  and the control (PERF.md). The residuals are divided by 1 + ||b||,
  which a large LP's dense row sets, so they alone would let pass an x
  of the right mass and the wrong shape.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Optional, Sequence

import numpy as np

from . import kkt

OPTIMAL = "OPTIMAL"
RESIDUALS = ("rel_primal_residual", "rel_dual_residual", "rel_gap")
L1 = "primal_l1_error"


def digest(status: str, x: np.ndarray, y: np.ndarray) -> str:
    h = hashlib.blake2b(status.encode(), digest_size=16)
    h.update(np.ascontiguousarray(x, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(y, dtype=np.float64).tobytes())
    return h.hexdigest()


def _finite(value: float) -> float:
    return value if math.isfinite(value) else math.inf


def judge(solves: Sequence[Sequence[tuple]], expected: int,
          lp_of: Callable[[int], object], limit: float,
          solution_of: Optional[Callable[[int], np.ndarray]] = None,
          l1_limit: float = math.inf) -> dict:
    """`solves`: one list of answers (index, status, x, y) a solve;
    `expected`: the answers a solve owes (indices 0 .. expected-1);
    `lp_of(index)`: the LP answer `index` solves; `limit`: the
    residuals' limit; `solution_of(index)`: the reference's x of that
    LP, or None. Returns the checks (name -> {"value", "limit"}),
    `attempted` and `failed` (answers), and `residuals` of each answer
    judged, by (index, digest)."""
    names = RESIDUALS + ((L1,) if solution_of else ())
    limits = {name: limit for name in RESIDUALS}
    limits[L1] = l1_limit
    missing = 0
    worst = {name: 0.0 for name in names}
    not_optimal = 0
    attempted = failed = 0
    verdicts = {}  # (index, digest) -> passed
    residuals = {}
    if not solves:
        missing = expected
    for answers in solves:
        got = {a[0] for a in answers}
        missing += sum(1 for i in range(expected) if i not in got)
        missing += sum(1 for a in answers
                       if not (isinstance(a[0], (int, np.integer))
                               and 0 <= a[0] < expected))
        for index, status, x, y in answers:
            attempted += 1
            key = (int(index), digest(status, x, y))
            if key not in verdicts:
                ok = status == OPTIMAL
                if not ok:
                    not_optimal += 1
                if 0 <= index < expected:
                    res = kkt.residuals(lp_of(int(index)), x, y)
                    if solution_of:
                        res[L1] = float(np.sum(np.abs(
                            np.asarray(x, dtype=np.float64)
                            - solution_of(int(index)))))
                else:
                    res = {name: math.inf for name in names}
                for name, value in res.items():
                    value = _finite(value)
                    ok = ok and value <= limits[name]
                    worst[name] = max(worst[name], value)
                verdicts[key] = ok
                residuals[key] = res
            elif status != OPTIMAL:
                not_optimal += 1
            failed += not verdicts[key]
    checks = {
        "answers_missing": {"value": missing, "limit": 0},
        "not_optimal": {"value": not_optimal, "limit": 0},
        **{name: {"value": worst[name], "limit": limits[name]}
           for name in names},
    }
    return {"checks": checks, "attempted": attempted, "failed": failed,
            "residuals": residuals}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
