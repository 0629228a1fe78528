"""LP presolve.

Re-implements the high-value rules of the reference presolve
(highs/presolve/HPresolve.cpp rule loop :5780) as vectorized numpy
passes with a stack-replay postsolve
(highs/presolve/HighsPostsolveStack.h).  This first version implements
the trivial-detection subset (empty rows/cols, inconsistent bounds);
the full vectorized rule loop lives in `rules.py` and is applied when
`presolve != off`.

`presolve_lp` runs on the solve's device: it uploads the constraint
matrix once (`device.py` `DeviceMatrix`), and the empty-row check and
every rule family's sweeps over the nonzeros read that copy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..constants import HighsModelStatus, kHighsInf
from ..models.lp import HighsLp
from ..models.solution import HighsSolution
from ..options import HighsOptions
from ..utils.timer import span


@dataclasses.dataclass
class PresolveResult:
    status: HighsModelStatus
    reduced_lp: HighsLp
    # postsolve metadata (filled by rules.py when reductions happen)
    stack: List = dataclasses.field(default_factory=list)
    reduced: bool = False
    keep_rows: Optional[object] = None  # np.ndarray of kept row indices
    keep_cols: Optional[object] = None
    orig_num_row: int = 0
    orig_num_col: int = 0


def presolve_lp(lp: HighsLp, options: HighsOptions,
                device) -> PresolveResult:
    """Presolve `lp`, its sweeps over the nonzeros on `device` (a torch
    device or its name)."""
    tol = options.primal_feasibility_tolerance
    # inconsistent bounds
    if np.any(lp.col_lower > lp.col_upper + tol) or (
            lp.num_row and np.any(lp.row_lower > lp.row_upper + tol)):
        return PresolveResult(HighsModelStatus.kInfeasible, lp)

    timer = getattr(options, "_timer", None)
    with span(timer, "presolve.setup"):
        a = lp.a_matrix.to_scipy().tocsc()
    if options.presolve == "off":
        # no sweeps follow: count the rows' stored entries on the host
        if _empty_row_infeasible(
                lp, np.bincount(a.indices, minlength=lp.num_row), tol):
            return PresolveResult(HighsModelStatus.kInfeasible, lp)
        return PresolveResult(HighsModelStatus.kNotset, lp)

    a.sum_duplicates()
    from .device import DeviceMatrix
    matrix = DeviceMatrix(a, device, timer)
    if _empty_row_infeasible(lp, matrix.stored_row_counts(), tol):
        return PresolveResult(HighsModelStatus.kInfeasible, lp)

    from .rules import run_presolve_rules
    return run_presolve_rules(lp, options, matrix)


def _empty_row_infeasible(lp: HighsLp, row_counts: np.ndarray,
                          tol: float) -> bool:
    """A row with no stored entry whose bounds exclude 0."""
    empty = row_counts == 0
    return bool(np.any(empty & ((lp.row_lower > tol) |
                                (lp.row_upper < -tol))))


def log_rule_use(options: HighsOptions, log) -> None:
    """Log each rule family's seconds, passes and stack entries (the
    clocks and counters "presolve.<rule>" of the run's timer) where
    `presolve_rule_logging` asks for them."""
    timer = getattr(options, "_timer", None)
    if options.presolve_rule_logging and log is not None and \
            timer is not None:
        for line in timer.report(prefix="presolve."):
            log(line)


def postsolve_lp(original_lp: HighsLp, presolve_result: PresolveResult,
                 solution: HighsSolution, basis=None):
    """Replay the reduction stack to recover a solution (and an alien
    basis, when a reduced basis is given) for the original LP."""
    if not presolve_result.reduced:
        return solution, basis
    from .rules import postsolve_rules
    return postsolve_rules(original_lp, presolve_result, solution,
                           reduced_basis=basis)
