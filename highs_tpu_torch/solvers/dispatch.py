"""LP solver selection and dispatch.

Equivalent of the reference's free function `solveLp`
(lp_data/HighsSolve.cpp:20, selection :41-117): picks the solver from the
`solver` option, runs presolve when enabled, solves the (reduced) LP and
postsolves.  Solver strings follow the reference
(HighsOptions.h:274-280): "simplex" / "choose" / "ipm" / "ipx" / "hipo" /
"pdlp" / "hipdlp" / "qpasm".

This package has the reflected-Halpern PDLP engine ("hipdlp", and
"choose" on a large LP).  The selection rule is the JAX package's; a
branch whose solver is not ported yet raises NotImplementedError naming
its ROADMAP item when it is reached.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

from ..constants import HighsModelStatus
from ..models.lp import HighsLp
from ..models.solution import HighsBasis, HighsSolution
from ..options import HighsOptions


def not_yet_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported (ROADMAP queue 1 item {item})")


@dataclasses.dataclass
class LpSolveInfo:
    iterations: int = 0
    simplex_iteration_count: int = -1
    ipm_iteration_count: int = -1
    crossover_iteration_count: int = -1
    pdlp_iteration_count: int = -1
    solve_time: float = 0.0
    basis: Optional[HighsBasis] = None


class _NullScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def solve_lp(lp: HighsLp, options: HighsOptions, log=None,
             presolve: bool = True,
             basis: Optional[HighsBasis] = None,
             warm_solution: Optional[HighsSolution] = None,
             device=None
             ) -> Tuple[HighsModelStatus, HighsSolution, LpSolveInfo]:
    info = LpSolveInfo()
    solver = options.solver or "choose"

    if math.isfinite(options.time_limit):
        # absolute deadline shared by every stage of this solve
        options._solve_deadline = time.perf_counter() + options.time_limit
    else:
        options._solve_deadline = None

    # named clocks (reference HighsTimer registry); the facade passes
    # its timer via the internal _timer attribute
    timer = getattr(options, "_timer", None)

    def clock(name):
        return timer.scope(name) if timer is not None else _NullScope()

    reduced_lp = lp
    postsolve_stack = None
    if presolve:
        from ..presolve.presolve import presolve_lp
        with clock("presolve"):
            presolve_result = presolve_lp(lp, options)
        if presolve_result.status in (
                HighsModelStatus.kInfeasible, HighsModelStatus.kUnbounded,
                HighsModelStatus.kUnboundedOrInfeasible):
            return presolve_result.status, HighsSolution(), info
        reduced_lp = presolve_result.reduced_lp
        postsolve_stack = presolve_result

    if options.icrash and warm_solution is None and reduced_lp.num_col:
        raise not_yet_ported("iCrash (option icrash)", 5)

    with clock("solve"):
        status, solution, raw_info = _solve_core(
            reduced_lp, options, solver, log, basis, warm_solution, device)

    # presolved-model dimensions for the run-data registry (reference
    # HighsRunData.h:29-47)
    info.presolved_num_col = reduced_lp.num_col
    info.presolved_num_row = reduced_lp.num_row
    info.presolved_num_nz = reduced_lp.a_matrix.num_nz
    info.iterations = raw_info.iterations
    info.solve_time = raw_info.solve_time
    info.pdlp_iteration_count = raw_info.iterations

    if postsolve_stack is not None and solution.value_valid:
        from ..presolve.presolve import postsolve_lp
        with clock("postsolve"):
            solution, full_basis = postsolve_lp(lp, postsolve_stack,
                                                solution, basis=info.basis)
        info.basis = full_basis
    return status, solution, info


def _deadline_exceeded(options) -> bool:
    dl = getattr(options, "_solve_deadline", None)
    return dl is not None and time.perf_counter() > dl


class _TimeoutInfo:
    iterations = 0
    solve_time = 0.0


def _solve_core(lp: HighsLp, options: HighsOptions, solver: str, log,
                basis, warm_solution, device):
    x0 = warm_solution.col_value if (
        warm_solution is not None and options.use_warm_start and
        len(warm_solution.col_value) == lp.num_col) else None
    y0 = warm_solution.row_dual if (
        warm_solution is not None and options.use_warm_start and
        warm_solution.dual_valid and
        len(warm_solution.row_dual) == lp.num_row) else None

    if solver in ("ipm", "ipx", "hipo"):
        raise not_yet_ported(f"LP solver {solver!r} (interior point)", 5)
    if solver == "simplex":
        raise not_yet_ported("LP solver 'simplex'", 4)

    # the JAX package's IPM capacity model: the dense normal equations
    # or the sparse LDL' are tried first on problems in this range
    _nnz = int(lp.a_matrix.num_nz)
    ipm_ok = ((lp.num_row <= 2500 and
               lp.num_row * (lp.num_col + lp.num_row) <= (1 << 26)) or
              (lp.num_row <= 80000 and _nnz <= 2_000_000))

    if solver == "choose" and (
            lp.num_row <= 1500 or
            (lp.num_row <= 20000 and _nnz <= 120_000)):
        # small or very sparse problems go to the native simplex first
        raise not_yet_ported(
            "solver 'choose' on a small or very sparse LP (simplex "
            "first); set solver='hipdlp' to solve it with PDLP", 4)
    if solver == "choose" and ipm_ok:
        raise not_yet_ported(
            "solver 'choose' on a mid-size LP (IPM first); set "
            "solver='hipdlp' to solve it with PDLP", 5)

    # hipdlp / large "choose" -> PDHG workhorse
    from .pdlp.wrapper import solve_lp_pdlp
    if _deadline_exceeded(options):
        return (HighsModelStatus.kTimeLimit, HighsSolution(),
                _TimeoutInfo())
    return solve_lp_pdlp(lp, options, x0=x0, y0=y0, device=device)
