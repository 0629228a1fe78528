"""LP solver selection and dispatch.

Equivalent of the reference's free function `solveLp`
(lp_data/HighsSolve.cpp:20, selection :41-117): picks the solver from the
`solver` option, runs presolve when enabled, solves the (reduced) LP and
postsolves.  Solver strings follow the reference
(HighsOptions.h:274-280): "simplex" / "choose" / "ipm" / "ipx" / "hipo" /
"pdlp" / "hipdlp" / "qpasm".

This package has the interior-point solver ("ipm" / "ipx" / "hipo", and
"choose" on an LP in the IPM's range, with the classification of an
inconclusive IPM result and PDLP after it) and the reflected-Halpern
PDLP engine ("hipdlp", and "choose" on a large LP).  The selection rule
is the JAX package's; a branch whose solver is not ported yet (simplex,
crossover) raises NotImplementedError naming its ROADMAP item when it
is reached.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np

from ..constants import HighsModelStatus
from ..models.lp import HighsLp
from ..models.solution import HighsBasis, HighsSolution
from ..options import HighsOptions
from .classify import classify_inconclusive
from .icrash import run_icrash
from .ipm.wrapper import solve_lp_ipm
from .pdlp.wrapper import solve_lp_pdlp


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
        # iterative crash starting point (reference ICrash.cpp; the
        # result warm-starts the first-order/IPM solvers)
        with clock("icrash"):
            icrash_info = run_icrash(reduced_lp, options, log=log,
                                     device=device)
        warm_solution = HighsSolution(
            value_valid=True, dual_valid=True,
            col_value=icrash_info.x,
            row_value=(reduced_lp.a_matrix.to_scipy() @ icrash_info.x
                       if reduced_lp.num_row else np.zeros(0)),
            col_dual=np.zeros(reduced_lp.num_col),
            row_dual=icrash_info.lambda_)
        if log is not None:
            log(f"iCrash: {icrash_info.num_iterations} iterations, "
                f"residual {icrash_info.final_residual_norm2:.3e}, "
                f"time {icrash_info.total_time:.2f}s")

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
    ipm_iters = getattr(raw_info, "ipm_iterations", -1)
    if ipm_iters > 0:
        info.ipm_iteration_count = ipm_iters
    else:
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
        if options.run_crossover == "on" and lp.num_row <= 3000:
            # the JAX package runs crossover to a vertex basis after an
            # optimal IPM solve of such an LP (run_crossover default "on")
            raise not_yet_ported(
                f"crossover after LP solver {solver!r} (run_crossover "
                "'on' on an LP of at most 3,000 rows); set run_crossover="
                "'off' to return the interior solution", 4)
        return solve_lp_ipm(lp, options, log=log, device=device)
    if solver == "simplex":
        raise not_yet_ported("LP solver 'simplex'", 4)

    # IPM capacity model (not a dense cap): small problems factor the
    # normal matrix dense; mid-to-large sparse problems use the sparse
    # LDL' route, whose symbolic analysis self-aborts on fill-catastrophic
    # patterns and falls back to matrix-free CG.  The m <= 2500 band may
    # factor dense, so it also bounds the dense working set.
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
            "first); set solver='hipdlp', or solver='ipm' with "
            "run_crossover='off', to solve it", 4)
    if solver == "choose" and ipm_ok:
        # "choose": the high-accuracy IPM first where its normal
        # equations fit; PDLP after it when it cannot conclude.  (The JAX
        # package's PDLP -> IPM polish, dispatch.py:260-274, is behind
        # this branch's returns for every such LP and never runs.)
        status, solution, info = solve_lp_ipm(lp, options, log=log,
                                              device=device)
        if status in (HighsModelStatus.kOptimal,
                      HighsModelStatus.kInfeasible,
                      HighsModelStatus.kUnbounded,
                      HighsModelStatus.kInterrupt):
            return status, solution, info
        if _deadline_exceeded(options):
            info.status = HighsModelStatus.kTimeLimit
            return HighsModelStatus.kTimeLimit, solution, info
        # IPM could not conclude: classify infeasible/unbounded exactly
        # via elastic feasibility LPs (reference analogue: simplex
        # phase 1 / IPX termination states)
        verdict = classify_inconclusive(lp, options, log=log,
                                        device=device)
        if verdict in (HighsModelStatus.kInfeasible,
                       HighsModelStatus.kUnbounded):
            return verdict, HighsSolution(), info
        return solve_lp_pdlp(lp, options, x0=x0, y0=y0, device=device)

    # hipdlp / large "choose" -> PDHG workhorse
    if _deadline_exceeded(options):
        return (HighsModelStatus.kTimeLimit, HighsSolution(),
                _TimeoutInfo())
    return solve_lp_pdlp(lp, options, x0=x0, y0=y0, device=device)
