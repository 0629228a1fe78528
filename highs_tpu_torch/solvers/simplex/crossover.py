"""Crossover: interior-point solution -> optimal vertex basis.

Re-implements the role of the reference crossover (ipm/ipx/crossover.cc
primal/dual push phases; run_crossover option): from a near-optimal
interior solution, guess an active set (variables within tolerance of a
bound go nonbasic; the most interior variables form the basic set), then
let the native simplex repair and finish from that warm basis; on a
near-optimal starting point it needs few pivots.  Host work only.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from ...constants import HighsModelStatus
from ...models.lp import HighsLp
from ...models.solution import HighsSolution
from ...options import HighsOptions
from .native import (RESULT_INFEASIBLE, RESULT_OPTIMAL, RESULT_UNBOUNDED,
                     simplex_solve)
from .wrapper import SimplexRunInfo, basis_from_statuses


def _guess_statuses(values, lo, up, tol):
    """Per-variable status guess and 'interiorness' score."""
    lo_fin = np.isfinite(lo)
    up_fin = np.isfinite(up)
    d_lo = np.where(lo_fin, values - lo, np.inf)
    d_up = np.where(up_fin, up - values, np.inf)
    at_lo = d_lo <= tol * (1.0 + np.abs(np.where(lo_fin, lo, 0.0)))
    at_up = d_up <= tol * (1.0 + np.abs(np.where(up_fin, up, 0.0)))
    # a nonbasic status must reference a FINITE bound (a kLower status
    # with lo = -inf would park the variable at the pseudo-infinite
    # bound and blow up the warm basis)
    statuses = np.where(lo_fin, 0, np.where(up_fin, 2, 3)).astype(np.int8)
    statuses[at_up & ~at_lo & up_fin] = 2  # kUpper
    free = ~lo_fin & ~up_fin
    statuses[free] = 3  # kZero
    interior = np.minimum(d_lo, d_up)
    interior[free] = np.inf
    return statuses, interior


def crossover_from_solution(lp: HighsLp, options: HighsOptions,
                            solution: HighsSolution
                            ) -> Tuple[HighsModelStatus, HighsSolution,
                                       SimplexRunInfo]:
    """Build a basis guess from `solution` and clean up with simplex."""
    t0 = time.perf_counter()
    m, n = lp.num_row, lp.num_col
    tol = 10.0 * options.primal_feasibility_tolerance

    col_stat, col_int = _guess_statuses(
        np.asarray(solution.col_value), lp.col_lower, lp.col_upper, tol)
    row_vals = (np.asarray(solution.row_value)
                if len(solution.row_value) == m
                else lp.a_matrix.to_scipy() @ solution.col_value)
    row_stat, row_int = _guess_statuses(
        row_vals, lp.row_lower, lp.row_upper, tol)

    statuses = np.concatenate([col_stat, row_stat])
    interior = np.concatenate([col_int, row_int])
    # the m most interior variables become the basic guess
    order = np.argsort(-interior)
    statuses[order[:m]] = 1  # kBasic

    sense = float(lp.sense)
    result, x, y, z, basis_out, iters = simplex_solve(
        lp.a_matrix.to_scipy().tocsc(), sense * lp.col_cost,
        lp.col_lower, lp.col_upper, lp.row_lower, lp.row_upper,
        basis_in=statuses,
        tol_p=options.primal_feasibility_tolerance * 1e-2,
        tol_d=options.dual_feasibility_tolerance * 1e-2,
        max_iter=min(options.simplex_iteration_limit, 10**7),
        time_limit=min(options.time_limit, 1e18))

    info = SimplexRunInfo()
    info.iterations = iters
    info.simplex_iterations = iters
    info.solve_time = time.perf_counter() - t0
    if result == RESULT_OPTIMAL:
        info.status = HighsModelStatus.kOptimal
    elif result == RESULT_INFEASIBLE:
        info.status = HighsModelStatus.kInfeasible
        return info.status, HighsSolution(), info
    elif result == RESULT_UNBOUNDED:
        info.status = HighsModelStatus.kUnbounded
        return info.status, HighsSolution(), info
    else:
        info.status = HighsModelStatus.kUnknown
        return info.status, solution, info

    sol = HighsSolution(
        value_valid=True, dual_valid=True,
        col_value=x, col_dual=sense * z,
        row_value=lp.a_matrix.to_scipy() @ x, row_dual=sense * y)
    info.primal_obj = float(lp.col_cost @ x) + lp.offset
    info.basis = basis_from_statuses(basis_out, n, m)
    return info.status, sol, info
