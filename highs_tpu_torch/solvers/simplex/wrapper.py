"""Simplex solver entry ("simplex" solver option, and "choose" on a
small or very sparse LP).

Runs the native bounded-variable simplex on the host (native/
hsimplex.cpp and the dual engine of native/hdual.cpp, through this
package's ctypes bindings; the sequential pivot loop stays on the host,
like the reference's C++ simplex) and returns a vertex solution with a
valid basis.  Problems past the simplex's row limit, a numerical
failure, or an exhausted pivot budget go to the interior-point solver
on the caller's device (then crossover to a vertex).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ...constants import (HighsBasisStatus, HighsCallbackType,
                          HighsModelStatus)
from ...models.lp import HighsLp
from ...models.solution import HighsBasis, HighsSolution
from ...options import HighsOptions
from ..ipm.wrapper import solve_lp_ipm
from ..pdlp.wrapper import _solve_bound_lp
from .dual_native import RESULT_OPTIMAL as DUAL_OPTIMAL
from .dual_native import dual_solve
from .dualize import build_dual_lp, primal_status_guess, should_dualize
from .native import (RESULT_INFEASIBLE, RESULT_ITER_LIMIT, RESULT_OPTIMAL,
                     RESULT_UNBOUNDED, _ruiz_scales, simplex_solve)


@dataclasses.dataclass
class SimplexRunInfo:
    status: HighsModelStatus = HighsModelStatus.kNotset
    iterations: int = 0
    simplex_iterations: int = 0
    primal_obj: float = 0.0
    solve_time: float = 0.0
    basis: Optional[HighsBasis] = None


_STATUS_MAP = {
    0: HighsBasisStatus.kLower,
    1: HighsBasisStatus.kBasic,
    2: HighsBasisStatus.kUpper,
    3: HighsBasisStatus.kZero,
}

# problems beyond this row count use the IPM path (the limit reflects
# the serial pricing loop, not memory)
SIMPLEX_MAX_ROWS = 20000


def basis_from_statuses(statuses: np.ndarray, n: int, m: int) -> HighsBasis:
    basis = HighsBasis(valid=True)
    basis.col_status = [_STATUS_MAP[int(s)] for s in statuses[:n]]
    basis.row_status = [_STATUS_MAP[int(s)] for s in statuses[n:n + m]]
    return basis


def _scaled_dual_solve(lp: HighsLp, a_csc, sense: float, cap: int, kw):
    """The dual engine on the Ruiz-scaled LP, mapped back; None unless
    it ends optimal at a point feasible for the unscaled LP."""
    sc = _ruiz_scales(a_csc)
    if sc is not None:
        r, c = sc
        a_d = (sp.diags(r) @ a_csc @ sp.diags(c)).tocsc()
    else:
        r = c = None
        a_d = a_csc

    def scl(v, f, mul):
        if f is None:
            return v
        return np.where(np.isfinite(v), v * f if mul else v / f, v)
    cost = sense * lp.col_cost * (c if c is not None else 1.0)
    rd, xd, yd, zd, bd, itd = dual_solve(
        a_d, a_d.tocsr(), cost, scl(lp.col_lower, c, False),
        scl(lp.col_upper, c, False), scl(lp.row_lower, r, True),
        scl(lp.row_upper, r, True), tol_p=kw["tol_p"], tol_d=kw["tol_d"],
        max_iter=cap, time_limit=kw["time_limit"])
    if rd != DUAL_OPTIMAL:
        return None
    if c is not None:
        xd, yd, zd = xd * c, yd * r, zd / c
    ax = a_csc @ xd
    feas = (np.all(ax >= lp.row_lower - 1e-6) and
            np.all(ax <= lp.row_upper + 1e-6) and
            np.all(xd >= lp.col_lower - 1e-6) and
            np.all(xd <= lp.col_upper + 1e-6))
    return (RESULT_OPTIMAL, xd, yd, zd, bd, itd) if feas else None


def solve_lp_simplex(lp: HighsLp, options: HighsOptions, log=None,
                     basis: Optional[HighsBasis] = None, device=None
                     ) -> Tuple[HighsModelStatus, HighsSolution,
                                SimplexRunInfo]:
    """Simplex solve of `lp` on the host; its IPM fallbacks run on
    `device` (default CUDA)."""
    t0 = time.perf_counter()
    info = SimplexRunInfo()
    if lp.num_row == 0:
        status, sol = _solve_bound_lp(lp)
        info.status = status
        if sol.value_valid:
            info.primal_obj = float(lp.col_cost @ sol.col_value) + lp.offset
        return status, sol, info
    if lp.num_row > SIMPLEX_MAX_ROWS:
        return solve_lp_ipm(lp, options, log=log, device=device)

    sense = float(lp.sense)
    basis_in = None
    if basis is not None and basis.valid and \
            len(basis.col_status) == lp.num_col and \
            len(basis.row_status) == lp.num_row:
        rev = {v: k for k, v in _STATUS_MAP.items()}
        basis_in = np.array(
            [rev.get(HighsBasisStatus(int(s)), 0)
             for s in list(basis.col_status) + list(basis.row_status)],
            dtype=np.int8)

    # ---- dualization strategy (reference HApp.h:206-214 via
    # simplex_dualize_strategy): cold-started tall LPs solve their
    # bounded-variable dual (n rows instead of m), then the status guess
    # mapped back warm-starts the native engine, which certifies the
    # solution primal-side (the undualize() role)
    if basis_in is None and not getattr(options, "_in_dualize", False) \
            and should_dualize(lp, int(options.simplex_dualize_strategy),
                               False):
        built = build_dual_lp(lp, sense)
        if built is not None:
            dual_lp, dz_meta = built
            d_opts = copy.copy(options)
            d_opts._in_dualize = True
            d_opts.simplex_dualize_strategy = -1
            if log is not None:
                log(f"Simplex dualize: solving the dual "
                    f"({dual_lp.num_row} rows x {dual_lp.num_col} cols)")
            dst, dsol, _ = solve_lp_simplex(dual_lp, d_opts, log=None,
                                            device=device)
            if dst == HighsModelStatus.kOptimal:
                guess = primal_status_guess(lp, sense, dsol, dz_meta)
                if guess is not None:
                    basis_in = guess

    # native pivot budget: highly degenerate instances crawl in primal
    # phase 1; past this budget IPM + crossover is faster and still ends
    # at a vertex basis
    native_budget = min(options.simplex_iteration_limit,
                        max(100000, 100 * lp.num_row))
    cbs = getattr(options, "_callbacks", None)
    si_active = cbs is not None and cbs.callback_active(
        HighsCallbackType.kCallbackSimplexInterrupt)
    a_solve = lp.a_matrix.to_scipy().tocsc()
    kw = dict(tol_p=options.primal_feasibility_tolerance * 1e-2,
              tol_d=options.dual_feasibility_tolerance * 1e-2,
              time_limit=min(options.time_limit, 1e18))
    if not si_active:
        # the reference's default LP engine is DUAL simplex: try the
        # native dual engine first under a strict pivot cap; anything
        # but a verified optimum falls through to the primal engine
        result = None
        if basis_in is None and lp.num_row >= 2:
            out = _scaled_dual_solve(
                lp, a_solve, sense,
                int(min(native_budget, 6 * lp.num_row + 4000)), kw)
            if out is not None:
                result, x, y, z, basis_out, iters = out
        if result is None:
            result, x, y, z, basis_out, iters = simplex_solve(
                a_solve, sense * lp.col_cost,
                lp.col_lower, lp.col_upper, lp.row_lower, lp.row_upper,
                basis_in=basis_in, max_iter=native_budget, **kw)
    else:
        # kCallbackSimplexInterrupt (reference: fired per iteration,
        # HEkk.cpp:3460): the native pivot loop runs in chunks with the
        # callback fired between them
        iters = 0
        chunk = 2000
        b_cur = basis_in
        interrupted = False
        while True:
            result, x, y, z, basis_out, it_c = simplex_solve(
                a_solve, sense * lp.col_cost,
                lp.col_lower, lp.col_upper, lp.row_lower, lp.row_upper,
                basis_in=b_cur,
                max_iter=min(chunk, native_budget - iters), **kw)
            iters += it_c
            if result != RESULT_ITER_LIMIT or iters >= native_budget:
                break
            cbs.data_out.simplex_iteration_count = iters
            cbs.data_out.running_time = time.perf_counter() - t0
            if cbs.call(HighsCallbackType.kCallbackSimplexInterrupt,
                        "Simplex interrupt"):
                interrupted = True
                break
            b_cur = basis_out
        if interrupted:
            info.iterations = iters
            info.simplex_iterations = iters
            info.status = HighsModelStatus.kInterrupt
            info.solve_time = time.perf_counter() - t0
            return info.status, HighsSolution(), info

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
    elif result == RESULT_ITER_LIMIT and \
            native_budget < options.simplex_iteration_limit and \
            _elastic_says_infeasible(lp, options):
        # phase-1 stall arbiter: the elastic LP is always feasible, and a
        # strictly positive optimum certifies infeasibility
        info.status = HighsModelStatus.kInfeasible
        return info.status, HighsSolution(), info
    elif result == RESULT_ITER_LIMIT and \
            native_budget < options.simplex_iteration_limit:
        # budget exhausted (not a user limit): IPM -> crossover gives a
        # vertex basis; the cleanup re-enters the native simplex
        # warm-started near the optimum
        st, sol, raw = solve_lp_ipm(lp, options, log=log, device=device)
        if sol.value_valid and st in (HighsModelStatus.kOptimal,
                                      HighsModelStatus.kUnknown,
                                      HighsModelStatus.kIterationLimit):
            # even an imprecise interior point is a good crossover seed
            # (reference: IPM "imprecise" -> simplex cleanup,
            # HighsSolve.cpp:123-163)
            from .crossover import crossover_from_solution
            st2, sol2, info2 = crossover_from_solution(lp, options, sol)
            if st2 == HighsModelStatus.kOptimal:
                info2.ipm_iterations = raw.iterations
                info2.simplex_iterations = iters + info2.iterations
                return st2, sol2, info2
        return st, sol, raw
    elif result == RESULT_ITER_LIMIT:
        info.status = HighsModelStatus.kIterationLimit
    else:
        # singular/numerical failure: IPM fallback
        return solve_lp_ipm(lp, options, log=log, device=device)

    sol = HighsSolution(
        value_valid=True, dual_valid=True,
        col_value=x, col_dual=sense * z,
        row_value=lp.a_matrix.to_scipy() @ x, row_dual=sense * y)
    info.primal_obj = float(lp.col_cost @ x) + lp.offset
    info.basis = basis_from_statuses(basis_out, lp.num_col, lp.num_row)
    return info.status, sol, info


def _elastic_says_infeasible(lp: HighsLp, options: HighsOptions) -> bool:
    """Solve the elastic feasibility LP  min 1'(p+q) s.t.
    rl <= Ax + p - q <= ru  with the native simplex and report whether
    its optimum certifies primal infeasibility."""
    m = lp.num_row
    if m == 0:
        return bool(np.any(lp.col_lower > lp.col_upper + 1e-9))
    a = lp.a_matrix.to_scipy().tocsc()
    ident = sp.identity(m, format="csc")
    a_el = sp.hstack([a, ident, -ident]).tocsc()
    cost = np.concatenate([np.zeros(lp.num_col), np.ones(2 * m)])
    lo_el = np.concatenate([lp.col_lower, np.zeros(2 * m)])
    up_el = np.concatenate([lp.col_upper, np.full(2 * m, np.inf)])
    result, x, _y, _z, _b, _it = simplex_solve(
        a_el, cost, lo_el, up_el, lp.row_lower, lp.row_upper,
        tol_p=1e-9, tol_d=1e-9,
        max_iter=max(100000, 50 * (lp.num_col + m)),
        time_limit=min(options.time_limit, 1e18))
    if result != RESULT_OPTIMAL:
        return False  # inconclusive
    scale = 1.0 + float(np.max(np.abs(np.where(
        np.isfinite(lp.row_upper), lp.row_upper, 0.0)), initial=0.0))
    return float(cost @ x) > 1e-7 * scale
