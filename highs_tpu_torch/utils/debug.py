"""highs_debug_level-gated consistency checks.

Role of the reference's debug layer (lp_data/HighsDebug.cpp,
HighsSolutionDebug.cpp, simplex/HEkkDebug, util/HFactorDebug): optional
assert-style validation of solutions and bases after a solve, gated by
`highs_debug_level` so production runs pay nothing.

Levels (reference kHighsDebugLevel*):
  0  off
  1  cheap: basis shape/status consistency, primal feasibility census
  2  costly: full relative-KKT census (primal+dual residuals,
     complementarity) against the solver tolerances
  3  expensive: basis-system residual  ||B x_B - (b - N x_N)||
"""
from __future__ import annotations

import numpy as np

from ..constants import HighsBasisStatus, HighsModelStatus


def debug_check_lp_solution(lp, solution, basis, options, status,
                            log=None) -> list:
    """Run the level-gated checks on the host; returns a list of finding
    strings (also sent to `log`).  A failure of the checks themselves is
    reported as a finding, never raised; they touch no device."""
    level = int(getattr(options, "highs_debug_level", 0) or 0)
    findings: list = []
    if level <= 0 or not getattr(solution, "value_valid", False):
        return findings

    def report(msg):
        findings.append(msg)
        if log is not None:
            log(f"DEBUG[{level}]: {msg}")

    try:
        n, m = lp.num_col, lp.num_row
        x = np.asarray(solution.col_value, dtype=np.float64)
        feastol = options.primal_feasibility_tolerance

        # ---- level >= 1: cheap structural checks ----------------------
        if basis is not None and getattr(basis, "valid", False):
            cstat = np.asarray(basis.col_status)
            rstat = np.asarray(basis.row_status)
            n_basic = int((cstat == HighsBasisStatus.kBasic).sum() +
                          (rstat == HighsBasisStatus.kBasic).sum())
            if len(cstat) == n and len(rstat) == m and n_basic != m:
                report(f"basis has {n_basic} basic variables, "
                       f"expected num_row={m}")
            lo = np.asarray(lp.col_lower)
            up = np.asarray(lp.col_upper)
            bad_lower = (cstat == HighsBasisStatus.kLower) & \
                ~np.isfinite(lo)
            bad_upper = (cstat == HighsBasisStatus.kUpper) & \
                ~np.isfinite(up)
            if bad_lower.any() or bad_upper.any():
                report(f"{int(bad_lower.sum() + bad_upper.sum())} "
                       "nonbasic statuses point at infinite bounds")
        if status == HighsModelStatus.kOptimal:
            viol_lo = np.maximum(lp.col_lower - x, 0.0)
            viol_up = np.maximum(x - lp.col_upper, 0.0)
            worst = float(np.maximum(viol_lo, viol_up).max(initial=0.0))
            if worst > 10.0 * feastol:
                report(f"column bound violation {worst:.3e} exceeds "
                       f"10x feasibility tolerance at optimality")

        # ---- level >= 2: full relative KKT census ---------------------
        if level >= 2 and m and status == HighsModelStatus.kOptimal:
            a = lp.a_matrix.to_scipy()
            ax = a @ x
            rl = np.asarray(lp.row_lower)
            ru = np.asarray(lp.row_upper)
            pres = float(np.maximum(
                np.maximum(rl - ax, ax - ru), 0.0).max(initial=0.0))
            if pres > 10.0 * feastol * (1.0 + float(
                    np.abs(ax).max(initial=0.0))):
                report(f"row violation {pres:.3e} at optimality")
            if getattr(solution, "dual_valid", False) and \
                    len(solution.row_dual) == m:
                y = np.asarray(solution.row_dual)
                z = np.asarray(solution.col_dual)
                sense = float(lp.sense)
                stat_res = sense * np.asarray(lp.col_cost) - a.T @ y - z
                worst_d = float(np.abs(stat_res).max(initial=0.0))
                dualtol = options.dual_feasibility_tolerance
                scale = 1.0 + float(
                    np.abs(lp.col_cost).max(initial=0.0))
                if worst_d > 1e3 * dualtol * scale:
                    report(f"dual stationarity residual {worst_d:.3e}")

        # ---- level >= 3: reconstruct x_B through the basis system -----
        # (role of HEkkDebug/HFactorDebug solve checks): with the
        # slack form A x - s = 0, solving B xb = -N x_N must reproduce
        # the basic components of (x, s)
        if level >= 3 and m and basis is not None and \
                getattr(basis, "valid", False) and \
                len(basis.col_status) == n and \
                len(basis.row_status) == m:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla
            a = lp.a_matrix.to_scipy().tocsc()
            full = sp.hstack([a, -sp.identity(m, format="csc")]).tocsc()
            stat = np.concatenate([np.asarray(basis.col_status),
                                   np.asarray(basis.row_status)])
            row_act = a @ x
            v = np.concatenate([x, row_act])  # (x, s)
            basic = np.nonzero(stat == HighsBasisStatus.kBasic)[0]
            nonbasic = np.nonzero(stat != HighsBasisStatus.kBasic)[0]
            if len(basic) == m:
                bmat = full[:, basic].tocsc()
                rhs = -(full[:, nonbasic] @ v[nonbasic])
                try:
                    xb = spla.spsolve(bmat, rhs)
                    resid = float(np.abs(
                        xb - v[basic]).max(initial=0.0))
                    scale = 1.0 + float(np.abs(v).max(initial=0.0))
                    if resid > 1e-6 * scale:
                        report("basis reconstruction residual "
                               f"{resid:.3e}")
                except (RuntimeError, ArithmeticError, ValueError):
                    # scipy's answer to a singular basis matrix
                    report("basis matrix is singular")
    # the debug layer must never break a solve: numpy and scipy errors of
    # the checks themselves are findings (RuntimeError, which a device's
    # errors are, is not caught here)
    except (ArithmeticError, ValueError, TypeError, IndexError,
            AttributeError, np.linalg.LinAlgError) as exc:
        report(f"debug checker itself failed: {exc!r}")
    return findings
