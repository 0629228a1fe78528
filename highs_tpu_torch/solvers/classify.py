"""Infeasibility / unboundedness classification via elastic LPs.

When the primary solver cannot conclude (the reference distinguishes
these states inside simplex phase 1 / IPX termination; first-order
methods only produce approximate certificates), we classify exactly:

- primal feasibility: min sum(p + q) s.t. L <= Ax + p - q <= U,
  p, q >= 0, original column bounds.  Optimum > tol  =>  infeasible.
  (This is also the core of the reference's feasibility relaxation,
  Highs.h:634, and the IIS machinery.)
- dual feasibility: min sum(p + q) s.t. A'y + zl - zu + p - q = c with
  sign conditions on y (>=0 on >= rows, <=0 on <= rows, free on
  equality/ranged rows) and zl/zu existing only for finite bounds.
  Optimum > tol with a feasible primal  =>  unbounded.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..constants import HighsModelStatus, ObjSense, kHighsInf
from ..models.lp import HighsLp, HighsSparseMatrix
from ..options import HighsOptions


def build_primal_feasibility_lp(lp: HighsLp) -> HighsLp:
    m, n = lp.num_row, lp.num_col
    a = lp.a_matrix.to_scipy().tocsc()
    eye = sp.identity(m, format="csc")
    a_elastic = sp.hstack([a, eye, -eye], format="csc")
    return HighsLp(
        num_col=n + 2 * m, num_row=m,
        col_cost=np.concatenate([np.zeros(n), np.ones(2 * m)]),
        col_lower=np.concatenate([lp.col_lower, np.zeros(2 * m)]),
        col_upper=np.concatenate([lp.col_upper,
                                  np.full(2 * m, kHighsInf)]),
        row_lower=lp.row_lower.copy(), row_upper=lp.row_upper.copy(),
        a_matrix=HighsSparseMatrix.from_scipy(a_elastic),
        sense=ObjSense.kMinimize, offset=0.0)


def build_dual_feasibility_lp(lp: HighsLp) -> HighsLp:
    """LP whose optimum is 0 iff the dual of `lp` is feasible."""
    m, n = lp.num_row, lp.num_col
    sense = float(lp.sense)
    c = sense * lp.col_cost
    a = lp.a_matrix.to_scipy().tocsc()

    # y sign conditions from row types (minimization convention)
    y_lower = np.full(m, -kHighsInf)
    y_upper = np.full(m, kHighsInf)
    lo_fin_r = np.isfinite(lp.row_lower)
    up_fin_r = np.isfinite(lp.row_upper)
    geq = lo_fin_r & ~up_fin_r
    leq = up_fin_r & ~lo_fin_r
    free_r = ~lo_fin_r & ~up_fin_r
    y_lower[geq] = 0.0
    y_upper[leq] = 0.0
    y_lower[free_r] = 0.0
    y_upper[free_r] = 0.0

    lo_fin_c = np.isfinite(lp.col_lower)
    up_fin_c = np.isfinite(lp.col_upper)
    zl_cols = np.nonzero(lo_fin_c)[0]
    zu_cols = np.nonzero(up_fin_c)[0]
    n_zl, n_zu = len(zl_cols), len(zu_cols)

    # constraint rows (one per original column):
    # (A'y)_j + zl_j - zu_j + p_j - q_j = c_j
    at = a.T.tocsc()
    zl_mat = sp.csc_matrix(
        (np.ones(n_zl), (zl_cols, np.arange(n_zl))), shape=(n, n_zl))
    zu_mat = sp.csc_matrix(
        (-np.ones(n_zu), (zu_cols, np.arange(n_zu))), shape=(n, n_zu))
    eye_n = sp.identity(n, format="csc")
    big_a = sp.hstack([at, zl_mat, zu_mat, eye_n, -eye_n], format="csc")

    num_var = m + n_zl + n_zu + 2 * n
    return HighsLp(
        num_col=num_var, num_row=n,
        col_cost=np.concatenate([np.zeros(m + n_zl + n_zu),
                                 np.ones(2 * n)]),
        col_lower=np.concatenate([y_lower, np.zeros(n_zl + n_zu),
                                  np.zeros(2 * n)]),
        col_upper=np.concatenate([y_upper,
                                  np.full(n_zl + n_zu + 2 * n, kHighsInf)]),
        row_lower=c.copy(), row_upper=c.copy(),
        a_matrix=HighsSparseMatrix.from_scipy(big_a),
        sense=ObjSense.kMinimize, offset=0.0)


def classify_inconclusive(lp: HighsLp, options: HighsOptions,
                          log=None, device=None) -> HighsModelStatus:
    """Resolve kUnknown into kInfeasible / kUnbounded / kUnknown; the
    elastic LPs are solved by the IPM on `device` (default CUDA)."""
    from .ipm.wrapper import solve_lp_ipm
    tol = max(options.primal_feasibility_tolerance, 1e-9)

    feas_lp = build_primal_feasibility_lp(lp)
    st, sol, info = solve_lp_ipm(feas_lp, options, log=None,
                                 device=device)
    if st == HighsModelStatus.kOptimal:
        scale = 1.0 + float(np.linalg.norm(
            np.where(np.isfinite(lp.row_lower), lp.row_lower, 0.0)) +
            np.linalg.norm(
                np.where(np.isfinite(lp.row_upper), lp.row_upper, 0.0)))
        if info.primal_obj > tol * scale:
            return HighsModelStatus.kInfeasible
    else:
        return HighsModelStatus.kUnknown

    dual_lp = build_dual_feasibility_lp(lp)
    st2, sol2, info2 = solve_lp_ipm(dual_lp, options, log=None,
                                    device=device)
    if st2 == HighsModelStatus.kOptimal:
        scale2 = 1.0 + float(np.linalg.norm(lp.col_cost))
        if info2.primal_obj > tol * scale2:
            # primal feasible + dual infeasible => unbounded
            return HighsModelStatus.kUnbounded
    return HighsModelStatus.kUnknown


def build_qp_ray_lp(model) -> HighsLp:
    """LP over ray directions d: minimize c'd (minimization sense) over
    the recession cone of the feasible set intersected with null(Q) and
    the [-1, 1] box.  Optimum < 0  <=>  the QP is unbounded (given a
    feasible point), since the objective is linear along null(Q) rays.
    """
    lp = model.lp
    m, n = lp.num_row, lp.num_col
    sense = float(lp.sense)
    a = lp.a_matrix.to_scipy().tocsc()
    if model.hessian.dim > 0 and model.hessian.num_nz > 0:
        q = (sense * model.hessian.to_scipy_full()).tocsc()
    else:
        q = sp.csc_matrix((0, n))

    lo_fin_r = np.isfinite(lp.row_lower)
    up_fin_r = np.isfinite(lp.row_upper)
    # recession cone of L <= Ax <= U:
    row_lower = np.where(lo_fin_r, 0.0, -kHighsInf)
    row_upper = np.where(up_fin_r, 0.0, kHighsInf)

    d_lower = np.where(np.isfinite(lp.col_lower), 0.0, -1.0)
    d_upper = np.where(np.isfinite(lp.col_upper), 0.0, 1.0)

    nq = q.shape[0]
    big_a = sp.vstack([a, q], format="csc") if nq else a
    return HighsLp(
        num_col=n, num_row=m + nq,
        col_cost=sense * lp.col_cost,
        col_lower=d_lower, col_upper=d_upper,
        row_lower=np.concatenate([row_lower, np.zeros(nq)]),
        row_upper=np.concatenate([row_upper, np.zeros(nq)]),
        a_matrix=HighsSparseMatrix.from_scipy(big_a),
        sense=ObjSense.kMinimize, offset=0.0)


def classify_qp_inconclusive(model, options: HighsOptions,
                             log=None, device=None) -> HighsModelStatus:
    """Resolve a QP kUnknown into kInfeasible / kUnbounded / kUnknown;
    the LPs are solved by the IPM on `device` (default CUDA)."""
    from .ipm.wrapper import solve_lp_ipm
    lp = model.lp
    tol = max(options.primal_feasibility_tolerance, 1e-9)

    feas_lp = build_primal_feasibility_lp(lp)
    st, sol, info = solve_lp_ipm(feas_lp, options, log=None,
                                 device=device)
    if st == HighsModelStatus.kOptimal:
        scale = 1.0 + float(np.linalg.norm(
            np.where(np.isfinite(lp.row_lower), lp.row_lower, 0.0)) +
            np.linalg.norm(
                np.where(np.isfinite(lp.row_upper), lp.row_upper, 0.0)))
        if info.primal_obj > tol * scale:
            return HighsModelStatus.kInfeasible
    else:
        return HighsModelStatus.kUnknown

    ray_lp = build_qp_ray_lp(model)
    st2, sol2, info2 = solve_lp_ipm(ray_lp, options, log=None,
                                    device=device)
    if st2 == HighsModelStatus.kOptimal:
        scale2 = 1.0 + float(np.linalg.norm(lp.col_cost))
        if info2.primal_obj < -tol * scale2:
            return HighsModelStatus.kUnbounded
    return HighsModelStatus.kUnknown
