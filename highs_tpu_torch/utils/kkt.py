"""Uniform KKT assessment.

Re-implements the behavior of the reference's uniform KKT census
(lp_data/HighsSolution.cpp, docs/src/guide/kkt.md): every solver's
solution is assessed against the same absolute and relative measures so
results from PDLP / IPM / simplex are comparable.

Measures (all for `min s·c'x  s.t. L <= Ax <= U, l <= x <= u`, where
s = +1 minimize / -1 maximize):

- primal infeasibility of x against [l, u] and of Ax against [L, U];
- dual infeasibility: a reduced cost / row dual has the wrong sign for the
  bound the value sits at (or is nonzero for an interior value);
- primal residual:  |row_value - A x|;
- dual residual:    |s·c - A'y - z|  with z = col_dual;
- complementarity violation: |min-slack · dual|;
- relative variants scale by 1 + norms of the participating data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..constants import ObjSense, kHighsInf
from ..info import HighsInfo
from ..models.lp import HighsLp
from ..models.solution import HighsSolution


@dataclasses.dataclass
class KktReport:
    num_primal_infeasibilities: int = 0
    max_primal_infeasibility: float = 0.0
    sum_primal_infeasibilities: float = 0.0
    num_dual_infeasibilities: int = 0
    max_dual_infeasibility: float = 0.0
    sum_dual_infeasibilities: float = 0.0
    num_relative_primal_infeasibilities: int = 0
    max_relative_primal_infeasibility: float = 0.0
    num_relative_dual_infeasibilities: int = 0
    max_relative_dual_infeasibility: float = 0.0
    num_primal_residual_errors: int = 0
    max_primal_residual_error: float = 0.0
    num_dual_residual_errors: int = 0
    max_dual_residual_error: float = 0.0
    num_relative_primal_residual_errors: int = 0
    max_relative_primal_residual_error: float = 0.0
    num_relative_dual_residual_errors: int = 0
    max_relative_dual_residual_error: float = 0.0
    num_complementarity_violations: int = 0
    max_complementarity_violation: float = 0.0
    primal_dual_objective_error: float = 0.0
    objective_function_value: float = 0.0
    primal_feasible: bool = False
    dual_feasible: bool = False


def _bound_infeasibility(value, lower, upper):
    below = np.maximum(lower - value, 0.0)
    above = np.maximum(value - upper, 0.0)
    return np.maximum(below, above)


def compute_kkt(lp: HighsLp, solution: HighsSolution,
                primal_feasibility_tolerance: float = 1e-7,
                dual_feasibility_tolerance: float = 1e-7,
                primal_residual_tolerance: float = 1e-7,
                dual_residual_tolerance: float = 1e-7,
                complementarity_tolerance: float = 1e-7,
                hessian=None) -> KktReport:
    rep = KktReport()
    if not solution.value_valid:
        return rep
    x = np.asarray(solution.col_value, dtype=np.float64)
    a = lp.a_matrix.to_scipy()
    ax = a @ x if lp.num_row else np.zeros(0)
    row_value = (np.asarray(solution.row_value, dtype=np.float64)
                 if len(solution.row_value) == lp.num_row else ax)

    sense = float(lp.sense)
    rep.objective_function_value = float(lp.col_cost @ x) + lp.offset
    # QP: objective and stationarity include the Hessian term
    quad = 0.0
    qx = np.zeros(lp.num_col)
    if hessian is not None and getattr(hessian, "dim", 0) > 0:
        qfull = hessian.to_scipy_full()
        qx[:qfull.shape[0]] = qfull @ x[:qfull.shape[0]]
        quad = float(0.5 * x[:qfull.shape[0]] @ qx[:qfull.shape[0]])
        rep.objective_function_value += quad

    # --- primal infeasibilities -------------------------------------------
    col_inf = _bound_infeasibility(x, lp.col_lower, lp.col_upper)
    row_inf = (_bound_infeasibility(row_value, lp.row_lower, lp.row_upper)
               if lp.num_row else np.zeros(0))
    all_inf = np.concatenate([col_inf, row_inf])
    rep.num_primal_infeasibilities = int(
        np.sum(all_inf > primal_feasibility_tolerance))
    rep.max_primal_infeasibility = float(np.max(all_inf, initial=0.0))
    rep.sum_primal_infeasibilities = float(np.sum(all_inf))

    col_scale = 1.0 + np.maximum(np.abs(np.where(np.isfinite(lp.col_lower),
                                                 lp.col_lower, 0.0)),
                                 np.abs(np.where(np.isfinite(lp.col_upper),
                                                 lp.col_upper, 0.0)))
    row_scale = 1.0 + np.maximum(np.abs(np.where(np.isfinite(lp.row_lower),
                                                 lp.row_lower, 0.0)),
                                 np.abs(np.where(np.isfinite(lp.row_upper),
                                                 lp.row_upper, 0.0)))
    rel_inf = np.concatenate([col_inf / col_scale,
                              row_inf / row_scale if lp.num_row
                              else np.zeros(0)])
    rep.num_relative_primal_infeasibilities = int(
        np.sum(rel_inf > primal_feasibility_tolerance))
    rep.max_relative_primal_infeasibility = float(np.max(rel_inf,
                                                         initial=0.0))
    rep.primal_feasible = rep.num_primal_infeasibilities == 0

    # --- primal residual (row_value vs Ax) --------------------------------
    if lp.num_row:
        pres = np.abs(row_value - ax)
        rel_pres = pres / (1.0 + np.abs(ax))
        rep.num_primal_residual_errors = int(
            np.sum(pres > primal_residual_tolerance))
        rep.max_primal_residual_error = float(np.max(pres, initial=0.0))
        rep.num_relative_primal_residual_errors = int(
            np.sum(rel_pres > primal_residual_tolerance))
        rep.max_relative_primal_residual_error = float(
            np.max(rel_pres, initial=0.0))

    if not solution.dual_valid:
        return rep

    y = np.asarray(solution.row_dual, dtype=np.float64)
    z = np.asarray(solution.col_dual, dtype=np.float64)

    # --- dual residual: c - A'y - z = 0 (duals reported in the original
    # sense, so the stationarity identity is sense-free) -------------------
    aty = a.T @ y if lp.num_row else np.zeros(lp.num_col)
    # QP stationarity: grad = c + Qx replaces c (Qx enters in the
    # original sense, like the cost)
    grad = lp.col_cost + qx
    dres = np.abs(grad - aty - z)
    rel_dres = dres / (1.0 + np.abs(grad))
    rep.num_dual_residual_errors = int(np.sum(dres > dual_residual_tolerance))
    rep.max_dual_residual_error = float(np.max(dres, initial=0.0))
    rep.num_relative_dual_residual_errors = int(
        np.sum(rel_dres > dual_residual_tolerance))
    rep.max_relative_dual_residual_error = float(np.max(rel_dres,
                                                        initial=0.0))

    # --- dual infeasibilities ---------------------------------------------
    def dual_infeas(value, lower, upper, dual):
        # A dual value is infeasible when its sign cannot be supported by
        # any bound: in the minimization convention a positive reduced
        # cost requires a finite lower bound, a negative one a finite
        # upper bound.  (Complementarity with the *current* point is
        # measured separately as max_complementarity_violation — this
        # split matches first-order/IPM semantics and the reference's
        # uniform KKT census, which reports both.)  For maximization the
        # reported duals flip sign; testing sense*dual restores the
        # minimization convention.
        sdual = sense * dual
        lo_fin = np.isfinite(lower)
        up_fin = np.isfinite(upper)
        infeas = (np.where(lo_fin, 0.0, np.maximum(sdual, 0.0)) +
                  np.where(up_fin, 0.0, np.maximum(-sdual, 0.0)))
        return infeas

    col_dinf = dual_infeas(x, lp.col_lower, lp.col_upper, z)
    row_dinf = (dual_infeas(row_value, lp.row_lower, lp.row_upper, y)
                if lp.num_row else np.zeros(0))
    all_dinf = np.concatenate([col_dinf, row_dinf])
    rep.num_dual_infeasibilities = int(
        np.sum(all_dinf > dual_feasibility_tolerance))
    rep.max_dual_infeasibility = float(np.max(all_dinf, initial=0.0))
    rep.sum_dual_infeasibilities = float(np.sum(all_dinf))
    rel_dinf = all_dinf / (1.0 + np.abs(np.concatenate([z, y])))
    rep.num_relative_dual_infeasibilities = int(
        np.sum(rel_dinf > dual_feasibility_tolerance))
    rep.max_relative_dual_infeasibility = float(np.max(rel_dinf,
                                                       initial=0.0))
    rep.dual_feasible = rep.num_dual_infeasibilities == 0

    # --- complementarity ---------------------------------------------------
    def comp_viol(value, lower, upper, dual):
        lo_slack = np.where(np.isfinite(lower), value - lower, kHighsInf)
        up_slack = np.where(np.isfinite(upper), upper - value, kHighsInf)
        slack = np.minimum(np.abs(lo_slack), np.abs(up_slack))
        slack = np.where(np.isfinite(slack), slack, 0.0)
        return np.abs(slack * dual)

    comp = np.concatenate([
        comp_viol(x, lp.col_lower, lp.col_upper, z),
        comp_viol(row_value, lp.row_lower, lp.row_upper, y)
        if lp.num_row else np.zeros(0)])
    rep.num_complementarity_violations = int(
        np.sum(comp > complementarity_tolerance))
    rep.max_complementarity_violation = float(np.max(comp, initial=0.0))

    # --- primal-dual objective error --------------------------------------
    # dual objective in the minimization sense (using sense-corrected duals)
    ym = sense * y
    zm = sense * z
    yl = np.where(np.isfinite(lp.row_lower), lp.row_lower, 0.0)
    yu = np.where(np.isfinite(lp.row_upper), lp.row_upper, 0.0)
    zl = np.where(np.isfinite(lp.col_lower), lp.col_lower, 0.0)
    zu = np.where(np.isfinite(lp.col_upper), lp.col_upper, 0.0)
    dual_obj = (np.sum(np.maximum(ym, 0.0) * yl + np.minimum(ym, 0.0) * yu) +
                np.sum(np.maximum(zm, 0.0) * zl + np.minimum(zm, 0.0) * zu))
    # QP (Dorn) dual objective: bound terms - 1/2 x'Qx (min sense)
    dual_obj -= sense * quad
    primal_obj_min = sense * (rep.objective_function_value - lp.offset)
    denom = 1.0 + abs(primal_obj_min) + abs(dual_obj)
    rep.primal_dual_objective_error = abs(primal_obj_min - dual_obj) / denom
    return rep


def fill_info_from_kkt(info: HighsInfo, rep: KktReport):
    for f in dataclasses.fields(rep):
        if hasattr(info, f.name):
            setattr(info, f.name, getattr(rep, f.name))
