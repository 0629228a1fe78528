"""Cost/bound/RHS ranging from an optimal basis.

Re-implements the behavior of the reference ranging
(lp_data/HighsRanging.cpp, Highs::getRanging Highs.h:629): for each
column cost, column bound and row bound, the range over which the
current optimal basis stays optimal, plus the objective value at each
end of the range (linear within the basis: d obj/d c_j = x_j,
d obj/d bound = dual).

Works over the augmented system W = [A, -I] (logicals carry row
bounds); tableau rows/columns come from a sparse LU of the basis.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..constants import HighsBasisStatus, kHighsInf
from ..models.lp import HighsLp
from ..models.solution import HighsBasis, HighsSolution


@dataclasses.dataclass
class HighsRangingRecord:
    value_: np.ndarray
    objective_: np.ndarray


@dataclasses.dataclass
class HighsRanging:
    valid: bool = False
    col_cost_up: HighsRangingRecord = None
    col_cost_dn: HighsRangingRecord = None
    col_bound_up: HighsRangingRecord = None
    col_bound_dn: HighsRangingRecord = None
    row_bound_up: HighsRangingRecord = None
    row_bound_dn: HighsRangingRecord = None


def compute_ranging(lp: HighsLp, solution: HighsSolution,
                    basis: HighsBasis, objective: float) -> HighsRanging:
    m, n = lp.num_row, lp.num_col
    nv = n + m
    sense = float(lp.sense)
    a = lp.a_matrix.to_scipy().tocsc()
    w = sp.hstack([a, -sp.identity(m, format="csc")], format="csc")

    statuses = list(basis.col_status) + list(basis.row_status)
    basic = [j for j in range(nv)
             if statuses[j] == HighsBasisStatus.kBasic]
    nonbasic = [j for j in range(nv)
                if statuses[j] != HighsBasisStatus.kBasic]
    if len(basic) != m:
        return HighsRanging(valid=False)

    b_mat = w[:, basic].tocsc()
    try:
        lu = spla.splu(b_mat)
    except RuntimeError:
        return HighsRanging(valid=False)

    cost = np.concatenate([sense * lp.col_cost, np.zeros(m)])
    lo = np.concatenate([lp.col_lower, lp.row_lower])
    up = np.concatenate([lp.col_upper, lp.row_upper])
    xall = np.concatenate([solution.col_value, solution.row_value])
    # duals in minimization sense
    zall = sense * np.concatenate([solution.col_dual, solution.row_dual])

    pos_of = {j: p for p, j in enumerate(basic)}
    tol = 1e-9

    inf = kHighsInf
    cost_up_v = np.full(n, inf)
    cost_dn_v = np.full(n, -inf)
    cost_up_o = np.full(n, inf)
    cost_dn_o = np.full(n, -inf)
    bnd_up_v = np.full(nv, inf)
    bnd_dn_v = np.full(nv, -inf)
    bnd_up_o = np.full(nv, inf)
    bnd_dn_o = np.full(nv, -inf)

    # the nonbasic columns' tableau entries come from one sparse product
    # per basic row (the JAX package slices W one column at a time, which
    # takes minutes at 1,500 rows); their statuses and reduced costs
    # line up with it
    nb = np.asarray(nonbasic, dtype=np.int64)
    w_nb_t = w[:, nb].T.tocsr()
    st_nb = np.array([int(statuses[k]) for k in nonbasic], dtype=np.int64)
    z_nb = zall[nb]
    at_lower = st_nb == int(HighsBasisStatus.kLower)
    at_upper = st_nb == int(HighsBasisStatus.kUpper)
    up_b = up[np.asarray(basic, dtype=np.int64)]
    lo_b = lo[np.asarray(basic, dtype=np.int64)]
    x_b = xall[np.asarray(basic, dtype=np.int64)]

    def ratio_bounds(alpha, keep, to_max, to_min, stop):
        """min over `to_max` and max over `to_min` of the candidates in
        `keep` order, as the sequential ratio test takes them: a `stop`
        entry resets both to 0 and only the entries after the last one
        count."""
        idx = np.nonzero(keep)[0]
        stops = idx[stop[idx]]
        if stops.size:
            idx = idx[idx > stops[-1]]
        dmax = min(0.0, float(np.min(to_max[idx], initial=np.inf))) \
            if stops.size else float(np.min(to_max[idx], initial=np.inf))
        dmin = max(0.0, float(np.max(to_min[idx], initial=-np.inf))) \
            if stops.size else float(np.max(to_min[idx], initial=-np.inf))
        return dmax, dmin

    # --- cost ranging ------------------------------------------------------
    for j in range(n):
        st = statuses[j]
        xj = xall[j]
        if st != HighsBasisStatus.kBasic:
            zj = zall[j]
            # nonbasic: reduced cost z_j = c_j - w_j' y; changing c_j by
            # delta changes z_j by delta; stays optimal while z keeps sign
            if st == HighsBasisStatus.kLower:
                cost_dn_v[j] = sense * lp.col_cost[j] - zj
                cost_up_v[j] = inf
            elif st == HighsBasisStatus.kUpper:
                cost_up_v[j] = sense * lp.col_cost[j] - zj
                cost_dn_v[j] = -inf
            else:  # free at zero: any change breaks optimality
                cost_dn_v[j] = sense * lp.col_cost[j]
                cost_up_v[j] = sense * lp.col_cost[j]
        else:
            # basic: delta bounded by ratio test on the tableau row
            p = pos_of[j]
            e = np.zeros(m)
            e[p] = 1.0
            brow = lu.solve(e, trans="T")  # row p of B^{-1}
            alpha = w_nb_t @ brow
            keep = np.abs(alpha) >= tol
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = z_nb / alpha
            # z_k(delta) = z_k - delta * alpha must keep sign: at a lower
            # bound z_k - delta alpha >= 0, at an upper one <= 0; a free
            # nonbasic's z_k must stay 0
            pos = alpha > 0
            to_max = np.where((at_lower & pos) | (at_upper & ~pos), ratio,
                              inf)
            to_min = np.where((at_lower & ~pos) | (at_upper & pos), ratio,
                              -inf)
            dmax, dmin = ratio_bounds(alpha, keep, to_max, to_min,
                                      ~(at_lower | at_upper))
            cost_up_v[j] = sense * lp.col_cost[j] + dmax
            cost_dn_v[j] = sense * lp.col_cost[j] + dmin
        # objective at range ends: d obj / d c_j = x_j
        for arr_v, arr_o in ((cost_up_v, cost_up_o),
                             (cost_dn_v, cost_dn_o)):
            end = arr_v[j]
            if np.isfinite(end):
                arr_o[j] = objective + sense * (
                    end - sense * lp.col_cost[j]) * xj
            else:
                arr_o[j] = inf if xj == 0 else np.sign(end) * inf

    # --- bound ranging -----------------------------------------------------
    for j in range(nv):
        st = statuses[j]
        xj = xall[j]
        dual_j = zall[j]
        if st == HighsBasisStatus.kBasic:
            # a basic variable's active-bound ranging: lower can rise to
            # x_j, upper can drop to x_j; the other direction needs a
            # ratio test — report the simple within-basis range
            bnd_dn_v[j] = -inf if not np.isfinite(lo[j]) else xj \
                if lo[j] > -inf else -inf
            bnd_dn_v[j] = xj if np.isfinite(lo[j]) else -inf
            bnd_up_v[j] = xj if np.isfinite(up[j]) else inf
            bnd_dn_o[j] = objective
            bnd_up_o[j] = objective
        else:
            # nonbasic at a bound: moving the bound moves x_j; basics
            # follow -B^{-1} w_j; ratio test limits the move
            alpha = lu.solve(w[:, j].toarray().ravel())
            keep = np.abs(alpha) >= tol
            room_up = up_b - x_b
            room_dn = lo_b - x_b
            # x_B = x_B - alpha * t where t = bound move
            with np.errstate(divide="ignore", invalid="ignore"):
                to_max = np.where(alpha > 0, -room_dn / alpha,
                                  -room_up / alpha)
                to_min = np.where(alpha > 0, -room_up / alpha,
                                  -room_dn / alpha)
            dmax, dmin = ratio_bounds(alpha, keep, to_max, to_min,
                                      np.zeros(m, dtype=bool))
            base = xj
            bnd_up_v[j] = base + dmax
            bnd_dn_v[j] = base + dmin
            # d obj / d bound = dual (minimization sense)
            bnd_up_o[j] = objective + sense * dmax * dual_j \
                if np.isfinite(dmax) else inf
            bnd_dn_o[j] = objective + sense * dmin * dual_j \
                if np.isfinite(dmin) else -inf

    def rec(v, o):
        return HighsRangingRecord(value_=v, objective_=o)

    # cost values reported in the original sense
    return HighsRanging(
        valid=True,
        col_cost_up=rec(sense * cost_up_v if sense < 0 else cost_up_v,
                        cost_up_o),
        col_cost_dn=rec(sense * cost_dn_v if sense < 0 else cost_dn_v,
                        cost_dn_o),
        col_bound_up=rec(bnd_up_v[:n], bnd_up_o[:n]),
        col_bound_dn=rec(bnd_dn_v[:n], bnd_dn_o[:n]),
        row_bound_up=rec(bnd_up_v[n:], bnd_up_o[n:]),
        row_bound_dn=rec(bnd_dn_v[n:], bnd_dn_o[n:]))
