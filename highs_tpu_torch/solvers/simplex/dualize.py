"""LP dualization for the simplex entry (reference: HEkk::dualize
driven by `simplex_dualize_strategy` in highs/simplex/HApp.h:206-214;
strategy values kHighsOptionOff/-1, kHighsOptionChoose/0 — dualize
cold-started LPs with num_row >= 10*num_col — and kHighsOptionOn/1).

Given the primal   min c'x  s.t.  rl <= Ax <= ru,  l <= x <= u,
the bounded-variable dual is

    max  rl'vl - ru'vu + l'zl - u'zu
    s.t. A'(vl - vu) + zl - zu = c,   vl, vu, zl, zu >= 0,

with a column only for each FINITE bound.  A tall primal (m >> n)
becomes a wide dual with only n rows — the shape the bounded dual
simplex engine likes.  The solve here recovers the primal point from
the dual LP's row duals (x = -p), maps activities/duals back, and
returns a STATUS GUESS for the original LP; the caller warm-starts its
own engine from it, so the final solution is always certified by a
primal-side solve (the role of EKK's undualize()).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ...models.lp import HighsLp, HighsSparseMatrix


def should_dualize(lp: HighsLp, strategy: int,
                   has_basis: bool) -> bool:
    """Reference HApp.h:206-214: only cold starts dualize; `choose`
    requires num_row >= 10 * num_col."""
    if has_basis or lp.num_col == 0 or lp.num_row == 0:
        return False
    if strategy == 1:
        return True
    if strategy == 0:
        return lp.num_row >= 10 * lp.num_col
    return False


def build_dual_lp(lp: HighsLp, sense: float
                  ) -> Optional[Tuple[HighsLp, dict]]:
    """Construct the bounded-variable dual as a MIN problem.

    Returns (dual_lp, meta) or None when the primal has a structure
    the mapping does not cover (empty matrix)."""
    m, n = lp.num_row, lp.num_col
    a = lp.a_matrix.to_scipy().tocsc()
    c = sense * np.asarray(lp.col_cost, dtype=float)
    rl = np.asarray(lp.row_lower, dtype=float)
    ru = np.asarray(lp.row_upper, dtype=float)
    cl = np.asarray(lp.col_lower, dtype=float)
    cu = np.asarray(lp.col_upper, dtype=float)
    at = a.T.tocsc()
    fin_rl = np.isfinite(rl)
    fin_ru = np.isfinite(ru)
    fin_cl = np.isfinite(cl)
    fin_cu = np.isfinite(cu)
    i_rl = np.flatnonzero(fin_rl)
    i_ru = np.flatnonzero(fin_ru)
    j_cl = np.flatnonzero(fin_cl)
    j_cu = np.flatnonzero(fin_cu)
    blocks = []
    gcost = []
    if len(i_rl):
        blocks.append(at[:, i_rl])
        gcost.append(-rl[i_rl])
    if len(i_ru):
        blocks.append(-at[:, i_ru])
        gcost.append(ru[i_ru])
    if len(j_cl):
        blocks.append(sp.csc_matrix(
            (np.ones(len(j_cl)), (j_cl, np.arange(len(j_cl)))),
            shape=(n, len(j_cl))))
        gcost.append(-cl[j_cl])
    if len(j_cu):
        blocks.append(sp.csc_matrix(
            (-np.ones(len(j_cu)), (j_cu, np.arange(len(j_cu)))),
            shape=(n, len(j_cu))))
        gcost.append(cu[j_cu])
    if not blocks:
        return None
    dmat = sp.hstack(blocks).tocsc()
    ncol_d = dmat.shape[1]
    dual = HighsLp(
        num_col=ncol_d, num_row=n,
        col_cost=np.concatenate(gcost),
        col_lower=np.zeros(ncol_d),
        col_upper=np.full(ncol_d, np.inf),
        row_lower=c.copy(), row_upper=c.copy(),
        a_matrix=HighsSparseMatrix.from_scipy(dmat))
    meta = dict(i_rl=i_rl, i_ru=i_ru, j_cl=j_cl, j_cu=j_cu, m=m, n=n)
    return dual, meta


def primal_status_guess(lp: HighsLp, sense: float, dual_solution,
                        meta) -> Optional[np.ndarray]:
    """Status vector (dual_native convention: 0 lower / 1 basic /
    2 upper / 3 free-at-zero) for the ORIGINAL lp derived from the
    solved dual LP: x from the dual's row duals (x = -p), y from the
    recovered vl - vu column values.  The guess warm-starts the native
    engine; exactness is not required."""
    if not dual_solution.dual_valid or dual_solution.row_dual is None:
        return None
    m, n = meta["m"], meta["n"]
    p = np.asarray(dual_solution.row_dual, dtype=float)
    if len(p) != n:
        return None
    x = -p
    w = np.asarray(dual_solution.col_value, dtype=float)
    off = 0
    y = np.zeros(m)
    if len(meta["i_rl"]):
        y[meta["i_rl"]] += w[off:off + len(meta["i_rl"])]
        off += len(meta["i_rl"])
    if len(meta["i_ru"]):
        y[meta["i_ru"]] -= w[off:off + len(meta["i_ru"])]
        off += len(meta["i_ru"])
    a = lp.a_matrix.to_scipy()
    act = a @ x
    tol = 1e-7
    stat = np.ones(n + m, dtype=np.int8)  # default basic
    cl = np.asarray(lp.col_lower, dtype=float)
    cu = np.asarray(lp.col_upper, dtype=float)
    rl = np.asarray(lp.row_lower, dtype=float)
    ru = np.asarray(lp.row_upper, dtype=float)
    at_lo = np.isfinite(cl) & (np.abs(x - cl) <= tol * (1 + np.abs(cl)))
    at_up = np.isfinite(cu) & (np.abs(x - cu) <= tol * (1 + np.abs(cu)))
    free = ~np.isfinite(cl) & ~np.isfinite(cu)
    stat[:n][at_lo] = 0
    stat[:n][at_up & ~at_lo] = 2
    stat[:n][free & (np.abs(x) <= tol)] = 3
    r_lo = np.isfinite(rl) & (np.abs(act - rl) <= tol * (1 + np.abs(rl)))
    r_up = np.isfinite(ru) & (np.abs(act - ru) <= tol * (1 + np.abs(ru)))
    # a TIGHT row with a nonzero multiplier carries the bound: its
    # logical is nonbasic there; slack rows keep the logical basic
    y_nz = np.abs(y) > tol
    stat[n:][r_lo & y_nz] = 0
    stat[n:][r_up & y_nz & ~r_lo] = 2
    # the engine repairs any rank defect of the guess
    return stat
