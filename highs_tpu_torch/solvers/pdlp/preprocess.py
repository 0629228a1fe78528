"""LP -> PDHG standard form.

Re-implements the behavior of the reference HiPDLP preprocessing
(highs/pdlp/hipdlp/pdhg.cc:152-271 preprocessLp): rows are classified as
EQ / GEQ / LEQ (sign-flipped to GEQ) / BOUNDED / FREE; two-sided
(BOUNDED) and FREE rows are converted to equalities `a_i'x - z_i = 0`
with a new slack column z_i bounded by the row bounds; equality rows are
permuted first.  The result is

    min  c'x  s.t.  K x  =  q   (rows [0, num_eq))
                    K x  >= q   (rows [num_eq, m))
                    l <= x <= u

in minimization sense (a maximize objective is negated here and restored
in postprocessing).  Dual convention: y free on equality rows, y >= 0 on
inequality rows; reduced costs z = c - K'y.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from ...constants import ObjSense, kHighsInf
from ...models.lp import HighsLp

# Row classes
ROW_EQ = 0
ROW_GEQ = 1
ROW_LEQ = 2  # flipped to GEQ
ROW_BOUNDED = 3  # slack-augmented equality
ROW_FREE = 4  # slack-augmented equality with free slack


@dataclasses.dataclass
class StandardFormLP:
    """The PDHG standard-form problem plus recovery metadata."""

    num_col: int  # columns including slacks
    num_row: int  # rows after transformation
    num_eq: int  # equality rows come first
    orig_num_col: int
    orig_num_row: int
    a: sp.csr_matrix  # K (num_row x num_col)
    b: np.ndarray  # q
    c: np.ndarray  # minimization cost (slacks have cost 0)
    col_lower: np.ndarray
    col_upper: np.ndarray
    offset: float  # objective offset in minimization sense
    sense_mult: float  # +1 minimize, -1 maximize (for reporting back)
    # per original row: index in transformed problem (-1 if dropped)
    row_new_idx: np.ndarray
    # per original row: class (ROW_*)
    row_class: np.ndarray
    # slack column index per original row (-1 if none)
    row_slack_col: np.ndarray

    @property
    def num_ineq(self) -> int:
        return self.num_row - self.num_eq


def preprocess_lp(lp: HighsLp) -> StandardFormLP:
    m, n = lp.num_row, lp.num_col
    a_csr = lp.a_matrix.to_scipy().tocsr()
    rl = np.asarray(lp.row_lower, dtype=np.float64)
    ru = np.asarray(lp.row_upper, dtype=np.float64)

    lo_fin = np.isfinite(rl)
    up_fin = np.isfinite(ru)
    row_class = np.empty(m, dtype=np.int64)
    row_class[lo_fin & up_fin & (rl == ru)] = ROW_EQ
    row_class[lo_fin & ~up_fin] = ROW_GEQ
    row_class[~lo_fin & up_fin] = ROW_LEQ
    row_class[lo_fin & up_fin & (rl < ru)] = ROW_BOUNDED
    row_class[~lo_fin & ~up_fin] = ROW_FREE

    is_eq_like = (row_class == ROW_EQ) | (row_class == ROW_BOUNDED) | (
        row_class == ROW_FREE)
    eq_rows = np.nonzero(is_eq_like)[0]
    ineq_rows = np.nonzero(~is_eq_like)[0]
    order = np.concatenate([eq_rows, ineq_rows])
    num_eq = len(eq_rows)

    row_new_idx = np.empty(m, dtype=np.int64)
    row_new_idx[order] = np.arange(m)

    # sign flips: LEQ rows become -a'x >= -u
    sign = np.ones(m)
    sign[row_class == ROW_LEQ] = -1.0

    # rhs per transformed row
    b = np.zeros(m)
    b[row_new_idx[row_class == ROW_EQ]] = rl[row_class == ROW_EQ]
    b[row_new_idx[row_class == ROW_GEQ]] = rl[row_class == ROW_GEQ]
    b[row_new_idx[row_class == ROW_LEQ]] = -ru[row_class == ROW_LEQ]
    # BOUNDED/FREE rows: a'x - z = 0
    b[row_new_idx[(row_class == ROW_BOUNDED) | (row_class == ROW_FREE)]] = 0.0

    # slack columns for BOUNDED and FREE rows
    slack_rows = np.nonzero((row_class == ROW_BOUNDED) |
                            (row_class == ROW_FREE))[0]
    num_slack = len(slack_rows)
    row_slack_col = np.full(m, -1, dtype=np.int64)
    row_slack_col[slack_rows] = n + np.arange(num_slack)

    # build transformed matrix: rows permuted+signed, slack entries appended
    d_sign = sp.diags(sign)
    perm = sp.csr_matrix(
        (np.ones(m), (np.arange(m), order)), shape=(m, m))
    a_perm = (perm @ (d_sign @ a_csr)).tocsr()
    if num_slack:
        slack_mat = sp.csr_matrix(
            (-np.ones(num_slack),
             (row_new_idx[slack_rows], np.arange(num_slack))),
            shape=(m, num_slack))
        a_full = sp.hstack([a_perm, slack_mat], format="csr")
    else:
        a_full = a_perm

    sense_mult = float(lp.sense)
    c = np.concatenate([sense_mult * lp.col_cost, np.zeros(num_slack)])
    col_lower = np.concatenate([
        lp.col_lower,
        np.where(np.isfinite(rl[slack_rows]), rl[slack_rows], -kHighsInf)])
    col_upper = np.concatenate([
        lp.col_upper,
        np.where(np.isfinite(ru[slack_rows]), ru[slack_rows], kHighsInf)])

    return StandardFormLP(
        num_col=n + num_slack, num_row=m, num_eq=num_eq,
        orig_num_col=n, orig_num_row=m,
        a=a_full, b=b, c=c,
        col_lower=col_lower, col_upper=col_upper,
        offset=sense_mult * lp.offset, sense_mult=sense_mult,
        row_new_idx=row_new_idx, row_class=row_class,
        row_slack_col=row_slack_col)


def recover_solution(std: StandardFormLP, x_std: np.ndarray,
                     y_std: np.ndarray, z_std: np.ndarray):
    """Map standard-form (x, y, z) back to the original LP's
    (col_value, row_value, row_dual, col_dual).

    Undoes the row permutation, sign flips and slack splitting
    (reference behavior: pdlp/hipdlp/pdhg.cc postprocess/unscaleSolution).
    Duals are returned in the original sense convention (reference stores
    duals for the sign-flipped objective of a maximization problem too,
    i.e. we multiply back by sense).
    """
    n, m = std.orig_num_col, std.orig_num_row
    col_value = np.asarray(x_std[:n], dtype=np.float64)
    row_dual = np.zeros(m)
    for i in range(m):
        yi = y_std[std.row_new_idx[i]]
        if std.row_class[i] == ROW_LEQ:
            yi = -yi
        elif std.row_slack_col[i] >= 0:
            # dual of the slack-augmented equality: the original row dual
            # is the equality multiplier (slack reduced cost is z_slack)
            pass
        row_dual[i] = yi
    # row activities in original orientation
    # (recomputed by the caller from the original matrix for accuracy)
    col_dual = np.asarray(z_std[:n], dtype=np.float64)
    # restore sense: minimize form used sense*c, so duals/reduced costs of
    # the original problem are sense * (standard-form duals)
    col_dual *= std.sense_mult
    row_dual *= std.sense_mult
    return col_value, row_dual, col_dual
