"""Semi-variable reformulation (reference: HPresolve converts bounded
semi-continuous/semi-integer columns during MIP presolve — the solve
log shows them re-entering as binary + continuous pairs, e.g.
check/instances/3015.mps: 78 semi-continuous in, 0 out, +binaries).

x semi with domain {0} u [l, u], u finite, becomes
    x in [min(0, l), u]   (continuous, or integer for semi-integer)
    y in {0, 1}
    x - u*y <= 0
    x - l*y >= 0
so y = 0 forces x = 0 and y = 1 restores [l, u].  The MIP machinery
(coefficient strengthening, variable-bound c-MIR, propagation) then
operates on standard big-M structure instead of bespoke disjunction
branching.  Semis with infinite upper bound stay semi (the branch
scheme in the MIP solver handles them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..constants import HighsVarType, kHighsInf
from ..models.lp import HighsLp, HighsSparseMatrix


@dataclasses.dataclass
class SemiExpansion:
    lp: HighsLp
    n_orig_col: int
    n_orig_row: int


def reformulate_semi_variables(lp: HighsLp):
    """Return a SemiExpansion for bounded semi variables, or None if
    the model has none (or only unbounded ones)."""
    integ = np.asarray(lp.integrality)
    if integ.size != lp.num_col:
        return None
    semi = (integ == int(HighsVarType.kSemiContinuous)) | (
        integ == int(HighsVarType.kSemiInteger))
    semi &= np.isfinite(lp.col_upper)
    if not semi.any():
        return None
    js = np.nonzero(semi)[0]
    k = len(js)
    n, m = lp.num_col, lp.num_row

    a = lp.a_matrix.to_scipy().tocsc()
    # new rows: x_j - u_j y_j <= 0  and  x_j - l_j y_j >= 0
    rows = []
    cols = []
    vals = []
    new_rl = []
    new_ru = []
    r = 0
    for idx, j in enumerate(js):
        u = float(lp.col_upper[j])
        l = float(lp.col_lower[j])
        rows.append(r); cols.append(int(j)); vals.append(1.0)
        rows.append(r); cols.append(n + idx); vals.append(-u)
        new_rl.append(-kHighsInf); new_ru.append(0.0)
        r += 1
        if l > 0.0:
            rows.append(r); cols.append(int(j)); vals.append(1.0)
            rows.append(r); cols.append(n + idx); vals.append(-l)
            new_rl.append(0.0); new_ru.append(kHighsInf)
            r += 1
    block = sp.csc_matrix((vals, (rows, cols)), shape=(r, n + k))
    a_ext = sp.vstack([
        sp.hstack([a, sp.csc_matrix((m, k))]), block]).tocsc()

    cl = np.concatenate([lp.col_lower.copy(), np.zeros(k)])
    cu = np.concatenate([lp.col_upper.copy(), np.ones(k)])
    # the semi column itself relaxes to [min(0, l), u]
    cl[js] = np.minimum(cl[js], 0.0)
    cost = np.concatenate([lp.col_cost, np.zeros(k)])
    integ2 = np.concatenate([
        integ.copy(), np.full(k, int(HighsVarType.kInteger),
                              dtype=integ.dtype)])
    # semi-continuous -> continuous; semi-integer -> integer
    integ2[js] = np.where(
        integ[js] == int(HighsVarType.kSemiInteger),
        int(HighsVarType.kInteger), int(HighsVarType.kContinuous))

    lp2 = HighsLp(
        num_col=n + k, num_row=m + r,
        col_cost=cost, col_lower=cl, col_upper=cu,
        row_lower=np.concatenate([lp.row_lower, np.asarray(new_rl)]),
        row_upper=np.concatenate([lp.row_upper, np.asarray(new_ru)]),
        a_matrix=HighsSparseMatrix.from_scipy(a_ext),
        sense=lp.sense, offset=lp.offset,
        model_name=lp.model_name,
        integrality=integ2,
        sos=list(getattr(lp, "sos", [])))
    return SemiExpansion(lp=lp2, n_orig_col=n, n_orig_row=m)
