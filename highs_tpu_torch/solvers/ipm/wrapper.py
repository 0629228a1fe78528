"""Interior-point LP solver entry (normal-equations based).

Regularized predictor-corrector IPM on the normal equations
A·diag(theta)·A' (see solver.py).  Used standalone ("ipm" / "ipx" /
"hipo" solver options), by `choose` on an LP in the IPM's range, and by
the classification of inconclusive results.
"""
from __future__ import annotations

import copy

import numpy as np

from ...constants import HighsModelStatus
from ...models.lp import HighsLp
from ...models.solution import HighsSolution
from ...options import HighsOptions
from ..simplex.dualize import build_dual_lp
from .solver import solve_lp_ipm_native


def solve_lp_ipm(lp: HighsLp, options: HighsOptions, log=None,
                 device=None):
    """Solve `lp` with the IPM on `device` (default CUDA).

    ipx_dualize_strategy (reference IpxWrapper.cpp; values of
    HConst.h:122-128 — off/-1, choose/0, on/1, Lukas/2, Filippo/3): a
    tall LP's normal equations are m x m; solving the bounded-variable
    dual instead factors an n x n system.  All the "on"-family
    strategies dualize outright; choose requires a strongly tall shape.
    The primal point is recovered from the dual solve's row duals and
    certified by the caller's KKT census."""
    strat = int(getattr(options, "ipx_dualize_strategy", 0))
    tall = lp.num_row >= 10 * lp.num_col
    if lp.num_col and lp.num_row and \
            not getattr(options, "_in_dualize", False) and \
            (strat >= 1 or (strat == 0 and tall)):
        built = build_dual_lp(lp, float(lp.sense))
        if built is not None:
            dual_lp, meta = built
            d_opts = copy.copy(options)
            d_opts._in_dualize = True
            d_opts.ipx_dualize_strategy = -1
            if log is not None:
                log(f"IPM dualize: solving the dual "
                    f"({dual_lp.num_row} rows x {dual_lp.num_col} "
                    f"cols)")
            dst, dsol, dinfo = solve_lp_ipm_native(
                dual_lp, d_opts, log=None, device=device)
            if dst == HighsModelStatus.kOptimal and dsol.dual_valid and \
                    dsol.row_dual is not None and \
                    len(dsol.row_dual) == lp.num_col:
                sense = float(lp.sense)
                x = -np.asarray(dsol.row_dual, dtype=float)
                w = np.asarray(dsol.col_value, dtype=float)
                y = np.zeros(lp.num_row)
                off = 0
                if len(meta["i_rl"]):
                    y[meta["i_rl"]] += w[off:off + len(meta["i_rl"])]
                    off += len(meta["i_rl"])
                if len(meta["i_ru"]):
                    y[meta["i_ru"]] -= w[off:off + len(meta["i_ru"])]
                    off += len(meta["i_ru"])
                a = lp.a_matrix.to_scipy()
                z = sense * np.asarray(lp.col_cost) - (a.T @ y)
                sol = HighsSolution(value_valid=True, dual_valid=True,
                                    col_value=x, row_value=a @ x,
                                    col_dual=sense * z, row_dual=sense * y)
                dinfo.primal_obj = float(lp.col_cost @ x) + lp.offset
                return dst, sol, dinfo
    return solve_lp_ipm_native(lp, options, log=log, device=device)
