"""Feasibility Jump primal heuristic.

Re-implements the behavior of the reference's vendored feasibility-jump
heuristic (highs/mip/feasibilityjump.hh, HighsFeasibilityJump.cpp;
Luteberget & Sartorius 2023): weighted-violation local search over
variable assignments — each move sets one variable to the value
minimizing the weighted constraint violation along its coordinate
(piecewise-linear minimum over row breakpoints); when stuck in a local
minimum the weights of violated rows are bumped.  Integers move on
integral values; a small objective term breaks ties toward good
solutions.  The search runs in the native `hx_feasibility_jump`
(native/hsimplex.cpp), as the reference's vendored engine is C++.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..simplex import native as _nat


def feasibility_jump(a: sp.spmatrix, row_lower: np.ndarray,
                     row_upper: np.ndarray, col_lower: np.ndarray,
                     col_upper: np.ndarray, cost: np.ndarray,
                     is_int: np.ndarray,
                     x0: Optional[np.ndarray] = None,
                     max_moves: int = 30000,
                     feastol: float = 1e-6,
                     seed: int = 0,
                     time_budget: float = float("inf")
                     ) -> Optional[np.ndarray]:
    """Return a row-feasible assignment (integers integral) or None."""
    m, n = a.shape
    a_csc = a.tocsc()
    a_csr = a.tocsr()

    lo = np.where(np.isfinite(col_lower), col_lower, -1e9)
    up = np.where(np.isfinite(col_upper), col_upper, 1e9)

    if x0 is None:
        x = np.clip(0.0, lo, up)
    else:
        x = np.clip(np.asarray(x0, dtype=np.float64).copy(), lo, up)
    x = np.where(is_int, np.clip(np.round(x), lo, up), x)

    lib = _nat.get_lib()
    x_io = np.ascontiguousarray(x, dtype=np.float64).copy()
    ok = lib.hx_feasibility_jump(
        m, n,
        np.ascontiguousarray(a_csc.indptr, dtype=np.int64),
        np.ascontiguousarray(a_csc.indices, dtype=np.int32),
        np.ascontiguousarray(a_csc.data, dtype=np.float64),
        np.ascontiguousarray(a_csr.indptr, dtype=np.int64),
        np.ascontiguousarray(a_csr.indices, dtype=np.int32),
        np.ascontiguousarray(a_csr.data, dtype=np.float64),
        np.ascontiguousarray(
            np.where(np.isfinite(row_lower), row_lower, -1e30),
            dtype=np.float64),
        np.ascontiguousarray(
            np.where(np.isfinite(row_upper), row_upper, 1e30),
            dtype=np.float64),
        np.ascontiguousarray(lo, dtype=np.float64),
        np.ascontiguousarray(up, dtype=np.float64),
        np.ascontiguousarray(cost, dtype=np.float64),
        np.ascontiguousarray(is_int, dtype=np.int8),
        # an infinite budget overflows the native deadline (which then
        # lies in the past): cap it at a finite 1e9 s
        float(feastol), int(max_moves), min(float(time_budget), 1e9),
        np.uint64(seed * 7919 + 1), x_io)
    return x_io if ok else None
