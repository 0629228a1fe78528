"""The plain reference that decides `correct`: an f64 KKT check of a
returned solution, worked out again from the generated model alone.

Every LP the benchmark generates is  min c'x  s.t.  A x >= b,
0 <= x <= upper.  Rows A x >= b of a minimisation carry duals y >= 0;
every column is boxed, so any reduced cost z = c - A'y is absorbed by
its bounds, and the dual objective is b'y + upper' min(z, 0).  Each
measure is relative, against 1 + a norm of the data, as the solver's
own termination test measures it.  (The arithmetic of `chip_smoke.py`
`kkt_check`, copied and extended by the reported objective.)

Plain NumPy and SciPy: this module imports nothing of the program and
takes nothing the program made but the answer it judges.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp


class Lp(NamedTuple):
    """min c'x s.t. a x >= b, 0 <= x <= upper (a: SciPy sparse)."""
    a: sp.spmatrix
    b: np.ndarray
    c: np.ndarray
    upper: np.ndarray


def kkt(lp: Lp, x, y, objective: float) -> dict:
    """The relative primal residual, dual residual and gap of the answer
    (x, y, objective): the gap is the larger of c'x's and the reported
    objective's distance from the dual objective."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != lp.c.shape or y.shape != lp.b.shape:
        return {"rel_primal": math.inf, "rel_dual": math.inf,
                "rel_gap": math.inf}
    row_viol = np.maximum(lp.b - lp.a @ x, 0.0)
    bound_viol = np.maximum(-x, 0.0) + np.maximum(x - lp.upper, 0.0)
    rel_p = math.hypot(np.linalg.norm(row_viol),
                       np.linalg.norm(bound_viol)) / (
                           1.0 + np.linalg.norm(lp.b))
    z = lp.c - lp.a.T @ y
    rel_d = np.linalg.norm(np.minimum(y, 0.0)) / (1.0 + np.linalg.norm(lp.c))
    pobj = float(lp.c @ x)
    dobj = float(lp.b @ y) + float(lp.upper @ np.minimum(z, 0.0))
    gap = max(abs(pobj - dobj), abs(float(objective) - dobj)) / (
        1.0 + abs(pobj) + abs(dobj))
    out = {"rel_primal": float(rel_p), "rel_dual": float(rel_d),
           "rel_gap": float(gap)}
    # a NaN anywhere reads as the worst answer, never as a pass
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(measures: dict) -> float:
    """The largest of an answer's three measures."""
    return max(measures.values())
