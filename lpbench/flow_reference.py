"""The plain reference that decides `correct` for an equality-form LP
with nonnegative columns: an f64 optimality certificate of a returned
solution, worked out again from the generated model alone.

An LP here is  min c'x  s.t.  A x = b,  x >= 0  (A: SciPy sparse). Row
duals y are free; the reduced costs are z = c - A'y, which a dual
feasible point holds at z >= 0. An answer (x, y, objective) is measured
by

- `rel_primal`: |A x - b| and |min(x, 0)|, over 1 + |b|;
- `rel_dual`: |min(c - A'y, 0)|, over 1 + |c|. For the EMD-L1 flow
  (unit arc costs on the pixel grid) this is |y_u - y_v| <= 1 on every
  arc: y is a Kantorovich potential;
- `rel_gap`: the larger of c'x's and the reported objective's distance
  from b'y, over 1 + |p| + |d|.

A primal and a dual point that pass all three bound the optimum from
both sides. `strip_w1` is the closed form of W1 between two histograms
on a line of cells (a 1 x n image), against which a solver's objective
can be held without another solver.

Plain PyTorch in float64 on the CPU: this module imports nothing of the
program and takes nothing the program made but the answer it judges.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

F64 = torch.float64


class FlowLp(NamedTuple):
    """min c'x s.t. a x = b, x >= 0 (a: SciPy sparse)."""
    a: sp.spmatrix
    b: np.ndarray
    c: np.ndarray


def vec(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=F64)


def product(mat: sp.spmatrix, v: torch.Tensor) -> torch.Tensor:
    """mat @ v in float64 torch, each row's terms added by `index_add`."""
    coo = sp.coo_matrix(mat)
    rows = torch.as_tensor(coo.row, dtype=torch.int64)
    cols = torch.as_tensor(coo.col, dtype=torch.int64)
    vals = torch.as_tensor(coo.data, dtype=F64)
    return torch.zeros(coo.shape[0], dtype=F64).index_add_(
        0, rows, vals * v[cols])


def certificate(lp: FlowLp, x, y, reported: float) -> dict:
    """The answer's three relative measures (`inf` where the answer has
    the wrong shape, or a NaN anywhere, its objective too)."""
    worst = {"rel_primal": math.inf, "rel_dual": math.inf,
             "rel_gap": math.inf}
    m, n = lp.a.shape
    x, y = vec(x), vec(y)
    if x.shape != (n,) or y.shape != (m,):
        return worst
    b, c = vec(lp.b), vec(lp.c)
    primal = math.hypot(float((product(lp.a, x) - b).norm()),
                        float(torch.clamp_max(x, 0.0).norm())) / (
        1.0 + float(b.norm()))
    z = c - product(lp.a.T, y)
    dual = float(torch.clamp_max(z, 0.0).norm()) / (1.0 + float(c.norm()))
    pobj, dobj = float(c @ x), float(b @ y)
    # `max` would pass over a NaN in its second place
    gap = float(np.max([abs(pobj - dobj), abs(float(reported) - dobj)])) / (
        1.0 + abs(pobj) + abs(dobj))
    out = {"rel_primal": primal, "rel_dual": dual, "rel_gap": gap}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(measures: dict) -> float:
    """The largest of an answer's measures."""
    return max(measures.values())


def strip_w1(mu, nu) -> float:
    """W1 between histograms `mu` and `nu` of equal mass on cells 0..n-1
    of a line, unit distance between neighbours: the sum over the n - 1
    cuts of the mass that has to cross each, |sum_{i<=k} (mu_i - nu_i)|."""
    d = torch.cumsum(vec(mu) - vec(nu), 0)
    return float(d[:-1].abs().sum())
