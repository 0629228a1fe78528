"""The plain reference that decides `correct` for a convex QP: an f64
optimality certificate of a returned solution, worked out again from
the generated model alone.

A QP here is  min 1/2 x'Qx + c'x  s.t.  row_lower <= A x <= row_upper,
col_lower <= x <= col_upper  (Q symmetric positive semidefinite, stored
whole). Row duals y and column duals z follow the LP's signs: positive
at a lower bound, negative at an upper one. An answer (x, y, z,
objective) is measured by

- `rel_primal`: the rows' and bounds' violation, over 1 + the norm of
  the finite bounds;
- `rel_stationarity`: |c + Qx - A'y - z|, over 1 + |c|, each entry
  summed in compensated arithmetic (`exact_rows`);
- `rel_dual_sign`: the weight of y and z on infinite bounds (a positive
  multiplier on a row or column with no lower bound, a negative one
  with no upper bound), over 1 + |c|;
- `rel_gap`: the larger of the primal objective's and the reported
  objective's distance from the dual objective
  -1/2 x'Qx + sum of the finite bound terms, over 1 + |p| + |d|.

A primal and a dual point that pass all four bound the optimum from
both sides. (The arithmetic of `chip_smoke.py` `qp_certificate`, copied
and extended by the reported objective.)

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


class Qp(NamedTuple):
    """min 1/2 x'Qx + c'x s.t. row_lower <= a x <= row_upper,
    col_lower <= x <= col_upper (q, a: SciPy sparse, q whole)."""
    q: sp.spmatrix
    c: np.ndarray
    a: sp.spmatrix
    row_lower: np.ndarray
    row_upper: np.ndarray
    col_lower: np.ndarray
    col_upper: np.ndarray


class Product:
    """v -> mat @ v for a SciPy sparse `mat`, in float64 torch on the
    CPU (products summed term by term with `index_add`)."""

    def __init__(self, mat: sp.spmatrix):
        coo = sp.coo_matrix(mat)
        self.rows = torch.as_tensor(coo.row, dtype=torch.int64)
        self.cols = torch.as_tensor(coo.col, dtype=torch.int64)
        self.vals = torch.as_tensor(coo.data, dtype=F64)
        self.num_rows = coo.shape[0]

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(self.num_rows, dtype=F64).index_add_(
            0, self.rows, self.vals * v[self.cols])


def exact_rows(rows, cols, vals, v, size: int) -> torch.Tensor:
    """out[r] = sum of vals[k] * v[cols[k]] over the k with rows[k] = r,
    each product split exactly (Dekker) and each entry's terms summed
    with compensation (Knuth's two-sum): the exact sum rounded to
    float64, but for errors of the order eps^2. Duals of 1e8 (CVXQP3_L)
    round every term of a plain float64 A'y by 1e-8 and more, which a
    norm over 10,000 entries would read as a stationarity of 1e-7."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    a = torch.as_tensor(vals, dtype=F64)
    b = vec(v)[torch.as_tensor(cols, dtype=torch.int64)]
    p = a * b

    def halves(u):
        t = 134217729.0 * u  # 2^27 + 1
        hi = t - (t - u)
        return hi, u - hi
    a_hi, a_lo = halves(a)
    b_hi, b_lo = halves(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    # each entry's terms in a row of a padded table
    rows, order = torch.sort(rows, stable=True)
    p, err = p[order], err[order]
    counts = torch.bincount(rows, minlength=size)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(rows)) - torch.repeat_interleave(starts, counts)
    width = max(int(counts.max()) if len(counts) else 0, 1)
    table = torch.zeros(size, width, dtype=F64)
    table[rows, slot] = p
    total = table[:, 0].clone()
    comp = torch.zeros(size, dtype=F64).index_add_(0, rows, err)
    for k in range(1, width):
        t = table[:, k]
        s = total + t
        back = s - total
        comp += (total - (s - back)) + (t - back)
        total = s
    return total + comp


def vec(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=F64)


def objective(qp: Qp, x) -> float:
    """1/2 x'Qx + c'x."""
    x = vec(x)
    return float(0.5 * x @ (Product(qp.q) @ x) + vec(qp.c) @ x)


def _excess(v, lo, up):
    """How far v lies outside [lo, up], where the bound is finite."""
    zero = torch.zeros_like(v)
    return (torch.where(torch.isfinite(lo), torch.clamp_min(lo - v, 0.0),
                        zero) +
            torch.where(torch.isfinite(up), torch.clamp_min(v - up, 0.0),
                        zero))


def _bound_terms(mult, lo, up):
    """The dual objective's terms of multipliers `mult` on the bounds
    [lo, up], and the multipliers that sit on an infinite bound."""
    pos, neg = torch.clamp_min(mult, 0.0), torch.clamp_max(mult, 0.0)
    lo_f, up_f = torch.isfinite(lo), torch.isfinite(up)
    term = (torch.where(lo_f, lo, 0.0) @ pos +
            torch.where(up_f, up, 0.0) @ neg)
    return term, torch.cat([pos[~lo_f], neg[~up_f]])


def certificate(qp: Qp, x, y, z, reported: float) -> dict:
    """The answer's four relative measures (`inf` where the answer has
    the wrong shape, or a NaN anywhere)."""
    worst = {"rel_primal": math.inf, "rel_stationarity": math.inf,
             "rel_dual_sign": math.inf, "rel_gap": math.inf}
    m, n = qp.a.shape
    x, y, z = vec(x), vec(y), vec(z)
    if x.shape != (n,) or z.shape != (n,) or y.shape != (m,):
        return worst
    a, q = Product(qp.a), Product(qp.q)
    c = vec(qp.c)
    rl, ru = vec(qp.row_lower), vec(qp.row_upper)
    cl, cu = vec(qp.col_lower), vec(qp.col_upper)
    bounds = torch.cat([rl, ru, cl, cu])
    qx = q @ x
    primal = math.hypot(float(_excess(a @ x, rl, ru).norm()),
                        float(_excess(x, cl, cu).norm())) / (
        1.0 + float(bounds[torch.isfinite(bounds)].norm()))
    norm_c = 1.0 + float(c.norm())
    # c + Qx - A'y - z, entry by entry, as exactly as float64 holds it
    q, a_t = sp.coo_matrix(qp.q), sp.coo_matrix(qp.a.T)
    idx = np.arange(n)
    stationarity = float(exact_rows(
        np.concatenate([idx, q.row, a_t.row, idx]),
        np.concatenate([idx, n + q.col, 2 * n + a_t.col, 2 * n + m + idx]),
        np.concatenate([np.ones(n), q.data, -a_t.data, -np.ones(n)]),
        torch.cat([c, x, y, z]), n).norm()) / norm_c
    row_term, row_wrong = _bound_terms(y, rl, ru)
    col_term, col_wrong = _bound_terms(z, cl, cu)
    dual_sign = float(torch.cat([row_wrong, col_wrong]).norm()) / norm_c
    pobj = float(c @ x + 0.5 * x @ qx)
    dobj = float(-0.5 * x @ qx + row_term + col_term)
    # `max` would pass over a NaN in its second place
    gap = float(np.max([abs(pobj - dobj), abs(float(reported) - dobj)])) / (
        1.0 + abs(pobj) + abs(dobj))
    out = {"rel_primal": primal, "rel_stationarity": stationarity,
           "rel_dual_sign": dual_sign, "rel_gap": gap}
    # a NaN anywhere (a NaN objective too) reads as the worst answer
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(measures: dict) -> float:
    """The largest of an answer's measures."""
    return max(measures.values())
