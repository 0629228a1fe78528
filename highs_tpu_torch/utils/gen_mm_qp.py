"""Maros-Meszaros-style convex QPs from a seed.

`gen_mm_style` is a copy of the JAX package's generator
(`tools/qp_sweep.py:34-62`): 0.5 x'Qx + c'x subject to L <= Ax <= U and
l <= x <= u, with Q = B'B (+ 1e-3 I for a full-rank Hessian), a share
`eq_frac` of equality rows, x >= 0 and an upper bound of 10 on about 70%
of the columns.  `mm_qp_model` returns it as a HighsModel whose
HighsHessian holds the lower triangle of Q column by column.

`gen_mm_style(7, 10000, 5000, "full", 1e4, 0.3, 5e-4)` has the size of
the Maros-Meszaros CVXQP1_L (10,000 columns, 5,000 rows); its Q is
nearly dense (about 98% of its entries are nonzero).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def gen_mm_style(seed: int, n: int, m: int, hess_rank: str,
                 cond: float, eq_frac: float, density: float):
    """One convex QP: 0.5 x'Qx + c'x, L <= Ax <= U, l <= x <= u."""
    rng = np.random.default_rng(seed)
    # Hessian: Q = B'B (+ diag) with controlled rank/conditioning
    k = n if hess_rank == "full" else max(1, n // 3)
    B = sp.random(k, n, density=min(1.0, 3.0 / n + 0.02),
                  random_state=seed, format="csr")
    B.data = B.data * 2 - 1
    scales = np.logspace(0, np.log10(cond), k) ** 0.5
    B = sp.diags(scales) @ B
    Q = (B.T @ B).tocoo()
    if hess_rank == "full":
        Q = (Q + sp.diags(np.full(n, 1e-3))).tocoo()
    A = sp.random(m, n, density=density, random_state=seed + 1,
                  format="csr")
    A.data = np.round(A.data * 4 - 2, 6)
    x0 = rng.uniform(0, 1, n)
    act = A @ x0
    n_eq = int(eq_frac * m)
    rl = np.where(np.arange(m) < n_eq, act,
                  act - np.abs(rng.standard_normal(m)))
    ru = np.where(np.arange(m) < n_eq, act,
                  act + np.abs(rng.standard_normal(m)))
    c = rng.standard_normal(n)
    lo = np.zeros(n)
    up = np.where(rng.uniform(size=n) < 0.7, 10.0, np.inf)
    return Q.tocsc(), c, A, rl, ru, lo, up


def lower_hessian(q: sp.spmatrix):
    """The HighsHessian of a symmetric Q: its lower triangle, CSC."""
    from ..models.lp import HighsHessian
    low = sp.tril(q, format="csc")
    low.sum_duplicates()
    low.sort_indices()
    return HighsHessian(dim=q.shape[0],
                        start=low.indptr.astype(np.int64),
                        index=low.indices.astype(np.int64),
                        value=low.data.astype(np.float64))


def mm_qp_model(seed: int, n: int, m: int, hess_rank: str = "full",
                cond: float = 1e4, eq_frac: float = 0.3,
                density: float | None = None):
    """`gen_mm_style` as a HighsModel (minimise); `density` defaults to
    5 / n, as the JAX package's QP sweep draws it."""
    from ..models.lp import HighsLp, HighsModel, HighsSparseMatrix
    q, c, a, rl, ru, lo, up = gen_mm_style(
        seed, n, m, hess_rank, cond, eq_frac,
        5.0 / n if density is None else density)
    lp = HighsLp(num_col=n, num_row=m, col_cost=c, col_lower=lo,
                 col_upper=up, row_lower=rl, row_upper=ru,
                 a_matrix=HighsSparseMatrix.from_scipy(a.tocsc()), sense=1)
    return HighsModel(lp=lp, hessian=lower_hessian(q))


def status_qp_model(kind: str, seed: int = 11, n: int = 24, m: int = 12):
    """A seeded QP of `mm_qp_model` made "infeasible" (a row
    x_0 + ... + x_4 <= -1 over x >= 0) or "unbounded" (one more column
    with cost -1, no Hessian entry, no row entry and no upper bound)."""
    from ..models.lp import HighsHessian, HighsLp, HighsModel, \
        HighsSparseMatrix
    model = mm_qp_model(seed, n, m)
    lp = model.lp
    a = lp.a_matrix.to_scipy().tocsc()
    if kind == "infeasible":
        row = sp.csc_matrix((np.ones(5), (np.zeros(5), np.arange(5))),
                            shape=(1, n))
        lp = HighsLp(
            num_col=n, num_row=m + 1, col_cost=lp.col_cost,
            col_lower=lp.col_lower, col_upper=lp.col_upper,
            row_lower=np.append(lp.row_lower, -np.inf),
            row_upper=np.append(lp.row_upper, -1.0),
            a_matrix=HighsSparseMatrix.from_scipy(
                sp.vstack([a, row], format="csc")), sense=1)
        return HighsModel(lp=lp, hessian=model.hessian)
    if kind != "unbounded":
        raise ValueError(f"kind must be 'infeasible' or 'unbounded', "
                         f"not {kind!r}")
    lp = HighsLp(
        num_col=n + 1, num_row=m, col_cost=np.append(lp.col_cost, -1.0),
        col_lower=np.append(lp.col_lower, 0.0),
        col_upper=np.append(lp.col_upper, np.inf),
        row_lower=lp.row_lower, row_upper=lp.row_upper,
        a_matrix=HighsSparseMatrix.from_scipy(
            sp.hstack([a, sp.csc_matrix((m, 1))], format="csc")), sense=1)
    h = model.hessian
    return HighsModel(lp=lp, hessian=HighsHessian(
        dim=n + 1, start=np.append(h.start, h.start[-1]), index=h.index,
        value=h.value))
