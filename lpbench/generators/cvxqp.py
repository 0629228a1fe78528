"""The CVXQP family of the Maros-Meszaros convex QP test set (CUTE's
CVXQP1-3, N. Gould 1995), made from its defining formulas:

    min  sum_i (i/2) (x_i + x_{(2i-1 mod n)+1} + x_{(3i-1 mod n)+1})^2
    s.t. x_i + 2 x_{(4i-1 mod n)+1} + 3 x_{(5i-1 mod n)+1} = 6,
         i = 1..m,  0.1 <= x <= 10,

with m = n/2, n/4 or 3n/4 for CVXQP1, CVXQP2 and CVXQP3 (the base
"seed" 1, 2 or 3 names the variant). So 1/2 x'Qx with
Q = sum_i i v_i v_i', v_i the (summed) indicator of the three columns
of term i, and c = 0. At n = 10,000 these are CVXQP1_L, CVXQP2_L and
CVXQP3_L; at n = 100 the S instances, at n = 1,000 the M ones.

A fresh instance permutes rows and columns (Q as P'QP), which leaves
the optimum's value unchanged.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lpbench.qp_reference import Qp

# m as a share of n, by variant
ROWS = {1: (1, 2), 2: (1, 4), 3: (3, 4)}


def cvxqp(n: int, variant: int) -> Qp:
    """CVXQP<variant> with n columns."""
    num, den = ROWS[variant]
    m = n * num // den
    i = np.arange(n)
    # 0-based columns of term i + 1: i, (2i + 1) mod n, (3i + 2) mod n
    terms = np.stack([i, (2 * i + 1) % n, (3 * i + 2) % n], axis=1)
    v = sp.csr_matrix((np.ones(3 * n), terms.ravel(),
                       np.arange(0, 3 * n + 1, 3)), shape=(n, n))
    v.sum_duplicates()
    q = (v.T @ sp.diags(i + 1.0) @ v).tocsc()
    r = np.arange(m)
    cols = np.stack([r, (4 * r + 3) % n, (5 * r + 4) % n], axis=1)
    a = sp.csr_matrix((np.tile([1.0, 2.0, 3.0], m), cols.ravel(),
                       np.arange(0, 3 * m + 1, 3)), shape=(m, n))
    a.sum_duplicates()
    six = np.full(m, 6.0)
    return Qp(q=q, c=np.zeros(n), a=a.tocsc(), row_lower=six,
              row_upper=six.copy(), col_lower=np.full(n, 0.1),
              col_upper=np.full(n, 10.0))


def generate(params: dict) -> Qp:
    """The base instance: variant `params["seed"]` at `params["n"]`."""
    return cvxqp(int(params["n"]), int(params["seed"]))


def permuted(base: Qp, p: np.ndarray, q: np.ndarray) -> Qp:
    """`base` with rows taken in the order `p` and columns in `q`."""
    return Qp(q=base.q[q, :][:, q].tocsc(), c=base.c[q],
              a=base.a[:, q].tocsr()[p, :].tocsc(),
              row_lower=base.row_lower[p], row_upper=base.row_upper[p],
              col_lower=base.col_lower[q], col_upper=base.col_upper[q])


def fresh(base: Qp, params: dict, rng) -> Qp:
    """`base` with its rows and columns permuted, drawn from `rng`."""
    m, n = base.a.shape
    return permuted(base, rng.permutation(m), rng.permutation(n))


def stats(base: Qp, params: dict) -> dict:
    """Sizes and nonzeros (Q's whole, both triangles)."""
    m, n = base.a.shape
    return {"m": m, "n": n, "nnz": int(base.a.nnz), "q_nnz": int(base.q.nnz)}
