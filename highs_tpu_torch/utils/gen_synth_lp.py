"""The scattered-sparsity flagship LP (synth50k) and its smaller members.

m x n with `per_col` random rows per column (duplicates summed), unit
normal values: nonzeros scattered over every 128x128 tile, the opposite
of block64k's dense tiles.  The default, seed 42, is 50,000 x 50,000
with 499,953 nonzeros, the same matrix and vectors as the JAX package's
`bench.py` `synth50k`.

Feasible by construction: pick x*, b = A x* - |noise| * 0.1 (so Ax >= b
is strictly feasible), c > 0; the LP is min c'x s.t. Ax >= b,
0 <= x <= 10.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

M = N = 50_000
PER_COL = 10
SEED = 42
UPPER = 10.0


def gen_synth_lp(m: int = M, n: int = N, per_col: int = PER_COL,
                 seed: int = SEED):
    """(A as CSC, b, c) of the scattered LP."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=(n, per_col))
    cols = np.repeat(np.arange(n), per_col)
    vals = rng.standard_normal(n * per_col)
    a = sp.csc_matrix((vals, (rows.ravel(), cols)), shape=(m, n))
    a.sum_duplicates()
    xstar = rng.uniform(0, 1, n)
    b = a @ xstar - np.abs(rng.standard_normal(m)) * 0.1
    c = rng.uniform(0.1, 1.0, n)
    return a, b, c


def synth_lp(m: int = M, n: int = N, per_col: int = PER_COL,
             seed: int = SEED):
    """The LP as a HighsLp: min c'x s.t. Ax >= b, 0 <= x <= 10."""
    from ..models.lp import HighsLp, HighsSparseMatrix
    a, b, c = gen_synth_lp(m=m, n=n, per_col=per_col, seed=seed)
    return HighsLp(
        num_col=n, num_row=m, col_cost=c,
        col_lower=np.zeros(n), col_upper=np.full(n, UPPER),
        row_lower=b, row_upper=np.full(m, np.inf),
        a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
