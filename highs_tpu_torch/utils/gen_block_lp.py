"""The block-structured flagship LP (block64k) and its smaller members.

Block-tridiagonal LP with dense 128x128 blocks: the structure of
time-staged / staircase models (multi-period production, control
horizons).  The default, 512 block-rows, is 65,536 x 65,536 with about
25.1M nonzeros.

Feasible by construction: pick x*, b = A x* - |noise| * 0.1 (so Ax >= b
is strictly feasible), c > 0; the LP is min c'x s.t. Ax >= b,
0 <= x <= 10.  The same seed gives the same matrix as the JAX package's
tools/gen_block_lp.py.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

BLOCK = 128
NBLOCKS = 512  # m = n = 65536
SEED = 2024
UPPER = 10.0


def gen_block_lp(nblocks: int = NBLOCKS, block: int = BLOCK,
                 seed: int = SEED):
    """(A as CSC, b, c) of the block-tridiagonal LP."""
    rng = np.random.default_rng(seed)
    mb = nb = nblocks
    m = n = nblocks * block
    # block-tridiagonal pattern: (i, i-1), (i, i), (i, i+1)
    rows_b = []
    cols_b = []
    for i in range(mb):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nb:
                rows_b.append(i)
                cols_b.append(j)
    nnzb = len(rows_b)
    # dense blocks, ~10 unit-normal entries' worth of norm per row
    scale = float(np.sqrt(10.0 / (3.0 * block)))
    blocks = rng.standard_normal((nnzb, block, block)) * scale
    indptr = np.zeros(mb + 1, dtype=np.int64)
    for i in rows_b:
        indptr[i + 1] += 1
    indptr = np.cumsum(indptr)
    a = sp.bsr_matrix((blocks, np.asarray(cols_b, dtype=np.int64),
                       indptr), shape=(m, n)).tocsc()
    xstar = rng.uniform(0, 1, n)
    b = a @ xstar - np.abs(rng.standard_normal(m)) * 0.1
    c = rng.uniform(0.1, 1.0, n)
    return a, b, c


def block_lp(nblocks: int = NBLOCKS, seed: int = SEED):
    """The LP as a HighsLp: min c'x s.t. Ax >= b, 0 <= x <= 10."""
    from ..models.lp import HighsLp, HighsSparseMatrix
    a, b, c = gen_block_lp(nblocks=nblocks, seed=seed)
    m, n = a.shape
    return HighsLp(
        num_col=n, num_row=m, col_cost=c,
        col_lower=np.zeros(n), col_upper=np.full(n, UPPER),
        row_lower=b, row_upper=np.full(m, np.inf),
        a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
