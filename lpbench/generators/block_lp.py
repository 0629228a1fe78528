"""The block-tridiagonal ("staircase") LP family of time-staged models.

A frozen copy of `highs_tpu_torch/utils/gen_block_lp.py`, so that a
change to the port cannot move the yardstick: block-rows of dense
`block` x `block` tiles at (i, i-1), (i, i), (i, i+1), unit normal
values scaled to sqrt(10 / (3 block)), x* uniform in [0, 1],
b = A x* - 0.1 |noise| (so A x >= b is strictly feasible), c uniform in
[0.1, 1]; the LP is min c'x s.t. A x >= b, 0 <= x <= upper.

A fresh instance permutes the rows inside each block-row and the
columns inside each block-column: every tile stays dense and in its
place, so the structure and the LP's optimum are the base's, while the
data that reaches the solver is new.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lpbench.reference import Lp


def generate(params: dict) -> Lp:
    """The base instance of `params["nblocks"]` block-rows of
    `params["block"]` (m = n = nblocks block), from `params["seed"]`."""
    nblocks, block = params["nblocks"], params["block"]
    rng = np.random.default_rng(params["seed"])
    mb = nb = nblocks
    m = n = nblocks * block
    rows_b = []
    cols_b = []
    for i in range(mb):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nb:
                rows_b.append(i)
                cols_b.append(j)
    scale = float(np.sqrt(10.0 / (3.0 * block)))
    blocks = rng.standard_normal((len(rows_b), block, block)) * scale
    indptr = np.zeros(mb + 1, dtype=np.int64)
    for i in rows_b:
        indptr[i + 1] += 1
    indptr = np.cumsum(indptr)
    a = sp.bsr_matrix((blocks, np.asarray(cols_b, dtype=np.int64), indptr),
                      shape=(m, n)).tocsc()
    xstar = rng.uniform(0, 1, n)
    b = a @ xstar - np.abs(rng.standard_normal(m)) * 0.1
    c = rng.uniform(0.1, 1.0, n)
    return Lp(a, b, c, np.full(n, float(params["upper"])))


def _within_blocks(size: int, block: int, rng) -> np.ndarray:
    """A permutation of range(size) that maps each run of `block`
    indices onto itself."""
    keys = np.arange(size) // block + rng.random(size)
    return np.argsort(keys, kind="stable")


def fresh(base: Lp, params: dict, rng) -> Lp:
    """`base` with its rows permuted inside each block-row and its
    columns inside each block-column, drawn from `rng`."""
    m, n = base.a.shape
    p = _within_blocks(m, params["block"], rng)
    q = _within_blocks(n, params["block"], rng)
    a = base.a[:, q].tocsr()[p, :].tocsc()
    return Lp(a, base.b[p], base.c[q], base.upper[q])


def stats(base: Lp, params: dict) -> dict:
    """What the byte count of a product needs: sizes, nonzeros and the
    stored tiles (every tile of this family is dense)."""
    m, n = base.a.shape
    block = params["block"]
    return {"m": m, "n": n, "nnz": int(base.a.nnz), "block": block,
            "tiles": int(base.a.nnz) // (block * block)}
