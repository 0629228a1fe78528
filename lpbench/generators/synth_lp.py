"""The scattered LP family: `per_col` unit normal nonzeros per column.

A frozen copy of `highs_tpu_torch/utils/gen_synth_lp.py` (the JAX
package's `bench.py` `synth50k` at 50,000 x 50,000, seed 42), so that a
change to the port cannot move the yardstick: each column takes
`per_col` uniform random rows (duplicates summed) with unit normal
values, x* uniform in [0, 1], b = A x* - 0.1 |noise|, c uniform in
[0.1, 1]; the LP is min c'x s.t. A x >= b, 0 <= x <= upper.

A fresh instance permutes all rows and all columns: the nonzeros stay
scattered over every tile, and the LP's optimum is the base's.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lpbench.reference import Lp


def generate(params: dict) -> Lp:
    """The base instance, `params["m"]` x `params["n"]`, from
    `params["seed"]`."""
    m, n, per_col = params["m"], params["n"], params["per_col"]
    rng = np.random.default_rng(params["seed"])
    rows = rng.integers(0, m, size=(n, per_col))
    cols = np.repeat(np.arange(n), per_col)
    vals = rng.standard_normal(n * per_col)
    a = sp.csc_matrix((vals, (rows.ravel(), cols)), shape=(m, n))
    a.sum_duplicates()
    xstar = rng.uniform(0, 1, n)
    b = a @ xstar - np.abs(rng.standard_normal(m)) * 0.1
    c = rng.uniform(0.1, 1.0, n)
    return Lp(a, b, c, np.full(n, float(params["upper"])))


def fresh(base: Lp, params: dict, rng) -> Lp:
    """`base` with its rows and columns permuted, drawn from `rng`."""
    m, n = base.a.shape
    p = rng.permutation(m)
    q = rng.permutation(n)
    a = base.a[:, q].tocsr()[p, :].tocsc()
    return Lp(a, base.b[p], base.c[q], base.upper[q])


def stats(base: Lp, params: dict) -> dict:
    """What the byte count of a product needs: sizes and nonzeros."""
    m, n = base.a.shape
    return {"m": m, "n": n, "nnz": int(base.a.nnz)}
