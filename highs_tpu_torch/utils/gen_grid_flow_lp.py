"""A grid min-cost flow LP: the sparse IPM route's structured case.

A copy of the JAX package's test generator (`tests/test_sparse_ipm.py`
`_grid_flow_lp`): g x g nodes, one arc each way between grid neighbours
(right and down, either sign of flow within [-50, 50]), node supplies of
unit normal values with mean 0 as equality rows, arc costs uniform in
[1, 3].  Its normal matrix is a grid Laplacian: banded after an RCM
ordering, and singular (the supplies sum to 0).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..models.lp import HighsLp, HighsSparseMatrix


def grid_flow_lp(g: int = 40, seed: int = 5) -> HighsLp:
    m = g * g
    rows, cols, vals = [], [], []
    e = 0
    for i in range(g):
        for j in range(g):
            if j + 1 < g:
                rows += [i * g + j, i * g + j + 1]
                cols += [e, e]
                vals += [1.0, -1.0]
                e += 1
            if i + 1 < g:
                rows += [i * g + j, (i + 1) * g + j]
                cols += [e, e]
                vals += [1.0, -1.0]
                e += 1
    a = sp.csc_matrix((vals, (rows, cols)), shape=(m, e))
    rng = np.random.default_rng(seed)
    supply = rng.standard_normal(m)
    supply -= supply.mean()
    c = rng.uniform(1.0, 3.0, e)
    return HighsLp(
        num_col=e, num_row=m, col_cost=c,
        col_lower=np.full(e, -50.0), col_upper=np.full(e, 50.0),
        row_lower=supply, row_upper=supply,
        a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
