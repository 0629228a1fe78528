"""Seeded MIP instances of two public classes, as numpy model dicts.

- Set covering after Balas & Ho (1980), generated as in Gasse et al.,
  "Exact Combinatorial Optimization with Graph Convolutional Neural
  Networks" (NeurIPS 2019), section 5.1: `nrows` x `ncols` 0/1 matrix of
  density `density` in which every column covers at least two rows and
  every row is covered, costs uniform in 1..100;
  min c'x s.t. A x >= 1, x binary.  The paper's sizes are 1,000 columns
  at density 0.05 with 500 rows ("easy") and 1,000 rows ("medium").
- Capacitated facility location after Cornuejols, Sridharan & Thizy
  (1991), generated as in the same paper: customers and facilities
  uniform in the unit square, demands in 5..35, capacities in 10..160
  rescaled so that their sum is `ratio` times the total demand, fixed
  costs (100..110) sqrt(capacity) + 0..90, transport costs
  10 * demand * distance; continuous assignments x_ij in [0, 1], binary
  openings y_j:
      min  sum_j f_j y_j + sum_ij t_ij x_ij
      s.t. sum_j x_ij >= 1                   (each customer served)
           sum_i d_i x_ij <= s_j y_j        (each facility's capacity)
           sum_j s_j y_j >= sum_i d_i       (total capacity)
           x_ij <= y_j                      (linking rows)
  so 100 customers and 100 facilities give 10,201 rows, 10,100 columns
  and 40,200 nonzeros.

Each generator returns the dict `convert.lp_from_numpy` reads (column-
wise matrix), the same arrays for any package.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _model(a: sp.spmatrix, cost, col_lower, col_upper, row_lower,
           row_upper, integrality) -> dict:
    a = sp.csc_matrix(a, dtype=np.float64)
    a.sort_indices()
    return dict(num_col=a.shape[1], num_row=a.shape[0],
                col_cost=np.asarray(cost, dtype=np.float64),
                col_lower=np.asarray(col_lower, dtype=np.float64),
                col_upper=np.asarray(col_upper, dtype=np.float64),
                row_lower=np.asarray(row_lower, dtype=np.float64),
                row_upper=np.asarray(row_upper, dtype=np.float64),
                a_start=a.indptr.astype(np.int64),
                a_index=a.indices.astype(np.int64),
                a_value=a.data.astype(np.float64),
                integrality=np.asarray(integrality, dtype=np.uint8))


def set_cover(nrows: int = 500, ncols: int = 1000, density: float = 0.05,
              seed: int = 0, max_cost: int = 100) -> dict:
    """The set-covering MIP (Gasse et al. 2019's generator)."""
    rng = np.random.default_rng(seed)
    nnz = int(nrows * ncols * density)
    if nnz < nrows or nnz < 2 * ncols:
        raise ValueError("density too low to cover every row and to give "
                         "every column two rows")
    # columns of the nonzeros: two per column first, the rest at random
    col_of = rng.integers(0, ncols, size=nnz)
    col_of[:2 * ncols] = np.repeat(np.arange(ncols), 2)
    col_count = np.bincount(col_of, minlength=ncols)
    # rows, column by column: the first nrows slots cover every row once
    rows = np.empty(nnz, dtype=np.int64)
    rows[:nrows] = rng.permutation(nrows)
    indptr = np.concatenate([[0], np.cumsum(col_count)])
    for j in range(ncols):
        s, e = int(indptr[j]), int(indptr[j + 1])
        if s >= nrows:
            rows[s:e] = rng.choice(nrows, size=e - s, replace=False)
        elif e > nrows:
            rest = np.setdiff1d(np.arange(nrows), rows[s:nrows],
                                assume_unique=True)
            rows[nrows:e] = rng.choice(rest, size=e - nrows, replace=False)
    a = sp.csc_matrix((np.ones(nnz), rows, indptr), shape=(nrows, ncols))
    cost = rng.integers(1, max_cost + 1, size=ncols)
    return _model(a, cost, np.zeros(ncols), np.ones(ncols),
                  np.ones(nrows), np.full(nrows, np.inf), np.ones(ncols))


def facility_location(n_customers: int = 100, n_facilities: int = 100,
                      ratio: float = 5.0, seed: int = 0) -> dict:
    """The capacitated facility-location MIP (Gasse et al. 2019's
    generator); columns x_ij customer-major, then y_j."""
    rng = np.random.default_rng(seed)
    nc, nf = n_customers, n_facilities
    c_xy = rng.uniform(size=(nc, 2))
    f_xy = rng.uniform(size=(nf, 2))
    demand = rng.integers(5, 36, size=nc).astype(np.float64)
    capacity = rng.integers(10, 161, size=nf).astype(np.float64)
    fixed = np.floor(rng.integers(100, 111, size=nf) * np.sqrt(capacity)
                     + rng.integers(0, 91, size=nf))
    capacity = np.floor(capacity * ratio * demand.sum() / capacity.sum())
    dist = np.sqrt(((c_xy[:, None, :] - f_xy[None, :, :]) ** 2).sum(-1))
    trans = dist * 10.0 * demand[:, None]
    n_x = nc * nf
    x_id = np.arange(n_x).reshape(nc, nf)
    y_id = n_x + np.arange(nf)
    blocks = []
    # demand rows: sum_j x_ij >= 1
    blocks.append((np.repeat(np.arange(nc), nf), x_id.ravel(),
                   np.ones(n_x)))
    # capacity rows: sum_i d_i x_ij - s_j y_j <= 0
    r0 = nc
    blocks.append((r0 + np.tile(np.arange(nf), nc), x_id.ravel(),
                   np.repeat(demand, nf)))
    blocks.append((r0 + np.arange(nf), y_id, -capacity))
    # total capacity: sum_j s_j y_j >= sum_i d_i
    r1 = r0 + nf
    blocks.append((np.full(nf, r1), y_id, capacity))
    # linking rows: x_ij - y_j <= 0
    r2 = r1 + 1
    blocks.append((r2 + np.arange(n_x), x_id.ravel(), np.ones(n_x)))
    blocks.append((r2 + np.arange(n_x), np.tile(y_id, nc), -np.ones(n_x)))
    rows, cols, vals = (np.concatenate(p) for p in zip(*blocks))
    m = r2 + n_x
    a = sp.csc_matrix((vals, (rows, cols)), shape=(m, n_x + nf))
    row_lower = np.concatenate([np.ones(nc), np.full(nf, -np.inf),
                                [demand.sum()], np.full(n_x, -np.inf)])
    row_upper = np.concatenate([np.full(nc, np.inf), np.zeros(nf),
                                [np.inf], np.zeros(n_x)])
    cost = np.concatenate([trans.ravel(), fixed])
    integrality = np.concatenate([np.zeros(n_x), np.ones(nf)])
    return _model(a, cost, np.zeros(n_x + nf), np.ones(n_x + nf),
                  row_lower, row_upper, integrality)


def equality_knapsacks(m: int = 4, n: int = 20, seed: int = 0) -> dict:
    """A market-split-like binary program (after Cornuejols & Dawande,
    1998): `m` equality knapsack rows with coefficients uniform in
    0..99 over `n` binaries, right-hand sides from a planted 0/1 point
    (so it is feasible), costs uniform in 1..19.  Rounding heuristics
    rarely satisfy its equalities, so the MIP solver's root reaches the
    later heuristics (central rounding, sub-MIPs) without an
    incumbent."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 100, size=(m, n)).astype(np.float64)
    b = a @ rng.integers(0, 2, size=n)
    cost = rng.integers(1, 20, size=n)
    return _model(sp.csc_matrix(a), cost, np.zeros(n), np.ones(n), b, b,
                  np.ones(n))
