"""ctypes binding of the native simplex (native/hsimplex.cpp).

The reference keeps its simplex core native (highs/simplex/HEkk*,
util/HFactor, C++); so does this package: the bounded-variable revised
simplex runs on the host through the repository's
`native/libhsimplex.so`, loaded by `solvers/native_lib.py` as it is (or
built into `highs_tpu_torch/_build/` where it will not load; never
rebuilt in place).  The LP path binds `hx_simplex_solve`; the library's
MIP entries wait for the MIP slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .. import native_lib

# result codes from hsimplex.cpp
RESULT_OPTIMAL = 0
RESULT_INFEASIBLE = 1
RESULT_UNBOUNDED = 2
RESULT_ITER_LIMIT = 3
RESULT_SINGULAR = 4


def _declare(lib):
    f64p = np.ctypeslib.ndpointer(np.float64)
    lib.hx_simplex_solve.restype = ctypes.c_int
    lib.hx_simplex_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int32),
        f64p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_void_p,  # basis_in (nullable)
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double,  # time_limit_s (<=0 or huge: none)
        f64p, f64p, f64p,
        np.ctypeslib.ndpointer(np.int8),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]


def get_lib():
    return native_lib.load("hsimplex", ["hsimplex.cpp"], _declare)


def _ruiz_scales(a_csc, rounds: int = 6):
    """Ruiz equilibration factors (r, c) so that R A C has entries near
    unit magnitude (reference: the simplex scaling pass of HEkk/HMatrix).
    Returns None when the matrix is already well scaled."""
    m, n = a_csc.shape
    if a_csc.nnz == 0:
        return None
    amax = float(np.abs(a_csc.data).max())
    amin = float(np.abs(a_csc.data[a_csc.data != 0]).min()) \
        if a_csc.nnz else 1.0
    if amax <= 64.0 and amin >= 1.0 / 64.0:
        return None
    # linear passes over one CSR copy: per-entry row/col ids
    r = np.ones(m)
    c = np.ones(n)
    csr = a_csc.tocsr()
    row_of = np.repeat(np.arange(m), np.diff(csr.indptr))
    col_of = csr.indices
    data = np.abs(csr.data.astype(np.float64, copy=True))
    for _ in range(rounds):
        rmax = np.zeros(m)
        np.maximum.at(rmax, row_of, data)
        rmax[rmax == 0] = 1.0
        rs = 1.0 / np.sqrt(rmax)
        data *= rs[row_of]
        r *= rs
        cmax = np.zeros(n)
        np.maximum.at(cmax, col_of, data)
        cmax[cmax == 0] = 1.0
        cs = 1.0 / np.sqrt(cmax)
        data *= cs[col_of]
        c *= cs
    # power-of-two snapping keeps the mapping exact in binary fp
    r = np.exp2(np.round(np.log2(r)))
    c = np.exp2(np.round(np.log2(c)))
    return r, c


def simplex_solve(a_csc, col_cost, col_lower, col_upper, row_lower,
                  row_upper, basis_in: Optional[np.ndarray] = None,
                  tol_p: float = 1e-9, tol_d: float = 1e-9,
                  max_iter: int = 200000, time_limit: float = 0.0
                  ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, int]:
    """Solve min c'x s.t. L <= Ax <= U, l <= x <= u with the native
    simplex.  Returns (result, x, y, z, basis_status(n+m), iters)."""
    lib = get_lib()
    m, n = a_csc.shape
    big = 1e30

    def finite(v, fill):
        return np.ascontiguousarray(np.where(np.isfinite(v), v, fill),
                                    dtype=np.float64)
    ap = np.ascontiguousarray(a_csc.indptr, dtype=np.int64)
    ai = np.ascontiguousarray(a_csc.indices, dtype=np.int32)
    ax = np.ascontiguousarray(a_csc.data, dtype=np.float64)
    c = np.ascontiguousarray(col_cost, dtype=np.float64)

    x = np.zeros(n)
    y = np.zeros(m)
    z = np.zeros(n)
    basis_out = np.zeros(n + m, dtype=np.int8)
    iters = ctypes.c_int(0)
    status = ctypes.c_int(-1)

    basis_ptr = None
    if basis_in is not None:
        basis_arr = np.ascontiguousarray(basis_in, dtype=np.int8)
        basis_ptr = basis_arr.ctypes.data_as(ctypes.c_void_p)

    lib.hx_simplex_solve(
        m, n, ap, ai, ax, c, finite(col_lower, -big),
        finite(col_upper, big), finite(row_lower, -big),
        finite(row_upper, big), basis_ptr, tol_p, tol_d, max_iter,
        float(time_limit), x, y, z, basis_out, ctypes.byref(iters),
        ctypes.byref(status))
    return int(status.value), x, y, z, basis_out, int(iters.value)
