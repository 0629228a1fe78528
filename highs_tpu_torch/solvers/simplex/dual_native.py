"""ctypes binding of the native dual simplex (native/hdual.cpp).

The reference's default LP engine is dual simplex (highs/simplex/
HEkkDual.cpp); this binding exposes its one-shot entry, mirroring
`native.simplex_solve` with a CSR copy for sparse PRICE.  The library
is the repository's `native/libhdual.so` (hdual.cpp with hcuts.cpp),
loaded by `solvers/native_lib.py` as it is or built into
`highs_tpu_torch/_build/` where it will not load.  Its persistent
engine, branch-and-bound and cut loop wait for the MIP slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .. import native_lib

# result codes (hdual.cpp Result enum)
RESULT_OPTIMAL = 0
RESULT_INFEASIBLE = 1
RESULT_UNBOUNDED = 2
RESULT_ITER_LIMIT = 3
RESULT_SINGULAR = 4


def _declare(lib):
    i64p = np.ctypeslib.ndpointer(np.int64)
    i32p = np.ctypeslib.ndpointer(np.int32)
    f64p = np.ctypeslib.ndpointer(np.float64)
    i8p = np.ctypeslib.ndpointer(np.int8)
    lib.hx_dual_solve.restype = ctypes.c_int
    lib.hx_dual_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, i64p, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_void_p,  # basis_in (nullable)
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, f64p, f64p, f64p, i8p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


def get_lib():
    return native_lib.load("hdual", ["hdual.cpp", "hcuts.cpp"], _declare)


def _finite(a, big=1e30):
    return np.ascontiguousarray(
        np.clip(np.nan_to_num(np.asarray(a, dtype=np.float64),
                              nan=0.0, posinf=big, neginf=-big),
                -big, big))


def dual_solve(a_csc, a_csr, col_cost, col_lower, col_upper, row_lower,
               row_upper, basis_in: Optional[np.ndarray] = None,
               tol_p: float = 1e-9, tol_d: float = 1e-9,
               max_iter: int = 200000, time_limit: float = 0.0
               ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray, int]:
    """One-shot dual simplex.  Returns (result, x, y, z, basis, iters)."""
    lib = get_lib()
    m, n = a_csc.shape
    big = 1e30
    ap = np.ascontiguousarray(a_csc.indptr, dtype=np.int64)
    ai = np.ascontiguousarray(a_csc.indices, dtype=np.int32)
    ax = np.ascontiguousarray(a_csc.data, dtype=np.float64)
    rp = np.ascontiguousarray(a_csr.indptr, dtype=np.int64)
    ri = np.ascontiguousarray(a_csr.indices, dtype=np.int32)
    rx = np.ascontiguousarray(a_csr.data, dtype=np.float64)
    c = _finite(col_cost)
    cl = _finite(np.where(np.isfinite(col_lower), col_lower, -big))
    cu = _finite(np.where(np.isfinite(col_upper), col_upper, big))
    rl = _finite(np.where(np.isfinite(row_lower), row_lower, -big))
    ru = _finite(np.where(np.isfinite(row_upper), row_upper, big))
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
    lib.hx_dual_solve(
        m, n, ap, ai, ax, rp, ri, rx, c, cl, cu, rl, ru, basis_ptr,
        tol_p, tol_d, int(max_iter), float(time_limit), x, y, z,
        basis_out, ctypes.byref(iters), ctypes.byref(status))
    return int(status.value), x, y, z, basis_out, int(iters.value)
