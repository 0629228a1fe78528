"""ctypes binding of the native simplex (native/hsimplex.cpp).

The reference keeps its simplex core native (highs/simplex/HEkk*,
util/HFactor, C++); so does this package: the bounded-variable revised
simplex runs on the host through the repository's
`native/libhsimplex.so`, loaded by `solvers/native_lib.py` as it is (or
built into `highs_tpu_torch/_build/` where it will not load; never
rebuilt in place).  The LP path binds `hx_simplex_solve`; the MIP binds
the feasibility jump (`hx_feasibility_jump`), the branch-and-bound dive
loop (`hx_bb_solve`) and the worklist propagator (`hx_propagate`).  A
library that will not load or bind raises: no caller falls back to a
Python path.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .. import native_lib

# result codes from hsimplex.cpp
RESULT_OPTIMAL = 0
RESULT_INFEASIBLE = 1
RESULT_UNBOUNDED = 2
RESULT_ITER_LIMIT = 3
RESULT_SINGULAR = 4


def _declare(lib):
    f64p = np.ctypeslib.ndpointer(np.float64)
    i64p = np.ctypeslib.ndpointer(np.int64)
    i32p = np.ctypeslib.ndpointer(np.int32)
    i8p = np.ctypeslib.ndpointer(np.int8)
    lib.hx_simplex_solve.restype = ctypes.c_int
    lib.hx_simplex_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_void_p,  # basis_in (nullable)
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double,  # time_limit_s (<=0 or huge: none)
        f64p, f64p, f64p, i8p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.hx_feasibility_jump.restype = ctypes.c_int
    lib.hx_feasibility_jump.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, i64p, i32p, f64p,
        f64p, f64p, f64p, f64p, f64p, i8p,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_uint64,
        f64p,
    ]
    lib.hx_bb_solve.restype = ctypes.c_int
    lib.hx_bb_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, i64p, i32p, f64p,
        f64p, f64p, f64p, f64p, f64p, i8p,
        ctypes.c_void_p,  # root basis (nullable)
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_double,
        f64p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.hx_propagate.restype = ctypes.c_int
    lib.hx_propagate.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, f64p, f64p, i8p,
        ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p,  # seed_cols (nullable)
        ctypes.c_int,
        f64p, f64p,
    ]


def get_lib():
    return native_lib.load("hsimplex", ["hsimplex.cpp"], _declare)


def propagate_native(rp, ri, rx, row_lo, row_up, is_int, lo, up,
                     feastol=1e-6, max_rounds=8, seed_cols=None):
    """Worklist activity propagation (hx_propagate).  Tightens lo/up
    copies; returns (feasible, lo, up)."""
    lib = get_lib()
    lo = np.ascontiguousarray(lo, dtype=np.float64).copy()
    up = np.ascontiguousarray(up, dtype=np.float64).copy()
    if seed_cols is None:
        seed_ptr, n_seed = None, -1
    else:
        seed = np.ascontiguousarray(seed_cols, dtype=np.int32)
        seed_ptr = seed.ctypes.data_as(ctypes.c_void_p)
        n_seed = len(seed)
    ok = lib.hx_propagate(
        len(row_lo), len(lo), rp, ri, rx, row_lo, row_up, is_int,
        feastol, max_rounds, seed_ptr, n_seed, lo, up)
    return bool(ok), lo, up


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
                  max_iter: int = 200000, time_limit: float = 0.0,
                  scales=None, scaled_matrix=None
                  ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, int]:
    """Solve min c'x s.t. L <= Ax <= U, l <= x <= u with the native
    simplex.  Returns (result, x, y, z, basis_status(n+m), iters).

    With `scales` = (r, c) (`_ruiz_scales`) the scaled LP R A C is
    solved instead (`scaled_matrix` is R A C when the caller has it)
    and the solution mapped back exactly (power-of-two factors):
    x = C x', y = R y', z = z'/C; basis statuses are scale-invariant."""
    if scales is not None:
        r, cdiag = scales
        a_s = scaled_matrix if scaled_matrix is not None else (
            sp.diags(r) @ a_csc @ sp.diags(cdiag)).tocsc()
        res, xs, ys, zs, b, it = simplex_solve(
            a_s, np.asarray(col_cost) * cdiag,
            np.where(np.isfinite(col_lower), col_lower / cdiag, col_lower),
            np.where(np.isfinite(col_upper), col_upper / cdiag, col_upper),
            np.where(np.isfinite(row_lower), row_lower * r, row_lower),
            np.where(np.isfinite(row_upper), row_upper * r, row_upper),
            basis_in=basis_in, tol_p=tol_p, tol_d=tol_d,
            max_iter=max_iter, time_limit=time_limit)
        return res, xs * cdiag, ys * r, zs / cdiag, b, it
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


def bb_solve(a_csc, a_csr, cost, col_lo, col_up, row_lo, row_up,
             is_int, root_basis, incumbent_obj, obj_scale,
             mip_abs_gap, mip_rel_gap, obj_offset, root_bound,
             feastol=1e-6, tol_p=1e-9, tol_d=1e-9,
             max_nodes=10**12, time_limit=1e18):
    """Native branch-and-bound dive loop (hx_bb_solve).  Returns
    (status, found, best_x, best_obj, dual_bound, nodes, lp_iters);
    status 0 = exhausted, 2 = limit, 3 = numerical fallback."""
    lib = get_lib()
    m, n = a_csc.shape
    big = 1e30

    def clip(v, nan):
        return np.ascontiguousarray(np.clip(np.nan_to_num(
            v, nan=nan, posinf=big, neginf=-big), -big, big))
    ap = np.ascontiguousarray(a_csc.indptr, dtype=np.int64)
    ai = np.ascontiguousarray(a_csc.indices, dtype=np.int32)
    ax = np.ascontiguousarray(a_csc.data, dtype=np.float64)
    rp = np.ascontiguousarray(a_csr.indptr, dtype=np.int64)
    ri = np.ascontiguousarray(a_csr.indices, dtype=np.int32)
    rx = np.ascontiguousarray(a_csr.data, dtype=np.float64)
    c = np.ascontiguousarray(cost, dtype=np.float64)
    ii = np.ascontiguousarray(is_int, dtype=np.int8)
    basis_ptr = None
    if root_basis is not None:
        bas = np.ascontiguousarray(root_basis, dtype=np.int8)
        basis_ptr = bas.ctypes.data_as(ctypes.c_void_p)
    best_x = np.zeros(n)
    best_obj = ctypes.c_double(0.0)
    dual_bound = ctypes.c_double(0.0)
    nodes = ctypes.c_int64(0)
    iters = ctypes.c_int64(0)
    found = ctypes.c_int(0)
    status = ctypes.c_int(-1)
    inc = float(incumbent_obj) if np.isfinite(incumbent_obj) else big
    lib.hx_bb_solve(
        m, n, ap, ai, ax, rp, ri, rx, c, clip(col_lo, -big),
        clip(col_up, big), clip(row_lo, -big), clip(row_up, big), ii,
        basis_ptr, inc, float(obj_scale or 0.0), float(mip_abs_gap),
        float(mip_rel_gap), float(obj_offset),
        float(root_bound) if np.isfinite(root_bound) else -big,
        float(feastol), float(tol_p), float(tol_d),
        int(max_nodes), float(time_limit), best_x,
        ctypes.byref(best_obj), ctypes.byref(dual_bound),
        ctypes.byref(nodes), ctypes.byref(iters), ctypes.byref(found),
        ctypes.byref(status))
    db = dual_bound.value
    if db >= big:
        db = np.inf
    elif db <= -big:
        db = -np.inf
    return (int(status.value), bool(found.value), best_x,
            float(best_obj.value), db, int(nodes.value),
            int(iters.value))
