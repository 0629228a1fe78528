"""ctypes binding of the native dual simplex (native/hdual.cpp).

The reference's default LP engine is dual simplex (highs/simplex/
HEkkDual.cpp) and its MIP node engine is the same, hot-started
(highs/mip/HighsLpRelaxation.cpp).  This binding exposes the one-shot
entry (mirroring `native.simplex_solve` with a CSR copy for sparse
PRICE), the persistent engine whose factorization survives across node
re-solves (`DualEngine`), the native branch-and-bound over it
(`mip_solve`) and the root separation round (`root_cuts`).  The library
is the repository's `native/libhdual.so` (hdual.cpp with hcuts.cpp),
loaded by `solvers/native_lib.py` as it is or built into
`highs_tpu_torch/_build/` where it will not load; a failure to load or
bind raises.
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
RESULT_NEED_PRIMAL = 5
RESULT_OBJ_CUT = 6

# progress hook from hx_mip_solve: (user, what, primal, dual, nodes,
# lp_iters, x_ptr, n) -> nonzero interrupts.  what: 0 periodic,
# 1 improved incumbent.
MIP_CALLBACK = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
    ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
    ctypes.POINTER(ctypes.c_double), ctypes.c_int)


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
    lib.hx_dual_create.restype = ctypes.c_void_p
    lib.hx_dual_create.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, i64p, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p]
    lib.hx_dual_destroy.restype = None
    lib.hx_dual_destroy.argtypes = [ctypes.c_void_p]
    lib.hx_dual_set_col_bounds.restype = None
    lib.hx_dual_set_col_bounds.argtypes = [ctypes.c_void_p, f64p, f64p]
    lib.hx_dual_set_basis.restype = None
    lib.hx_dual_set_basis.argtypes = [ctypes.c_void_p, i8p]
    lib.hx_dual_set_tol_scale.restype = None
    lib.hx_dual_set_tol_scale.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.hx_dual_solve_h.restype = ctypes.c_int
    lib.hx_dual_solve_h.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        f64p, f64p, f64p, i8p, ctypes.POINTER(ctypes.c_int)]
    lib.hx_mip_solve.restype = ctypes.c_int
    lib.hx_mip_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, i64p, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p, i8p,
        ctypes.c_void_p,  # root basis (nullable)
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int,
        MIP_CALLBACK, ctypes.c_void_p,
        ctypes.c_void_p,  # tol_scale (nullable)
        ctypes.c_void_p, ctypes.c_int,  # symmetry generators
        ctypes.c_void_p,  # ext_upper (nullable shared incumbent)
        f64p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hx_root_cuts.restype = ctypes.c_int
    lib.hx_root_cuts.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, i64p, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p, i8p,
        ctypes.c_void_p,  # basis_in (nullable)
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p,  # x_in (nullable)
        i64p, i64p, f64p, f64p,
        ctypes.POINTER(ctypes.c_double), f64p, f64p, i8p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int)]


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


def _csc_csr(a_csc, a_csr):
    """The matrix's index and value arrays in the native layout."""
    return (np.ascontiguousarray(a_csc.indptr, dtype=np.int64),
            np.ascontiguousarray(a_csc.indices, dtype=np.int32),
            np.ascontiguousarray(a_csc.data, dtype=np.float64),
            np.ascontiguousarray(a_csr.indptr, dtype=np.int64),
            np.ascontiguousarray(a_csr.indices, dtype=np.int32),
            np.ascontiguousarray(a_csr.data, dtype=np.float64))


def _bounds(col_lo, col_up, row_lo, row_up, big=1e30):
    return tuple(_finite(np.where(np.isfinite(v), v, fill))
                 for v, fill in ((col_lo, -big), (col_up, big),
                                 (row_lo, -big), (row_up, big)))


class DualEngine:
    """Persistent dual simplex over a fixed matrix with mutable column
    bounds: the MIP hot-resolve shape (HighsLpRelaxation parity).  The
    native engine copies the arrays it is given."""

    def __init__(self, a_csc, a_csr, cost, col_lo, col_up, row_lo,
                 row_up):
        self._lib = get_lib()
        self.m, self.n = a_csc.shape[0], a_csc.shape[1]
        self._h = self._lib.hx_dual_create(
            self.m, self.n, *_csc_csr(a_csc, a_csr), _finite(cost),
            *_bounds(col_lo, col_up, row_lo, row_up))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.hx_dual_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def set_col_bounds(self, lo, up):
        big = 1e30
        self._lib.hx_dual_set_col_bounds(
            self._h, _finite(np.where(np.isfinite(lo), lo, -big)),
            _finite(np.where(np.isfinite(up), up, big)))

    def set_tol_scale(self, tol_scale):
        """Per-variable primal tolerance scale (len n+m: 1/col_scale
        then row_scale) so the engine enforces ABSOLUTE unscaled
        feasibility on Ruiz-scaled data.  The engine copies it."""
        ts = np.ascontiguousarray(tol_scale, dtype=np.float64)
        self._lib.hx_dual_set_tol_scale(
            self._h, ts.ctypes.data_as(ctypes.c_void_p))

    def set_basis(self, basis):
        self._lib.hx_dual_set_basis(
            self._h, np.ascontiguousarray(basis, dtype=np.int8))

    def solve(self, tol_p=1e-9, tol_d=1e-9, max_iter=100000,
              time_limit=0.0, obj_cut=np.inf):
        x = np.zeros(self.n)
        y = np.zeros(self.m)
        z = np.zeros(self.n)
        basis = np.zeros(self.n + self.m, dtype=np.int8)
        iters = ctypes.c_int(0)
        res = self._lib.hx_dual_solve_h(
            self._h, tol_p, tol_d, int(max_iter), float(time_limit),
            float(obj_cut) if np.isfinite(obj_cut) else 1e30,
            x, y, z, basis, ctypes.byref(iters))
        return int(res), x, y, z, basis, int(iters.value)


def mip_solve(a_csc, a_csr, cost, col_lo, col_up, row_lo, row_up,
              is_int, root_basis, incumbent_obj, obj_scale,
              mip_abs_gap, mip_rel_gap, obj_offset, root_bound,
              feastol=1e-6, tol_p=1e-9, tol_d=1e-9,
              max_nodes=10**12, time_limit=1e18, reliable=4,
              callback=None, tol_scale=None, sym_gens=None,
              ext_upper=None):
    """Native branch-and-bound over the persistent dual engine
    (hx_mip_solve).  Returns (status, found, best_x, best_obj,
    dual_bound, nodes, lp_iters); status 0 = exhausted, 2 = limit or
    callback interrupt, 3 = numerical fallback.

    `callback(what, primal, dual, nodes, lp_iters, x_or_None)` with
    what 0 = periodic tick, 1 = improved incumbent; a truthy return
    interrupts the search.  An exception in the callback interrupts the
    search too, and is raised again once the native call returns.

    `ext_upper`: optional ctypes double buffer a concurrent worker
    writes its best objective into; the engine polls it at periodic
    ticks and adopts better values for pruning (reference
    HighsMipSolver worker solution sync :336)."""
    lib = get_lib()
    m, n = a_csc.shape
    big = 1e30
    ii = np.ascontiguousarray(is_int, dtype=np.int8)
    basis_ptr = None
    if root_basis is not None:
        bas = np.ascontiguousarray(root_basis, dtype=np.int8)
        basis_ptr = bas.ctypes.data_as(ctypes.c_void_p)
    ts = (np.ascontiguousarray(tol_scale, dtype=np.float64)
          if tol_scale is not None else None)
    gens = (np.ascontiguousarray(sym_gens, dtype=np.int32)
            if sym_gens is not None and len(sym_gens) else None)
    best_x = np.zeros(n)
    best_obj = ctypes.c_double(0.0)
    dual_bound = ctypes.c_double(0.0)
    nodes = ctypes.c_int64(0)
    iters = ctypes.c_int64(0)
    found = ctypes.c_int(0)
    status = ctypes.c_int(-1)
    inc = float(incumbent_obj) if np.isfinite(incumbent_obj) else big

    raised = []
    if callback is not None:
        def _trampoline(_ud, what, primal, dual, nds, lpit, x_ptr, nn):
            xs = None
            if what == 1 and x_ptr:
                xs = np.ctypeslib.as_array(x_ptr, shape=(nn,)).copy()
            try:
                return 1 if callback(what, primal, dual, nds, lpit,
                                     xs) else 0
            except BaseException as err:  # raised after the call
                raised.append(err)
                return 1
        cb = MIP_CALLBACK(_trampoline)
    else:
        cb = MIP_CALLBACK()  # NULL

    lib.hx_mip_solve(
        m, n, *_csc_csr(a_csc, a_csr), _finite(cost),
        *_bounds(col_lo, col_up, row_lo, row_up), ii, basis_ptr,
        inc, float(obj_scale or 0.0), float(mip_abs_gap),
        float(mip_rel_gap), float(obj_offset),
        float(root_bound) if np.isfinite(root_bound) else -big,
        float(feastol), float(tol_p), float(tol_d), int(max_nodes),
        float(time_limit), int(reliable), cb, None,
        ts.ctypes.data_as(ctypes.c_void_p) if ts is not None else None,
        gens.ctypes.data_as(ctypes.c_void_p) if gens is not None
        else None,
        (len(sym_gens) // n if sym_gens is not None else 0),
        (ctypes.cast(ext_upper, ctypes.c_void_p)
         if ext_upper is not None else None), best_x,
        ctypes.byref(best_obj), ctypes.byref(dual_bound),
        ctypes.byref(nodes), ctypes.byref(iters), ctypes.byref(found),
        ctypes.byref(status))
    if raised:
        raise raised[0]
    db = dual_bound.value
    if db >= big:
        db = np.inf
    elif db <= -big:
        db = -np.inf
    return (int(status.value), bool(found.value), best_x,
            float(best_obj.value), db, int(nodes.value),
            int(iters.value))


def root_cuts(a_csc, a_csr, cost, col_lo, col_up, row_lo, row_up,
              is_int, basis_in=None, feastol=1e-6, tol_p=1e-9,
              tol_d=1e-9, max_cuts_round=200, cut_cap=4000,
              nnz_cap=500000, time_budget=5.0, x_at=None):
    """One native separation round at the root (hx_root_cuts in its
    separate-only mode): tableau-MIR from the engine's own factorization
    of `basis_in`, single-row c-MIR over the relaxation rows and
    path-aggregation c-MIR, against the point `x_at` (reference
    evaluateRootNode's separation, HighsMipSolverData.cpp:1987-2143).
    The library's full cut loop (separate_only=0) is not bound.

    Returns (status, cuts, bound, x, z, basis, lp_iters, rounds) where
    cuts is a list of (cols int64[], vals f64[], rhs) rows valid as
    a'x <= rhs, and status is 0 = root optimal, 1 = infeasible,
    2 = numerical trouble (outputs beyond `cuts` are then
    meaningless)."""
    lib = get_lib()
    m, n = a_csc.shape
    ii = np.ascontiguousarray(is_int, dtype=np.int8)
    basis_ptr = None
    if basis_in is not None:
        bas = np.ascontiguousarray(basis_in, dtype=np.int8)
        basis_ptr = bas.ctypes.data_as(ctypes.c_void_p)
    x_in = (np.ascontiguousarray(x_at, dtype=np.float64)
            if x_at is not None else None)
    cut_indptr = np.zeros(cut_cap + 1, dtype=np.int64)
    cut_cols = np.zeros(nnz_cap, dtype=np.int64)
    cut_vals = np.zeros(nnz_cap, dtype=np.float64)
    cut_rhs = np.zeros(cut_cap, dtype=np.float64)
    bound = ctypes.c_double(-np.inf)
    x = np.zeros(n)
    z = np.zeros(n)
    basis_out = np.zeros(n + m + cut_cap, dtype=np.int8)
    n_cuts = ctypes.c_int(0)
    lp_iters = ctypes.c_int64(0)
    rounds = ctypes.c_int(0)
    status = lib.hx_root_cuts(
        m, n, *_csc_csr(a_csc, a_csr), _finite(cost),
        *_bounds(col_lo, col_up, row_lo, row_up), ii,
        basis_ptr, float(feastol), float(tol_p), float(tol_d),
        1, int(max_cuts_round), int(cut_cap), int(nnz_cap),
        float(time_budget), 1,
        x_in.ctypes.data_as(ctypes.c_void_p) if x_in is not None
        else None,
        cut_indptr, cut_cols, cut_vals, cut_rhs,
        ctypes.byref(bound), x, z, basis_out,
        ctypes.byref(n_cuts), ctypes.byref(lp_iters),
        ctypes.byref(rounds))
    k = int(n_cuts.value)
    cuts = []
    for t in range(k):
        s, e = cut_indptr[t], cut_indptr[t + 1]
        cuts.append((cut_cols[s:e].copy(), cut_vals[s:e].copy(),
                     float(cut_rhs[t])))
    return (int(status), cuts, float(bound.value), x, z,
            basis_out[:n + m + k].copy(), int(lp_iters.value),
            int(rounds.value))
