"""ctypes binding of the native cut-generation library (native/hcuts.cpp).

The reference generates cuts in C++ (highs/mip/HighsCutGeneration.cpp);
so does this package: `hx_mir_on_leq` is a semantics-exact port of
`cuts._mir_on_leq_py` (which stays as the property-test oracle),
`hx_mir_batch` runs it over many rows in one call and
`hx_integral_scale` is the integral-scale search.  The library is the
repository's `native/libhcuts.so`, loaded by `solvers/native_lib.py` as
it is or built into `highs_tpu_torch/_build/` where it will not load; a
failure to load or bind raises.  The JAX package's path-aggregation
entry (`hx_path_mir`) is not bound: the port's solver leaves path
separation to the native root round (`dual_native.root_cuts`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .. import native_lib

i64p = np.ctypeslib.ndpointer(np.int64)
f64p = np.ctypeslib.ndpointer(np.float64)
i8p = np.ctypeslib.ndpointer(np.int8)


def _declare(lib):
    i32p = np.ctypeslib.ndpointer(np.int32)
    lib.hx_integral_scale.restype = ctypes.c_double
    lib.hx_integral_scale.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_longlong, ctypes.c_double]
    lib.hx_mir_on_leq.restype = ctypes.c_int
    lib.hx_mir_on_leq.argtypes = [
        ctypes.c_int, i64p, f64p, ctypes.c_double, f64p, f64p, f64p, i8p,
        ctypes.c_double, ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_void_p,  # vb_ptr (nullable)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, i64p, f64p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.hx_mir_batch.restype = None
    lib.hx_mir_batch.argtypes = [
        ctypes.c_int, i64p, i64p, f64p, f64p, f64p, f64p, f64p,
        i8p, ctypes.c_double, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, i64p, f64p, f64p, f64p, i32p]


def get_lib():
    return native_lib.load("hcuts", ["hcuts.cpp"], _declare)


class VBounds(dict):
    """dict col -> [(ycol, c1, c0), ...] that can carry a cached
    flattened (native-call) representation."""
    __slots__ = ("_flat",)


def flatten_vbounds(vubs: dict, vlbs: dict):
    """Flatten (vubs, vlbs) into per-column arrays for the native call:
    per column, vlbs first then vubs, insertion order preserved (this
    order is the python candidate order and drives tie-breaks)."""
    n_vb = 1 + max(max(vubs, default=-1), max(vlbs, default=-1))
    if n_vb <= 0:
        return (0, np.zeros(1, np.int64), np.zeros(0, np.int32),
                np.zeros(0), np.zeros(0), np.zeros(0, np.uint8))
    counts = np.zeros(n_vb + 1, np.int64)
    for j, lst in vlbs.items():
        counts[j + 1] += len(lst)
    for j, lst in vubs.items():
        counts[j + 1] += len(lst)
    indptr = np.cumsum(counts)
    total = int(indptr[-1])
    y = np.zeros(total, np.int32)
    c1 = np.zeros(total)
    c0 = np.zeros(total)
    isub = np.zeros(total, np.uint8)
    pos = indptr[:-1].copy()
    for src, flag in ((vlbs, 0), (vubs, 1)):
        for j, lst in src.items():
            p = int(pos[j])
            for (yc, a1, a0) in lst:
                y[p] = yc
                c1[p] = a1
                c0[p] = a0
                isub[p] = flag
                p += 1
            pos[j] = p
    return n_vb, np.ascontiguousarray(indptr), y, c1, c0, isub


def _flat_for(vubs, vlbs):
    if vubs is None:
        vubs = {}
    if vlbs is None:
        vlbs = {}
    holder = vubs if isinstance(vubs, VBounds) else (
        vlbs if isinstance(vlbs, VBounds) else None)
    if holder is not None:
        flat = getattr(holder, "_flat", None)
        if flat is not None:
            return flat
    flat = flatten_vbounds(vubs, vlbs)
    if holder is not None:
        holder._flat = flat
    return flat


def mir_on_leq_native(cols, vals, rhs, x, lo, up, is_int, feastol,
                      vubs=None, vlbs=None, prefer_vbds=False
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          float, float]]:
    """Native `_mir_on_leq`.  Returns (cols, vals, rhs, efficacy) or
    None."""
    lib = get_lib()
    n_vb, indptr, vy, vc1, vc0, visub = _flat_for(vubs, vlbs)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    nnz = len(cols)
    cap = 3 * nnz + 16
    out_cols = np.empty(cap, np.int64)
    out_vals = np.empty(cap, np.float64)
    out_rhs = ctypes.c_double(0.0)
    out_eff = ctypes.c_double(0.0)
    if n_vb > 0:
        pp = indptr.ctypes.data_as(ctypes.c_void_p)
        py = vy.ctypes.data_as(ctypes.c_void_p)
        p1 = vc1.ctypes.data_as(ctypes.c_void_p)
        p0 = vc0.ctypes.data_as(ctypes.c_void_p)
        pi = visub.ctypes.data_as(ctypes.c_void_p)
    else:
        pp = py = p1 = p0 = pi = None
    while True:
        n_out = lib.hx_mir_on_leq(
            nnz, cols, vals, float(rhs), x, lo, up, is_int,
            float(feastol), int(prefer_vbds), n_vb, pp, py, p1, p0, pi,
            cap, out_cols, out_vals, ctypes.byref(out_rhs),
            ctypes.byref(out_eff))
        if n_out != -1:
            break
        cap *= 4
        out_cols = np.empty(cap, np.int64)
        out_vals = np.empty(cap, np.float64)
    if n_out <= 0:
        return None
    return (out_cols[:n_out].copy(), out_vals[:n_out].copy(),
            float(out_rhs.value), float(out_eff.value))


def mir_batch_native(trials, x, lo, up, is_int, feastol,
                     vubs=None, vlbs=None, prefer_vbds=False):
    """Batched `_mir_on_leq` over many (cols, vals, rhs) trials in ONE
    native call (hx_mir_batch).  Returns a list aligned with `trials`:
    (cols, vals, rhs, efficacy) or None per trial."""
    lib = get_lib()
    n_vb, indptr, vy, vc1, vc0, visub = _flat_for(vubs, vlbs)
    if n_vb > 0:
        pp = indptr.ctypes.data_as(ctypes.c_void_p)
        py = vy.ctypes.data_as(ctypes.c_void_p)
        p1 = vc1.ctypes.data_as(ctypes.c_void_p)
        p0 = vc0.ctypes.data_as(ctypes.c_void_p)
        pi = visub.ctypes.data_as(ctypes.c_void_p)
    else:
        pp = py = p1 = p0 = pi = None
    nr = len(trials)
    if nr == 0:
        return []
    lens = np.fromiter((len(t[0]) for t in trials), np.int64, nr)
    row_ptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.ascontiguousarray(
        np.concatenate([np.asarray(t[0], np.int64) for t in trials]))
    vals = np.ascontiguousarray(
        np.concatenate([np.asarray(t[1], np.float64)
                        for t in trials]))
    rhs = np.fromiter((t[2] for t in trials), np.float64, nr)
    cap = int(3 * lens.max() + 16)
    out_cols = np.empty(nr * cap, np.int64)
    out_vals = np.empty(nr * cap, np.float64)
    out_rhs = np.empty(nr, np.float64)
    out_eff = np.empty(nr, np.float64)
    n_out = np.empty(nr, np.int32)
    xx = np.ascontiguousarray(x, np.float64)
    ll = np.ascontiguousarray(lo, np.float64)
    uu = np.ascontiguousarray(up, np.float64)
    ii = np.ascontiguousarray(is_int, np.int8)
    lib.hx_mir_batch(
        nr, np.ascontiguousarray(row_ptr), cols, vals, rhs, xx, ll,
        uu, ii, float(feastol), int(prefer_vbds), n_vb, pp, py, p1,
        p0, pi, cap, out_cols, out_vals, out_rhs, out_eff, n_out)
    results = []
    for t in range(nr):
        k = int(n_out[t])
        if k == -1:
            # capacity overflow: retry singly with growth
            results.append(mir_on_leq_native(
                trials[t][0], trials[t][1], trials[t][2], xx, ll, uu,
                ii, feastol, vubs=vubs, vlbs=vlbs,
                prefer_vbds=prefer_vbds))
        elif k <= 0:
            results.append(None)
        else:
            base = t * cap
            results.append((out_cols[base:base + k].copy(),
                            out_vals[base:base + k].copy(),
                            float(out_rhs[t]), float(out_eff[t])))
    return results
