"""ctypes binding of the native sparse LDL' factorization
(native/hipm.cpp) — the Newton-system kernel of the sparse IPM path.

Role of the reference's HiPO FactorHiGHS supernodal LDL'
(highs/ipm/hipo/factorhighs/Analyse.cpp, Factorise.cpp) with its AMD
ordering extra: the normal matrix's PATTERN is constant across IPM
iterations, so `SparseLdl` analyzes once (minimum-degree ordering +
elimination tree + symbolic L) and refactors numerically per
iteration.

The library is the repository's `native/libhipm.so`, loaded as it is
and never rebuilt in place.  Where it is missing, or cannot be loaded
on this machine, `native/hipm.cpp` is compiled with g++ into
`highs_tpu_torch/_build/` (the file name carries a hash of the source).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np
import scipy.sparse as sp

REPO_DIR = pathlib.Path(__file__).resolve().parents[3]
NATIVE_LIB = REPO_DIR / "native" / "libhipm.so"
NATIVE_SRC = REPO_DIR / "native" / "hipm.cpp"
BUILD_DIR = REPO_DIR / "highs_tpu_torch" / "_build"

_LIB = None


def _built_lib() -> pathlib.Path:
    """Compile native/hipm.cpp into the build folder (once per source)."""
    digest = hashlib.sha256(NATIVE_SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libhipm-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        str(NATIVE_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(str(NATIVE_LIB))
    except OSError:  # missing, or built for another machine
        lib = ctypes.CDLL(str(_built_lib()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.hx_ldl_analyze.restype = ctypes.c_void_p
    lib.hx_ldl_analyze.argtypes = [ctypes.c_int, i64p, i32p]
    lib.hx_ldl_analyze_capped.restype = ctypes.c_void_p
    lib.hx_ldl_analyze_capped.argtypes = [ctypes.c_int, i64p, i32p,
                                          ctypes.c_int64,
                                          ctypes.c_int64]
    lib.hx_ldl_factor.restype = ctypes.c_int
    lib.hx_ldl_factor.argtypes = [ctypes.c_void_p, i64p, i32p, f64p,
                                  ctypes.c_double]
    lib.hx_ldl_factor_signed.restype = ctypes.c_int
    lib.hx_ldl_factor_signed.argtypes = [ctypes.c_void_p, i64p, i32p,
                                         f64p, ctypes.c_double, i8p]
    lib.hx_ldl_solve.restype = None
    lib.hx_ldl_solve.argtypes = [ctypes.c_void_p, f64p]
    lib.hx_ldl_lnnz.restype = ctypes.c_int64
    lib.hx_ldl_lnnz.argtypes = [ctypes.c_void_p]
    lib.hx_ldl_n_reg.restype = ctypes.c_int
    lib.hx_ldl_n_reg.argtypes = [ctypes.c_void_p]
    lib.hx_ldl_destroy.restype = None
    lib.hx_ldl_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class LdlBlowup(RuntimeError):
    """The symbolic analysis hit its work/fill budget: this pattern is
    fill-catastrophic for a direct factorization — use an iterative
    Newton solver instead."""


class SparseLdl:
    """Persistent LDL' of a symmetric positive (semi)definite matrix
    with a FIXED sparsity pattern and changing values.

    `max_work`/`max_fill` (0 = unlimited) bound the symbolic analysis;
    LdlBlowup is raised when the budget is exceeded."""

    def __init__(self, mat: sp.spmatrix, max_work: int = 0,
                 max_fill: int = 0):
        self._lib = get_lib()
        m = mat.tocsc()
        m.sum_duplicates()
        self.n = m.shape[0]
        self._ap = np.ascontiguousarray(m.indptr, dtype=np.int64)
        self._ai = np.ascontiguousarray(m.indices, dtype=np.int32)
        self._h = self._lib.hx_ldl_analyze_capped(
            self.n, self._ap, self._ai, int(max_work), int(max_fill))
        if not self._h:
            raise LdlBlowup(
                f"symbolic analysis exceeded budget on n={self.n}")
        self.lnnz = int(self._lib.hx_ldl_lnnz(self._h))
        self.factor(m)

    def matches(self, mat: sp.csc_matrix) -> bool:
        return (mat.shape[0] == self.n and
                len(mat.indices) == len(self._ai) and
                np.array_equal(mat.indptr, self._ap) and
                np.array_equal(mat.indices, self._ai))

    def _values(self, mat: sp.csc_matrix) -> np.ndarray:
        ax = np.ascontiguousarray(mat.data, dtype=np.float64)
        if ax.shape != self._ai.shape:
            raise ValueError(f"{ax.size} values for a pattern of "
                             f"{self._ai.size} entries")
        return ax

    def factor(self, mat: sp.csc_matrix, reg_floor: float = 1e-12
               ) -> int:
        """Numeric refactorization; returns # regularized pivots."""
        ax = self._values(mat)
        return int(self._lib.hx_ldl_factor(self._h, self._ap, self._ai,
                                           ax, reg_floor))

    def factor_signed(self, mat: sp.csc_matrix, signs: np.ndarray,
                      reg_floor: float = 1e-12) -> int:
        """Signed refactorization for QUASI-DEFINITE matrices
        (saddle KKT systems): `signs[i]` is the expected pivot sign of
        original index i (+1 Hessian block, -1 constraint block)."""
        ax = self._values(mat)
        sg = np.ascontiguousarray(signs, dtype=np.int8)
        if sg.shape != (self.n,):
            raise ValueError(f"signs of shape {sg.shape}, want ({self.n},)")
        return int(self._lib.hx_ldl_factor_signed(
            self._h, self._ap, self._ai, ax, reg_floor, sg))

    def solve(self, b: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(b, dtype=np.float64).copy()
        if x.shape != (self.n,):
            raise ValueError(f"rhs of shape {x.shape}, want ({self.n},)")
        self._lib.hx_ldl_solve(self._h, x)
        return x

    def close(self):
        if getattr(self, "_h", None):
            self._lib.hx_ldl_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - gc path
        try:
            self.close()
        except Exception:
            pass
