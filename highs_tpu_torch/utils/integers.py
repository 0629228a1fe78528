"""Integer/rational utilities.

Equivalent of the reference HighsIntegers (highs/util/HighsIntegers.h):
gcd helpers and rational rounding used for integral scaling of cuts and
objectives (cut coefficients scaled to small integers improve both
numerics and the strength of integral-rounding arguments)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def gcd(a: int, b: int) -> int:
    return math.gcd(int(a), int(b))


def nearest_rational(x: float, max_denom: int = 1024
                     ) -> Tuple[int, int]:
    """Best rational approximation p/q with q <= max_denom (continued
    fractions; reference HighsIntegers::nearestInteger/denominator
    machinery)."""
    from fractions import Fraction
    f = Fraction(x).limit_denominator(max_denom)
    return f.numerator, f.denominator


def _cf_denominators(x: np.ndarray, max_denom: int) -> np.ndarray:
    """Vectorized continued-fraction denominators: for each |x| the
    denominator of its best rational approximation with q <= max_denom
    (semiconvergent differences vs Fraction.limit_denominator are
    harmless — integral_scale verifies the final scale either way)."""
    a = np.floor(x)
    num_prev = np.ones_like(x)
    num = a.copy()
    den_prev = np.zeros_like(x)
    den = np.ones_like(x)
    frac = x - a
    active = frac > 1e-12
    for _ in range(40):
        if not active.any():
            break
        inv = np.where(active & (frac > 0), 1.0 / np.where(
            frac <= 0, 1.0, frac), 0.0)
        a = np.floor(inv)
        new_num = a * num + num_prev
        new_den = a * den + den_prev
        over = new_den > max_denom
        upd = active & ~over
        active = upd
        num_prev = np.where(upd, num, num_prev)
        num = np.where(upd, new_num, num)
        den_prev = np.where(upd, den, den_prev)
        den = np.where(upd, new_den, den)
        frac = np.where(upd, inv - a, frac)
        active = active & (np.abs(x - num / den) >
                           1e-12 * np.maximum(1.0, x))
    return den


def integral_scale(values: np.ndarray, deltadown: float = 1e-9,
                   deltaup: float = 1e-9, max_denom: int = 1024,
                   max_scale: float = 1e6) -> Optional[float]:
    """Smallest positive scale s such that s*values are all within
    [deltadown, deltaup] of integers, or None: the native
    hx_integral_scale (the numpy version `_integral_scale_py` pays
    ~0.2ms of small-array op overhead per call, and cut-heavy MIP roots
    call this tens of thousands of times)."""
    import ctypes
    from ..solvers.mip import native_cuts
    vals = np.ascontiguousarray(values, dtype=np.float64)
    s = native_cuts.get_lib().hx_integral_scale(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(vals), deltadown, deltaup, max_denom, max_scale)
    return float(s) if s > 0.0 else None


def _integral_scale_py(values: np.ndarray, deltadown: float = 1e-9,
                       deltaup: float = 1e-9, max_denom: int = 1024,
                       max_scale: float = 1e6) -> Optional[float]:
    """Smallest positive scale s such that s*values are all within
    [deltadown, deltaup] of integers (reference
    HighsIntegers::integralScale).  Returns None if no such scale with
    denominator bounds exists.  Fully vectorized (this runs once per
    generated cut; the fractions-based version was ~10% of total MIP
    wall-clock on cut-heavy instances)."""
    vals = np.asarray(values, dtype=np.float64)
    vals = vals[vals != 0.0]
    if len(vals) == 0:
        return None
    tol = np.maximum(deltadown, deltaup)
    absv = np.abs(vals)
    # fast path: already integral
    r0 = np.round(absv)
    if np.all(np.abs(absv - r0) <= tol * np.maximum(1.0, r0)):
        denom = 1
    else:
        dens = _cf_denominators(absv, max_denom)
        denom = 1
        for q in np.unique(dens.astype(np.int64)):
            denom = denom * int(q) // math.gcd(denom, int(q))
            if denom > max_scale:
                return None
    scaled = vals * denom
    rounded = np.round(scaled)
    if np.any(np.abs(scaled - rounded) > tol *
              np.maximum(1.0, np.abs(rounded))):
        return None
    # reduce by the gcd of the integer values
    ints = np.abs(rounded).astype(np.int64)
    ints = ints[ints > 0]
    if len(ints) == 0:
        return None
    g = int(np.gcd.reduce(ints))
    if g == 0:
        return None
    return float(denom) / float(g)
