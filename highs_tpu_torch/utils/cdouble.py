"""Compensated (double-double) arithmetic.

Equivalent of the reference HighsCDouble (highs/util/HighsCDouble.h:22):
~quad-precision value represented as an unevaluated sum hi + lo of two
doubles, used where exactness matters (cut generation, postsolve).
Implemented with error-free transformations (two-sum / two-prod via
FMA-free Dekker splitting), plus vectorized compensated dot/sum helpers
for the cut generators.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

_SPLITTER = 134217729.0  # 2^27 + 1


def _two_sum(a: float, b: float):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _two_prod(a: float, b: float):
    p = a * b
    # Dekker split
    ca = _SPLITTER * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = _SPLITTER * b
    bhi = cb - (cb - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


@dataclasses.dataclass(frozen=True)
class CDouble:
    hi: float = 0.0
    lo: float = 0.0

    @staticmethod
    def from_float(v: float) -> "CDouble":
        return CDouble(float(v), 0.0)

    def __add__(self, other):
        if isinstance(other, CDouble):
            s, e = _two_sum(self.hi, other.hi)
            e += self.lo + other.lo
            hi, lo = _two_sum(s, e)
            return CDouble(hi, lo)
        s, e = _two_sum(self.hi, float(other))
        e += self.lo
        hi, lo = _two_sum(s, e)
        return CDouble(hi, lo)

    __radd__ = __add__

    def __neg__(self):
        return CDouble(-self.hi, -self.lo)

    def __sub__(self, other):
        return self + (-other if isinstance(other, CDouble)
                       else -float(other))

    def __rsub__(self, other):
        return (-self) + float(other)

    def __mul__(self, other):
        if isinstance(other, CDouble):
            p, e = _two_prod(self.hi, other.hi)
            e += self.hi * other.lo + self.lo * other.hi
            hi, lo = _two_sum(p, e)
            return CDouble(hi, lo)
        o = float(other)
        p, e = _two_prod(self.hi, o)
        e += self.lo * o
        hi, lo = _two_sum(p, e)
        return CDouble(hi, lo)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = other.hi + other.lo if isinstance(other, CDouble) \
            else float(other)
        q1 = (self.hi + self.lo) / o
        # one Newton correction in compensated arithmetic
        r = self - CDouble.from_float(q1) * o
        q2 = (r.hi + r.lo) / o
        hi, lo = _two_sum(q1, q2)
        return CDouble(hi, lo)

    def __float__(self):
        return self.hi + self.lo

    def __repr__(self):
        return f"CDouble({self.hi!r} + {self.lo!r})"

    def __lt__(self, other):
        return float(self) < float(other)

    def __le__(self, other):
        return float(self) <= float(other)

    def floor(self) -> "CDouble":
        f = math.floor(self.hi)
        rem = (self - f)
        if float(rem) < 0:
            f -= 1.0
        elif float(rem) >= 1.0:
            f += 1.0
        return CDouble(f, 0.0)


def comp_sum(values: np.ndarray) -> float:
    """Neumaier compensated sum (vector helper)."""
    s = 0.0
    c = 0.0
    for v in np.asarray(values, dtype=np.float64):
        t = s + v
        if abs(s) >= abs(v):
            c += (s - t) + v
        else:
            c += (v - t) + s
        s = t
    return s + c


def comp_dot(a: np.ndarray, b: np.ndarray) -> float:
    """Compensated dot product via two-prod + Neumaier accumulation."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    s = 0.0
    c = 0.0
    for x, y in zip(a, b):
        p, e = _two_prod(float(x), float(y))
        t = s + p
        if abs(s) >= abs(p):
            c += (s - t) + p
        else:
            c += (p - t) + s
        s = t
        c += e
    return s + c
