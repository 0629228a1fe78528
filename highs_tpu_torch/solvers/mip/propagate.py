"""Activity-based domain propagation.

Vectorized re-implementation of the core rule of the reference's
HighsDomain (highs/mip/HighsDomain.cpp bound propagation over rows):
for each row  L <= a'x <= U  and each entry a_ij, the partial minimal /
maximal activity of the other variables implies

    x_j <= (U - minact_{-j}) / a_ij   (a_ij > 0)
    x_j >= (L - maxact_{-j}) / a_ij   (a_ij > 0)

(and mirrored for a_ij < 0).  Integer variables round the implied
bounds.  Passes repeat until fixpoint or `max_rounds`.  The rule runs
in the native worklist propagator; `strengthen_coefficients` is numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..simplex import native as _nat


class Propagator:
    """Activity propagation over the rows of `a` by the native worklist
    propagator (hx_propagate, native/hsimplex.cpp): the MIP node loop
    calls it tens of thousands of times on small arrays, where it is
    ~50x faster than vectorized numpy (reference analogue: HighsDomain
    is C++).  A library that will not load or bind raises."""

    def __init__(self, a: sp.csr_matrix, row_lower: np.ndarray,
                 row_upper: np.ndarray, is_integer: np.ndarray,
                 feastol: float = 1e-6):
        self.a = a.tocsr()
        self.row_lower = row_lower
        self.row_upper = row_upper
        self.is_integer = is_integer.astype(bool)
        self.feastol = feastol
        # bumped by the MIP solver when it rebuilds the propagator with
        # cut rows; nodes record the generation their box was
        # fixpointed against (incremental-seeding validity check)
        self.gen = 0
        _nat.get_lib()
        self._rp = np.ascontiguousarray(self.a.indptr, dtype=np.int64)
        self._ri = np.ascontiguousarray(self.a.indices, dtype=np.int32)
        self._rx = np.ascontiguousarray(self.a.data, dtype=np.float64)
        kb = 1e30
        self._rl_clip = np.clip(np.nan_to_num(
            self.row_lower, nan=-kb, posinf=kb, neginf=-kb), -kb, kb)
        self._ru_clip = np.clip(np.nan_to_num(
            self.row_upper, nan=kb, posinf=kb, neginf=-kb), -kb, kb)
        self._int8 = self.is_integer.astype(np.int8)

    def propagate(self, lo: np.ndarray, up: np.ndarray,
                  max_rounds: int = 8, seed_cols=None
                  ) -> Tuple[bool, np.ndarray, np.ndarray]:
        """Tighten (lo, up).  Returns (feasible, lo, up).

        `seed_cols` optionally restricts the initial worklist to rows
        touching those columns (incremental propagation after a branch
        changes one variable's bounds)."""
        kb = 1e30
        lo_c = np.clip(np.nan_to_num(lo, nan=-kb, posinf=kb, neginf=-kb),
                       -kb, kb)
        up_c = np.clip(np.nan_to_num(up, nan=kb, posinf=kb, neginf=-kb),
                       -kb, kb)
        ok, lo_n, up_n = _nat.propagate_native(
            self._rp, self._ri, self._rx, self._rl_clip, self._ru_clip,
            self._int8, lo_c, up_c, feastol=self.feastol,
            max_rounds=max_rounds, seed_cols=seed_cols)
        lo_out = np.where(lo_n <= -kb, -np.inf, lo_n)
        up_out = np.where(up_n >= kb, np.inf, up_n)
        # preserve original infinities that never tightened
        lo_out = np.where(~np.isfinite(lo) & (lo_n == lo_c), lo, lo_out)
        up_out = np.where(~np.isfinite(up) & (up_n == up_c), up, up_out)
        return ok, lo_out, up_out


def strengthen_coefficients(a_csr: sp.csr_matrix, row_lower: np.ndarray,
                            row_upper: np.ndarray, lo: np.ndarray,
                            up: np.ndarray, is_int: np.ndarray,
                            feastol: float = 1e-6
                            ) -> Tuple[sp.csr_matrix, np.ndarray,
                                       np.ndarray, int]:
    """Coefficient strengthening on one-sided rows (reference: HPresolve
    coefficient tightening; classic big-M reduction).

    For a row sum_i a_i x_i <= b and an integer variable j whose
    coefficient makes the row redundant once x_j moves one step off its
    binding bound, the coefficient (and rhs) shrink to the point where
    that step makes the row exactly implied by the bounds of the other
    variables.  Fixed-charge structures x - M y <= 0 with M larger than
    x's own upper bound u become x - u y <= 0, which tightens the LP
    relaxation dramatically.  Valid for every integer-feasible point;
    use only on the MIP relaxation (the LP dual of the original rows is
    not preserved).

    Returns (a_csr', row_lower', row_upper', n_changed).
    """
    m, n = a_csr.shape
    a = a_csr.copy()
    rl = np.asarray(row_lower, dtype=np.float64).copy()
    ru = np.asarray(row_upper, dtype=np.float64).copy()
    lo = np.asarray(lo, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    indptr, indices, data = a.indptr, a.indices, a.data
    n_changed = 0
    has_rl = np.isfinite(rl)
    has_ru = np.isfinite(ru)
    one_sided = has_rl ^ has_ru
    span = up - lo
    for i in np.nonzero(one_sided)[0]:
        k0, k1 = indptr[i], indptr[i + 1]
        cols = indices[k0:k1]
        vals = data[k0:k1]
        if not np.any(is_int[cols]):
            continue
        # normalize to <= form: flip >= rows
        flip = has_rl[i]
        b = -rl[i] if flip else ru[i]
        v = -vals if flip else vals.copy()
        # max activity contributions; all must be finite
        contrib = np.where(v > 0, v * up[cols], v * lo[cols])
        if not np.all(np.isfinite(contrib)):
            continue
        maxact = float(contrib.sum())
        changed_row = False
        for k in range(len(cols)):
            j = cols[k]
            if not is_int[j] or span[j] < 1.0 - feastol:
                continue
            vj = v[k]
            rmax = maxact - contrib[k]
            if vj < 0:
                # binding at l_j; redundant for x_j >= l_j + 1 when
                # rmax + vj*(l_j+1) <= b  <=>  a_new > vj
                a_new = b - vj * lo[j] - rmax
                if a_new > vj + 1e-9 * (1.0 + abs(vj)) and \
                        a_new < -feastol:
                    b = b + (a_new - vj) * lo[j]
                    v[k] = a_new
                    contrib[k] = a_new * lo[j]
                    maxact = rmax + contrib[k]
                    changed_row = True
                    n_changed += 1
            elif vj > 0:
                # binding at u_j; redundant for x_j <= u_j - 1
                a_new = rmax - b + vj * up[j]
                if a_new < vj - 1e-9 * (1.0 + abs(vj)) and \
                        a_new > feastol:
                    b = b + (a_new - vj) * up[j]
                    v[k] = a_new
                    contrib[k] = a_new * up[j]
                    maxact = rmax + contrib[k]
                    changed_row = True
                    n_changed += 1
        if changed_row:
            if flip:
                data[k0:k1] = -v
                rl[i] = -b
            else:
                data[k0:k1] = v
                ru[i] = b
    return a, rl, ru, n_changed
