"""Activity-based domain propagation.

Vectorized re-implementation of the core rule of the reference's
HighsDomain (highs/mip/HighsDomain.cpp bound propagation over rows):
for each row  L <= a'x <= U  and each entry a_ij, the partial minimal /
maximal activity of the other variables implies

    x_j <= (U - minact_{-j}) / a_ij   (a_ij > 0)
    x_j >= (L - maxact_{-j}) / a_ij   (a_ij > 0)

(and mirrored for a_ij < 0).  Integer variables round the implied
bounds.  Passes repeat until fixpoint or `max_rounds`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


class Propagator:
    def __init__(self, a: sp.csr_matrix, row_lower: np.ndarray,
                 row_upper: np.ndarray, is_integer: np.ndarray,
                 feastol: float = 1e-6):
        self.a = a.tocsr()
        self.a_csc = a.tocsc()
        self.row_lower = row_lower
        self.row_upper = row_upper
        self.is_integer = is_integer.astype(bool)
        self.feastol = feastol
        ap = self.a.copy()
        ap.data = np.maximum(ap.data, 0.0)
        an = self.a.copy()
        an.data = np.minimum(an.data, 0.0)
        self.a_pos = ap
        self.a_neg = an
        # 0/1 patterns for counting infinite-bound contributions
        pp = self.a.copy()
        pp.data = (pp.data > 0).astype(np.float64)
        pn = self.a.copy()
        pn.data = (pn.data < 0).astype(np.float64)
        self.pat_pos = pp
        self.pat_neg = pn
        # bumped by the MIP solver when it rebuilds the propagator with
        # cut rows; nodes record the generation their box was
        # fixpointed against (incremental-seeding validity check)
        self.gen = 0
        # static COO view reused every round (the matrix never changes;
        # rebuilding it per propagate() round dominated MIP node time)
        coo = self.a.tocoo()
        self._coo_row = coo.row
        self._coo_col = coo.col
        self._coo_val = coo.data
        self._coo_pos = coo.data > 0
        # native worklist propagator (hx_propagate): the MIP node loop
        # calls propagate tens of thousands of times on small arrays
        # where numpy per-call overhead dominates — the native path is
        # ~50x faster there (reference analogue: HighsDomain is C++)
        self._native = None
        try:
            # ImportError until the MIP slice binds hx_propagate
            from ..simplex.native import get_lib, propagate_native
            get_lib()
            self._rp = np.ascontiguousarray(self.a.indptr,
                                            dtype=np.int64)
            self._ri = np.ascontiguousarray(self.a.indices,
                                            dtype=np.int32)
            self._rx = np.ascontiguousarray(self.a.data,
                                            dtype=np.float64)
            kb = 1e30
            self._rl_clip = np.clip(np.nan_to_num(
                self.row_lower, nan=-kb, posinf=kb, neginf=-kb),
                -kb, kb)
            self._ru_clip = np.clip(np.nan_to_num(
                self.row_upper, nan=kb, posinf=kb, neginf=-kb),
                -kb, kb)
            self._int8 = self.is_integer.astype(np.int8)
            self._native = propagate_native
        except Exception:
            self._native = None

    def propagate(self, lo: np.ndarray, up: np.ndarray,
                  max_rounds: int = 8, seed_cols=None
                  ) -> Tuple[bool, np.ndarray, np.ndarray]:
        """Tighten (lo, up).  Returns (feasible, lo, up).

        `seed_cols` optionally restricts the initial worklist to rows
        touching those columns (incremental propagation after a branch
        changes one variable's bounds)."""
        if self._native is not None:
            kb = 1e30
            lo_c = np.clip(np.nan_to_num(lo, nan=-kb, posinf=kb,
                                         neginf=-kb), -kb, kb)
            up_c = np.clip(np.nan_to_num(up, nan=kb, posinf=kb,
                                         neginf=-kb), -kb, kb)
            ok, lo_n, up_n = self._native(
                self._rp, self._ri, self._rx, self._rl_clip,
                self._ru_clip, self._int8, lo_c, up_c,
                feastol=self.feastol, max_rounds=max_rounds,
                seed_cols=seed_cols)
            lo_out = np.where(lo_n <= -kb, -np.inf, lo_n)
            up_out = np.where(up_n >= kb, np.inf, up_n)
            # preserve original infinities that never tightened
            lo_out = np.where(~np.isfinite(lo) & (lo_n == lo_c), lo,
                              lo_out)
            up_out = np.where(~np.isfinite(up) & (up_n == up_c), up,
                              up_out)
            return ok, lo_out, up_out
        lo = lo.copy()
        up = up.copy()
        m, n = self.a.shape
        if m == 0:
            return bool(np.all(lo <= up + self.feastol)), lo, up
        inf = np.inf
        for _ in range(max_rounds):
            if np.any(lo > up + self.feastol):
                return False, lo, up
            lo_c = np.where(np.isfinite(lo), lo, 0.0)
            up_c = np.where(np.isfinite(up), up, 0.0)
            # min activity: pos coeffs * lo + neg coeffs * up
            minact = self.a_pos @ lo_c + self.a_neg @ up_c
            maxact = self.a_pos @ up_c + self.a_neg @ lo_c
            # infinite contributions (counted via 0/1 patterns)
            n_min_inf = (self.pat_pos @ (~np.isfinite(lo)).astype(float) +
                         self.pat_neg @ (~np.isfinite(up)).astype(float))
            n_max_inf = (self.pat_pos @ (~np.isfinite(up)).astype(float) +
                         self.pat_neg @ (~np.isfinite(lo)).astype(float))
            # row infeasibility check
            min_ok = np.where(n_min_inf > 0, -inf, minact)
            max_ok = np.where(n_max_inf > 0, inf, maxact)
            if np.any(min_ok > self.row_upper + self.feastol *
                      (1 + np.abs(self.row_upper))):
                return False, lo, up
            if np.any(max_ok < self.row_lower - self.feastol *
                      (1 + np.abs(self.row_lower))):
                return False, lo, up

            changed = False
            r, c, v = self._coo_row, self._coo_col, self._coo_val
            lo_j = lo[c]
            up_j = up[c]
            lo_fin = np.isfinite(lo_j)
            up_fin = np.isfinite(up_j)
            pos = self._coo_pos
            # contribution of x_j to minact / maxact of its row
            contrib_min = np.where(pos, v * np.where(lo_fin, lo_j, 0.0),
                                   v * np.where(up_fin, up_j, 0.0))
            contrib_max = np.where(pos, v * np.where(up_fin, up_j, 0.0),
                                   v * np.where(lo_fin, lo_j, 0.0))
            j_min_inf = np.where(pos, ~lo_fin, ~up_fin)
            j_max_inf = np.where(pos, ~up_fin, ~lo_fin)
            other_min_inf = n_min_inf[r] - j_min_inf
            other_max_inf = n_max_inf[r] - j_max_inf
            minact_other = minact[r] - contrib_min
            maxact_other = maxact[r] - contrib_max

            ru = self.row_upper[r]
            rl = self.row_lower[r]
            with np.errstate(divide="ignore", invalid="ignore"):
                # upper bound candidates
                ub_cand = np.where(
                    pos & (other_min_inf == 0) & np.isfinite(ru),
                    (ru - minact_other) / v, inf)
                ub_cand2 = np.where(
                    ~pos & (other_max_inf == 0) & np.isfinite(rl),
                    (rl - maxact_other) / v, inf)
                lb_cand = np.where(
                    pos & (other_max_inf == 0) & np.isfinite(rl),
                    (rl - maxact_other) / v, -inf)
                lb_cand2 = np.where(
                    ~pos & (other_min_inf == 0) & np.isfinite(ru),
                    (ru - minact_other) / v, -inf)
            ub_all = np.minimum(ub_cand, ub_cand2)
            lb_all = np.maximum(lb_cand, lb_cand2)

            new_up = up.copy()
            np.minimum.at(new_up, c, ub_all + self.feastol)
            new_lo = lo.copy()
            np.maximum.at(new_lo, c, lb_all - self.feastol)
            # only accept meaningful tightenings
            with np.errstate(invalid="ignore"):
                tighten_up = new_up < up - 1e-9 * (
                    1 + np.abs(np.where(np.isfinite(up), up, 0.0)))
                tighten_lo = new_lo > lo + 1e-9 * (
                    1 + np.abs(np.where(np.isfinite(lo), lo, 0.0)))
            if self.is_integer.any():
                new_up_i = np.floor(new_up + self.feastol)
                new_lo_i = np.ceil(new_lo - self.feastol)
                new_up = np.where(self.is_integer & np.isfinite(new_up),
                                  new_up_i, new_up)
                new_lo = np.where(self.is_integer & np.isfinite(new_lo),
                                  new_lo_i, new_lo)
                tighten_up |= self.is_integer & (new_up < up - 0.5)
                tighten_lo |= self.is_integer & (new_lo > lo + 0.5)
            if np.any(tighten_up):
                up = np.where(tighten_up, new_up, up)
                changed = True
            if np.any(tighten_lo):
                lo = np.where(tighten_lo, new_lo, lo)
                changed = True
            if not changed:
                break
        return bool(np.all(lo <= up + self.feastol)), lo, up


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
