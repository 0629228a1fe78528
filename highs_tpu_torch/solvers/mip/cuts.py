"""Cutting planes for the MIP solver.

Re-implementation (TPU-build idiom: vectorized numpy separation on the
host, like every other irregular-control-flow MIP component; the LP
re-solves that consume the cuts run on-device / in the native node
engine) of the reference cut layer:

- ``CutPool``: age/parallelism-filtered storage of globally valid cuts
  (reference: highs/mip/HighsCutPool.cpp — aging, orthogonality
  filtering, soft limit).
- Gomory mixed-integer cuts from an optimal simplex tableau row
  (reference: highs/mip/HighsTableauSeparator.cpp driving
  HighsCutGeneration).
- Complemented mixed-integer rounding (c-MIR) cuts on single rows with
  bound substitution and delta search (reference:
  highs/mip/HighsCutGeneration.cpp `cmirCutGenerationHeuristic`).
- Clique cuts from a set-packing clique table extracted from the rows
  (reference: highs/mip/HighsCliqueTable.cpp extraction +
  `separationRound` clique separation in HighsSeparation.cpp:43-160).

All cuts are returned in structural space as  a'x <= rhs  and are
globally valid (derived from original rows + integrality only), so they
can extend the node relaxation for the entire tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

_EPS = 1e-12
_MAX_DYNAMISM = 1e5
_MIN_VIOL = 1e-7
_MIN_EFFICACY = 1e-6


@dataclasses.dataclass
class Cut:
    cols: np.ndarray          # int32 indices
    vals: np.ndarray          # float64 coefficients
    rhs: float                # a'x <= rhs
    efficacy: float = 0.0     # violation / ||a||
    age: int = 0
    _key: Optional[tuple] = None

    def key(self) -> tuple:
        # dedupe key: support + normalized coefficients (rounded);
        # cached — the root loop asks for it many times per cut
        if self._key is not None:
            return self._key
        nrm = np.linalg.norm(self.vals)
        if nrm <= 0:
            self._key = (tuple(self.cols),)
        else:
            q = np.round(self.vals / nrm, 9)
            self._key = (tuple(self.cols.tolist()), tuple(q.tolist()),
                         round(self.rhs / nrm, 9))
        return self._key


class CutPool:
    """Globally valid cut storage with aging and parallelism filtering
    (reference HighsCutPool: age limit `mip_pool_age_limit`, soft size
    limit `mip_pool_soft_limit`, pairwise-parallelism rejection)."""

    def __init__(self, num_col: int, age_limit: int = 30,
                 soft_limit: int = 10000):
        self.num_col = num_col
        self.age_limit = age_limit
        self.soft_limit = soft_limit
        self.cuts: List[Cut] = []
        self._keys = set()

    def add(self, cut: Cut) -> bool:
        k = cut.key()
        if k in self._keys:
            return False
        self._keys.add(k)
        self.cuts.append(cut)
        return True

    def age_and_evict(self, active_mask: Optional[np.ndarray] = None):
        # eviction can shrink-then-regrow to the same length: drop the
        # cached pool matrix outright
        self._mat_cache = None
        keep = []
        for i, c in enumerate(self.cuts):
            active = bool(active_mask[i]) if active_mask is not None and \
                i < len(active_mask) else False
            c.age = 0 if active else c.age + 1
            if c.age <= self.age_limit:
                keep.append(c)
            else:
                self._keys.discard(c.key())
        self.cuts = keep
        if len(self.cuts) > self.soft_limit:
            self.cuts.sort(key=lambda c: (-c.efficacy, c.age))
            for c in self.cuts[self.soft_limit:]:
                self._keys.discard(c.key())
            self.cuts = self.cuts[:self.soft_limit]

    def violated(self, x: np.ndarray, tol: float = _MIN_VIOL,
                 max_cuts: int = 200,
                 min_orthogonality: float = 0.5) -> List[Cut]:
        """Violated pool cuts, filtered so selected cuts are pairwise
        not-too-parallel (reference cut selection in
        HighsCutPool::separate)."""
        if not self.cuts:
            return []
        # vectorized scoring: one sparse matvec over the whole pool
        # (the per-cut python loop was ~0.2s per call on a 2k-cut
        # pool); the assembled matrix is cached until the pool changes
        cache = getattr(self, "_mat_cache", None)
        if cache is not None and cache[0] == len(self.cuts):
            amat, rhs = cache[1], cache[2]
        else:
            amat, rhs = self.matrix(self.cuts)
            self._mat_cache = (len(self.cuts), amat, rhs)
        act = amat @ x
        nrm = np.sqrt(np.asarray(amat.multiply(amat).sum(axis=1)
                                 ).ravel())
        with np.errstate(invalid="ignore", divide="ignore"):
            eff = np.where(nrm > 0, (act - rhs) / np.maximum(nrm, _EPS),
                           -np.inf)
        idx = np.nonzero(eff > tol)[0]
        if idx.size == 0:
            return []
        for i in idx:
            self.cuts[i].efficacy = float(eff[i])
        order = idx[np.argsort(-eff[idx], kind="stable")]
        # cap the orthogonality scan: past ~3x the pick budget the
        # remaining candidates are low-efficacy near-duplicates and
        # each costs a sparse row slice
        order = order[:max_cuts * 3]
        # orthogonality filter against already-picked cuts.  Work on
        # the raw CSR arrays: a candidate row has ~10-30 nonzeros, so
        # its dot products against ALL picked rows are one fancy-index
        # slice of the dense picked block — no sparse row slicing
        # (23k+ scipy __getitem__ calls per root loop before).
        indptr, indices, data = amat.indptr, amat.indices, amat.data
        inv_nrm = 1.0 / np.maximum(nrm, _EPS)
        picked: List[Cut] = []
        picked_dense = np.zeros((max_cuts, self.num_col))
        npick = 0
        thresh = 1.0 - min_orthogonality + 0.5
        for i in order:
            if npick >= max_cuts:
                break
            i = int(i)
            lo, hi = indptr[i], indptr[i + 1]
            ci = indices[lo:hi]
            vi = data[lo:hi] * inv_nrm[i]
            if npick and np.any(np.abs(
                    picked_dense[:npick, ci] @ vi) > thresh):
                continue
            picked.append(self.cuts[i])
            picked_dense[npick, ci] = vi
            npick += 1
        return picked

    def matrix(self, cuts: Sequence[Cut]) -> Tuple[sp.csr_matrix,
                                                   np.ndarray]:
        if not cuts:
            return (sp.csr_matrix((0, self.num_col)), np.zeros(0))
        lens = np.fromiter((len(c.cols) for c in cuts), dtype=np.int64,
                           count=len(cuts))
        indptr = np.concatenate([[0], np.cumsum(lens)])
        cols = np.concatenate([c.cols for c in cuts])
        vals = np.concatenate([c.vals for c in cuts])
        rhs = np.fromiter((c.rhs for c in cuts), dtype=np.float64,
                          count=len(cuts))
        a = sp.csr_matrix((vals, cols, indptr),
                          shape=(len(cuts), self.num_col))
        return a, rhs


def _finite(v, default=0.0):
    return np.where(np.isfinite(v), v, default)


def _clean_cut(cols: np.ndarray, vals: np.ndarray, rhs: float,
               lo: np.ndarray, up: np.ndarray) -> Optional[Tuple]:
    """Numerical hygiene shared by all separators (reference:
    HighsCutGeneration::postprocessCut): drop tiny coefficients by
    moving them to the rhs via the best bound; reject cuts with huge
    dynamism or where a tiny coefficient has an infinite bound."""
    keep = np.abs(vals) > _EPS
    cols, vals = cols[keep], vals[keep]
    if cols.size == 0:
        return None
    amax = float(np.max(np.abs(vals)))
    small = np.abs(vals) < 1e-9 * max(1.0, amax)
    if small.any():
        for i in np.nonzero(small)[0]:
            a = vals[i]
            j = cols[i]
            # relax the <= cut: sum' <= rhs - a*x_j <= rhs - a*l_j for
            # a > 0 (rhs - a*u_j for a < 0) — the worst-case bound side
            b = lo[j] if a > 0 else up[j]
            if not np.isfinite(b):
                return None
            rhs -= a * b
        cols, vals = cols[~small], vals[~small]
        if cols.size == 0:
            return None
        amax = float(np.max(np.abs(vals)))
    amin = float(np.min(np.abs(vals)))
    if amax / max(amin, _EPS) > _MAX_DYNAMISM:
        return None
    if not np.isfinite(rhs) or abs(rhs) > 1e15:
        return None
    # integral scaling when a small rational scale makes every
    # coefficient integer (reference HighsIntegers::integralScale via
    # HighsCutGeneration) — integer cuts are numerically sturdier;
    # otherwise normalize to unit max coefficient
    from ...utils.integers import integral_scale
    s = integral_scale(vals)
    if s is not None and s * amax <= 1e4:
        vals = np.round(vals * s)
        rhs = rhs * s
    else:
        vals = vals / amax
        rhs = rhs / amax
    return cols, vals, float(rhs)


# --------------------------------------------------------------------------
# Gomory mixed-integer cuts from the simplex tableau
# --------------------------------------------------------------------------

def separate_gomory(a_csc: sp.csc_matrix, lo: np.ndarray, up: np.ndarray,
                    row_lower: np.ndarray, row_upper: np.ndarray,
                    basis: np.ndarray, x: np.ndarray,
                    is_int: np.ndarray, feastol: float = 1e-6,
                    max_cuts: int = 24) -> List[Cut]:
    """GMI cuts for fractional basic integer variables.

    Works in the bounded standard form  W [x; s] = 0,  W = [A, -I],
    l <= x <= u, L <= s <= U (the native engine's space, so the basis
    statuses returned by `simplex_solve` apply verbatim).  Tableau rows
    come from a fresh sparse LU of the basis (host-side scipy, mirroring
    the reference's CPU HFactor btran + PRICE in
    HighsTableauSeparator.cpp).
    """
    m, n = a_csc.shape
    nv = n + m
    if m == 0:
        return []
    kLower, kBasic, kUpper, kZero = 0, 1, 2, 3
    basic = np.nonzero(basis == kBasic)[0]
    if basic.size != m:
        return []
    s = a_csc @ x  # logical values
    v_all = np.concatenate([x, s])
    lo_all = np.concatenate([lo, row_lower])
    up_all = np.concatenate([up, row_upper])

    # B columns: structural j -> A[:, j]; logical n+i -> -e_i
    w_full = sp.hstack([a_csc, -sp.identity(m, format="csc")]).tocsc()
    B = w_full[:, basic]
    try:
        lu = sp.linalg.splu(B.tocsc())
    except RuntimeError:
        return []

    # candidate rows: basic structural integers with fractional value
    frac_v = np.abs(v_all[basic] - np.round(v_all[basic]))
    cand_positions = [
        p for p in np.argsort(-frac_v)
        if basic[p] < n and is_int[basic[p]] and
        frac_v[p] > 10 * feastol and frac_v[p] < 1.0 - 10 * feastol]
    cand_positions = cand_positions[:max_cuts]
    if not cand_positions:
        return []

    nonbasic = np.nonzero(basis != kBasic)[0]
    w_nb = w_full[:, nonbasic].tocsc()
    a_csr = a_csc.tocsr()
    # vectorized per-nonbasic attributes (hoisted out of the cut loop)
    nb_at_lower = (basis[nonbasic] == kLower) | (basis[nonbasic] == kZero)
    nb_bound = np.where(nb_at_lower, lo_all[nonbasic], up_all[nonbasic])
    nb_bound_finite = np.isfinite(nb_bound)
    nb_int = (nonbasic < n) & is_int[np.minimum(nonbasic, n - 1)] & \
        (nonbasic < n) & nb_bound_finite
    cuts: List[Cut] = []
    for p in cand_positions:
        e = np.zeros(m)
        e[p] = 1.0
        rbt = lu.solve(e, trans="T")          # e_p' B^{-1}
        trow = np.asarray(rbt @ w_nb).ravel()  # tableau row, nonbasics
        bbar = float(v_all[basic[p]])
        f0 = bbar - math.floor(bbar)
        if f0 < 10 * feastol or f0 > 1 - 10 * feastol:
            continue
        # GMI in shifted nonbasic space — vectorized over nonbasics
        nzm = np.abs(trow) >= _EPS
        tt = np.where(nb_at_lower, trow, -trow)
        fj = tt - np.floor(tt)
        g_int = np.where(fj <= f0 + 1e-12, fj,
                         f0 * (1.0 - fj) / (1.0 - f0))
        g_cont = np.where(tt >= 0, tt, f0 * (-tt) / (1.0 - f0))
        g = np.where(nb_int, g_int, g_cont)
        g[~nzm] = 0.0
        live = g != 0.0
        # an infinite bound with a non-negligible coefficient kills
        # the cut; tiny coefficients on free variables are dropped
        bad = live & ~nb_bound_finite
        if np.any(bad & (np.abs(g) >= 1e-11)):
            continue
        live &= nb_bound_finite
        alpha = np.zeros(nv)   # cut coefficients on original vars
        sgn = np.where(nb_at_lower, 1.0, -1.0)
        alpha[nonbasic[live]] = sgn[live] * g[live]
        beta = float(f0 + np.sum(sgn[live] * g[live] * nb_bound[live]))
        # substitute logicals s_i = (A x)_i — one sparse vec-mat product
        logi = np.nonzero(np.abs(alpha[n:]) > _EPS)[0]
        coef = alpha[:n].copy()
        if logi.size:
            coef += np.asarray(alpha[n:][logi] @ a_csr[logi]).ravel()
        # cut: coef' x >= beta  ->  -coef' x <= -beta
        mask = np.abs(coef) > _EPS
        res = _clean_cut(np.nonzero(mask)[0].astype(np.int32),
                         -coef[mask], -beta, lo, up)
        if res is None:
            continue
        ccols, cvals, crhs = res
        viol = float(x[ccols] @ cvals) - crhs
        nrm = float(np.linalg.norm(cvals))
        if nrm > 0 and viol / nrm > _MIN_EFFICACY:
            cuts.append(Cut(ccols, cvals, crhs, viol / nrm))
    return cuts


# --------------------------------------------------------------------------
# c-MIR cuts on single rows
# --------------------------------------------------------------------------

def collect_variable_bounds(a_csr: sp.csr_matrix, row_lower: np.ndarray,
                            row_upper: np.ndarray, is_int: np.ndarray,
                            max_per_col: int = 4):
    """Variable upper/lower bounds  x_j <= c0 + c1*y  /  x_j >= c0 + c1*y
    (y integer) harvested from two-nonzero rows (reference:
    HighsImplications::VarBound used by HighsTransformedLp).  Returns
    (vubs, vlbs): dicts col -> list of (ycol, c1, c0)."""
    from .native_cuts import VBounds
    # memoized per matrix object (separators in one round share the
    # same relaxation matrix; the per-row scan was ~0.5s/solve)
    ck = (id(a_csr), a_csr.shape, int(a_csr.nnz),
          id(row_lower), id(row_upper))
    cache = getattr(collect_variable_bounds, "_cache", None)
    if cache is not None and cache[0] == ck:
        return cache[1], cache[2]
    vubs: dict = VBounds()
    vlbs: dict = VBounds()
    m = a_csr.shape[0]
    indptr, indices, data = a_csr.indptr, a_csr.indices, a_csr.data
    two = np.nonzero(np.diff(indptr) == 2)[0]
    for i in two:
        k0, k1 = indptr[i], indptr[i + 1]
        c0_, c1_ = indices[k0], indices[k0 + 1]
        v0, v1 = data[k0], data[k0 + 1]
        # want one continuous x and one integer y
        if is_int[c0_] == is_int[c1_]:
            continue
        if is_int[c0_]:
            ycol, ay, xcol, ax = c0_, v0, c1_, v1
        else:
            ycol, ay, xcol, ax = c1_, v1, c0_, v0
        if abs(ax) <= _EPS or abs(ay) <= _EPS:
            continue
        for b, sgn in ((row_upper[i], 1.0), (row_lower[i], -1.0)):
            if not np.isfinite(b):
                continue
            # sgn*(ax*x + ay*y) <= sgn*b
            axs, ays, bs = sgn * ax, sgn * ay, sgn * b
            if axs > 0:
                # x <= bs/axs - (ays/axs) y  : VUB
                lst = vubs.setdefault(int(xcol), [])
            else:
                # x >= bs/axs - (ays/axs) y  : VLB
                lst = vlbs.setdefault(int(xcol), [])
            if len(lst) < max_per_col:
                lst.append((int(ycol), -ays / axs, bs / axs))
    # pin the keyed objects so their ids cannot be recycled
    collect_variable_bounds._cache = (ck, vubs, vlbs, a_csr,
                                      row_lower, row_upper)
    return vubs, vlbs


def _mir_on_leq_py(cols: np.ndarray, vals: np.ndarray, rhs: float,
                   x: np.ndarray, lo: np.ndarray, up: np.ndarray,
                   is_int: np.ndarray, feastol: float,
                   vubs=None, vlbs=None, prefer_vbds: bool = False
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, float,
                                       float]]:
    """Best c-MIR cut for one  a'x <= b  row.  Returns
    (cols, vals, rhs, efficacy) or None.

    Bound substitution (reference HighsTransformedLp): integer
    variables complement to the finite simple bound closest to x*;
    continuous variables choose among simple bounds and variable bounds
    x <= c0 + c1*y / x >= c0 + c1*y (y integer) by smallest slack at
    x*.  Variable-bound substitution moves continuous mass onto integer
    y coefficients, which is what gives c-MIR flow-cover strength on
    fixed-charge rows.  Then MIR with delta from the fractional-support
    candidate set."""
    ints_mask = is_int[cols]
    # ---- continuous substitution: s = sigma*(x_j - b0 - b1*y) >= 0 ----
    # accumulated integer x-space coefficients (original + vbound mass)
    int_coef: dict = {}
    for c, v in zip(cols[ints_mask], vals[ints_mask]):
        int_coef[int(c)] = int_coef.get(int(c), 0.0) + float(v)
    bh0 = float(rhs)
    slack_defs = []   # (xcol, sigma, b0, b1, ycol, coef_on_s, s_star)
    for c, v in zip(cols[~ints_mask], vals[~ints_mask]):
        j = int(c)
        xj = float(x[j])
        cands = []
        if np.isfinite(lo[j]):
            cands.append((xj - float(lo[j]), 1.0, float(lo[j]), 0.0, -1))
        if np.isfinite(up[j]):
            cands.append((float(up[j]) - xj, -1.0, float(up[j]), 0.0,
                          -1))
        if vlbs is not None:
            for (ycol, c1, c0) in vlbs.get(j, ()):
                s = xj - c0 - c1 * float(x[ycol])
                cands.append((s, 1.0, c0, c1, ycol))
        if vubs is not None:
            for (ycol, c1, c0) in vubs.get(j, ()):
                s = c0 + c1 * float(x[ycol]) - xj
                cands.append((s, -1.0, c0, c1, ycol))
        cands = [cd for cd in cands if cd[0] >= -feastol]
        if not cands:
            return None
        if prefer_vbds:
            # aggregated (path) rows prefer variable bounds outright
            # (reference HighsTransformedLp preferVbds): among vbound
            # candidates within feastol of the best slack, take one
            sbest = min(cd[0] for cd in cands)
            vb = [cd for cd in cands
                  if cd[4] >= 0 and cd[0] <= sbest + feastol]
            s_star, sigma, b0, b1, ycol = (
                min(vb, key=lambda t: t[0]) if vb
                else min(cands, key=lambda t: t[0]))
        else:
            s_star, sigma, b0, b1, ycol = min(cands, key=lambda t: t[0])
        # a_j x_j = a_j b0 + a_j b1 y + a_j sigma s
        bh0 -= float(v) * b0
        if ycol >= 0 and abs(b1) > _EPS:
            int_coef[ycol] = int_coef.get(ycol, 0.0) + float(v) * b1
        slack_defs.append((j, sigma, b0, b1, ycol, float(v) * sigma,
                           max(s_star, 0.0)))

    # ---- integer complementation to the nearest finite bound ----------
    icols = np.fromiter(int_coef.keys(), dtype=np.int64,
                        count=len(int_coef))
    ivals = np.fromiter(int_coef.values(), dtype=np.float64,
                        count=len(int_coef))
    keep = np.abs(ivals) > _EPS
    icols, ivals = icols[keep], ivals[keep]
    use_lower = np.abs(x[icols] - _finite(lo[icols])) <= \
        np.abs(_finite(up[icols], 1e30) - x[icols])
    use_lower &= np.isfinite(lo[icols])
    use_upper = ~use_lower & np.isfinite(up[icols])
    if not np.all(use_lower | use_upper):
        return None
    sub_b = np.where(use_lower, _finite(lo[icols]), _finite(up[icols]))
    sign = np.where(use_lower, 1.0, -1.0)
    ah = ivals * sign                # coefficient on xh >= 0
    bh = bh0 - float(ivals @ sub_b)
    xh = sign * (x[icols] - sub_b)
    acs = np.array([d[5] for d in slack_defs])   # coefs on slacks
    s_vals = np.array([d[6] for d in slack_defs])
    widths = _finite(up[icols], 1e30) - _finite(lo[icols], -1e30)

    def _lifted_cover():
        """Lifted cover cut in the transformed space (reference
        HighsCutGeneration::determineCover +
        separateLiftedKnapsackCover / separateLiftedMixedBinaryCover).
        This is the flow-cover cut family that closes fixed-charge
        gaps where c-MIR plateaus.  Returns (eff, gi, gc, grhs) in the
        same format as _eval, or None.  General-integer lifting is not
        implemented: only rows whose integers are all binary-width
        qualify."""
        if len(icols) == 0:
            return None
        if np.any(widths > 1.5) or np.any(~np.isfinite(widths)):
            return None  # general/unbounded ints: c-MIR handles those
        # all integer coefficients must be positive for the cover
        # lifting functions (reference: flipComplementation of every
        # negative integer before tryGenerateCut)
        ah = _ah_base.copy()
        xh = _xh_base.copy()
        bh = _bh_base
        sign2 = sign.copy()
        sub_b2 = sub_b.copy()
        for k in np.nonzero(ah < 0)[0]:
            ob = up[icols[k]] if use_lower[k] else lo[icols[k]]
            if not np.isfinite(ob):
                return None
            bh = bh - ivals[k] * (ob - sub_b2[k])
            sign2[k] = -sign2[k]
            sub_b2[k] = ob
            ah[k] = ivals[k] * sign2[k]
            xh[k] = sign2[k] * (x[icols[k]] - ob)
        if bh <= 10 * feastol:
            return None
        # --- cover selection: saturated columns seed the cover, then
        # fractional ones join in LP-value-weighted order until the
        # total weight strictly exceeds the capacity (the classical
        # minimal-cover heuristic on the LP point; reference analogue
        # HighsCutGeneration::determineCover) ------------------------
        active = np.nonzero(xh > feastol)[0]
        if len(active) == 0:
            return None
        sat = xh[active] >= widths[active] - feastol
        seed = active[sat]
        frac = active[~sat]
        # vectorized ordering key: largest LP contribution first,
        # weight and index as tie-breaks
        if len(frac):
            order_f = np.lexsort(
                (frac, -ah[frac], -(xh[frac] * ah[frac])))
            frac = frac[order_f]
        weight_of = ah * widths
        excess_floor = max(10 * feastol, feastol * abs(bh))
        total = float(weight_of[seed].sum())
        take = 0
        while total - bh <= excess_floor and take < len(frac):
            total += float(weight_of[frac[take]])
            take += 1
        cover = np.concatenate([seed, frac[:take]]).astype(int)
        lam = total - bh
        if len(cover) == 0 or lam <= excess_floor:
            return None
        cov_set = np.zeros(len(icols), dtype=bool)
        cov_set[cover] = True
        cw = np.sort(np.array([float(ah[k]) for k in cover]))[::-1]
        gi = np.zeros(len(icols))
        if len(slack_defs) == 0:
            # --- pure-integer knapsack cover, superadditive lifting
            # (Gu–Nemhauser–Savelsbergh sequence-independent lifting
            # with the Letchford–Souli half-integral strengthening).
            # Vectorized over the lifted columns; the reference reaches
            # the same inequality family through
            # HighsCutGeneration::separateLiftedKnapsackCover.
            #
            # The residual divisor mu: shaving every cover weight down
            # to mu must absorb exactly the cover excess lam.  With the
            # weights sorted descending and pre_i their prefix sums,
            # shaving the first i weights to cw[i] absorbs
            # pre_{i-1} - i*cw[i] (a telescoping sum) — so mu sits in
            # the first prefix whose absorption reaches lam, at
            # mu = (pre_{i-1} - lam) / i, and lam exceeding the total
            # absorption means every weight shaves to the average.
            K = len(cw)
            pre = np.cumsum(cw)
            if K > 1:
                ii = np.arange(1, K)
                absorb = pre[:-1] - ii * cw[1:]
                hit = np.nonzero(absorb >= lam)[0]
            else:
                hit = np.zeros(0, dtype=int)
            if len(hit):
                i_star = int(hit[0]) + 1
                mu = (pre[i_star - 1] - lam) / i_star
            else:
                mu = bh / K
            # superadditive step function: levels[h] is the largest
            # weight a column may carry and still lift to h+1
            levels = np.cumsum(np.minimum(mu, cw))
            n_big = int(np.count_nonzero(cw > mu + feastol))
            # columns: cover members at-or-below mu lift to 1; all
            # others through the step function
            small_cover = cov_set & (ah <= mu + feastol) & \
                (np.abs(ah) > _EPS)
            lift_mask = ~small_cover & (np.abs(ah) > _EPS)
            zl = ah[lift_mask]
            steps = np.searchsorted(levels, zl - feastol, side="left")
            # half-integral strengthening: a weight equal to a
            # multiple h*mu (h below the count of above-mu cover
            # weights) supports a 1/2 contribution; doubling then
            # restores integrality of the whole inequality
            if mu > _EPS:
                ratio = zl / mu
                near = np.floor(ratio + 0.5)
                at_mult = (near != 0) & \
                    (np.abs(ratio - near) * max(1.0, mu) <= 1e-9) & \
                    (near <= n_big - 1)
            else:
                at_mult = np.zeros(len(zl), dtype=bool)
            base = np.maximum(near.astype(int) - 1, 0) \
                if mu > _EPS else np.zeros(len(zl), dtype=int)
            steps = np.maximum(steps, base)
            lifted = steps.astype(float) + np.where(at_mult, 0.5, 0.0)
            gi[small_cover] = 1.0
            gi[lift_mask] = lifted
            grhs = float(K - 1)
            if bool(at_mult.any()):
                grhs *= 2
                gi *= 2
            gc = np.zeros(0)
        else:
            # --- mixed-binary cover: lift through the piecewise-linear
            # superadditive function of the cover's heavy weights
            # (reference analogue: separateLiftedMixedBinaryCover).
            # The function climbs lam per completed heavy weight and
            # linearly inside the top lam-wide band of each.
            heavy = cw[cw - lam > 1e-12]
            if len(heavy) == 0:
                return None
            tops = np.cumsum(heavy)            # band upper edges
            grhs = -lam
            cov_vals = np.minimum(ah[cov_set], lam)
            gi[cov_set] = cov_vals
            grhs += float(cov_vals.sum())
            zl = ah[~cov_set]
            # band index: position of each weight among the edges
            bi = np.searchsorted(tops, zl, side="left")
            bi_c = np.minimum(bi, len(tops) - 1)
            in_band = (bi < len(tops)) & (zl > tops[bi_c] - lam)
            flat = bi.astype(float) * lam
            climb = (bi + 1) * lam + (zl - tops[bi_c])
            over = len(tops) * lam + (zl - tops[-1])
            gi[~cov_set] = np.where(
                bi >= len(tops), over, np.where(in_band, climb, flat))
            # continuous slacks: negative kept, positive relaxed away
            gc = np.minimum(acs, 0.0)
        act = float(gi @ xh) + (float(gc @ s_vals) if len(gc) else 0.0)
        viol = act - grhs
        nrm = math.sqrt(float(gi @ gi) +
                        (float(gc @ gc) if len(gc) else 0.0))
        if nrm <= _EPS:
            return None
        return (viol / nrm, gi, gc, float(grhs)), sign2, sub_b2

    def _eval(delta, ah_e, bh_e, xh_e):
        """MIR at divisor delta; returns (eff, gi, gc, grhs) or None."""
        b_d = bh_e / delta
        f = b_d - math.floor(b_d)
        if f < 0.005 or f > 0.995:
            return None
        if 1.0 / (1.0 - f) > 1e6:
            return None
        a_d = ah_e / delta
        gi = np.floor(a_d) + np.maximum(a_d - np.floor(a_d) - f, 0.0) / \
            (1.0 - f)
        # continuous slacks: positive coeffs relaxed away; negative
        # scaled by 1/(1-f)
        gc = np.minimum(acs / delta, 0.0) / (1.0 - f)
        grhs = math.floor(b_d)
        act = float(gi @ xh_e) + (float(gc @ s_vals) if len(gc) else 0.0)
        viol = act - grhs
        nrm = math.sqrt(float(gi @ gi) +
                        (float(gc @ gc) if len(gc) else 0.0))
        if nrm <= _EPS:
            return None
        return viol / nrm, gi, gc, float(grhs)

    # delta candidates (reference cmirCutGenerationHeuristic): |a_j| of
    # integers active at x*, 1.0, and max|a|+1
    cand = [1.0]
    sup = np.abs(ah[xh > feastol])
    sup = np.unique(np.round(sup[sup > 1e-4], 12))[:16]
    cand.extend(sup)
    if len(sup):
        cand.append(float(sup.max()) + 1.0)
    # lifted cover cut candidate (computed with its own positive-
    # coefficient complementation; _ah_base etc. are the frozen inputs)
    _ah_base, _xh_base, _bh_base = ah, xh, bh
    _cover = _lifted_cover()
    if _cover is not None:
        cover_got, cover_sign, cover_sub_b = _cover
    else:
        cover_got, cover_sign, cover_sub_b = None, None, None

    def _eval_batch(deltas, ah_e, bh_e, xh_e):
        """Vectorized MIR over all divisor candidates at once (the
        per-delta Python loop dominated separation time).  Returns
        (eff, gi, gc, grhs, delta) of the best valid delta or None."""
        D = np.asarray(deltas, dtype=np.float64)[:, None]
        b_d = bh_e / D[:, 0]
        fl_b = np.floor(b_d)
        f = b_d - fl_b
        ok = (f >= 0.005) & (f <= 0.995)
        if not ok.any():
            return None
        oneminus = np.where(ok, 1.0 - f, 1.0)
        a_d = ah_e[None, :] / D
        fl = np.floor(a_d)
        gi_m = fl + np.maximum(a_d - fl - f[:, None], 0.0) / \
            oneminus[:, None]
        act = gi_m @ xh_e
        sq = np.einsum('ij,ij->i', gi_m, gi_m)
        if len(acs):
            gc_m = np.minimum(acs[None, :] / D, 0.0) / oneminus[:, None]
            act = act + gc_m @ s_vals
            sq = sq + np.einsum('ij,ij->i', gc_m, gc_m)
        viol = act - fl_b
        nrm = np.sqrt(sq)
        eff_all = np.where(ok & (nrm > _EPS), viol / np.maximum(nrm,
                                                                _EPS),
                           -np.inf)
        k = int(np.argmax(eff_all))
        if not np.isfinite(eff_all[k]) or eff_all[k] <= _MIN_EFFICACY:
            return None
        gc_k = (gc_m[k] if len(acs) else np.zeros(0))
        return (float(eff_all[k]), gi_m[k], gc_k, float(fl_b[k]),
                float(D[k, 0]))

    got = _eval_batch(cand, ah, bh, xh)
    best = None
    best_delta = None
    if got is not None:
        best = got[:4]
        best_delta = got[4]
    if best is None and (cover_got is None or
                         cover_got[0] <= _MIN_EFFICACY):
        return None
    if best is not None:
        # refine: delta*2, *4, *8 (reference tries bestdelta << k)
        got = _eval_batch([best_delta * 2, best_delta * 4,
                           best_delta * 8], ah, bh, xh)
        if got is not None and got[0] > best[0]:
            best = got[:4]
            best_delta = got[4]
        # greedy complementation flipping of integers at the chosen
        # delta (reference: flipComplementation loop) — flipping k
        # substitutes the other finite bound, which changes bh and the
        # sign of ah_k.  Capped: each trial costs a full evaluation
        n_flips = 0
        for kk in range(len(icols)):
            if n_flips >= 10:
                break
            ob = up[icols[kk]] if use_lower[kk] else lo[icols[kk]]
            if not np.isfinite(ob) or xh[kk] <= feastol:
                continue
            n_flips += 1
            sign_k = -sign[kk]
            bh_f = bh - ivals[kk] * (ob - sub_b[kk])
            ah_f = ah.copy()
            ah_f[kk] = ivals[kk] * sign_k
            xh_f = xh.copy()
            xh_f[kk] = sign_k * (x[icols[kk]] - ob)
            got = _eval(best_delta, ah_f, bh_f, xh_f)
            if got is not None and got[0] > best[0]:
                best = got
                sign[kk] = sign_k
                sub_b[kk] = ob
                ah = ah_f
                bh = bh_f
                xh = xh_f
    # pick the better of lifted cover and c-MIR (reference
    # tryGenerateCut keeps the lifted cut unless c-MIR beats it)
    if cover_got is not None and (best is None or
                                  cover_got[0] > best[0]):
        best = cover_got
        sign = cover_sign
        sub_b = cover_sub_b
    eff, gi, gc, grhs = best
    # ---- un-substitute ------------------------------------------------
    out: dict = {}
    out_rhs = grhs
    # integer xh = sign*(x - sub_b)
    for c, g, sg, sb in zip(icols, gi, sign, sub_b):
        if abs(g) > _EPS:
            out[int(c)] = out.get(int(c), 0.0) + g * sg
            out_rhs += g * sg * sb
    # continuous s = sigma*(x_j - b0 - b1*y):
    #   g*s = g*sigma*x_j - g*sigma*b1*y - g*sigma*b0
    for (j, sigma, b0, b1, ycol, _cs, _sv), g in zip(slack_defs, gc):
        if abs(g) <= _EPS:
            continue
        out[j] = out.get(j, 0.0) + g * sigma
        out_rhs += g * sigma * b0
        if ycol >= 0 and abs(b1) > _EPS:
            out[ycol] = out.get(ycol, 0.0) - g * sigma * b1
    if not out:
        return None
    ocols = np.fromiter(out.keys(), dtype=np.int64, count=len(out))
    ovals = np.fromiter(out.values(), dtype=np.float64, count=len(out))
    order = np.argsort(ocols)
    return ocols[order], ovals[order], float(out_rhs), eff


def separate_mir(a_csr: sp.csr_matrix, row_lower: np.ndarray,
                 row_upper: np.ndarray, lo: np.ndarray, up: np.ndarray,
                 x: np.ndarray, is_int: np.ndarray,
                 feastol: float = 1e-6, max_cuts: int = 64) -> List[Cut]:
    """c-MIR separation over single rows (both row senses)."""
    m, n = a_csr.shape
    cuts: List[Cut] = []
    vubs, vlbs = collect_variable_bounds(a_csr, row_lower, row_upper,
                                         is_int)
    # prefer rows that are tight at x*
    act = a_csr @ x
    tight_u = np.where(np.isfinite(row_upper),
                       np.abs(act - row_upper), np.inf)
    tight_l = np.where(np.isfinite(row_lower),
                       np.abs(act - row_lower), np.inf)
    order = np.argsort(np.minimum(tight_u, tight_l))
    # collect every (cols, vals, rhs) trial first, then run ONE
    # batched native c-MIR call (hx_mir_batch): the per-row ctypes
    # round trip cost ~30us x thousands of rows per round
    trials = []
    indptr_, indices_, data_ = a_csr.indptr, a_csr.indices, a_csr.data
    for i in order[:400]:
        s_, e_ = indptr_[i], indptr_[i + 1]
        cols = indices_[s_:e_].astype(np.int32)
        vals = data_[s_:e_].astype(np.float64)
        # rows qualify with direct integer support OR continuous
        # variables whose variable bounds bring integers in at
        # substitution time (fixed-charge flow rows are pure-continuous)
        if cols.size < 2 or not (
                np.any(is_int[cols]) or
                any(int(c) in vubs or int(c) in vlbs for c in cols)):
            continue
        if np.isfinite(row_upper[i]):
            trials.append((cols, vals, float(row_upper[i])))
        if np.isfinite(row_lower[i]):
            trials.append((cols, -vals, float(-row_lower[i])))

    from . import native_cuts
    results = native_cuts.mir_batch_native(
        trials, x, lo, up,
        (is_int.view(np.int8) if is_int.dtype == np.bool_ and
         is_int.flags["C_CONTIGUOUS"] else
         np.ascontiguousarray(is_int, dtype=np.int8)),
        feastol, vubs=vubs, vlbs=vlbs)
    for got in results:
        if len(cuts) >= max_cuts:
            break
        if got is None:
            continue
        ccols, cvals, crhs, eff = got
        res = _clean_cut(ccols.copy(), cvals.copy(), crhs, lo, up)
        if res is None:
            continue
        ccols, cvals, crhs = res
        viol = float(x[ccols] @ cvals) - crhs
        nrm = float(np.linalg.norm(cvals))
        if nrm > 0 and viol / nrm > _MIN_EFFICACY:
            cuts.append(Cut(ccols, cvals, crhs, viol / nrm))
    return cuts


# --------------------------------------------------------------------------
# Clique table + clique cuts
# --------------------------------------------------------------------------

class CliqueTable:
    """Set-packing cliques extracted from rows (reference
    HighsCliqueTable::extractCliques).  A clique is a set of binary
    literals (var, complemented?) of which at most one can be 1."""

    def __init__(self, a_csr: sp.csr_matrix, row_lower: np.ndarray,
                 row_upper: np.ndarray, lo: np.ndarray, up: np.ndarray,
                 is_int: np.ndarray, feastol: float = 1e-6):
        self.cliques: List[Tuple[np.ndarray, np.ndarray]] = []
        n = a_csr.shape[1]
        binary = is_int & (lo >= -feastol) & (up <= 1 + feastol) & \
            (up - lo > 0.5)
        m = a_csr.shape[0]
        indptr_, indices_, data_ = (a_csr.indptr, a_csr.indices,
                                    a_csr.data)
        for i in range(m):
            s_, e_ = indptr_[i], indptr_[i + 1]
            cols = indices_[s_:e_]
            vals = data_[s_:e_]
            if cols.size < 2 or cols.size > 200:
                continue
            if not np.all(binary[cols]):
                continue
            # knapsack row sum a_j x_j <= b with binary x: after
            # complementing negatives (x -> 1 - x), a clique requires
            # a_j + a_k > b for all pairs — with equal +-1 coeffs this is
            # the standard set-packing detection
            for sgn, b in ((1.0, row_upper[i]), (-1.0, -row_lower[i])):
                if not np.isfinite(b):
                    continue
                v = sgn * vals
                comp = v < 0
                vv = np.abs(v)
                # complement x_j -> 1 - x_j for negative coefficients:
                # rhs shifts by -sum of the negative coefficients
                bb = b - float(v[comp].sum())
                if vv.size < 2:
                    continue
                two_smallest = np.partition(vv, 1)[:2]
                if two_smallest.sum() > bb + feastol and \
                        vv.max() <= bb + feastol:
                    self.cliques.append((cols.copy(), comp.copy()))
        self._merge()
        self._build_neighbors()

    # -- merging + extension (reference HighsCliqueTable.cpp:
    #    merging absorbs dominated cliques, runCliqueMerging /
    #    extension grows a clique by literals in conflict with every
    #    member) -----------------------------------------------------
    def _merge(self):
        """Drop cliques whose literal set is contained in another."""
        lits = [frozenset(zip(c.tolist(), cm.tolist()))
                for c, cm in self.cliques]
        order = sorted(range(len(lits)), key=lambda i: -len(lits[i]))
        kept: List[int] = []
        kept_sets: List[frozenset] = []
        for i in order:
            li = lits[i]
            dominated = any(li <= ks for ks in kept_sets)
            if not dominated:
                kept.append(i)
                kept_sets.append(li)
        self.cliques = [self.cliques[i] for i in sorted(kept)]

    def _build_neighbors(self):
        """literal -> set of conflicting literals (via shared
        cliques); a literal is (col, complemented)."""
        self._nbr: dict = {}
        for cols, comp in self.cliques:
            ls = list(zip(cols.tolist(), comp.tolist()))
            for a in ls:
                st_ = self._nbr.setdefault(a, set())
                for b_ in ls:
                    if b_ != a:
                        st_.add(b_)

    def extend(self, cols: np.ndarray, comp: np.ndarray,
               x: np.ndarray, max_extra: int = 10):
        """Greedy clique extension: add literals conflicting with
        EVERY current member, highest fractional value first
        (reference clique extension in separation)."""
        if not getattr(self, "_nbr", None):
            return cols, comp
        members = list(zip(cols.tolist(), comp.tolist()))
        common = None
        for lit in members:
            nb = self._nbr.get(lit)
            if not nb:
                return cols, comp
            common = set(nb) if common is None else (common & nb)
            if not common:
                return cols, comp
        common -= set(members)
        if not common:
            return cols, comp
        def litval(l):
            j, c = l
            return 1.0 - float(x[j]) if c else float(x[j])
        added = []
        for lit in sorted(common, key=litval, reverse=True):
            if all(lit in self._nbr.get(ml, ()) for ml in
                   members + added):
                added.append(lit)
                if len(added) >= max_extra:
                    break
        if not added:
            return cols, comp
        cols2 = np.concatenate([cols,
                                np.array([l[0] for l in added],
                                         dtype=cols.dtype)])
        comp2 = np.concatenate([comp,
                                np.array([l[1] for l in added],
                                         dtype=bool)])
        return cols2, comp2

    def separate(self, x: np.ndarray, tol: float = 1e-5,
                 max_cuts: int = 50) -> List[Cut]:
        cuts = []
        seen = set()
        for cols, comp in self.cliques:
            key = (tuple(cols.tolist()), tuple(comp.tolist()))
            if key in seen:
                continue
            seen.add(key)
            lit = np.where(comp, 1.0 - x[cols], x[cols])
            viol = float(lit.sum()) - 1.0
            if viol > tol:
                cols, comp = self.extend(cols, comp, x)
                # sum_{!comp} x + sum_{comp} (1-x) <= 1
                vals = np.where(comp, -1.0, 1.0)
                rhs = 1.0 - float(comp.sum())
                nrm = math.sqrt(len(cols))
                cuts.append(Cut(cols.astype(np.int32), vals, rhs,
                                viol / nrm))
        cuts.sort(key=lambda c: -c.efficacy)
        return cuts[:max_cuts]


def select_diverse_cuts(cuts: List[Cut], max_cuts: int = 300,
                        max_parallelism: float = 0.9) -> List[Cut]:
    """Efficacy-ordered greedy selection rejecting near-parallel cuts
    (reference HighsCutPool::separate cut selection): a diverse set of
    moderately strong cuts moves the LP bound further than many
    near-duplicates of the single strongest one.

    One sparse row-matrix product per candidate against everything
    picked so far (the previous pairwise intersect1d loop was the
    hottest root-cut function on p0548)."""

    cuts = sorted(cuts, key=lambda c: -c.efficacy)
    if not cuts:
        return []
    ncol = 1 + max(int(c.cols.max()) for c in cuts if len(c.cols))
    picked: List[Cut] = []
    cap = min(max_cuts, len(cuts))
    pmat = np.zeros((cap, ncol))
    k = 0
    for c in cuts:
        if k >= max_cuts:
            break
        nrm = float(np.linalg.norm(c.vals))
        if nrm <= _EPS:
            continue
        dense = np.zeros(ncol)
        dense[c.cols] = c.vals / nrm
        if k and float(
                np.max(np.abs(pmat[:k] @ dense))) > max_parallelism:
            continue
        picked.append(c)
        pmat[k] = dense
        k += 1
    return picked
