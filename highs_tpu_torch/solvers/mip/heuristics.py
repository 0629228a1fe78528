"""MIP primal heuristics.

Re-implements the behavior of the reference heuristics layer
(highs/mip/HighsPrimalHeuristics.cpp): ZI-round (:70), shifting (:67),
randomized rounding (:64), RINS (:48), RENS (:46) and root-reduced-cost
fixing (:44).  The rounding-style heuristics are vectorized NumPy passes
over row activities; RINS/RENS build restricted sub-MIPs (sub-MIP
plumbing, HighsPrimalHeuristics.cpp solveSubMip) solved by a recursion
into solve_mip with tight node/time budgets.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.sparse as sp


def _row_activity(a_csr: sp.csr_matrix, x: np.ndarray) -> np.ndarray:
    return a_csr @ x if a_csr.shape[0] else np.zeros(0)


def _feasible_rows(ax, row_lower, row_upper, feastol):
    sl = 1.0 + np.abs(np.where(np.isfinite(row_lower), row_lower, 0.0))
    su = 1.0 + np.abs(np.where(np.isfinite(row_upper), row_upper, 0.0))
    return np.all(ax >= row_lower - feastol * sl) and \
        np.all(ax <= row_upper + feastol * su)


def zi_round(a_csc: sp.csc_matrix, row_lower: np.ndarray,
             row_upper: np.ndarray, lo: np.ndarray, up: np.ndarray,
             cost: np.ndarray, is_int: np.ndarray, x0: np.ndarray,
             feastol: float = 1e-6, max_passes: int = 6
             ) -> Optional[np.ndarray]:
    """ZI-round (reference ziRound, HighsPrimalHeuristics.cpp:70).

    For each fractional integer variable, compute the largest shift up
    and down that keeps every row within its bounds (using row slacks
    and the variable's column), and apply whichever of the two shifts
    reduces the integer infeasibility ZI(x) = sum |x_j - round(x_j)|
    the most.  Pure row-slack arithmetic — no LP solves.
    """
    a_csr = a_csc.tocsr()
    x = np.asarray(x0, dtype=np.float64).copy()
    x = np.clip(x, lo, up)
    m = a_csr.shape[0]
    ax = _row_activity(a_csr, x)
    # row slack to the bounds (inf where bound infinite)
    for _pass in range(max_passes):
        frac = np.abs(x - np.round(x))
        cand = np.nonzero(is_int & (frac > feastol))[0]
        if len(cand) == 0:
            break
        improved = False
        # process most fractional first
        cand = cand[np.argsort(-frac[cand])]
        for j in cand:
            col = a_csc.getcol(j)
            rows = col.indices
            vals = col.data
            if m:
                slack_up = row_upper[rows] - ax[rows]  # >= 0 if feasible
                slack_dn = ax[rows] - row_lower[rows]
            else:
                slack_up = slack_dn = np.zeros(0)
            # max shift t >= 0 such that x_j + t keeps rows feasible:
            # vals>0 rows consume slack_up/vals, vals<0 consume slack_dn
            with np.errstate(divide="ignore", invalid="ignore"):
                up_lims = np.where(vals > 0, slack_up / vals,
                                   np.where(vals < 0, -slack_dn / vals,
                                            np.inf))
                dn_lims = np.where(vals > 0, slack_dn / vals,
                                   np.where(vals < 0, -slack_up / vals,
                                            np.inf))
            t_up = min(float(np.min(up_lims, initial=np.inf)),
                       up[j] - x[j])
            t_dn = min(float(np.min(dn_lims, initial=np.inf)),
                       x[j] - lo[j])
            fj = x[j] - math.floor(x[j])
            # candidate shifts toward the two integers
            shift_up = min(t_up, 1.0 - fj)
            shift_dn = min(t_dn, fj)
            zi_now = min(fj, 1.0 - fj)
            zi_up = min(abs(fj + shift_up - round(fj + shift_up)),
                        1.0) if shift_up > feastol else zi_now
            zi_dn = min(abs(fj - shift_dn - round(fj - shift_dn)),
                        1.0) if shift_dn > feastol else zi_now
            best = None
            if zi_up < zi_now - 1e-12 and zi_up <= zi_dn:
                best = shift_up
            elif zi_dn < zi_now - 1e-12:
                best = -shift_dn
            if best is None or abs(best) <= feastol:
                continue
            x[j] += best
            if m and len(rows):
                ax[rows] += vals * best
            improved = True
        if not improved:
            break
    frac = np.abs(x - np.round(x))
    if np.any(is_int & (frac > feastol)):
        return None
    x[is_int] = np.round(x[is_int])
    ax = _row_activity(a_csr, x)
    if m and not _feasible_rows(ax, row_lower, row_upper, feastol):
        return None
    if np.any(x < lo - feastol) or np.any(x > up + feastol):
        return None
    return x


def shifting(a_csc: sp.csc_matrix, row_lower: np.ndarray,
             row_upper: np.ndarray, lo: np.ndarray, up: np.ndarray,
             cost: np.ndarray, is_int: np.ndarray, x0: np.ndarray,
             feastol: float = 1e-6, max_iters: int = 2000
             ) -> Optional[np.ndarray]:
    """Shifting heuristic (reference HighsPrimalHeuristics.cpp:67).

    Round all integers to the nearest integer, then repair row
    infeasibility by shifting one variable at a time: pick the most
    violated row and the variable in it whose shift reduces the
    violation most per unit of objective degradation (continuous
    variables shift fractionally, integers by whole units).
    """
    a_csr = a_csc.tocsr()
    x = np.asarray(x0, dtype=np.float64).copy()
    x[is_int] = np.round(x[is_int])
    x = np.clip(x, lo, up)
    x[is_int] = np.round(x[is_int])  # clip can break integrality at bounds
    m = a_csr.shape[0]
    if m == 0:
        return x
    ax = _row_activity(a_csr, x)

    for _ in range(max_iters):
        viol_up = ax - row_upper  # > 0: too high
        viol_dn = row_lower - ax  # > 0: too low
        viol = np.maximum(np.maximum(viol_up, viol_dn), 0.0)
        i = int(np.argmax(viol))
        if viol[i] <= feastol * (1.0 + abs(ax[i])):
            break
        need_down = viol_up[i] > 0  # need to decrease activity
        amount = viol[i]
        row = a_csr.getrow(i)
        cols, vals = row.indices, row.data
        best_j, best_step, best_score = -1, 0.0, -np.inf
        for j, aij in zip(cols, vals):
            # direction of x_j that decreases (or increases) activity
            direction = -np.sign(aij) if need_down else np.sign(aij)
            # head-room in that direction
            room = (up[j] - x[j]) if direction > 0 else (x[j] - lo[j])
            if room <= feastol:
                continue
            step = min(room, amount / abs(aij))
            if is_int[j]:
                step = math.ceil(step - 1e-9)
                if step > room + feastol:
                    step = math.floor(room + 1e-9)
                if step < 1:
                    continue
            gain = min(step * abs(aij), amount)
            degrade = cost[j] * direction * step
            score = gain / (1.0 + max(degrade, 0.0))
            if score > best_score:
                best_j, best_step, best_score = j, direction * step, score
        if best_j < 0:
            return None  # stuck
        x[best_j] += best_step
        col = a_csc.getcol(best_j)
        ax[col.indices] += col.data * best_step

    viol = np.maximum(np.maximum(ax - row_upper, row_lower - ax), 0.0)
    if np.any(viol > feastol * (1.0 + np.abs(ax))):
        return None
    return x


def randomized_rounding(a_csr: sp.csr_matrix, lo: np.ndarray,
                        up: np.ndarray, is_int: np.ndarray,
                        x0: np.ndarray, seed: int = 0
                        ) -> np.ndarray:
    """Randomized rounding (HighsPrimalHeuristics.cpp:64): round each
    fractional integer up with probability equal to its fractionality.
    The caller repairs/completes the point (propagate + LP)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x0, dtype=np.float64).copy()
    f = x - np.floor(x)
    r = rng.random(x.shape)
    xi = np.floor(x) + (r < f)
    x = np.where(is_int, xi, x)
    return np.clip(x, lo, up)


def submip_bounds_rins(is_int: np.ndarray, incumbent: np.ndarray,
                       x_relax: np.ndarray, lo: np.ndarray,
                       up: np.ndarray, feastol: float = 1e-6):
    """RINS fixing (HighsPrimalHeuristics.cpp:48): fix integer variables
    where the incumbent and the relaxation agree; leave the rest free.
    Returns (lo', up', n_fixed)."""
    agree = is_int & (np.abs(incumbent - x_relax) <= feastol)
    lo2 = np.where(agree, np.round(incumbent), lo)
    up2 = np.where(agree, np.round(incumbent), up)
    return lo2, up2, int(agree.sum())


def submip_bounds_rens(is_int: np.ndarray, x_relax: np.ndarray,
                       lo: np.ndarray, up: np.ndarray):
    """RENS box (HighsPrimalHeuristics.cpp:46): restrict each integer to
    {floor, ceil} of the relaxation value."""
    lo2 = np.where(is_int, np.maximum(lo, np.floor(x_relax)), lo)
    up2 = np.where(is_int, np.minimum(up, np.ceil(x_relax)), up)
    return lo2, up2


def submip_bounds_root_redcost(is_int: np.ndarray, x_root: np.ndarray,
                               z_root: np.ndarray, lo: np.ndarray,
                               up: np.ndarray, frac_fix: float = 0.3):
    """Root-reduced-cost fixing heuristic (HighsPrimalHeuristics.cpp:44):
    fix the `frac_fix` fraction of integer variables with the largest
    |reduced cost| to their root-LP bound value."""
    n = len(lo)
    idx = np.nonzero(is_int)[0]
    if len(idx) == 0:
        return lo, up, 0
    order = idx[np.argsort(-np.abs(z_root[idx]))]
    k = max(1, int(frac_fix * len(order)))
    lo2, up2 = lo.copy(), up.copy()
    fixed = 0
    for j in order[:k]:
        if z_root[j] > 0 and np.isfinite(lo[j]):
            v = np.round(x_root[j])
            lo2[j] = up2[j] = v
            fixed += 1
        elif z_root[j] < 0 and np.isfinite(up[j]):
            v = np.round(x_root[j])
            lo2[j] = up2[j] = v
            fixed += 1
    return lo2, up2, fixed


def redcost_fixing(z: np.ndarray, x: np.ndarray, obj_bound: float,
                   cutoff: float, lo: np.ndarray, up: np.ndarray,
                   is_int: np.ndarray, feastol: float = 1e-6):
    """Reduced-cost bound tightening (reference HighsRedcostFixing.cpp):
    with node LP value `obj_bound`, incumbent `cutoff` and reduced cost
    z_j at a bound-optimal x, any better solution satisfies
        x_j <= x_j* + (cutoff - obj_bound) / z_j   (z_j > 0)
        x_j >= x_j* - (cutoff - obj_bound) / |z_j| (z_j < 0).
    Integer bounds round inward.  Returns (lo', up', n_tightened)."""
    gap = cutoff - obj_bound
    if not math.isfinite(gap) or gap < 0:
        return lo, up, 0
    lo2, up2 = lo.copy(), up.copy()
    tight = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        pos = z > feastol
        ub_new = np.where(pos, x + gap / np.where(pos, z, 1.0), np.inf)
        neg = z < -feastol
        lb_new = np.where(neg, x + gap / np.where(neg, z, 1.0), -np.inf)
    ub_new = np.where(is_int, np.floor(ub_new + feastol), ub_new)
    lb_new = np.where(is_int, np.ceil(lb_new - feastol), lb_new)
    better_ub = ub_new < up2 - feastol
    better_lb = lb_new > lo2 + feastol
    up2 = np.where(better_ub, np.maximum(ub_new, lo2), up2)
    lo2 = np.where(better_lb, np.minimum(lb_new, up2), lo2)
    # snap tolerance-width intervals onto the EXACT pre-existing bound:
    # leaving widths like [0, 2e-6] poisons downstream fixed-column
    # substitution (the drift compounds into false infeasibility);
    # reference HighsRedcostFixing fixes variables AT their bound
    snap_up = better_ub & (up2 - lo2 <= feastol) & (up2 > lo2)
    up2 = np.where(snap_up, lo2, up2)
    snap_lo = better_lb & (up2 - lo2 <= feastol) & (lo2 < up2)
    lo2 = np.where(snap_lo, up2, lo2)
    tight = int(better_ub.sum() + better_lb.sum())
    return lo2, up2, tight
