"""Vectorized presolve rule loop with stack-replay postsolve.

Re-implements the high-value rules of the reference presolve
(highs/presolve/HPresolve.cpp rule loop :5780) as numpy/scipy passes:

- empty rows (kPresolveRuleEmptyRow) / redundant rows
  (kPresolveRuleRedundantRow, activity-implied),
- singleton rows -> column bound (kPresolveRuleSingletonRow),
- empty columns (kPresolveRuleEmptyCol),
- fixed columns substituted out (kPresolveRuleFixedCol),
- doubleton equations (kPresolveRuleDoubletonEquation): the second
  variable is eliminated by substitution into all of its rows,
- duplicate (parallel) rows merged with intersected bounds
  (kParallelRowsAndCols; reference: parallel row/col hashing),
- forcing rows (kPresolveRuleForcingRow): minact==ru / maxact==rl fixes
  every variable in the row at its activity-extreme bound,
- free column singletons in equality rows substituted out
  (kPresolveRuleFreeColSubstitution).

Postsolve replays the reduction stack in reverse recovering primal AND
dual values (reference: HighsPostsolveStack.h reduction replay).  The
`presolve_rule_off` bitmask disables individual rules
(PresolveRuleType bit positions, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..constants import (HighsModelStatus, HighsVarType, PresolveRuleType,
                         kHighsInf)
from ..models.lp import HighsLp, HighsSparseMatrix
from ..models.solution import HighsSolution
from ..options import HighsOptions
from ..utils.timer import span
from .device import DeviceMatrix
from .presolve import PresolveResult


def _snap_fix_value(xj: float, lo_j: float, up_j: float,
                    tol: float) -> float:
    """Snap a fixing value to a nearby exact rational.

    When a column's bounds close to within tolerance, any point of the
    interval is an equally valid fixing — but a fuzzy midpoint
    (4.499999937 from propagation feastol slack) poisons every row rhs
    it is substituted into, and those errors compound into false
    infeasibilities downstream (reference instance issue-2290.mps).
    Prefer the exact integer or small rational within reach."""
    width = max(tol, (up_j - lo_j) if np.isfinite(up_j - lo_j) else tol)

    def _clip(v):
        # the fixing value must stay INSIDE the interval: values a
        # tolerance outside shift every substituted row and the drift
        # compounds into false infeasibilities
        if np.isfinite(lo_j):
            v = max(v, lo_j)
        if np.isfinite(up_j):
            v = min(v, up_j)
        return float(v)

    r = round(xj)
    if abs(r - xj) <= width and lo_j - tol <= r <= up_j + tol:
        return _clip(r)
    from ..utils.integers import nearest_rational
    p, q = nearest_rational(xj, 1024)
    cand = p / q
    if abs(cand - xj) <= width and lo_j - tol <= cand <= up_j + tol:
        return _clip(cand)
    return _clip(xj)


def _rule_on(options: HighsOptions, rule: PresolveRuleType) -> bool:
    return not (options.presolve_rule_off >> int(rule)) & 1


class _RuleClocks:
    """The pass loop's clocks, one rule family after another:
    `rule(name)` closes the open family's "presolve.<family>" scope,
    counts the stack entries it pushed under the same name, and opens
    `name`'s (None opens none)."""

    def __init__(self, timer, stack: list):
        self.timer = timer
        self.stack = stack
        self.name = None
        self.scope = None
        self.depth = 0

    def __call__(self, name: Optional[str]) -> None:
        if self.scope is not None:
            self.scope.__exit__(None, None, None)
            pushed = len(self.stack) - self.depth
            if pushed and self.timer is not None:
                self.timer.count(self.name, pushed)
        self.name = None if name is None else "presolve." + name
        self.scope = None if name is None else span(self.timer, self.name)
        self.depth = len(self.stack)
        if self.scope is not None:
            self.scope.__enter__()


def run_presolve_rules(lp: HighsLp, options: HighsOptions,
                       matrix: DeviceMatrix) -> PresolveResult:
    """The rule loop on `lp`, whose canonical CSC `matrix.host` is, with
    every sweep over the nonzeros read from `matrix`'s copy on the
    solve's device."""
    tol = options.primal_feasibility_tolerance
    m, n = lp.num_row, lp.num_col
    if n == 0 or lp.is_mip() and False:
        return PresolveResult(HighsModelStatus.kNotset, lp, reduced=False)

    is_mip = lp.is_mip()
    integ = (np.asarray(lp.integrality).copy()
             if len(lp.integrality) == n else
             np.zeros(n, dtype=np.uint8))
    is_int = (integ == int(HighsVarType.kInteger)) | (
        integ == int(HighsVarType.kSemiInteger))
    has_semi = lp.has_semi_variables()
    semi_mask = (integ == int(HighsVarType.kSemiContinuous)) | (
        integ == int(HighsVarType.kSemiInteger))

    timer = getattr(options, "_timer", None)
    # `matrix.host` is the host's matrix, the authority for edits and the
    # build: it keeps the entries of rows and columns that presolve
    # removes, and the device copy's masks hide them
    cost = lp.col_cost.copy()
    cl = lp.col_lower.copy()
    cu = lp.col_upper.copy()
    rl = lp.row_lower.copy()
    ru = lp.row_upper.copy()
    offset = 0.0

    row_active = np.ones(m, dtype=bool)
    col_active = np.ones(n, dtype=bool)
    stack: List[tuple] = []
    rule = _RuleClocks(timer, stack)

    # integer bounds round to integrality up front (reference: initial
    # sweep kPresolveRuleInitialSweep behavior)
    if is_int.any():
        with np.errstate(invalid="ignore"):
            cl = np.where(is_int & np.isfinite(cl), np.ceil(cl - tol), cl)
            cu = np.where(is_int & np.isfinite(cu), np.floor(cu + tol),
                          cu)

    sense = float(lp.sense)

    def col_rows(j):
        a = matrix.host
        s, e = a.indptr[j], a.indptr[j + 1]
        idx = a.indices[s:e]
        val = a.data[s:e]
        keep = row_active[idx] & (val != 0.0)
        return idx[keep], val[keep]

    def row_cols(i):
        a_csr = matrix.host_csr()
        s, e = a_csr.indptr[i], a_csr.indptr[i + 1]
        idx = a_csr.indices[s:e]
        val = a_csr.data[s:e]
        keep = col_active[idx] & (val != 0.0)
        return idx[keep], val[keep]

    max_passes = 6
    infeasible = False
    unbounded = False
    changed_any = False
    _sparsify_off = [False]  # sticky: a zero-edit pass disables it
    for _pass in range(max_passes):
        changed = False

        rule("setup")
        row_nnz = matrix.row_counts(row_active, col_active)

        rule("empty_row")
        # --- empty rows ---------------------------------------------------
        if _rule_on(options, PresolveRuleType.kEmptyRow):
            empty = row_active & (row_nnz == 0)
            if np.any(empty):
                bad = empty & ((rl > tol) | (ru < -tol))
                if np.any(bad):
                    infeasible = True
                    break
                for i in np.nonzero(empty)[0]:
                    stack.append(("empty_row", int(i)))
                row_active[empty] = False
                changed = True

        rule("singleton_row")
        # --- singleton rows ----------------------------------------------
        if _rule_on(options, PresolveRuleType.kSingletonRow):
            singles = np.nonzero(row_active & (row_nnz == 1))[0]
            for i in singles:
                cols, vals = row_cols(i)
                if len(cols) != 1:
                    continue
                j = int(cols[0])
                if has_semi and integ[j] in (
                        int(HighsVarType.kSemiContinuous),
                        int(HighsVarType.kSemiInteger)):
                    continue  # bound semantics differ for semi-variables
                v = float(vals[0])
                lo_i = rl[i] / v if np.isfinite(rl[i]) else None
                up_i = ru[i] / v if np.isfinite(ru[i]) else None
                if v < 0:
                    lo_i, up_i = up_i, lo_i
                old_cl, old_cu = cl[j], cu[j]
                new_cl = max(cl[j], lo_i) if lo_i is not None else cl[j]
                new_cu = min(cu[j], up_i) if up_i is not None else cu[j]
                if is_int[j]:
                    new_cl = np.ceil(new_cl - tol) if np.isfinite(new_cl) \
                        else new_cl
                    new_cu = np.floor(new_cu + tol) if np.isfinite(new_cu) \
                        else new_cu
                if new_cl > new_cu + tol:
                    infeasible = True
                    break
                stack.append(("singleton_row", int(i), j, v,
                              float(old_cl), float(old_cu),
                              float(new_cl), float(new_cu),
                              float(rl[i]), float(ru[i])))
                cl[j], cu[j] = new_cl, new_cu
                row_active[i] = False
                changed = True
            if infeasible:
                break

        rule("fixed_col")
        # --- fixed columns -----------------------------------------------
        if _rule_on(options, PresolveRuleType.kFixedCol):
            with np.errstate(invalid="ignore"):
                # integers: a width-<1 interval holds a unique integer.
                # continuous: only essentially-zero widths may be fixed
                # — a tolerance-width interval (propagation/rc-fixing
                # fuzz, e.g. [0, 2e-6]) can contain the ONLY feasible
                # value strictly inside, and fixing to an endpoint
                # manufactures infeasibility
                width_ok = np.where(
                    is_int, cu - cl <= tol * (1.0 + np.abs(cl)),
                    cu - cl <= 1e-10 * (1.0 + np.abs(cl)))
                fixed = col_active & np.isfinite(cl) & np.isfinite(cu) & \
                    width_ok
            if has_semi:
                semi_mask = (integ == int(HighsVarType.kSemiContinuous)) \
                    | (integ == int(HighsVarType.kSemiInteger))
                fixed &= ~semi_mask
            for j in np.nonzero(fixed)[0]:
                xj = _snap_fix_value(0.5 * (cl[j] + cu[j]),
                                     cl[j], cu[j], tol)
                rows, vals = col_rows(j)
                stack.append(("fixed_col", int(j), float(xj),
                              float(cost[j]),
                              rows.copy(), vals.copy()))
                # move contribution into row bounds
                rl[rows] = np.where(np.isfinite(rl[rows]),
                                    rl[rows] - vals * xj, rl[rows])
                ru[rows] = np.where(np.isfinite(ru[rows]),
                                    ru[rows] - vals * xj, ru[rows])
                offset += cost[j] * xj
                col_active[j] = False
                changed = True

        rule("empty_col")
        # --- empty columns -----------------------------------------------
        if _rule_on(options, PresolveRuleType.kEmptyCol):
            # active col nnz after fixed-col removal
            col_nnz2 = matrix.col_counts(row_active, col_active)
            empty_c = col_active & (col_nnz2 == 0)
            for j in np.nonzero(empty_c)[0]:
                cj = sense * cost[j]  # minimization-sense cost
                if cj > tol:
                    if not np.isfinite(cl[j]):
                        unbounded = True
                        break
                    xj = cl[j]
                elif cj < -tol:
                    if not np.isfinite(cu[j]):
                        unbounded = True
                        break
                    xj = cu[j]
                else:
                    xj = np.clip(0.0, cl[j], cu[j])
                    if not np.isfinite(xj):
                        xj = cl[j] if np.isfinite(cl[j]) else (
                            cu[j] if np.isfinite(cu[j]) else 0.0)
                stack.append(("empty_col", int(j), float(xj),
                              float(cost[j])))
                offset += cost[j] * xj
                col_active[j] = False
                changed = True
            if unbounded:
                break

        rule("redundant_row")
        # --- redundant rows (activity-implied) ----------------------------
        if _rule_on(options, PresolveRuleType.kRedundantRow):
            # semi variables have domain {0} u [l, u]: their effective
            # activity bounds are [min(0, l), max(0, u)] — using the
            # raw bounds wrongly declared semi models infeasible
            # (reference instance 3015.mps)
            eff_cl, eff_cu = cl, cu
            if has_semi:
                eff_cl = np.where(semi_mask, np.minimum(cl, 0.0), cl)
                eff_cu = np.where(semi_mask, np.maximum(cu, 0.0), cu)
            lo_c = np.where(col_active & np.isfinite(eff_cl), eff_cl,
                            0.0)
            up_c = np.where(col_active & np.isfinite(eff_cu), eff_cu,
                            0.0)
            inf_lo = (~np.isfinite(eff_cl) & col_active).astype(
                np.float64)
            inf_up = (~np.isfinite(eff_cu) & col_active).astype(
                np.float64)
            minact, maxact, n_min_inf, n_max_inf = matrix.activity(
                lo_c, up_c, inf_lo, inf_up)
            min_ok = np.where(n_min_inf > 0, -np.inf, minact)
            max_ok = np.where(n_max_inf > 0, np.inf, maxact)
            # infeasibility check
            if np.any(row_active & (min_ok > ru + tol * (1 + np.abs(ru)))) \
                    or np.any(row_active &
                              (max_ok < rl - tol * (1 + np.abs(rl)))):
                infeasible = True
                break
            redundant = row_active & \
                (min_ok >= rl - tol * (1 + np.abs(rl))) & \
                (max_ok <= ru + tol * (1 + np.abs(ru)))
            # rows with no active entries (at the pass's start) are the
            # empty-row rule's
            redundant &= row_nnz > 0
            for i in np.nonzero(redundant)[0]:
                stack.append(("redundant_row", int(i)))
                row_active[i] = False
                changed = True

        rule("doubleton_eq")
        # --- doubleton equations ------------------------------------------
        # MIP-safe when the ELIMINATED variable is continuous: the
        # substitution y = (d - ax x)/ay is linear and keeps x's
        # integrality (reference HPresolve::doubletonEq handles the
        # integer cases by always substituting a continuous column
        # when one is present)
        if _rule_on(options, PresolveRuleType.kDoubletonEquation):
            row_nnz = matrix.row_counts(row_active, col_active)
            doubletons = np.nonzero(row_active & (row_nnz == 2) &
                                    np.isfinite(rl) & np.isfinite(ru) &
                                    (np.abs(ru - rl) <= tol))[0]
            # accumulated matrix edits, applied as ONE sparse add at
            # the end of the rule (the former whole-matrix LIL
            # round-trip was ~30% of presolve time).  Reads within the
            # rule use the pre-rule snapshot; the touched_rows /
            # touched_cols guards below ensure no doubleton reads an
            # entry another one modified.
            d_rows: List[int] = []
            d_cols: List[int] = []
            d_vals: List[float] = []
            # rows/cols whose snapshot entries became stale this pass:
            # doubletons touching them wait for the next pass
            touched_rows: set = set()
            touched_cols: set = set()
            for i in doubletons[:600]:
                if int(i) in touched_rows:
                    continue
                cols, vals = row_cols(i)
                if len(cols) != 2:
                    continue
                if int(cols[0]) in touched_cols or \
                        int(cols[1]) in touched_cols:
                    continue
                jx, jy = int(cols[0]), int(cols[1])
                ax_, ay_ = float(vals[0]), float(vals[1])
                if abs(ay_) < abs(ax_):
                    jx, jy = jy, jx
                    ax_, ay_ = ay_, ax_
                if is_mip:
                    # eliminate a continuous column only
                    y_int = bool(is_int[jy])
                    x_int = bool(is_int[jx])
                    if y_int and not x_int:
                        jx, jy = jy, jx
                        ax_, ay_ = ay_, ax_
                    elif y_int and x_int:
                        continue
                if abs(ay_) < 1e-10:
                    continue
                d = rl[i]
                # y = (d - ax x)/ay: update y's other rows and cost
                ratio = ax_ / ay_
                y_rows, y_vals = col_rows(jy)
                keep = y_rows != i
                y_rows_o, y_vals_o = y_rows[keep], y_vals[keep]
                x_rows, x_vals = col_rows(jx)
                stack.append((
                    "doubleton_eq", int(i), jx, jy, ax_, ay_, float(d),
                    float(cost[jy]), float(cl[jy]), float(cu[jy]),
                    float(cl[jx]), float(cu[jx]),
                    y_rows_o.copy(), y_vals_o.copy()))
                # fold y out of its other rows:
                # a_iy * y = a_iy*(d - ax x)/ay.  The jy entries need
                # no explicit zeroing: col_active[jy]=False masks them
                # out of every subsequent read and rebuild.
                for rr, vv in zip(y_rows_o, y_vals_o):
                    d_rows.append(int(rr))
                    d_cols.append(jx)
                    d_vals.append(-float(vv) * ratio)
                    shift = vv * d / ay_
                    if np.isfinite(rl[rr]):
                        rl[rr] -= shift
                    if np.isfinite(ru[rr]):
                        ru[rr] -= shift
                # bounds on x implied by bounds on y
                # y in [cl_y, cu_y] -> (d - ay*... ) x in ...
                if ratio != 0.0:
                    b1 = (d - ay_ * cl[jy]) / ax_
                    b2 = (d - ay_ * cu[jy]) / ax_
                    lo_x, up_x = (min(b1, b2), max(b1, b2))
                    cl[jx] = max(cl[jx], lo_x) if np.isfinite(lo_x) \
                        else cl[jx]
                    cu[jx] = min(cu[jx], up_x) if np.isfinite(up_x) \
                        else cu[jx]
                    if cl[jx] > cu[jx] + tol:
                        infeasible = True
                        break
                # objective: c_y*y = c_y*(d - ax x)/ay
                cost[jx] -= cost[jy] * ratio
                offset += cost[jy] * d / ay_
                cost[jy] = 0.0
                col_active[jy] = False
                row_active[i] = False
                touched_rows.add(int(i))
                touched_rows.update(int(r) for r in y_rows_o)
                touched_cols.add(jx)
                touched_cols.add(jy)
                changed = True
            if d_rows:
                delta = sp.csc_matrix(
                    (d_vals, (d_rows, d_cols)), shape=matrix.host.shape)
                matrix.replace((matrix.host + delta).tocsc())
                # substitutions rewrote matrix entries: new
                # cancellation candidates may exist, so re-arm the
                # sparsify scan even if a previous pass found nothing
                _sparsify_off[0] = False
            if infeasible:
                break

        rule("duplicate_row")
        # --- duplicate (parallel) rows ------------------------------------
        if _rule_on(options, PresolveRuleType.kParallelRowsAndCols):
            # candidate groups by a 64-bit multiset hash of each row's
            # (col, coeff/first-coeff) pairs, on the device; hash
            # collisions are screened out by the exact verification
            # below
            groups = matrix.parallel_rows(row_active, col_active)

            def _rows_parallel(i1, i2):
                c1, v1 = row_cols(i1)
                c2, v2 = row_cols(i2)
                if len(c1) != len(c2):
                    return False
                if not np.array_equal(c1, c2):
                    return False
                lam = v2[0] / v1[0]
                return bool(np.allclose(v2, lam * v1,
                                        rtol=1e-9, atol=1e-12))

            for rows_g, firsts_g in groups:
                i1, v1 = int(rows_g[0]), float(firsts_g[0])
                for i2, v2 in zip(rows_g[1:].tolist(),
                                  firsts_g[1:].tolist()):
                    if not _rows_parallel(i1, i2):
                        continue
                    lam = v2 / v1   # row2 = lam * row1
                    # row2 bounds expressed on row1's activity
                    b1, b2 = rl[i2] / lam, ru[i2] / lam
                    if lam < 0:
                        b1, b2 = b2, b1
                    old = (float(rl[i1]), float(ru[i1]),
                           float(rl[i2]), float(ru[i2]))
                    new_rl = max(rl[i1], b1)
                    new_ru = min(ru[i1], b2)
                    if new_rl > new_ru + tol * (1 + abs(new_rl)):
                        infeasible = True
                        break
                    stack.append(("duplicate_row", int(i1), int(i2),
                                  float(lam)) + old)
                    rl[i1], ru[i1] = new_rl, new_ru
                    row_active[i2] = False
                    changed = True
                if infeasible:
                    break
            if infeasible:
                break

        rule("duplicate_col")
        # --- duplicate (parallel) columns -----------------------------------
        # (reference kPresolveRuleParallelRowsAndCols, column side of
        # HPresolve::detectParallelRowsAndCols: columns with
        # a_k = s * a_j and c_k = s * c_j act only through
        # t = x_j + s x_k, so they merge into one variable whose box is
        # the Minkowski sum; postsolve splits t* back into the two
        # boxes.  Continuous columns only — integer merges need
        # lattice-compatibility conditions.)
        if _rule_on(options, PresolveRuleType.kParallelRowsAndCols) \
                and not infeasible and _pass < 2:
            # first two passes only: the vectorized hash scan costs
            # ~5-10ms and merges rarely cascade beyond pass 1
            cnnz = matrix.col_counts(row_active, col_active)
            mergeable = col_active & (cnnz >= 2) & ~is_int & ~semi_mask
            if np.count_nonzero(mergeable) >= 2:
                cgroups = matrix.parallel_cols(row_active, col_active,
                                               mergeable)

                def _cols_parallel(j1, j2):
                    r1, v1 = col_rows(j1)
                    r2, v2 = col_rows(j2)
                    if len(r1) != len(r2):
                        return None
                    if not np.array_equal(r1, r2):
                        return None
                    sc = v2[0] / v1[0]
                    if not np.isfinite(sc) or abs(sc) < 1e-8 or \
                            abs(sc) > 1e8:
                        return None
                    if not np.allclose(v2, sc * v1, rtol=1e-9,
                                       atol=1e-12):
                        return None
                    if abs(cost[j2] - sc * cost[j1]) > \
                            1e-9 * (1.0 + abs(cost[j2])):
                        return None
                    return float(sc)

                for members in cgroups:
                    j1 = int(members[0])
                    for j2 in members[1:].tolist():
                        if not col_active[j2] or not col_active[j1]:
                            continue
                        sc = _cols_parallel(j1, j2)
                        if sc is None:
                            continue
                        if sc > 0:
                            nl = cl[j1] + sc * cl[j2]
                            nu = cu[j1] + sc * cu[j2]
                        else:
                            nl = cl[j1] + sc * cu[j2]
                            nu = cu[j1] + sc * cl[j2]
                        if np.isnan(nl) or np.isnan(nu):
                            continue  # inf-inf: unbounded directions
                        stack.append(("dup_col", int(j1), int(j2),
                                      float(sc), float(cl[j1]),
                                      float(cu[j1]), float(cl[j2]),
                                      float(cu[j2])))
                        cl[j1], cu[j1] = nl, nu
                        col_active[j2] = False
                        changed = True

        rule("sparsify")
        # --- sparsify: cancel nonzeros with equality rows -------------------
        # (reference kPresolveRuleSparsify, HPresolve::sparsify: add
        # lambda * (equality row e) to row r when that nets fewer
        # nonzeros; feasible set unchanged.  Postsolve: equality-row-
        # addition replay  y_e += lambda * y_r.)
        if _rule_on(options, PresolveRuleType.kSparsify) and \
                not _sparsify_off[0] and (_pass < 2 or is_mip):
            # pure LPs: passes 0-1 only — later passes re-examine the
            # same candidates at ~5-10ms a pass for single-digit extra
            # cancellations.  MIPs keep every pass: the cancellations
            # measurably strengthen downstream cut separation
            # (sp150x300d root bound 68.4 vs 63.1 with the cap, a
            # 257-node vs 13k-node tree)
            row_nnz = matrix.row_counts(row_active, col_active)
            eq_rows = np.nonzero(row_active & (row_nnz >= 2) &
                                 (row_nnz <= 32) & np.isfinite(rl) &
                                 np.isfinite(ru) &
                                 (np.abs(ru - rl) <= tol))[0]
            # matrix edits accumulate as COO triplets (one sparse add
            # at rule end, replacing the whole-matrix LIL round-trip);
            # each target row r is edited at most once (stale guard),
            # so reads of row r always see the pre-rule snapshot
            s_rows: List[int] = []
            s_cols: List[int] = []
            s_vals: List[float] = []
            edits = 0
            examined = 0
            stale: set = set()
            col_nnz = matrix.col_counts(row_active, col_active) \
                if len(eq_rows) else None
            for e in eq_rows[:100]:
                if edits >= 50 or examined >= 600:
                    break
                if int(e) in stale:
                    continue
                ecols, evals = row_cols(e)
                if len(ecols) < 2:
                    continue
                # pivot on e's sparsest column (fewest other rows)
                degs = col_nnz[ecols]
                pivk = int(np.argmin(degs))
                j0 = int(ecols[pivk])
                v0 = float(evals[pivk])
                for r in col_rows(j0)[0]:
                    r = int(r)
                    if r == int(e) or not row_active[r] or r in stale:
                        continue
                    examined += 1
                    if examined >= 600:
                        break
                    # row_cols segments stay sorted (csr construction),
                    # so membership/value lookup is a searchsorted
                    rcols, rvals = row_cols(r)
                    kj0 = int(np.searchsorted(rcols, j0))
                    if kj0 >= len(rcols) or rcols[kj0] != j0:
                        continue
                    lam = -float(rvals[kj0]) / v0
                    if abs(lam) > 1e4 or abs(lam) < 1e-10:
                        continue
                    # nonzero delta: entries cancelled minus fill-in
                    kk = np.searchsorted(rcols, ecols)
                    kk_c = np.minimum(kk, len(rcols) - 1)
                    common = rcols[kk_c] == ecols
                    rv = rvals[kk_c[common]]
                    cancelled = int(np.count_nonzero(
                        np.abs(rv + lam * evals[common]) <=
                        1e-11 * np.maximum(1.0, np.abs(rv))))
                    fill = int(len(ecols) - np.count_nonzero(common))
                    if cancelled - fill < 1:
                        continue
                    s_rows.extend([r] * len(ecols))
                    s_cols.extend(int(c) for c in ecols)
                    s_vals.extend(float(lam) * float(v) for v in evals)
                    be = float(rl[e])
                    if np.isfinite(rl[r]):
                        rl[r] += lam * be
                    if np.isfinite(ru[r]):
                        ru[r] += lam * be
                    stack.append(("sparsify", int(r), int(e),
                                  float(lam)))
                    stale.add(r)
                    edits += 1
                    changed = True
                stale.add(int(e))
            if edits == 0:
                # a pass with zero cancellations will not find any on
                # the next pass either (the candidate set only shrinks)
                # — the scan itself costs ~5-10ms per pass
                _sparsify_off[0] = True
            if s_rows:
                delta = sp.csc_matrix(
                    (s_vals, (s_rows, s_cols)), shape=matrix.host.shape)
                summed = (matrix.host + delta).tocsr()
                # snap cancellation residue to exact zero on the edited
                # rows ONLY (the whole point of sparsify is that these
                # entries leave the structure; a global snap could drop
                # legitimate tiny coefficients elsewhere)
                for r in sorted(set(s_rows)):
                    s0, e0 = summed.indptr[r], summed.indptr[r + 1]
                    seg = summed.data[s0:e0]
                    seg[np.abs(seg) <= 1e-11] = 0.0
                summed.eliminate_zeros()
                matrix.replace(summed.tocsc())

        rule("dependent_eq")
        # --- dependent equations --------------------------------------------
        # (reference kPresolveRuleDependentEquations: Gaussian
        # elimination over the equality rows; a row reducing to zero is
        # redundant when its rhs also cancels, else infeasible.)
        if _rule_on(options, PresolveRuleType.kDependentEquations) and \
                _pass == 0:
            eq_rows = np.nonzero(
                row_active & np.isfinite(rl) & np.isfinite(ru) &
                (np.abs(ru - rl) <= tol) &
                (matrix.row_counts(row_active, col_active) > 0))[0]
            dense = None
            if 2 <= len(eq_rows) <= 300 and n <= 4000:
                dense = np.zeros((len(eq_rows), n))
                for t, i in enumerate(eq_rows):
                    cols_t, vals_t = row_cols(i)
                    dense[t, cols_t] = vals_t
                # fast path: one rank-revealing QR on the row block —
                # full row rank (the overwhelmingly common case) means
                # no dependent equations, skipping the O(k^2) python
                # elimination below entirely
                import warnings as _warn

                import scipy.linalg as _sla
                try:
                    # LU with partial pivoting (getrf) as the rank
                    # probe: if every |U_ii| is comfortably nonzero
                    # the rows are independent.  A suspicious probe
                    # (tiny pivot) falls through to the exact
                    # sequential elimination — false alarms cost time,
                    # never correctness.  A singular block is an
                    # EXPECTED probe outcome, not a warning.
                    with _warn.catch_warnings():
                        _warn.simplefilter("ignore")
                        _lu_u = _sla.lu_factor(dense.T)[0]
                    _k = min(_lu_u.shape)
                    _diag = np.abs(np.diagonal(_lu_u)[:_k])
                    _dmax = float(_diag.max()) if _diag.size else 0.0
                    if _k >= len(eq_rows) and _dmax > 0 and \
                            float(_diag.min()) > 1e-9 * _dmax:
                        dense = None  # full row rank: nothing to find
                except Exception:
                    pass
            if dense is not None:
                aug = np.concatenate(
                    [dense, rl[eq_rows, None]], axis=1)
                # incremental elimination: reduce each row against the
                # accepted pivot rows; zero rows are dependent
                pivots: List[Tuple[int, np.ndarray]] = []  # (col, row)
                for t, i in enumerate(eq_rows):
                    rvec = aug[t]
                    for (pc, pv) in pivots:
                        f = rvec[pc]
                        if f != 0.0:
                            rvec = rvec - f * pv
                    scale = np.max(np.abs(rvec[:-1]))
                    if scale <= 1e-10 * max(
                            1.0, float(np.max(np.abs(dense[t])))):
                        # coefficients vanished: consistent?
                        if abs(rvec[-1]) > 1e-7 * (
                                1.0 + abs(rl[i])):
                            infeasible = True
                            break
                        stack.append(("redundant_row", int(i)))
                        row_active[i] = False
                        changed = True
                        continue
                    pc = int(np.argmax(np.abs(rvec[:-1])))
                    pivots.append((pc, rvec / rvec[pc]))
                if infeasible:
                    break

        rule("forcing_row")
        # --- forcing rows --------------------------------------------------
        if _rule_on(options, PresolveRuleType.kForcingRow):
            # semi variables: effective activity bounds include 0, and
            # rows touching semi variables are excluded from forcing
            # (fixing a semi var "at its bound" has different
            # semantics)
            eff_cl, eff_cu = cl, cu
            if has_semi:
                eff_cl = np.where(semi_mask, np.minimum(cl, 0.0), cl)
                eff_cu = np.where(semi_mask, np.maximum(cu, 0.0), cu)
            lo_c = np.where(col_active & np.isfinite(eff_cl), eff_cl,
                            0.0)
            up_c = np.where(col_active & np.isfinite(eff_cu), eff_cu,
                            0.0)
            inf_lo = (~np.isfinite(eff_cl) & col_active).astype(float)
            inf_up = (~np.isfinite(eff_cu) & col_active).astype(float)
            minact, maxact, n_min_inf, n_max_inf = matrix.activity(
                lo_c, up_c, inf_lo, inf_up)
            if has_semi:
                touches_semi = matrix.row_counts(
                    row_active, col_active, cols=semi_mask) > 0
            else:
                touches_semi = np.zeros(m, dtype=bool)
            # forcing at upper: min activity == ru -> every var sits at
            # its activity-minimizing bound; mirrored for rl
            # forcing must be detected near-exactly: propagated bounds
            # carry +-feastol slack (probing union bounds especially),
            # and a feastol-wide trigger here turns almost-forcing rows
            # into invalid fixings (reference instance issue-2290.mps)
            ftol = 1e-9
            with np.errstate(invalid="ignore"):
                force_up = row_active & ~touches_semi & \
                    (n_min_inf == 0) & \
                    np.isfinite(ru) & \
                    (minact >= ru - ftol * (1 + np.abs(
                        np.where(np.isfinite(ru), ru, 0.0))))
                force_lo = row_active & ~touches_semi & \
                    (n_max_inf == 0) & \
                    np.isfinite(rl) & \
                    (maxact <= rl + ftol * (1 + np.abs(
                        np.where(np.isfinite(rl), rl, 0.0))))
            forced_cols: set = set()
            for i in np.nonzero(force_up | force_lo)[0]:
                cols, vals = row_cols(i)
                if len(cols) == 0:
                    continue
                if any(int(jj) in forced_cols for jj in cols):
                    continue  # activities stale: wait for next pass
                up_side = bool(force_up[i])
                fixed_js, fixed_vs, fixed_xs = [], [], []
                ok = True
                for jj, vv in zip(cols, vals):
                    xj = (cl[jj] if (vv > 0) == up_side else cu[jj])
                    if not np.isfinite(xj):
                        ok = False
                        break
                    fixed_js.append(int(jj))
                    fixed_vs.append(float(vv))
                    fixed_xs.append(float(xj))
                if not ok:
                    continue
                stack.append(("forcing_row", int(i),
                              np.array(fixed_js), np.array(fixed_vs),
                              np.array(fixed_xs), up_side,
                              cost[fixed_js].copy()))
                for jj, xj in zip(fixed_js, fixed_xs):
                    rows_j, vals_j = col_rows(jj)
                    keep = rows_j != i
                    rows_o, vals_o = rows_j[keep], vals_j[keep]
                    rl[rows_o] = np.where(np.isfinite(rl[rows_o]),
                                          rl[rows_o] - vals_o * xj,
                                          rl[rows_o])
                    ru[rows_o] = np.where(np.isfinite(ru[rows_o]),
                                          ru[rows_o] - vals_o * xj,
                                          ru[rows_o])
                    offset += cost[jj] * xj
                    col_active[jj] = False
                    forced_cols.add(jj)
                row_active[i] = False
                changed = True

        rule("free_col_sub")
        # --- free column singleton substitution ---------------------------
        if _rule_on(options, PresolveRuleType.kFreeColSubstitution):
            col_nnz3 = matrix.col_counts(row_active, col_active)
            cand = np.nonzero(col_active & (col_nnz3 == 1) &
                              ~np.isfinite(cl) & ~np.isfinite(cu) &
                              ~is_int)[0]
            done_rows: set = set()
            for j in cand:
                # j's one live entry; none once its row left in this rule
                rows_j, vals_j = col_rows(j)
                if len(rows_j) == 0:
                    continue
                i = int(rows_j[0])
                if i in done_rows or not row_active[i]:
                    continue
                if not (np.isfinite(rl[i]) and np.isfinite(ru[i]) and
                        abs(ru[i] - rl[i]) <= tol * (1 + abs(rl[i]))):
                    continue
                aij = float(vals_j[0])
                if abs(aij) < 1e-10:
                    continue
                cols_i, vals_i = row_cols(i)
                keep = cols_i != j
                oc, ov = cols_i[keep], vals_i[keep]
                d = float(rl[i])
                stack.append(("free_col_sub", int(j), int(i), aij, d,
                              float(cost[j]), oc.copy(), ov.copy()))
                # x_j = (d - sum ov*x)/aij: fold into costs
                ratio = cost[j] / aij
                cost[oc] -= ratio * ov
                offset += ratio * d
                cost[j] = 0.0
                col_active[j] = False
                row_active[i] = False
                done_rows.add(i)
                changed = True

        rule("aggregator")
        # --- implied-free column aggregation --------------------------------
        # (reference kPresolveRuleAggregator, HPresolve::aggregator
        # :463: substitute out a continuous column through an equality
        # row when the row itself implies the column's bounds — the
        # bounds can then never bind, so the substitution is exact for
        # primal AND dual.  This is the main reduction engine on
        # staircase LPs: greenbea's reference presolve removes ~600
        # more rows than the singleton/doubleton rules alone.)
        # NOTE: measured on the r4 suite, implied-free aggregation is a
        # net LOSS for this stack even when restricted to
        # net-nonzero-reducing substitutions (greenbea 1.23->1.49s,
        # stair 0.075->0.128s): the substituted structure costs our
        # dual simplex more per iteration than the removed rows save.
        # The rule ships default-off (presolve_aggregator) for parity
        # with the reference's aggregator; revisit if the LU adds
        # Markowitz ordering.
        if _rule_on(options, PresolveRuleType.kAggregator) and \
                getattr(options, "presolve_aggregator", False) and \
                not has_semi:
            a2r = matrix.live_csr(row_active, col_active)
            col_nnz4 = matrix.col_counts(row_active, col_active)
            # --- vectorized implied column bounds from single rows ---
            # (reference HPresolve::isImpliedFree via impliedRowBounds)
            lo_c4 = np.where(col_active & np.isfinite(cl), cl, 0.0)
            up_c4 = np.where(col_active & np.isfinite(cu), cu, 0.0)
            infl4 = (~np.isfinite(cl) & col_active).astype(float)
            infu4 = (~np.isfinite(cu) & col_active).astype(float)
            minact4, maxact4, nmin4, nmax4 = matrix.activity(
                lo_c4, up_c4, infl4, infu4)
            coo_r = np.repeat(np.arange(m), np.diff(a2r.indptr))
            coo_c = a2r.indices
            coo_v = a2r.data
            pos4 = coo_v > 0
            # own contribution to min/max activity (0 if own bound inf)
            own_lo_fin = np.isfinite(np.where(pos4, cl[coo_c],
                                              cu[coo_c]))
            own_up_fin = np.isfinite(np.where(pos4, cu[coo_c],
                                              cl[coo_c]))
            own_min = np.where(own_lo_fin, np.where(
                pos4, coo_v * cl[coo_c], coo_v * cu[coo_c]), 0.0)
            own_max = np.where(own_up_fin, np.where(
                pos4, coo_v * cu[coo_c], coo_v * cl[coo_c]), 0.0)
            o_min_inf = nmin4[coo_r] - (~own_lo_fin)
            o_max_inf = nmax4[coo_r] - (~own_up_fin)
            minact_o4 = minact4[coo_r] - own_min
            maxact_o4 = maxact4[coo_r] - own_max
            has_ru4 = np.isfinite(ru)[coo_r] & row_active[coo_r]
            has_rl4 = np.isfinite(rl)[coo_r] & row_active[coo_r]
            with np.errstate(invalid="ignore", divide="ignore"):
                iu = np.where(
                    pos4 & has_ru4 & (o_min_inf == 0),
                    (ru[coo_r] - minact_o4) / coo_v,
                    np.where(~pos4 & has_rl4 & (o_max_inf == 0),
                             (rl[coo_r] - maxact_o4) / coo_v, np.inf))
                il = np.where(
                    pos4 & has_rl4 & (o_max_inf == 0),
                    (rl[coo_r] - maxact_o4) / coo_v,
                    np.where(~pos4 & has_ru4 & (o_min_inf == 0),
                             (ru[coo_r] - minact_o4) / coo_v, -np.inf))
            imp_up4 = np.full(n, np.inf)
            np.minimum.at(imp_up4, coo_c, iu)
            imp_lo4 = np.full(n, -np.inf)
            np.maximum.at(imp_lo4, coo_c, il)
            # per-side tolerances from the FINITE quantities only (an
            # infinite implied bound must fail its test, not inflate
            # the tolerance to infinity)
            with np.errstate(invalid="ignore"):
                tl4 = tol * (1.0 + np.abs(np.where(np.isfinite(cl),
                                                   cl, 0.0)))
                tu4 = tol * (1.0 + np.abs(np.where(np.isfinite(cu),
                                                   cu, 0.0)))
                implied_free = (
                    (~np.isfinite(cl) | (imp_lo4 >= cl - tl4)) &
                    (~np.isfinite(cu) | (imp_up4 <= cu + tu4)))
            # candidates: implied-free continuous columns of small
            # degree (fill-in control) intersecting an equality row
            eq_mask4 = (row_active & np.isfinite(rl) & np.isfinite(ru)
                        & (np.abs(ru - rl) <= tol * (1 + np.abs(rl)))
                        ).astype(float)
            in_eq4 = matrix.col_counts(row_active, col_active,
                                       pos_rows=eq_mask4 > 0,
                                       neg_rows=eq_mask4 > 0) > 0
            cand = np.nonzero(col_active & ~is_int & implied_free &
                              in_eq4 &
                              (col_nnz4 >= 2) & (col_nnz4 <= 6))[0]
            g_rows: List[int] = []
            g_cols: List[int] = []
            g_vals: List[float] = []
            touched_r: set = set()
            touched_c: set = set()
            nsub = 0
            _ag_cap = 300
            _ag_fill = 0
            for j in cand:
                if nsub >= _ag_cap:
                    break
                if int(j) in touched_c or not col_active[j]:
                    continue
                rows_j, vals_j = col_rows(int(j))
                if len(rows_j) < 2 or \
                        any(int(r) in touched_r for r in rows_j):
                    continue
                # pick an equality pivot row with the largest |a_ej|
                best = -1
                best_v = 0.0
                for k, r in enumerate(rows_j):
                    r = int(r)
                    if not (np.isfinite(rl[r]) and np.isfinite(ru[r])
                            and abs(ru[r] - rl[r]) <=
                            tol * (1 + abs(rl[r]))):
                        continue
                    if abs(vals_j[k]) > abs(best_v):
                        best, best_v = k, float(vals_j[k])
                if best < 0 or abs(best_v) < 1e-8:
                    continue
                e_row = int(rows_j[best])
                cols_e, vals_e = row_cols(e_row)
                if any(int(c) in touched_c for c in cols_e):
                    continue
                # numerical pivot guard within the row
                if abs(best_v) < 0.01 * float(np.abs(vals_e).max()):
                    continue
                # EXACT fill accounting: the substitution removes row
                # e (len(cols_e) entries) and column j's other entries,
                # and adds row e's support into each other row of j.
                # Accept only net-nonzero-REDUCING substitutions — a
                # crude product cap let fill-positive substitutions
                # through and made every downstream simplex slower.
                if (len(rows_j) - 1) * (len(cols_e) - 1) > 16:
                    continue
                ke0 = cols_e != j
                oc0 = set(int(c) for c in cols_e[ke0])
                fill = 0
                removed = len(cols_e) + len(rows_j) - 1
                ok_fill = True
                for rr in rows_j:
                    rr = int(rr)
                    if rr == e_row:
                        continue
                    rc, _rv = row_cols(rr)
                    have = set(int(c) for c in rc)
                    fill += len(oc0 - have)
                    if fill >= removed + _ag_fill:
                        ok_fill = False
                        break
                if not ok_fill:
                    continue
                # implied-freeness already established by the
                # vectorized any-row test above
                ke = cols_e != j
                oc, ov = cols_e[ke], vals_e[ke]
                d = float(rl[e_row])
                # ---- substitute x_j out of its other rows ------------
                orj = np.array([int(r) for k, r in enumerate(rows_j)
                                if k != best], dtype=np.int64)
                orv = np.array([float(v) for k, v in enumerate(vals_j)
                                if k != best])
                lam = -orv / best_v
                if np.any(np.abs(lam) > 1e4):
                    continue
                stack.append(("agg_sub", int(j), e_row, best_v, d,
                              float(cost[j]), oc.copy(), ov.copy(),
                              orj.copy(), orv.copy()))
                for rr, lm in zip(orj, lam):
                    # row rr gains lam*(row e): delta on e's support
                    g_rows.extend([int(rr)] * (len(oc) + 1))
                    g_cols.extend(int(c) for c in oc)
                    g_cols.append(int(j))
                    g_vals.extend(float(lm) * float(v) for v in ov)
                    # cancel x_j's own entry exactly
                    g_vals.append(float(lm) * best_v)
                    shift = lm * d
                    if np.isfinite(rl[rr]):
                        rl[rr] += shift
                    if np.isfinite(ru[rr]):
                        ru[rr] += shift
                # objective: c_j x_j = c_j (d - sum ov x)/a_ej
                ratio = cost[j] / best_v
                cost[oc] -= ratio * ov
                offset += ratio * d
                cost[j] = 0.0
                col_active[j] = False
                row_active[e_row] = False
                touched_r.add(e_row)
                touched_r.update(int(r) for r in orj)
                touched_c.add(int(j))
                touched_c.update(int(c) for c in oc)
                nsub += 1
                changed = True
            if g_rows:
                delta = sp.csc_matrix(
                    (g_vals, (g_rows, g_cols)), shape=matrix.host.shape)
                summed = (matrix.host + delta).tocsr()
                # snap the exact cancellations of x_j's entries (and
                # any incidental cancellation) on the edited rows
                for r in sorted(set(g_rows)):
                    s0, e0 = summed.indptr[r], summed.indptr[r + 1]
                    seg = summed.data[s0:e0]
                    seg[np.abs(seg) <= 1e-11] = 0.0
                summed.eliminate_zeros()
                matrix.replace(summed.tocsc())

        rule("dominated_col")
        # --- dominated columns / dual fixing -------------------------------
        # (reference kPresolveRuleDominatedCol + HighsRedcostFixing-style
        # dual fixing inside presolve, HPresolve.cpp:394 dominatedCols)
        # Row dual sign ranges under min-sense:  y_i > 0 only if the row
        # can bind at its lower bound (finite rl); y_i < 0 only with
        # finite ru.  A column whose (A'y)_j is sign-forced has a
        # guaranteed reduced-cost sign => fix it at the matching bound.
        if _rule_on(options, PresolveRuleType.kDominatedCol) and \
                not has_semi:
            y_can_pos = np.isfinite(rl) & row_active
            y_can_neg = np.isfinite(ru) & row_active
            # counts per column of entries whose dual can push z_j down/up
            dn_breakers = matrix.col_counts(row_active, col_active,
                                            y_can_pos, y_can_neg)
            up_breakers = matrix.col_counts(row_active, col_active,
                                            y_can_neg, y_can_pos)
            cmin = sense * cost
            z_ge_c = dn_breakers == 0   # (A'y)_j <= 0 always => z_j >= c_j
            z_le_c = up_breakers == 0   # z_j <= c_j always
            fix_lo = col_active & z_ge_c & (cmin >= -tol)
            fix_up = col_active & z_le_c & (cmin <= tol) & ~fix_lo
            # strictly dominated with no finite bound => unbounded/infeas
            if np.any(fix_lo & (cmin > tol) & ~np.isfinite(cl)) or \
                    np.any(fix_up & (cmin < -tol) & ~np.isfinite(cu)):
                unbounded = True
                break
            fix_lo &= np.isfinite(cl)
            fix_up &= np.isfinite(cu)
            for j in np.nonzero(fix_lo | fix_up)[0]:
                # skip columns still touching stale rows this pass
                xj = float(cl[j] if fix_lo[j] else cu[j])
                rows_j, vals_j = col_rows(j)
                stack.append(("fixed_col", int(j), xj, float(cost[j]),
                              rows_j.copy(), vals_j.copy()))
                rl[rows_j] = np.where(np.isfinite(rl[rows_j]),
                                      rl[rows_j] - vals_j * xj,
                                      rl[rows_j])
                ru[rows_j] = np.where(np.isfinite(ru[rows_j]),
                                      ru[rows_j] - vals_j * xj,
                                      ru[rows_j])
                offset += cost[j] * xj
                col_active[j] = False
                changed = True

        rule("probing")
        # --- probing on binaries (MIP; reference kPresolveRuleProbing,
        # HPresolve probing + implication extraction) ----------------------
        if is_mip and _rule_on(options, PresolveRuleType.kProbing) and \
                _pass == 0 and not has_semi:
            binaries = np.nonzero(col_active & is_int &
                                  (cl == 0.0) & (cu == 1.0))[0]
            a2r = matrix.live_csr(row_active, col_active) \
                if len(binaries) else None
            if len(binaries) and a2r.nnz:
                from ..solvers.mip.propagate import Propagator
                # deactivated rows keep stale bounds; mask them to
                # free rows so the zeroed matrix rows stay redundant
                rl_act = np.where(row_active, rl, -np.inf)
                ru_act = np.where(row_active, ru, np.inf)
                prop = Propagator(a2r, rl_act, ru_act, is_int, tol)
                # probe the binaries appearing in the most rows first
                col_counts = matrix.col_counts(row_active, col_active)
                order = binaries[np.argsort(-col_counts[binaries])]
                n_fixed = 0
                for j in order[:100]:
                    if not col_active[j] or cl[j] == cu[j]:
                        continue
                    lo0, up0 = cl.copy(), cu.copy()
                    up0[j] = 0.0
                    ok0, l0, u0 = prop.propagate(lo0, up0, max_rounds=2)
                    lo1, up1 = cl.copy(), cu.copy()
                    lo1[j] = 1.0
                    ok1, l1, u1 = prop.propagate(lo1, up1, max_rounds=2)
                    if not ok0 and not ok1:
                        infeasible = True
                        break
                    if not ok0:
                        cl[j] = 1.0
                        changed = True
                        n_fixed += 1
                    elif not ok1:
                        cu[j] = 0.0
                        changed = True
                        n_fixed += 1
                    else:
                        # union bound strengthening over both branches.
                        # Continuous bounds are relaxed by feastol: the
                        # propagated values carry feastol fuzz, and
                        # applying them exactly lets the fixed-col rule
                        # close intervals onto fuzzy midpoints whose
                        # substitution errors compound into false
                        # infeasibilities (issue-2290.mps / 2122.lp)
                        new_l = np.minimum(l0, l1)
                        new_u = np.maximum(u0, u1)
                        with np.errstate(invalid="ignore"):
                            rel_l = np.where(
                                is_int, new_l,
                                new_l - 2 * tol * (1 + np.abs(new_l)))
                            rel_u = np.where(
                                is_int, new_u,
                                new_u + 2 * tol * (1 + np.abs(new_u)))
                        tighter = (rel_l > cl + tol) | (rel_u < cu - tol)
                        if np.any(tighter):
                            cl = np.maximum(cl, rel_l)
                            cu = np.minimum(cu, rel_u)
                            changed = True
                if infeasible:
                    break

        changed_any |= changed
        if not changed:
            break
    rule(None)

    if infeasible:
        return PresolveResult(HighsModelStatus.kInfeasible, lp,
                              stack=stack, reduced=False)
    if unbounded:
        return PresolveResult(HighsModelStatus.kUnbounded, lp,
                              stack=stack, reduced=False)
    if not changed_any:
        return PresolveResult(HighsModelStatus.kNotset, lp, reduced=False)

    # ---- build the reduced LP --------------------------------------------
    with span(timer, "presolve.build"):
        keep_rows = np.nonzero(row_active)[0]
        keep_cols = np.nonzero(col_active)[0]
        a_red = matrix.host_csr()[keep_rows][:, keep_cols].tocsc()
        # the host's matrix keeps the stored zeros the masks hid
        a_red.eliminate_zeros()
        reduced = HighsLp(
            num_col=len(keep_cols), num_row=len(keep_rows),
            col_cost=cost[keep_cols],
            col_lower=cl[keep_cols], col_upper=cu[keep_cols],
            row_lower=rl[keep_rows], row_upper=ru[keep_rows],
            a_matrix=HighsSparseMatrix.from_scipy(a_red),
            sense=lp.sense,
            # `offset` accumulated in the original cost space
            offset=lp.offset + offset,
            integrality=(integ[keep_cols]
                         if len(lp.integrality) else
                         np.zeros(0, dtype=np.uint8)))

    result = PresolveResult(HighsModelStatus.kNotset, reduced,
                            stack=stack, reduced=True)
    result.keep_rows = keep_rows
    result.keep_cols = keep_cols
    result.orig_num_row = m
    result.orig_num_col = n
    return result


def postsolve_rules(original_lp: HighsLp, pr: PresolveResult,
                    solution: HighsSolution,
                    reduced_basis=None):
    m, n = pr.orig_num_row, pr.orig_num_col
    x = np.zeros(n)
    z = np.zeros(n)
    y = np.zeros(m)
    have_dual = solution.dual_valid

    x[pr.keep_cols] = solution.col_value
    if have_dual:
        z[pr.keep_cols] = solution.col_dual
        y[pr.keep_rows] = solution.row_dual

    # best-effort basis mapping (marked alien: consumers repair it,
    # reference concept HighsBasis.alien)
    from ..constants import HighsBasisStatus as BS
    from ..models.solution import HighsBasis
    basis = None
    col_bs = None
    row_bs = None
    if reduced_basis is not None and getattr(reduced_basis, "valid",
                                             False):
        col_bs = [BS.kNonbasic] * n
        row_bs = [BS.kBasic] * m
        for local, orig in enumerate(pr.keep_cols):
            st = reduced_basis.col_status[local]
            # presolve may have TIGHTENED this column's bounds: a
            # nonbasic-at-bound status of the reduced LP can point at a
            # bound that is infinite in the original — remap to basic
            # (the variable rests at an interior value there)
            oj = int(orig)
            if st == BS.kLower and not np.isfinite(
                    original_lp.col_lower[oj]):
                st = BS.kBasic
            elif st == BS.kUpper and not np.isfinite(
                    original_lp.col_upper[oj]):
                st = BS.kBasic
            col_bs[oj] = st
        for local, orig in enumerate(pr.keep_rows):
            row_bs[int(orig)] = reduced_basis.row_status[local]

    cost = original_lp.col_cost
    sense = float(original_lp.sense)
    a_csc = original_lp.a_matrix.to_scipy().tocsc()
    a_csr = a_csc.tocsr()

    def set_col_status(j, xj):
        if col_bs is None:
            return
        lo_j, up_j = original_lp.col_lower[j], original_lp.col_upper[j]
        if np.isfinite(lo_j) and abs(xj - lo_j) <= 1e-8 * (1 + abs(lo_j)):
            col_bs[j] = BS.kLower
        elif np.isfinite(up_j) and abs(xj - up_j) <= 1e-8 * (1 + abs(up_j)):
            col_bs[j] = BS.kUpper
        elif not np.isfinite(lo_j) and not np.isfinite(up_j):
            col_bs[j] = BS.kZero if xj == 0.0 else BS.kBasic
        else:
            col_bs[j] = BS.kBasic

    for rec in reversed(pr.stack):
        kind = rec[0]
        if kind == "empty_row" or kind == "redundant_row":
            i = rec[1]
            y[i] = 0.0
            if row_bs is not None:
                row_bs[i] = BS.kBasic
        elif kind == "sparsify":
            # reduced row r was (a_r + lam a_e); in original terms the
            # equality row e absorbs lam * y_r (equality-row-addition
            # replay, reference HighsPostsolveStack kEqualityRowAddition)
            _, r, e, lam = rec
            if have_dual:
                y[e] += lam * y[r]
        elif kind == "singleton_row":
            (_, i, j, v, old_cl, old_cu, new_cl, new_cu,
             rl_i, ru_i) = rec
            # distribute the reduced cost between x's own bound and the
            # row dual so both keep valid signs (reference: singleton-row
            # postsolve in HighsPostsolveStack)
            if have_dual:
                zj = z[j]
                rv = v * x[j]
                eps_s = 1e-9 * (1.0 + abs(zj))
                tol_b = 1e-7
                at_row_lo = np.isfinite(rl_i) and \
                    abs(rv - rl_i) <= tol_b * (1 + abs(rl_i))
                at_row_up = np.isfinite(ru_i) and \
                    abs(rv - ru_i) <= tol_b * (1 + abs(ru_i))
                # validity must be judged against the TRUE original
                # bounds: presolve-tightened bounds are implied, and a
                # multiplier on an implied bound belongs to the rows
                # that implied it
                tcl = original_lp.col_lower[j]
                tcu = original_lp.col_upper[j]
                at_orig_lo = np.isfinite(tcl) and \
                    abs(x[j] - tcl) <= tol_b * (1 + abs(tcl))
                at_orig_up = np.isfinite(tcu) and \
                    abs(x[j] - tcu) <= tol_b * (1 + abs(tcu))
                y_cand = zj / v
                sy = sense * y_cand
                row_valid = ((at_row_lo and sy >= -eps_s) or
                             (at_row_up and sy <= eps_s))
                sz = sense * zj
                col_valid = ((at_orig_lo and sz >= -eps_s) or
                             (at_orig_up and sz <= eps_s) or
                             abs(zj) <= eps_s)
                if col_valid or not row_valid:
                    y[i] = 0.0
                    if row_bs is not None:
                        row_bs[i] = BS.kBasic
                else:
                    y[i] = y_cand
                    z[j] = 0.0
                    if row_bs is not None:
                        # slack leaves the basis at its active side; the
                        # column becomes basic
                        row_bs[i] = BS.kLower if at_row_lo else BS.kUpper
                        col_bs[j] = BS.kBasic
            elif row_bs is not None:
                row_bs[i] = BS.kBasic
        elif kind == "fixed_col":
            (_, j, xj, cj, rows, vals) = rec
            x[j] = xj
            if have_dual:
                # stationarity over the rows active at fixing time —
                # all of them are already recovered at this point of the
                # reverse replay; rows removed earlier replay later and
                # adjust z[j] themselves (e.g. singleton-row transfer)
                z[j] = cj - (float(vals @ y[rows]) if len(rows) else 0.0)
            set_col_status(j, xj)
        elif kind == "empty_col":
            (_, j, xj, cj) = rec
            x[j] = xj
            if have_dual:
                z[j] = cj
            set_col_status(j, xj)
        elif kind == "dup_col":
            # split the merged variable t = x_j + s x_k back into the
            # two original boxes; any split with x_k in [lk,uk] and
            # t - s x_k in [lj,uj] is optimal (costs/columns are
            # proportional), so prefer putting x_k at one of its own
            # bounds (keeps the basis vertex-like)
            (_, j, k, s, lj, uj, lk, uk) = rec
            t = float(x[j])
            tol9 = 1e-9 * (1.0 + abs(t))
            if s > 0:
                lo_k = (t - uj) / s if np.isfinite(uj) else -np.inf
                hi_k = (t - lj) / s if np.isfinite(lj) else np.inf
            else:
                lo_k = (t - lj) / s if np.isfinite(lj) else -np.inf
                hi_k = (t - uj) / s if np.isfinite(uj) else np.inf
            if np.isfinite(lk) and lk >= lo_k - tol9 and \
                    lk <= hi_k + tol9:
                xk = lk
            elif np.isfinite(uk) and uk >= lo_k - tol9 and \
                    uk <= hi_k + tol9:
                xk = uk
            else:
                xk = max(lk, lo_k)
                if not np.isfinite(xk):
                    xk = min(uk, hi_k)
                if not np.isfinite(xk):
                    xk = 0.0
                xk = min(max(xk, lk), uk)
            x[k] = xk
            x[j] = t - s * xk
            if have_dual:
                z[k] = s * z[j]
            set_col_status(k, xk)
            set_col_status(j, float(x[j]))
        elif kind == "doubleton_eq":
            (_, i, jx, jy, ax_, ay_, d, cy, cly, cuy, clx, cux,
             y_rows_o, y_vals_o) = rec
            x[jy] = (d - ax_ * x[jx]) / ay_
            if have_dual:
                # Two-case dual recovery (reference: doubleton-equation
                # postsolve in HighsPostsolveStack).  `other` = the
                # contribution of y's other rows (all already restored
                # by the reverse replay order).
                other = float(y_vals_o @ y[y_rows_o]) \
                    if len(y_rows_o) else 0.0
                at_orig = (x[jx] <= clx + 1e-8 * (1 + abs(clx)) or
                           x[jx] >= cux - 1e-8 * (1 + abs(cux)))
                if at_orig or abs(ax_) < 1e-12:
                    # multiplier stays on x's own bound: choose y_r so
                    # that z_x is unchanged, which forces z_y = 0
                    # (always sign-valid)
                    y[i] = (cy - other) / ay_
                    z[jy] = 0.0
                else:
                    # x is interior to its original bounds (it sat at a
                    # bound implied by y): move the multiplier onto y
                    zx = z[jx]
                    y[i] = zx / ax_ + (cy - other) / ay_
                    z[jy] = -(ay_ / ax_) * zx
                    z[jx] = 0.0
            if row_bs is not None:
                # equality row active: slack nonbasic at its fixed
                # value; the restored variable typically enters the
                # basis (alien repair fixes degenerate cases)
                row_bs[i] = BS.kLower
                set_col_status(jy, x[jy])
                if col_bs[jy] != BS.kBasic and have_dual and \
                        abs(z[jy]) <= 1e-9:
                    col_bs[jy] = BS.kBasic
        elif kind == "duplicate_row":
            (_, i1, i2, lam, rl1, ru1, rl2, ru2) = rec
            # the merged dual sits on i1; assign it to whichever
            # original row supplied the active bound
            if have_dual and abs(y[i1]) > 1e-12:
                act = float((a_csr[i1] @ x)[0])
                tol_b = 1e-7
                own_lo = np.isfinite(rl1) and \
                    abs(act - rl1) <= tol_b * (1 + abs(rl1))
                own_up = np.isfinite(ru1) and \
                    abs(act - ru1) <= tol_b * (1 + abs(ru1))
                if not (own_lo or own_up):
                    # bound came from row 2 (activity2 = lam * activity1)
                    y[i2] = y[i1] / lam
                    y[i1] = 0.0
                    if row_bs is not None:
                        act2 = lam * act
                        at2lo = np.isfinite(rl2) and \
                            abs(act2 - rl2) <= tol_b * (1 + abs(rl2))
                        row_bs[i2] = BS.kLower if at2lo else BS.kUpper
                        row_bs[i1] = BS.kBasic
                elif row_bs is not None:
                    row_bs[i2] = BS.kBasic
            elif row_bs is not None:
                row_bs[i2] = BS.kBasic
        elif kind == "forcing_row":
            (_, i, js, vs, xs, up_side, cjs) = rec
            for jj, xj in zip(js, xs):
                x[jj] = xj
            if have_dual:
                # pick y_i inside the sign-valid interval so every
                # fixed column's reduced cost  z_j = r_j - a_ij*y_i
                # keeps the sign its bound demands (reference:
                # forcing-row postsolve in HighsPostsolveStack)
                r = np.empty(len(js))
                for k, jj in enumerate(js):
                    s_, e_ = a_csc.indptr[jj], a_csc.indptr[jj + 1]
                    ridx = a_csc.indices[s_:e_]
                    rval = a_csc.data[s_:e_]
                    keep = ridx != i
                    r[k] = cjs[k] - float(rval[keep] @ y[ridx[keep]])
                lo_y, up_y = -np.inf, np.inf
                for k, (jj, vv, xj) in enumerate(zip(js, vs, xs)):
                    at_lo = (vv > 0) == up_side  # fixed at its lower bd
                    # min-sense: at lower -> sense*z >= 0,
                    #            at upper -> sense*z <= 0
                    want_nonneg = at_lo == (sense > 0)
                    if want_nonneg:
                        if vv > 0:
                            up_y = min(up_y, r[k] / vv)
                        else:
                            lo_y = max(lo_y, r[k] / vv)
                    else:
                        if vv > 0:
                            lo_y = max(lo_y, r[k] / vv)
                        else:
                            up_y = min(up_y, r[k] / vv)
                yi = float(np.clip(0.0, lo_y, up_y)) \
                    if lo_y <= up_y else 0.0
                y[i] = yi
                for k, (jj, vv) in enumerate(zip(js, vs)):
                    z[jj] = r[k] - vv * yi
            for jj, xj in zip(js, xs):
                set_col_status(int(jj), float(xj))
            if row_bs is not None:
                row_bs[i] = BS.kBasic if abs(y[i]) <= 1e-12 else (
                    BS.kUpper if up_side else BS.kLower)
        elif kind == "free_col_sub":
            (_, j, i, aij, d, cj, oc, ov) = rec
            x[j] = (d - (float(ov @ x[oc]) if len(oc) else 0.0)) / aij
            if have_dual:
                # stationarity of the (basic) free column: y_i = c_j/aij
                y[i] = cj / aij
                z[j] = 0.0
            if row_bs is not None:
                row_bs[i] = BS.kLower  # equality row active
                col_bs[j] = BS.kBasic
        elif kind == "agg_sub":
            # implied-free aggregation: x_j recovered from the pivot
            # equality row; its dual from x_j's stationarity across the
            # column's OTHER rows (whose duals are already recovered)
            (_, j, e_row, aej, d, cj, oc, ov, orj, orv) = rec
            x[j] = (d - (float(ov @ x[oc]) if len(oc) else 0.0)) / aej
            if have_dual:
                other = float(orv @ y[orj]) if len(orj) else 0.0
                y[e_row] = (cj - other) / aej
                z[j] = 0.0
            if row_bs is not None:
                row_bs[e_row] = BS.kLower  # equality row active
                col_bs[j] = BS.kBasic
        else:
            raise RuntimeError(f"unknown postsolve record {kind!r}")

    row_value = a_csr @ x if m else np.zeros(0)
    out_solution = HighsSolution(
        value_valid=True, dual_valid=have_dual,
        col_value=x, col_dual=z,
        row_value=row_value, row_dual=y)
    if col_bs is not None:
        # --- basis completeness repair -------------------------------
        # The replay is best-effort per rule; enforce the invariant
        # #basic == m before handing the basis out (reference: alien
        # bases are repaired on use, Highs::setBasis/formatted basis).
        num_basic = (sum(1 for s in col_bs if s == BS.kBasic) +
                     sum(1 for s in row_bs if s == BS.kBasic))
        if num_basic < m:
            # promote slacks of rows with (near) zero dual first — they
            # are unit columns, the safest additions
            for i in range(m):
                if num_basic >= m:
                    break
                if row_bs[i] != BS.kBasic and abs(y[i]) <= 1e-9:
                    row_bs[i] = BS.kBasic
                    num_basic += 1
            for j in range(n):
                if num_basic >= m:
                    break
                if col_bs[j] != BS.kBasic and abs(z[j]) <= 1e-9:
                    col_bs[j] = BS.kBasic
                    num_basic += 1
        elif num_basic > m:
            # demote basic columns resting exactly on a bound
            tol_b = 1e-9
            for j in range(n):
                if num_basic <= m:
                    break
                if col_bs[j] != BS.kBasic:
                    continue
                cl, cu = original_lp.col_lower[j], original_lp.col_upper[j]
                if np.isfinite(cl) and abs(x[j] - cl) <= tol_b * (
                        1 + abs(cl)):
                    col_bs[j] = BS.kLower
                    num_basic -= 1
                elif np.isfinite(cu) and abs(x[j] - cu) <= tol_b * (
                        1 + abs(cu)):
                    col_bs[j] = BS.kUpper
                    num_basic -= 1
        basis = HighsBasis(valid=True, alien=True,
                           col_status=col_bs, row_status=row_bs)
    return out_solution, basis
