"""Analysis / advanced API mixin: ranging, IIS, condition number,
basis files, feasibility relaxation, multi-objective optimization.

Reference behavior: Highs::getRanging (HighsRanging.cpp), Highs::getIis
(HighsIis.cpp deletion filter), getKappa (Highs.h:644), read/writeBasis
(HighsBasis file v2), feasibilityRelaxation (Highs.h:634),
multi-objective solve (HighsInterface.cpp:3940 blend/lexicographic).

The port's copy of the JAX package's mixin.  Every LP these methods
solve runs on the facade's device (the feasibility relaxation, the IIS's
feasibility LPs, the ill-conditioning LP); ranging, the basis solves and
κ are host scipy work on the model's data.  Only numerical and input
errors are answered with kError: an error of the device leaves the call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from .constants import (HighsBasisStatus, HighsModelStatus, HighsStatus,
                        IisBoundStatus, ObjSense, kHighsInf)
from .models.lp import HighsLp
from .models.solution import HighsBasis, HighsLinearObjective


def _drop_rows_outside(lp, keep_rows):
    """Copy of lp with every row OUTSIDE keep_rows made free."""
    work = lp.copy()
    keep = set(keep_rows)
    for i in range(lp.num_row):
        if i not in keep:
            work.row_lower[i] = -kHighsInf
            work.row_upper[i] = kHighsInf
    return work


@dataclasses.dataclass
class HighsIis:
    valid: bool = False
    strategy: int = 0
    col_index: List[int] = dataclasses.field(default_factory=list)
    row_index: List[int] = dataclasses.field(default_factory=list)
    col_bound: List[int] = dataclasses.field(default_factory=list)
    row_bound: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class HighsIllConditioningRecord:
    """One multiplier of the near-null basis combination (reference
    HStruct.h:149)."""
    index: int = 0
    multiplier: float = 0.0


@dataclasses.dataclass
class HighsIllConditioning:
    """Result of Highs.getIllConditioning (reference HStruct.h:154)."""
    record: List[HighsIllConditioningRecord] = dataclasses.field(
        default_factory=list)

    def clear(self):
        self.record.clear()


_BASIS_CHAR = {HighsBasisStatus.kLower: "L", HighsBasisStatus.kBasic: "B",
               HighsBasisStatus.kUpper: "U", HighsBasisStatus.kZero: "Z",
               HighsBasisStatus.kNonbasic: "N"}
_CHAR_BASIS = {v: k for k, v in _BASIS_CHAR.items()}


class HighsAnalysisApi:
    """Mixin over the Highs facade (self provides _model, _options,
    _solution, _basis, _model_status, run, ...)."""

    # ------------------------------------------------------------------
    # Ranging
    # ------------------------------------------------------------------
    def getRanging(self):
        """Return (status, HighsRanging).  Needs an optimal basis: if
        the last solve did not produce one, a simplex cleanup runs
        first (reference requires an optimal basic solution too)."""
        from .utils.ranging import compute_ranging
        if self._model_status != HighsModelStatus.kOptimal:
            return HighsStatus.kError, None
        if not self._basis.valid or self._basis.alien:
            from .solvers.simplex.wrapper import solve_lp_simplex
            status, solution, info = solve_lp_simplex(
                self._model.lp, self._options,
                basis=None, device=self._device)
            if status != HighsModelStatus.kOptimal or info.basis is None:
                return HighsStatus.kError, None
            self._solution = solution
            self._basis = info.basis
        ranging = compute_ranging(
            self._model.lp, self._solution, self._basis,
            self._info.objective_function_value)
        if not ranging.valid:
            return HighsStatus.kError, None
        return HighsStatus.kOk, ranging

    # ------------------------------------------------------------------
    # Condition number
    # ------------------------------------------------------------------
    def getKappa(self, exact: bool = False, report: bool = False):
        """1-norm condition estimate of the current basis matrix
        (reference Highs::getKappa)."""
        if not self._basis.valid:
            return HighsStatus.kError, None
        lp = self._model.lp
        m, n = lp.num_row, lp.num_col
        a = lp.a_matrix.to_scipy().tocsc()
        w = sp.hstack([a, -sp.identity(m, format="csc")], format="csc")
        statuses = list(self._basis.col_status) + \
            list(self._basis.row_status)
        basic = [j for j in range(n + m)
                 if statuses[j] == HighsBasisStatus.kBasic]
        if len(basic) != m:
            return HighsStatus.kError, None
        b_mat = w[:, basic].tocsc()
        try:
            if exact:
                b_dense = b_mat.toarray()
                kappa = float(np.linalg.cond(b_dense, 1))
            else:
                lu = spla.splu(b_mat)
                norm_b = spla.norm(b_mat, 1)
                # power-iteration-free estimate via a few solves
                x = np.ones(m) / m
                for _ in range(4):
                    x = lu.solve(x)
                    nx = np.abs(x).sum()
                    if nx == 0:
                        break
                    x /= nx
                norm_binv = np.abs(lu.solve(x)).sum() / max(
                    np.abs(x).sum(), 1e-30)
                kappa = float(norm_b * norm_binv)
        except (RuntimeError, ArithmeticError, ValueError,
                np.linalg.LinAlgError):
            # scipy and numpy only: a singular basis (splu) or a bad
            # input, no device work in the block
            return HighsStatus.kError, None
        return HighsStatus.kOk, kappa

    # ------------------------------------------------------------------
    # Basis files (reference v2 format-compatible layout)
    # ------------------------------------------------------------------
    def getIllConditioning(self, constraint: bool, method: int = 0,
                           ill_conditioning_bound: float = 1e-4):
        """Ill-conditioning analysis of the current basis matrix
        (reference Highs::getIllConditioning / computeIllConditioning,
        lp_data/HighsInterface.cpp:3206, Highs.h:644-751).

        Finds a near-null combination of the basis: method 0 minimizes
        ||B'y||_1 (constraint view) or ||By||_1 (column view) subject
        to e'y = 1; method 1 (Klotz14) minimizes ||y||_1 subject to
        ||B'y||_1 <= ill_conditioning_bound and e'y = 1 (may be
        infeasible when the bound is too small — returns kOk with an
        empty record, matching the reference's early-out).

        Returns (status, HighsIllConditioning, measure): records hold
        (index, multiplier) with multipliers normalized to unit 1-norm
        and sorted by decreasing magnitude; measure is the estimated
        1-norm distance of B from singularity."""
        b_mat, var_index = self._basis_matrix()
        if b_mat is None:
            return HighsStatus.kError, None, None
        m = b_mat.shape[0]
        if m == 0:
            return HighsStatus.kError, None, None
        from .highs import Highs as _H
        from .models.lp import HighsLp, HighsSparseMatrix
        op = b_mat.T.tocsc() if constraint else b_mat.tocsc()
        cond = _H(device=self._device)
        cond.setOptionValue("output_flag", False)
        if method == 0:
            # min e'(s+t)  s.t.  Op y - s + t = 0,  e'y = 1
            amat = sp.vstack([
                sp.hstack([op, -sp.identity(m), sp.identity(m)]),
                sp.hstack([sp.csr_matrix(np.ones((1, m))),
                           sp.csr_matrix((1, 2 * m))])]).tocsc()
            lp2 = HighsLp(
                num_col=3 * m, num_row=m + 1,
                col_cost=np.concatenate(
                    [np.zeros(m), np.ones(2 * m)]),
                col_lower=np.concatenate(
                    [np.full(m, -np.inf), np.zeros(2 * m)]),
                col_upper=np.full(3 * m, np.inf),
                row_lower=np.concatenate([np.zeros(m), [1.0]]),
                row_upper=np.concatenate([np.zeros(m), [1.0]]),
                a_matrix=HighsSparseMatrix.from_scipy(amat))
            cond.passModel(lp2)
            cond.run()
            if cond.getModelStatus() != HighsModelStatus.kOptimal:
                return HighsStatus.kError, None, None
            sol = np.asarray(cond.getSolution().col_value)
            y = sol[:m]
            resid_norm = float(
                cond.getInfo().objective_function_value)
        else:
            # min e'(u+w)  s.t.  Op y - s + t = 0,  y - u + w = 0,
            #                    e'y = 1,  e'(s+t) <= bound
            amat = sp.vstack([
                sp.hstack([op, -sp.identity(m), sp.identity(m),
                           sp.csr_matrix((m, 2 * m))]),
                sp.hstack([sp.identity(m), sp.csr_matrix((m, 2 * m)),
                           -sp.identity(m), sp.identity(m)]),
                sp.hstack([sp.csr_matrix(np.ones((1, m))),
                           sp.csr_matrix((1, 4 * m))]),
                sp.hstack([sp.csr_matrix((1, m)),
                           sp.csr_matrix(np.ones((1, 2 * m))),
                           sp.csr_matrix((1, 2 * m))])]).tocsc()
            lp2 = HighsLp(
                num_col=5 * m, num_row=2 * m + 2,
                col_cost=np.concatenate(
                    [np.zeros(3 * m), np.ones(2 * m)]),
                col_lower=np.concatenate(
                    [np.full(m, -np.inf), np.zeros(4 * m)]),
                col_upper=np.full(5 * m, np.inf),
                row_lower=np.concatenate(
                    [np.zeros(2 * m), [1.0], [-np.inf]]),
                row_upper=np.concatenate(
                    [np.zeros(2 * m), [1.0],
                     [float(ill_conditioning_bound)]]),
                a_matrix=HighsSparseMatrix.from_scipy(amat))
            cond.passModel(lp2)
            cond.run()
            st2 = cond.getModelStatus()
            if st2 == HighsModelStatus.kInfeasible:
                # bound insufficient for analysis (reference logs and
                # returns kOk with nothing extracted)
                return HighsStatus.kOk, HighsIllConditioning(), None
            if st2 != HighsModelStatus.kOptimal:
                return HighsStatus.kError, None, None
            sol = np.asarray(cond.getSolution().col_value)
            y = sol[:m]
            resid_norm = float(np.abs(sol[m:2 * m]).sum() +
                               np.abs(sol[2 * m:3 * m]).sum())
        norm1 = float(np.abs(y).sum())
        if norm1 <= 0:
            return HighsStatus.kError, None, None
        measure = resid_norm / norm1
        out = HighsIllConditioning()
        mult = y / norm1
        order = np.argsort(np.abs(mult))[::-1]
        for i in order:
            if abs(mult[i]) <= 1e-6:
                continue
            out.record.append(
                HighsIllConditioningRecord(int(i), float(mult[i])))
        return HighsStatus.kOk, out, measure

    def writeBasis(self, filename: str) -> HighsStatus:
        if not self._basis.valid:
            return HighsStatus.kError
        lp = self._model.lp
        lines = ["HiGHS v2"]
        lines.append("Valid")
        lines.append(f"# Columns {lp.num_col}")
        lines.append(" ".join(str(int(s)) for s in
                              self._basis.col_status))
        lines.append(f"# Rows {lp.num_row}")
        lines.append(" ".join(str(int(s)) for s in
                              self._basis.row_status))
        with open(filename, "w") as f:
            f.write("\n".join(lines) + "\n")
        return HighsStatus.kOk

    def readBasis(self, filename: str) -> HighsStatus:
        lp = self._model.lp
        try:
            with open(filename) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        except OSError:
            return HighsStatus.kError
        if not lines or not lines[0].startswith("HiGHS"):
            return HighsStatus.kError
        if len(lines) < 6 or lines[1] != "Valid":
            return HighsStatus.kError
        try:
            col_status = [HighsBasisStatus(int(t))
                          for t in lines[3].split()]
            row_status = [HighsBasisStatus(int(t))
                          for t in lines[5].split()]
        except (ValueError, IndexError):
            return HighsStatus.kError
        if len(col_status) != lp.num_col or len(row_status) != lp.num_row:
            return HighsStatus.kError
        self._basis = HighsBasis(valid=True, col_status=col_status,
                                 row_status=row_status)
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # Feasibility relaxation (elastic programming)
    # ------------------------------------------------------------------
    def feasibilityRelaxation(self, global_lower_penalty: float = 1.0,
                              global_upper_penalty: float = 1.0,
                              global_rhs_penalty: float = 1.0,
                              local_lower_penalty=None,
                              local_upper_penalty=None,
                              local_rhs_penalty=None) -> HighsStatus:
        """Solve the elastic relaxation minimizing weighted violations
        (reference Highs::feasibilityRelaxation Highs.h:634): negative
        penalty means the bound may not be violated."""
        lp = self._model.lp
        m, n = lp.num_row, lp.num_col
        lower_pen = (np.asarray(local_lower_penalty)
                     if local_lower_penalty is not None
                     else np.full(n, global_lower_penalty))
        upper_pen = (np.asarray(local_upper_penalty)
                     if local_upper_penalty is not None
                     else np.full(n, global_upper_penalty))
        rhs_pen = (np.asarray(local_rhs_penalty)
                   if local_rhs_penalty is not None
                   else np.full(m, global_rhs_penalty))

        a = lp.a_matrix.to_scipy().tocsc()
        blocks = [a]
        costs = [lp.col_cost.copy()]
        lowers = [lp.col_lower.copy()]
        uppers = [lp.col_upper.copy()]

        # row elastics: L - p <= Ax <= U + q (column-bound elastics are
        # representable by first moving bounds into singleton rows)
        elastic_cols = []
        elastic_cost = []
        for i in range(m):
            if rhs_pen[i] >= 0:
                elastic_cols.append((i, +1.0))
                elastic_cost.append(rhs_pen[i])
                elastic_cols.append((i, -1.0))
                elastic_cost.append(rhs_pen[i])
        if elastic_cols:
            data = [v for _, v in elastic_cols]
            rows = [i for i, _ in elastic_cols]
            cols = list(range(len(elastic_cols)))
            e_mat = sp.csc_matrix(
                (data, (rows, cols)), shape=(m, len(elastic_cols)))
            blocks.append(e_mat)
            costs.append(np.asarray(elastic_cost))
            lowers.append(np.zeros(len(elastic_cols)))
            uppers.append(np.full(len(elastic_cols), kHighsInf))

        big_a = sp.hstack(blocks, format="csc")
        from .models.lp import HighsSparseMatrix
        relaxed = HighsLp(
            num_col=big_a.shape[1], num_row=m,
            col_cost=np.concatenate(costs),
            col_lower=np.concatenate(lowers),
            col_upper=np.concatenate(uppers),
            row_lower=lp.row_lower.copy(), row_upper=lp.row_upper.copy(),
            a_matrix=HighsSparseMatrix.from_scipy(big_a),
            sense=ObjSense.kMinimize, offset=lp.offset)
        from .solvers.dispatch import solve_lp
        status, solution, info = solve_lp(relaxed, self._options,
                                          presolve=False,
                                          device=self._device)
        if solution.value_valid:
            from .models.solution import HighsSolution
            self._solution = HighsSolution(
                value_valid=True, dual_valid=False,
                col_value=solution.col_value[:n],
                row_value=(lp.a_matrix.to_scipy() @
                           solution.col_value[:n]) if m else np.zeros(0))
            self._model_status = status
            self._fill_info_lp(lp, info)
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # IIS (deletion filter)
    # ------------------------------------------------------------------
    def getIis(self):
        """Return (status, HighsIis) for an infeasible LP.

        Strategy bits (reference HConst.h:291-301, HighsIis.cpp):
        - light (0): deletion filter over the rows
        - kIisStrategyFromRay (1): Farkas-ray support pre-filters the
          candidate rows before the deletion filter
        - kIisStrategyIrreducible (4): additionally run the deletion
          filter over COLUMN bounds so the subsystem is irreducible
        - kIisStrategyColPriority (8): process column bounds before
          rows
        - kIisStrategyRelaxation (16): seed the candidate order from
          the elastic feasibility relaxation (violated rows first)
        """
        lp = self._model.lp
        iis = HighsIis(strategy=self._options.iis_strategy)
        if self._model_status == HighsModelStatus.kNotset:
            self.run()
        if self._model_status != HighsModelStatus.kInfeasible:
            return HighsStatus.kOk, iis  # empty IIS: model feasible

        import copy as _copy
        opts = _copy.copy(self._options)
        strategy = int(self._options.iis_strategy)
        from .solvers.classify import build_primal_feasibility_lp
        from .solvers.ipm.wrapper import solve_lp_ipm

        def is_infeasible(test_lp) -> bool:
            feas = build_primal_feasibility_lp(test_lp)
            st, _, info = solve_lp_ipm(feas, opts, device=self._device)
            if st != HighsModelStatus.kOptimal:
                return False
            return info.primal_obj > 1e-7 * (1.0 + abs(info.primal_obj))

        work = lp.copy()
        candidate_rows = list(range(lp.num_row))
        if strategy & 1:  # from-ray: restrict to the Farkas support
            # getDualRay answers (has_ray, ray); the JAX package compares
            # has_ray with HighsStatus.kOk (0), so its from-ray filter
            # never runs when there is a ray
            has_ray, ray = self.getDualRay()
            if has_ray and ray is not None and len(ray) == lp.num_row:
                sup = [i for i in candidate_rows
                       if abs(float(ray[i])) > 1e-9]
                if sup and is_infeasible(_drop_rows_outside(lp, sup)):
                    # the filter works on the support alone: the rows
                    # outside it are free (left in place, they would let
                    # the filter drop rows the subsystem needs)
                    candidate_rows = sup
                    work = _drop_rows_outside(lp, sup)
        if strategy & 16:  # relaxation seeding: violated rows first
            try:
                st_r, viol_rows = self._elastic_violated_rows()
                if st_r:
                    vs = set(viol_rows)
                    candidate_rows = sorted(
                        candidate_rows,
                        key=lambda i: (i not in vs, i))
                    candidate_rows.reverse()  # drop unviolated first
            except (ArithmeticError, ValueError, np.linalg.LinAlgError,
                    torch.linalg.LinAlgError):
                pass  # a numerical failure keeps the plain row order

        def filter_cols():
            """Deletion filter over column bounds (irreducible)."""
            kept_cols = []
            for j in range(lp.num_col):
                saved = (work.col_lower[j], work.col_upper[j])
                if not (np.isfinite(saved[0]) or np.isfinite(saved[1])):
                    continue
                work.col_lower[j] = -kHighsInf
                work.col_upper[j] = kHighsInf
                if is_infeasible(work):
                    continue
                work.col_lower[j], work.col_upper[j] = saved
                kept_cols.append(j)
            return kept_cols

        kept_bound_cols = None
        if (strategy & 8) and (strategy & 4):
            kept_bound_cols = filter_cols()  # col-priority: cols first
        kept: List[int] = []
        for i in candidate_rows:
            saved = (work.row_lower[i], work.row_upper[i])
            work.row_lower[i] = -kHighsInf
            work.row_upper[i] = kHighsInf
            if is_infeasible(work):
                continue  # row not needed for infeasibility
            work.row_lower[i], work.row_upper[i] = saved
            kept.append(i)
        kept.sort()
        if (strategy & 4) and kept_bound_cols is None:
            kept_bound_cols = filter_cols()
        iis.valid = True
        iis.row_index = kept
        for i in kept:
            lo_fin = np.isfinite(lp.row_lower[i])
            up_fin = np.isfinite(lp.row_upper[i])
            if lo_fin and up_fin:
                iis.row_bound.append(int(IisBoundStatus.kIisBoundStatusBoxed))
            elif lo_fin:
                iis.row_bound.append(int(IisBoundStatus.kIisBoundStatusLower))
            else:
                iis.row_bound.append(int(IisBoundStatus.kIisBoundStatusUpper))
        cols = set()
        a_csr = lp.a_matrix.to_scipy().tocsr()
        for i in kept:
            cols.update(int(c) for c in
                        a_csr.indices[a_csr.indptr[i]:a_csr.indptr[i + 1]])
        iis.col_index = sorted(cols)
        if kept_bound_cols is not None:
            kb = set(kept_bound_cols)
            iis.col_bound = []
            for j in iis.col_index:
                if j not in kb:
                    iis.col_bound.append(
                        int(IisBoundStatus.kIisBoundStatusFree))
                    continue
                lo_f = np.isfinite(work.col_lower[j])
                up_f = np.isfinite(work.col_upper[j])
                iis.col_bound.append(int(
                    IisBoundStatus.kIisBoundStatusBoxed if lo_f and up_f
                    else IisBoundStatus.kIisBoundStatusLower if lo_f
                    else IisBoundStatus.kIisBoundStatusUpper))
        else:
            iis.col_bound = [int(IisBoundStatus.kIisBoundStatusNull)] \
                * len(iis.col_index)
        return HighsStatus.kOk, iis

    def _elastic_violated_rows(self):
        """Rows with positive elastic violation in the feasibility
        relaxation (seed ordering for kIisStrategyRelaxation)."""
        from .solvers.classify import build_primal_feasibility_lp
        from .solvers.ipm.wrapper import solve_lp_ipm
        import copy as _copy
        lp = self._model.lp
        feas = build_primal_feasibility_lp(lp)
        st, sol, info = solve_lp_ipm(feas, _copy.copy(self._options),
                                     device=self._device)
        if st != HighsModelStatus.kOptimal or not sol.value_valid:
            return False, []
        if not len(sol.row_value):
            return False, []
        act = np.asarray(sol.row_value)[:lp.num_row]
        viol = np.maximum(lp.row_lower - act, 0.0) + \
            np.maximum(act - lp.row_upper, 0.0)
        viol = np.where(np.isfinite(viol), viol, 0.0)
        return True, [int(i) for i in np.nonzero(viol > 1e-7)[0]]

    # ------------------------------------------------------------------
    # Multi-objective
    # ------------------------------------------------------------------
    def addLinearObjective(self, obj: HighsLinearObjective,
                           iObj: int = -1) -> HighsStatus:
        if len(obj.coefficients) != self._model.lp.num_col:
            return HighsStatus.kError
        if not hasattr(self, "_linear_objectives"):
            self._linear_objectives: List[HighsLinearObjective] = []
        if iObj < 0 or iObj >= len(self._linear_objectives):
            self._linear_objectives.append(obj)
        else:
            self._linear_objectives.insert(iObj, obj)
        return HighsStatus.kOk

    def passLinearObjectives(self, objectives) -> HighsStatus:
        self._linear_objectives = list(objectives)
        return HighsStatus.kOk

    def clearLinearObjectives(self) -> HighsStatus:
        self._linear_objectives = []
        return HighsStatus.kOk

    def _has_multi_objectives(self) -> bool:
        return bool(getattr(self, "_linear_objectives", []))

    def _multiobjective_solve(self) -> HighsStatus:
        """Blend by weight or lexicographic by priority
        (reference HighsInterface.cpp:3940 multiobjectiveSolve)."""
        objs = self._linear_objectives
        lp = self._model.lp
        if self._options.blend_multi_objectives:
            cost = np.zeros(lp.num_col)
            offset = 0.0
            for o in objs:
                cost += o.weight * np.asarray(o.coefficients)
                offset += o.weight * o.offset
            saved_cost = lp.col_cost.copy()
            saved_off = lp.offset
            saved_sense = lp.sense
            lp.col_cost = cost
            lp.offset = offset
            lp.sense = ObjSense.kMinimize
            status = self._call_solve_lp() if not self._model.is_mip() \
                else self._call_solve_mip()
            lp.col_cost = saved_cost
            lp.offset = saved_off
            lp.sense = saved_sense
            return status
        # lexicographic: solve in decreasing priority, then constrain
        order = sorted(range(len(objs)),
                       key=lambda k: -objs[k].priority)
        saved_cost = lp.col_cost.copy()
        saved_off = lp.offset
        saved_sense = lp.sense
        added_rows = 0
        status = HighsStatus.kOk
        for pos, k in enumerate(order):
            o = objs[k]
            lp.col_cost = np.asarray(o.coefficients, dtype=np.float64)
            lp.offset = o.offset
            lp.sense = ObjSense.kMinimize if o.weight >= 0 else \
                ObjSense.kMaximize
            status = self._call_solve_lp() if not self._model.is_mip() \
                else self._call_solve_mip()
            if self._model_status != HighsModelStatus.kOptimal:
                break
            if pos == len(order) - 1:
                break  # no constraint needed after the last objective
            value = self._info.objective_function_value
            # constrain this objective near its optimum
            tol_abs = o.abs_tolerance if o.abs_tolerance >= 0 else 0.0
            tol_rel = o.rel_tolerance if o.rel_tolerance >= 0 else 0.0
            slack = tol_abs + tol_rel * abs(value)
            coeffs = np.asarray(o.coefficients)
            nz = np.nonzero(coeffs)[0]
            if lp.sense == ObjSense.kMinimize:
                self.addRow(-kHighsInf, value - o.offset + slack,
                            len(nz), nz, coeffs[nz])
            else:
                self.addRow(value - o.offset - slack, kHighsInf,
                            len(nz), nz, coeffs[nz])
            added_rows += 1
        # remove the temporary rows, restoring the last solve's results
        # (detach result objects first: invalidation mutates in place)
        from .info import HighsInfo as _Info
        from .models.solution import HighsSolution as _Sol
        final_solution = self._solution
        final_status = self._model_status
        final_info = self._info
        self._solution = _Sol()
        self._info = _Info()
        if added_rows:
            nrow = lp.num_row
            self.deleteRows(nrow - added_rows, nrow - 1)
        lp.col_cost = saved_cost
        lp.offset = saved_off
        lp.sense = saved_sense
        self._solution = final_solution
        self._model_status = final_status
        self._info = final_info
        return status
    # ------------------------------------------------------------------
    # Basis solves (reference Highs.h basis-solve block: getBasicVariables,
    # getBasisInverseRow/Col, getBasisSolve, getBasisTransposeSolve,
    # getReducedRow/Column; tests check/TestBasisSolves.cpp)
    # ------------------------------------------------------------------
    def _basis_matrix(self):
        """Build B from the stored basis: basic structural columns of A
        plus slack columns -e_i for basic rows (HiGHS convention: the
        logical for row i has coefficient -1, matching Ax - s = 0)."""
        if not self._basis.valid:
            return None, None
        lp = self._model.lp
        m = lp.num_row
        basic_cols = [j for j in range(lp.num_col)
                      if int(self._basis.col_status[j]) ==
                      int(HighsBasisStatus.kBasic)]
        basic_rows = [i for i in range(m)
                      if int(self._basis.row_status[i]) ==
                      int(HighsBasisStatus.kBasic)]
        if len(basic_cols) + len(basic_rows) != m:
            return None, None
        a = lp.a_matrix.to_scipy().tocsc()
        blocks = []
        if basic_cols:
            blocks.append(a[:, basic_cols])
        if basic_rows:
            sl = sp.csc_matrix(
                (-np.ones(len(basic_rows)),
                 (basic_rows, np.arange(len(basic_rows)))),
                shape=(m, len(basic_rows)))
            blocks.append(sl)
        b_mat = sp.hstack(blocks).tocsc() if blocks else \
            sp.csc_matrix((m, m))
        # variable index of each basic column: structural j, logical n+i
        var_index = basic_cols + [lp.num_col + i for i in basic_rows]
        return b_mat, var_index

    def getBasicVariables(self):
        """Returns the basic variable list: structural j >= 0, row i
        encoded as -(i+1) (reference Highs_getBasicVariables)."""
        b_mat, var_index = self._basis_matrix()
        if var_index is None:
            return HighsStatus.kError, []
        n = self._model.lp.num_col
        coded = [v if v < n else -(v - n + 1) for v in var_index]
        return HighsStatus.kOk, coded

    def _basis_lu(self):
        b_mat, var_index = self._basis_matrix()
        if b_mat is None:
            return None, None
        try:
            return spla.splu(b_mat.tocsc()), var_index
        except RuntimeError:
            return None, var_index

    def getBasisSolve(self, rhs):
        """Solve B x = rhs (reference Highs::getBasisSolve)."""
        lu, _ = self._basis_lu()
        if lu is None:
            return HighsStatus.kError, np.zeros(0)
        return HighsStatus.kOk, lu.solve(np.asarray(rhs,
                                                    dtype=np.float64))

    def getBasisTransposeSolve(self, rhs):
        """Solve B' x = rhs."""
        lu, _ = self._basis_lu()
        if lu is None:
            return HighsStatus.kError, np.zeros(0)
        return HighsStatus.kOk, lu.solve(
            np.asarray(rhs, dtype=np.float64), trans="T")

    def getBasisInverseRow(self, row: int):
        """Row `row` of B^-1 (solve B' x = e_row)."""
        m = self._model.lp.num_row
        e = np.zeros(m)
        e[row] = 1.0
        return self.getBasisTransposeSolve(e)

    def getBasisInverseCol(self, col: int):
        """Column `col` of B^-1 (solve B x = e_col)."""
        m = self._model.lp.num_row
        e = np.zeros(m)
        e[col] = 1.0
        return self.getBasisSolve(e)

    def getReducedRow(self, row: int):
        """Row `row` of B^-1 A (reference Highs::getReducedRow)."""
        status, binv_row = self.getBasisInverseRow(row)
        if status != HighsStatus.kOk:
            return status, np.zeros(0)
        a = self._model.lp.a_matrix.to_scipy().tocsc()
        return HighsStatus.kOk, np.asarray(a.T @ binv_row)

    def getReducedColumn(self, col: int):
        """Column `col` of B^-1 A (solve B x = A e_col)."""
        a = self._model.lp.a_matrix.to_scipy().tocsc()
        rhs = np.asarray(a[:, col].todense()).ravel()
        return self.getBasisSolve(rhs)
