"""MIP branch-and-bound solver.

Re-implementation of the reference MIP layer (highs/mip/HighsMipSolver.cpp
run loop, HighsSearch.cpp evaluateNode/branch, HighsDomain propagation,
HighsPseudocost), on the host with the native engines of `native/`:

- node relaxations of at most 10,000 rows solve in the hot-started
  native dual simplex, and the tree search runs in the native
  branch-and-bound (`hx_mip_solve`); larger relaxations solve every
  node LP with the normal-equations IPM on the solver's torch device,
  which also runs the root's analytic centre (central rounding), the
  elastic infeasibility check and the root's PDLP retry;
- domain propagation (propagate.py) runs in the native worklist
  propagator;
- pseudocost branching with most-fractional fallback
  (mip_pscost_minreliable reliability threshold);
- best-bound node selection with depth-first plunging;
- rounding + fix-and-repair primal heuristics at the root and during
  the dive;
- semi-continuous / semi-integer variables branch on the {0} vs [l, u]
  disjunction (reference: semi-variable handling in
  HighsLpRelaxation/HighsSearch).

Statuses/limits follow the reference: mip_rel_gap/mip_abs_gap,
mip_max_nodes, objective bound/target, time limit.  Every device solve
shares the MIP's deadline.  The solver reads no environment variable:
the JAX package's developer switches keep their defaults here.  A
native library that will not load raises, and so does a device error:
handlers catch only the numerical trouble of a heuristic.
"""
from __future__ import annotations

import copy as _copy
import ctypes as _ct
import dataclasses
import heapq
import math
import threading as _thr
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as _sp
import torch

from ...constants import (HighsCallbackType as CbT,
                          HighsModelStatus, HighsVarType,
                          kHighsInf)
from ...models.lp import HighsLp
from ...models.solution import HighsSolution
from ...device import resolve_device
from ...models.lp import HighsSparseMatrix
from ...options import HighsOptions
from ...utils.integers import integral_scale
from ...utils.timer import span
from ..classify import build_primal_feasibility_lp
from ..ipm.solver import solve_lp_ipm_native
from ..pdlp.wrapper import solve_lp_pdlp
from ..simplex import dual_native as _dn
from ..simplex.native import (RESULT_INFEASIBLE, RESULT_OPTIMAL,
                              RESULT_UNBOUNDED, _ruiz_scales,
                              simplex_solve)
from . import heuristics as heur
from .feasibility_jump import feasibility_jump
from .propagate import Propagator, strengthen_coefficients

# the numerical failures a heuristic's own linear algebra may raise,
# which end that heuristic and not the solve (a torch device error, a
# RuntimeError, is not among them)
_NUMERICAL = (ArithmeticError, ValueError, np.linalg.LinAlgError)
# node relaxations of at most this many rows solve in the native simplex
# engines (the dense basis inverse fits); larger ones in the IPM
SIMPLEX_MAX_ROWS = 10000


@dataclasses.dataclass
class MipRunInfo:
    status: HighsModelStatus = HighsModelStatus.kNotset
    iterations: int = 0
    mip_node_count: int = 0
    mip_dual_bound: float = -math.inf
    mip_gap: float = math.inf
    primal_obj: float = math.inf
    solve_time: float = 0.0


@dataclasses.dataclass(order=True)
class _Node:
    bound: float
    seq: int
    lo: np.ndarray = dataclasses.field(compare=False)
    up: np.ndarray = dataclasses.field(compare=False)
    depth: int = dataclasses.field(compare=False, default=0)
    # branching metadata for pseudocost updates at child-LP solve time
    branch_j: int = dataclasses.field(compare=False, default=-1)
    branch_dir: int = dataclasses.field(compare=False, default=0)
    branch_frac: float = dataclasses.field(compare=False, default=0.0)
    parent_obj: float = dataclasses.field(compare=False, default=0.0)
    basis: object = dataclasses.field(compare=False, default=None)
    # generation of the Propagator whose fixpoint (lo, up) is: child
    # propagation may seed incrementally from the branched columns only
    # when the propagator has not been rebuilt since (cut rows added)
    prop_gen: int = dataclasses.field(compare=False, default=0)
    # a batched-evaluator result (converged, dual_bound, x) for this node
    cached: object = dataclasses.field(compare=False, default=None)


class _Pseudocost:
    """Per-variable branching history (reference HighsPseudocost.cpp)."""

    def __init__(self, n: int, min_reliable: int):
        self.up_sum = np.zeros(n)
        self.up_cnt = np.zeros(n, dtype=np.int64)
        self.dn_sum = np.zeros(n)
        self.dn_cnt = np.zeros(n, dtype=np.int64)
        self.min_reliable = min_reliable

    def update(self, j: int, direction: int, frac: float, degrade: float):
        rate = max(degrade, 0.0) / max(frac, 1e-6)
        if direction > 0:
            self.up_sum[j] += rate
            self.up_cnt[j] += 1
        else:
            self.dn_sum[j] += rate
            self.dn_cnt[j] += 1

    def score(self, j: int, frac_dn: float, frac_up: float,
              avg_up: float, avg_dn: float) -> float:
        pc_up = (self.up_sum[j] / self.up_cnt[j]
                 if self.up_cnt[j] > 0 else avg_up)
        pc_dn = (self.dn_sum[j] / self.dn_cnt[j]
                 if self.dn_cnt[j] > 0 else avg_dn)
        eps = 1e-6
        return max(pc_dn * frac_dn, eps) * max(pc_up * frac_up, eps)

    def reliable(self, j: int) -> bool:
        return (self.up_cnt[j] >= self.min_reliable and
                self.dn_cnt[j] >= self.min_reliable)

    def averages(self):
        # default 1.0 so that, with no history, the score degrades to
        # the most-fractional rule f_dn * f_up
        up = (self.up_sum.sum() / self.up_cnt.sum()
              if self.up_cnt.sum() > 0 else 1.0)
        dn = (self.dn_sum.sum() / self.dn_cnt.sum()
              if self.dn_cnt.sum() > 0 else 1.0)
        return max(up, 1e-6), max(dn, 1e-6)


def solve_mip(lp: HighsLp, options: HighsOptions, log=None,
              callbacks: Optional[Dict] = None, device=None
              ) -> Tuple[HighsModelStatus, HighsSolution, MipRunInfo]:
    """Branch-and-cut on `lp`; every relaxation solved by a device
    solver (the IPM, PDLP) runs on `device` (default CUDA)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    # ---- per-stage MIP clocks (reference mip/MipTimer.h ~60 clocks;
    # read back with Highs.writeAllClocks / log_dev_level>=2) ----------
    _timer = getattr(options, "_timer", None)

    def _clk(name):
        return span(_timer, "mip::" + name)
    info = MipRunInfo()
    sense = float(lp.sense)
    feastol = options.mip_feasibility_tolerance

    integ = (np.asarray(lp.integrality)
             if len(lp.integrality) == lp.num_col
             else np.zeros(lp.num_col, dtype=np.uint8))
    is_int = (integ == int(HighsVarType.kInteger)) | (
        integ == int(HighsVarType.kSemiInteger))
    is_semi = (integ == int(HighsVarType.kSemiContinuous)) | (
        integ == int(HighsVarType.kSemiInteger))

    # --- relaxation template (continuous LP with node bounds) -------------
    relax = lp.copy()
    relax.integrality = np.zeros(0, dtype=np.uint8)
    # semi variables relax to [min(0, l), u]
    root_lo = lp.col_lower.copy()
    root_up = lp.col_upper.copy()
    root_lo = np.where(is_semi, np.minimum(0.0, root_lo), root_lo)

    # SOS sets (reference: SOS branching in HighsSearch): members
    # sorted by weight; SOS1 = at most one nonzero, SOS2 = at most two,
    # adjacent in weight order
    sos_sets = []
    for typ, _pri, scols, sweights in getattr(lp, "sos", []):
        order = np.argsort(np.asarray(sweights, dtype=np.float64))
        members = np.asarray(scols, dtype=np.int64)[order]
        sos_sets.append((2 if str(typ).upper().endswith("2") else 1,
                         members))

    def sos_first_violated(x):
        """Index of the first violated SOS set, or -1."""
        for si, (styp, members) in enumerate(sos_sets):
            nz = np.nonzero(np.abs(x[members]) > feastol)[0]
            if styp == 1 and len(nz) > 1:
                return si
            if styp == 2 and (len(nz) > 2 or
                              (len(nz) == 2 and nz[1] != nz[0] + 1)):
                return si
        return -1

    a_csr = lp.a_matrix.to_scipy().tocsr()
    prop = Propagator(a_csr, lp.row_lower, lp.row_upper, is_int, feastol)

    node_options = _copy.copy(options)
    # device solves share the MIP's deadline (the IPM and PDLP stop at
    # it), so one node LP cannot outlast the MIP's time limit
    node_options._solve_deadline = t0 + options.time_limit

    # node relaxations: hot-started native simplex when the dense basis
    # inverse fits (the reference's node engine is hot-started dual
    # simplex, HighsLpRelaxation); IPM otherwise
    use_simplex = lp.num_row <= SIMPLEX_MAX_ROWS
    mip_feastol = feastol

    # mutable relaxation state: root cut separation appends globally
    # valid cut rows (reference: HighsLpRelaxation row management)
    class _Relax:
        a_csc = lp.a_matrix.to_scipy().tocsc() if use_simplex else None
        row_lower = lp.row_lower
        row_upper = lp.row_upper
        num_cut_rows = 0
        _scale_key = None
        _scales = None
        _scaled_a = None
        _eng_key = None
        _eng = None

    def relax_scales():
        """Ruiz factors for the CURRENT relaxation matrix, cached per
        matrix version (computing them per node solve dominated node
        time on well-scaled instances)."""
        a = _Relax.a_csc
        if a is None:
            return None
        key = (id(a), a.shape, a.nnz)
        if _Relax._scale_key != key:
            _Relax._scale_key = key
            _Relax._scales = _ruiz_scales(a)
            if _Relax._scales is not None:
                r_, c_ = _Relax._scales
                _Relax._scaled_a = (_sp.diags(r_) @ a @
                                    _sp.diags(c_)).tocsc()
            else:
                _Relax._scaled_a = None
        return _Relax._scales

    # ---- symmetry handling (reference HighsSymmetry.cpp: generators ->
    # orbits / orbital fixing; here: verified generators -> first-row lex
    # symmetry-breaking rows + orbit-wide bound sharing) -----------------
    sym_orbit = None
    sym_gens = None
    orbitope_fix_cols: list = []
    _sub_level_early = int(getattr(options, "_sub_mip_level", 0))
    if options.mip_detect_symmetry and bool(is_int.any()) and \
            use_simplex and lp.num_col <= 5000 and \
            _sub_level_early == 0 and \
            int(getattr(options, "_mip_restart_count", 0)) == 0:
        # sub-MIPs and RESTARTED solves skip detection: the restart
        # model is a shrunk copy whose orbits rarely differ, and
        # re-detection+verification cost ~0.3s per restart (gesa2 x3)
        from ...presolve.symmetry import (detect_symmetry, orbits,
                                          symmetry_breaking_rows)
        # budget scales with model size: a deep IR dive costs ~30ms per
        # generator in Python, and on small models (sp150x300d) 16
        # generators cost more than the whole reference solve while
        # orbital branching buys nothing (measured: identical node
        # counts with symmetry off across the whole anchored suite) —
        # larger models get proportionally more search
        _sym_budget = min(2.0, 0.05 * options.time_limit,
                          max(0.1, 2e-5 * lp.a_matrix.num_nz))
        gens = detect_symmetry(
            lp, max_generators=16, time_budget=_sym_budget)
        if gens:
            # packing/partitioning orbitopes (reference
            # HighsSymmetry.h:58-126): staircase-fix the lex-max
            # representative at the root.  Generators touching fixed
            # variables are dropped from orbital branching — composing
            # both symmetry cuts on the same group can cut every
            # optimum.
            from ...presolve.symmetry import (detect_packing_orbitopes,
                                              orbitope_fixings)
            _otopes = detect_packing_orbitopes(lp, gens)
            _ofix = orbitope_fixings(_otopes, lp.num_col)
            if _ofix:
                orbitope_fix_cols.extend(_ofix)
                _fixset = set(_ofix)
                gens = [g for g in gens
                        if not any(int(j) in _fixset or
                                   int(g[j]) in _fixset
                                   for j in np.nonzero(
                                       g != np.arange(lp.num_col))[0])]
                if log is not None:
                    log(f"MIP symmetry: {len(_otopes)} packing "
                        f"orbitope(s), {len(_ofix)} lex fixings")
        if gens:
            sym_orbit = orbits(gens, lp.num_col)
            # the native search uses ORBITAL BRANCHING from the raw
            # generators (reference HighsSymmetry orbital fixing);
            # lex symmetry-breaking ROWS would conflict with it (both
            # cut symmetric counterparts, together they can cut every
            # optimum), so the rows are only added on the Python path
            sym_gens = gens
            pairs = ([] if getattr(options, "tpu_mip_native_search",
                                   False)
                     else symmetry_breaking_rows(gens, lp.num_col))
            if pairs:
                data, rows_ix, cols_ix = [], [], []
                for r, (j, k) in enumerate(pairs):
                    data += [1.0, -1.0]
                    rows_ix += [r, r]
                    cols_ix += [j, k]
                sym_rows = _sp.csc_matrix(
                    (data, (rows_ix, cols_ix)),
                    shape=(len(pairs), lp.num_col))
                _Relax.a_csc = _sp.vstack(
                    [_Relax.a_csc, sym_rows]).tocsc()
                _Relax.row_lower = np.concatenate(
                    [_Relax.row_lower, np.zeros(len(pairs))])
                _Relax.row_upper = np.concatenate(
                    [_Relax.row_upper, np.full(len(pairs), kHighsInf)])
                if log is not None:
                    log(f"MIP symmetry: {len(gens)} generators, "
                        f"{len(pairs)} symmetry-breaking rows")

    def apply_orbit_bounds(lo, up):
        """Implied bounds are symmetry-invariant: share the tightest
        bound across each orbit (orbital fixing generalization)."""
        if sym_orbit is None:
            return lo, up
        lo = lo.copy()
        up = up.copy()
        for orb in np.unique(sym_orbit):
            members = np.nonzero(sym_orbit == orb)[0]
            if len(members) < 2:
                continue
            lo[members] = lo[members].max()
            up[members] = up[members].min()
        return lo, up

    _elastic = {"key": None, "a": None, "scales": None,
                "scaled_a": None}

    def elastic_lp():
        """Elastic matrix [A I -I] + its Ruiz factors, cached per
        relaxation-matrix version (rebuilding + re-equilibrating per
        infeasibility check dominated node time)."""
        a = _Relax.a_csc
        key = (id(a), a.shape, a.nnz)
        if _elastic["key"] != key:
            mm = a.shape[0]
            ident = _sp.identity(mm, format="csc")
            a_el = _sp.hstack([a, ident, -ident]).tocsc()
            _elastic["key"] = key
            _elastic["a"] = a_el
            _elastic["scales"] = _ruiz_scales(a_el)
            if _elastic["scales"] is not None:
                r_, c_ = _elastic["scales"]
                _elastic["scaled_a"] = (_sp.diags(r_) @ a_el @
                                        _sp.diags(c_)).tocsc()
            else:
                _elastic["scaled_a"] = None
        return _elastic["a"], _elastic["scales"], _elastic["scaled_a"]

    def confirm_infeasible(lo, up) -> bool:
        """Elastic feasibility LP:  min 1's  s.t.
        rl <= Ax + p - q <= ru, p,q >= 0.  Always feasible, so the
        native engine's phase-1 drift heuristics never fire; its
        optimum certifies (in)feasibility of the node box.  A false
        'infeasible' at a node silently loses the MIP optimum
        (reference analogue: unscaled-feasibility guards in
        HighsLpRelaxation), so every infeasible verdict is confirmed."""
        a = _Relax.a_csc
        mm = a.shape[0]
        a_el, el_scales, el_scaled = elastic_lp()
        cost = np.concatenate([np.zeros(lp.num_col), np.ones(2 * mm)])
        lo_el = np.concatenate([lo, np.zeros(2 * mm)])
        up_el = np.concatenate([up, np.full(2 * mm, np.inf)])
        remaining_el = max(1.0, options.time_limit -
                           (time.perf_counter() - t0))
        result, x, y, z, b, iters = simplex_solve(
            a_el, cost, lo_el, up_el, _Relax.row_lower,
            _Relax.row_upper, tol_p=1e-9, tol_d=1e-9, max_iter=100000,
            time_limit=min(remaining_el, 1e18), scales=el_scales,
            scaled_matrix=el_scaled)
        info.iterations += iters
        if result != RESULT_OPTIMAL:
            return None  # inconclusive: keep the node
        # exact per-row check of the elastic point: a row counts as
        # violated only beyond feastol relative to its own activity
        # magnitude (absolute thresholds misfire both ways: tiny
        # masses on small-rhs instances, solver noise on rows with
        # 1e4-magnitude coefficients)
        x_str = np.clip(x[:lp.num_col], lo, up)
        act = a @ x_str
        act_scale = 1.0 + np.abs(act)
        v_lo = np.where(np.isfinite(_Relax.row_lower),
                        _Relax.row_lower - act, 0.0)
        v_up = np.where(np.isfinite(_Relax.row_upper),
                        act - _Relax.row_upper, 0.0)
        viol = np.maximum(np.maximum(v_lo, v_up), 0.0)
        if np.all(viol <= feastol * act_scale):
            # feasible within tolerance: hand back the point so the
            # caller can keep the node without a device fallback
            return x_str
        return True

    def relax_engine():
        """Persistent native dual-simplex engine for the CURRENT
        relaxation matrix (reference: HighsLpRelaxation keeps one
        hot-started dual simplex per worker).  Rebuilt only when the
        cut loop changes the matrix.  Returns (engine, r, c) with the
        Ruiz factors used (None, None when unscaled)."""
        a = _Relax.a_csc
        key = (id(a), a.shape, a.nnz)
        if _Relax._eng_key != key:
            sc = relax_scales()
            if sc is not None:
                r_, c_ = sc
                a_use = _Relax._scaled_a
                cost_use = sense * lp.col_cost * c_
                rl = np.asarray(_Relax.row_lower, float)
                ru = np.asarray(_Relax.row_upper, float)
                rl_use = np.where(np.isfinite(rl), rl * r_, rl)
                ru_use = np.where(np.isfinite(ru), ru * r_, ru)
            else:
                r_ = c_ = None
                a_use = a
                cost_use = sense * lp.col_cost
                rl_use = np.asarray(_Relax.row_lower, float)
                ru_use = np.asarray(_Relax.row_upper, float)
            if _Relax._eng is not None:
                _Relax._eng.close()
            _Relax._eng = _dn.DualEngine(
                a_use, a_use.tocsr(), cost_use,
                np.full(lp.num_col, -np.inf), np.full(lp.num_col,
                                                      np.inf),
                rl_use, ru_use)
            if r_ is not None:
                # absolute-unscaled feasibility on scaled data
                _Relax._eng.set_tol_scale(
                    np.concatenate([1.0 / c_, r_]))
            _Relax._eng_key = key
            _Relax._eng_sc = (r_, c_)
        return _Relax._eng, _Relax._eng_sc[0], _Relax._eng_sc[1]

    last_duals = {"z": None}

    def solve_node_lp(lo, up, warm_basis=None, cached=None):
        with _clk("node_lp"):
            return _solve_node_lp_impl(lo, up, warm_basis, cached)

    def _solve_node_lp_impl(lo, up, warm_basis=None, cached=None):
        """Returns (feasible, obj_minimize, x, basis) for the node
        relaxation.  Reduced costs of the last solve are stashed in
        last_duals["z"] (for reduced-cost fixing).  `cached` carries a
        batched-evaluator result (converged, dual_bound, x)."""
        last_duals["z"] = None
        if cached is not None:
            converged, dual_bound, xc = cached
            if converged and xc is not None:
                return True, dual_bound, xc, None
            # fall through to the exact engine
        if use_simplex:
            remaining = max(1.0, options.time_limit -
                            (time.perf_counter() - t0))
            # hot path: the persistent native dual engine (reference:
            # HighsLpRelaxation hot-started dual simplex).  Its
            # infeasible verdicts are internally re-verified on a
            # fresh factorization, so no elastic confirmation needed.
            eng, r_sc, c_sc = relax_engine()
            lo_e = lo / c_sc if c_sc is not None else lo
            up_e = up / c_sc if c_sc is not None else up
            eng.set_col_bounds(lo_e, up_e)
            if warm_basis is not None:
                eng.set_basis(warm_basis)
            result, x, y, z, basis_out, iters = eng.solve(
                tol_p=1e-9, tol_d=1e-9, max_iter=100000,
                time_limit=min(remaining, 1e18))
            info.iterations += iters
            if result == _dn.RESULT_OPTIMAL:
                if c_sc is not None:
                    x = x * c_sc
                    y = y * r_sc
                    z = z / c_sc
                last_duals["z"] = z
                return True, float(sense * lp.col_cost @ x), x, basis_out
            if result == _dn.RESULT_INFEASIBLE:
                return False, math.inf, None, None
            if result == _dn.RESULT_UNBOUNDED:
                return True, -math.inf, None, None
            # NEED_PRIMAL / SINGULAR / iteration trouble: the primal
            # engine handles cold starts and phase-1 shapes
            result, x, y, z, basis_out, iters = simplex_solve(
                _Relax.a_csc, sense * lp.col_cost, lo, up,
                _Relax.row_lower, _Relax.row_upper, basis_in=warm_basis,
                tol_p=1e-9, tol_d=1e-9, max_iter=100000,
                time_limit=min(remaining, 1e18),
                scales=relax_scales(),
                scaled_matrix=_Relax._scaled_a)
            info.iterations += iters
            if result not in (RESULT_OPTIMAL, RESULT_UNBOUNDED) and \
                    warm_basis is not None:
                # warm start went bad (or claims infeasible): retry cold
                # before falling back / trusting the claim
                result, x, y, z, basis_out, iters = simplex_solve(
                    _Relax.a_csc, sense * lp.col_cost, lo, up,
                    _Relax.row_lower, _Relax.row_upper, basis_in=None,
                    tol_p=1e-9, tol_d=1e-9, max_iter=100000,
                    scales=relax_scales(),
                    scaled_matrix=_Relax._scaled_a)
                info.iterations += iters
            if result == RESULT_OPTIMAL:
                last_duals["z"] = z
                return True, float(sense * lp.col_cost @ x), x, basis_out
            if result == RESULT_INFEASIBLE:
                conf = confirm_infeasible(lo, up)
                if conf is True:
                    return False, math.inf, None, None
                if conf is not None:
                    # borderline: the elastic LP certified tolerance-
                    # level feasibility and produced a point — keep
                    # the node with a trivial bound, no device
                    # fallback needed
                    return True, -math.inf, np.asarray(conf), None
                # inconclusive: numerical trouble — fall through to
                # the device solvers for a usable iterate
            elif result == RESULT_UNBOUNDED:
                return True, -math.inf, None, None
            # numerical failure: fall through to IPM below

        # device-solver fallback runs on the CURRENT relaxation rows
        # (original + strengthened + cut rows) — solving the cut-free
        # `relax` here silently collapses node bounds to the bare LP
        node_lp = relax
        if use_simplex and _Relax.num_cut_rows:
            node_lp = relax.copy()
            node_lp.a_matrix = HighsSparseMatrix.from_scipy(
                _Relax.a_csc)
            node_lp.row_lower = np.asarray(_Relax.row_lower, float)
            node_lp.row_upper = np.asarray(_Relax.row_upper, float)
            node_lp.num_row = _Relax.a_csc.shape[0]
            if getattr(node_lp, "row_names", None):
                node_lp.row_names = []
        node_lp.col_lower = lo
        node_lp.col_upper = up
        st, sol, lp_info = solve_lp_ipm_native(node_lp, node_options,
                                               device=device)
        info.iterations += lp_info.iterations
        if st == HighsModelStatus.kOptimal:
            if sol.dual_valid and len(sol.col_dual):
                last_duals["z"] = sense * np.asarray(sol.col_dual)
            return True, sense * (lp_info.primal_obj - lp.offset), \
                sol.col_value, None
        if st in (HighsModelStatus.kInfeasible,):
            return False, math.inf, None, None
        # inconclusive: confirm with elastic feasibility LP
        feas_lp = build_primal_feasibility_lp(node_lp)
        st2, _, inf2 = solve_lp_ipm_native(feas_lp, node_options,
                                           device=device)
        if st2 == HighsModelStatus.kOptimal and inf2.primal_obj > \
                1e-7 * (1.0 + float(np.abs(lp.row_upper[
                    np.isfinite(lp.row_upper)]).sum())):
            return False, math.inf, None, None
        # numerically hard but feasible: at the ROOT only, retry with
        # the PDHG solver (at interior nodes a half-second device
        # fallback per node dwarfs the node itself — keep the node
        # with a trivial bound instead)
        if info.mip_node_count <= 1:
            st3, sol3, inf3 = solve_lp_pdlp(node_lp, node_options,
                                            device=device)
            if st3 == HighsModelStatus.kOptimal:
                return True, sense * (inf3.primal_obj - lp.offset), \
                    sol3.col_value, None
            if st3 == HighsModelStatus.kInfeasible:
                return False, math.inf, None, None
        return True, -math.inf, None, None  # keep node, trivial bound

    def violation(x):
        """Max integrality/semi/SOS violation of a point."""
        v = 0.0
        if sos_sets and sos_first_violated(np.asarray(x)) >= 0:
            v = max(v, 1.0)
        if is_int.any():
            v = float(np.max(np.abs(x[is_int] - np.round(x[is_int])),
                             initial=0.0))
        if is_semi.any():
            xs = x[is_semi]
            semi_l = lp.col_lower[is_semi]
            dist0 = np.abs(xs)
            in_range = xs >= semi_l - feastol
            bad = np.minimum(dist0, np.where(in_range, 0.0, np.inf))
            v = max(v, float(np.max(np.where(bad > feastol, bad, 0.0),
                                    initial=0.0)))
        return v

    incumbent_x = None
    incumbent_obj = math.inf  # minimization value
    n_improving = 0

    # ---- debug solution tracer (reference HighsDebugSol.cpp,
    # option mip_debug_solution_file) -----------------------------------
    debug_sol = None
    if options.mip_debug_solution_file:
        from .debug_sol import DebugSolution
        pre_x = getattr(options, "_mip_debug_x", None)
        if pre_x is not None and len(pre_x) == lp.num_col:
            # already projected through presolve by the facade
            debug_sol = DebugSolution(pre_x, log=log)
        else:
            debug_sol = DebugSolution.load(
                options.mip_debug_solution_file, lp, log=log)
        if debug_sol is not None and log is not None:
            log(f"MIP debug solution loaded "
                f"({options.mip_debug_solution_file})")

    # ---- improving-solution recording (reference options
    # mip_improving_solution_file / _save / _report_sparse) -------------
    improving_solutions: List[np.ndarray] = []

    def record_improving(x, obj_user):
        if options.mip_improving_solution_save:
            improving_solutions.append(np.asarray(x).copy())
        if options.mip_improving_solution_file:
            try:
                with open(options.mip_improving_solution_file,
                          "a") as f:
                    f.write(f"# objective {obj_user:.15g}\n")
                    if options.mip_improving_solution_report_sparse:
                        for j in np.nonzero(np.abs(x) > 1e-13)[0]:
                            f.write(f"{j} {x[j]:.15g}\n")
                    else:
                        f.write(" ".join(f"{v:.15g}" for v in x) + "\n")
            except OSError:
                pass

    # ---- conflict pool (reference HighsConflictPool.cpp: no-good
    # constraints from infeasible nodes over branch-fixed binaries) -----
    conflict_pool: List[Tuple[np.ndarray, np.ndarray, float]] = []

    def add_conflict(node_lo, node_up):
        """If every bound difference vs the root box is a FIXED binary,
        the no-good 'at least one of them flips' is globally valid."""
        if len(conflict_pool) >= 1000:
            return
        diff = (node_lo > root_lo_p + feastol) | \
            (node_up < root_up_p - feastol)
        js = np.nonzero(diff)[0]
        if len(js) == 0 or len(js) > 50:
            return
        for j in js:
            if not (is_int[j] and node_lo[j] == node_up[j] and
                    node_lo[j] in (0.0, 1.0) and
                    root_lo_p[j] == 0.0 and root_up_p[j] == 1.0):
                return
        # sum_{x_j fixed 0} x_j + sum_{fixed 1} (1 - x_j) >= 1
        coefs = np.where(node_lo[js] == 0.0, 1.0, -1.0)
        rhs = 1.0 - float(np.sum(node_lo[js] == 1.0))
        conflict_pool.append((js.copy(), coefs, rhs))

    # objective_bound acts as a cutoff (reference: nodes with bound
    # above it are cut off); incumbent_obj stores the MINIMIZATION value
    # sense*(obj - offset), so translate the user-space bound.
    user_cutoff = (sense * (options.objective_bound - lp.offset)
                   if math.isfinite(options.objective_bound) else math.inf)
    objective_target = options.objective_target

    def cutoff_value():
        return min(incumbent_obj, user_cutoff)

    # objective integrality: every objective value is a multiple of
    # 1/_obj_scale when all costed columns are integer with integral
    # scaled costs (reference HighsObjectiveFunction::isIntegral)
    _obj_scale = None
    _nzc = np.abs(lp.col_cost) > 1e-12
    if not np.any(_nzc & ~is_int):
        if _nzc.any():
            _sc = integral_scale(lp.col_cost[_nzc], feastol, 1e-12)
            if _sc and 0 < _sc <= 1e6:
                _obj_scale = float(_sc)
        else:
            _obj_scale = 1.0

    def prune_limit():
        """STRICT node-pruning bound (reference upper_limit =
        computeNewUpperLimit(ub, 0.0, 0.0), HighsMipSolverData.cpp:880):
        only the feasibility tolerance / integral-objective step is
        subtracted — NOT the mip_rel_gap/mip_abs_gap.  The gap
        tolerances enter solely through the best-bound termination
        check (reference optimality_limit, applied at the node queue):
        pruning dives with the gap-based limit legally discards the
        true optimum and the search then "proves" a within-gap
        incumbent optimal (observed on bell5)."""
        ub = cutoff_value()
        if not math.isfinite(ub):
            return math.inf
        if _obj_scale:
            nl = math.floor(_obj_scale * ub - 0.5) / _obj_scale
            nl += feastol
        else:
            nl = ub - feastol
        return nl

    def current_gap(dual_bound):
        if incumbent_obj == math.inf:
            return math.inf
        return abs(incumbent_obj - dual_bound) / max(
            1.0, abs(incumbent_obj))

    def _fire_cut_pool():
        """kCallbackMipGetCutPool (reference
        HighsMipSolver::callbackGetCutPool): hand the current cut-pool
        rows to the user when a new incumbent arrives."""
        if callbacks is None or not callbacks.callback_active(
                CbT.kCallbackMipGetCutPool):
            return
        ncut = _Relax.num_cut_rows if _Relax.a_csc is not None else 0
        callbacks.data_out.cutpool_num_col = lp.num_col
        callbacks.data_out.cutpool_num_cut = int(ncut)
        if ncut:
            cut_csr = _Relax.a_csc[lp.num_row + (
                _Relax.a_csc.shape[0] - lp.num_row - ncut):].tocsr()
            callbacks.data_out.cutpool_start = \
                np.asarray(cut_csr.indptr)
            callbacks.data_out.cutpool_index = \
                np.asarray(cut_csr.indices)
            callbacks.data_out.cutpool_value = np.asarray(cut_csr.data)
            callbacks.data_out.cutpool_lower = np.asarray(
                _Relax.row_lower[-ncut:], float)
            callbacks.data_out.cutpool_upper = np.asarray(
                _Relax.row_upper[-ncut:], float)
        else:
            callbacks.data_out.cutpool_start = np.zeros(1, np.int64)
            callbacks.data_out.cutpool_index = np.zeros(0, np.int64)
            callbacks.data_out.cutpool_value = np.zeros(0)
            callbacks.data_out.cutpool_lower = np.zeros(0)
            callbacks.data_out.cutpool_upper = np.zeros(0)
        callbacks.call(CbT.kCallbackMipGetCutPool, "MIP cut pool")

    def _query_user_solution(origin=0):
        """kCallbackMipUserSolution (reference
        HighsMipSolverData::queryExternalSolution): give the user a
        chance to inject a feasible solution."""
        if callbacks is None or not callbacks.callback_active(
                CbT.kCallbackMipUserSolution):
            return
        callbacks.data_out.mip_node_count = info.mip_node_count
        callbacks.data_out.running_time = time.perf_counter() - t0
        callbacks.data_out.external_solution_query_origin = origin
        callbacks.data_in.user_has_solution = False
        callbacks.data_in.user_solution = None
        callbacks.call(CbT.kCallbackMipUserSolution,
                       "MIP User solution")
        if callbacks.data_in.user_has_solution and \
                callbacks.data_in.user_solution is not None:
            xs = np.asarray(callbacks.data_in.user_solution,
                            dtype=np.float64)
            if xs.shape == (lp.num_col,):
                try_incumbent(xs, "user solution")

    def try_incumbent(x, source=""):
        nonlocal incumbent_x, incumbent_obj, n_improving
        if x is None:
            return False
        x = np.asarray(x, dtype=np.float64)
        if violation(x) > feastol:
            return False
        # check row feasibility ABSOLUTELY (reference: MIP row
        # violations compare against mip_feasibility_tolerance without
        # rhs scaling — relative slack on large-rhs rows admits points
        # whose objective differs from any true solution by units)
        if lp.num_row:
            ax = a_csr @ x
            if (np.any(ax < lp.row_lower - feastol) or
                    np.any(ax > lp.row_upper + feastol)):
                return False
        if np.any(x < lp.col_lower - feastol) or \
                np.any(x > lp.col_upper + feastol):
            return False
        obj = sense * float(lp.col_cost @ x)
        if obj < incumbent_obj - 1e-12:
            incumbent_x = x.copy()
            incumbent_obj = obj
            n_improving += 1
            record_improving(incumbent_x, sense * obj + lp.offset)
            if log is not None:
                log(f"MIP incumbent {sense * obj + lp.offset:.10g}"
                    f"{' (' + source + ')' if source else ''}")
            if callbacks is not None and \
                    getattr(callbacks, "user_callback", None):
                callbacks.data_out.objective_function_value = \
                    sense * obj + lp.offset
                callbacks.data_out.mip_primal_bound = sense * obj + \
                    lp.offset
                callbacks.data_out.mip_node_count = info.mip_node_count
                callbacks.data_out.mip_solution = incumbent_x.copy()
                callbacks.call(CbT.kCallbackMipSolution)
                callbacks.call(CbT.kCallbackMipImprovingSolution)
                callbacks.call(
                    CbT.kCallbackMipDefineLazyConstraints,
                    "MIP define lazy constraints")
                _fire_cut_pool()
            return True
        return False

    def round_and_repair(x_relax, lo, up):
        """Round integers, fix them, propagate and re-solve the LP for
        the continuous completion (reference analogue: rounding +
        RINS-style fixing heuristics, HighsPrimalHeuristics.cpp)."""
        x = np.asarray(x_relax, dtype=np.float64).copy()
        xr = np.round(x)
        lo2, up2 = lo.copy(), up.copy()
        lo2[is_int] = np.maximum(lo[is_int], xr[is_int])
        up2[is_int] = np.minimum(up[is_int], xr[is_int])
        if is_semi.any():
            near0 = np.abs(x) <= feastol
            fix0 = is_semi & near0
            lo2 = np.where(fix0, 0.0, lo2)
            up2 = np.where(fix0, 0.0, up2)
            onr = is_semi & ~near0
            lo2 = np.where(onr, np.maximum(lo2, lp.col_lower), lo2)
        if np.any(lo2 > up2 + feastol):
            return None
        ok, lo3, up3 = prop.propagate(lo2, up2)
        if not ok:
            return None
        if not np.all(is_int | is_semi):
            feasible, obj, xc, _ = solve_node_lp(lo3, up3)
            if not feasible or xc is None:
                return None
            return xc
        # pure integer: midpoint of (now fixed) domain
        return 0.5 * (np.where(np.isfinite(lo3), lo3, 0.0) +
                      np.where(np.isfinite(up3), up3, 0.0))

    # ---- root ------------------------------------------------------------
    ok, root_lo_p, root_up_p = prop.propagate(root_lo, root_up)
    if ok:
        root_lo_p, root_up_p = apply_orbit_bounds(root_lo_p, root_up_p)
        if np.any(root_lo_p > root_up_p + feastol):
            ok = False
    if debug_sol is not None:
        if ok:
            debug_sol.check_bounds(root_lo_p, root_up_p,
                                   "root propagation", feastol)
        elif debug_sol.in_box(root_lo, root_up):
            debug_sol._report("root infeasibility")
    if not ok:
        info.status = HighsModelStatus.kInfeasible
        info.solve_time = time.perf_counter() - t0
        return info.status, HighsSolution(), info

    if orbitope_fix_cols:
        # packing-orbitope staircase fixings (lex-max representative,
        # Kaibel-Pfetsch; reference HighsSymmetry orbitope machinery):
        # optimum-preserving zero-fixings applied to the root box
        root_up_p = root_up_p.copy()
        root_up_p[orbitope_fix_cols] = np.minimum(
            root_up_p[orbitope_fix_cols],
            root_lo_p[orbitope_fix_cols])
        if log is not None:
            log(f"MIP orbitope fixings applied: "
                f"{len(orbitope_fix_cols)} columns at lower bound")

    # ---- coefficient strengthening (reference: HPresolve coefficient
    # tightening) on the RELAXATION only: big-M rows like x - M y <= 0
    # shrink to x - u y <= 0, massively tightening fixed-charge LP
    # bounds.  Valid for integer points, so the original a_csr /
    # lp.row_* stay untouched for incumbent checks, separators, and
    # reported row values. --------------------------------------------
    if is_int.any():
        st_a = a_csr
        st_rl, st_ru = lp.row_lower, lp.row_upper
        total_chg = 0
        for _sround in range(3):
            st_a, st_rl, st_ru, nchg = strengthen_coefficients(
                st_a, st_rl, st_ru, root_lo_p, root_up_p, is_int,
                feastol)
            if not nchg:
                break
            total_chg += nchg
            prop = Propagator(st_a, st_rl, st_ru, is_int, feastol)
            ok, root_lo_p, root_up_p = prop.propagate(root_lo_p,
                                                      root_up_p)
            if not ok:
                break
        if total_chg:
            if debug_sol is not None and debug_sol.active:
                ax_dbg = st_a @ debug_sol.x
                if np.any(ax_dbg > st_ru + feastol *
                          (1 + np.abs(np.where(np.isfinite(st_ru),
                                               st_ru, 0.0)))) or \
                        np.any(ax_dbg < st_rl - feastol *
                               (1 + np.abs(np.where(np.isfinite(st_rl),
                                                    st_rl, 0.0)))):
                    debug_sol._report("coefficient strengthening")
            if not ok:
                info.status = HighsModelStatus.kInfeasible
                info.solve_time = time.perf_counter() - t0
                return info.status, HighsSolution(), info
            if use_simplex:
                _Relax.a_csc = st_a.tocsc()
            _Relax.row_lower = st_rl
            _Relax.row_upper = st_ru
            relax.a_matrix = HighsSparseMatrix.from_scipy(st_a)
            relax.row_lower = st_rl
            relax.row_upper = st_ru
            if log is not None:
                log(f"MIP coefficient strengthening: {total_chg} "
                    f"coefficients tightened")

    feasible, root_bound, root_x, root_basis = solve_node_lp(
        root_lo_p, root_up_p)
    # snapshot the root duals NOW: solve_node_lp is also called by
    # heuristics (round_and_repair completion LPs with fixed integers)
    # whose duals must never be paired with root_bound for
    # reduced-cost fixing — that pairing prunes optimal solutions
    root_z = last_duals["z"]
    info.mip_node_count = 1
    if not feasible:
        info.status = HighsModelStatus.kInfeasible
        info.solve_time = time.perf_counter() - t0
        return info.status, HighsSolution(), info
    # incumbent carried through a restart (projected through presolve;
    # fully revalidated here)
    _warm_inc = getattr(options, "_warm_incumbent", None)
    if _warm_inc is not None and len(_warm_inc) == lp.num_col:
        try_incumbent(np.asarray(_warm_inc, dtype=np.float64),
                      "carried through restart")
    if root_x is not None:
        try_incumbent(root_x, "root relaxation")
        cand = round_and_repair(root_x, root_lo_p, root_up_p)
        if cand is not None:
            try_incumbent(cand, "rounding")

    sub_level = int(getattr(options, "_sub_mip_level", 0))

    # ---- primal heuristics (reference HighsPrimalHeuristics.cpp) ------
    _sub_native = {"key": None}

    def native_submip(lo3, up3, source, node_budget, tl):
        """Fast sub-MIP: hand the restricted box straight to the
        native branch-and-bound (hx_mip_solve) over the CURRENT
        relaxation rows — no recursive root machinery (the reference's
        solveSubMip also runs with submip=true effort caps).  Returns
        True when an improving incumbent was found."""
        a = _Relax.a_csc
        key = (id(a), a.shape, a.nnz)
        if _sub_native["key"] != key:
            cost_s = sense * lp.col_cost
            sc = _ruiz_scales(a)
            if sc is not None:
                r_s, c_s = sc
                c_s = np.where(is_int, 1.0, c_s)
                a_s = (_sp.diags(r_s) @ a @ _sp.diags(c_s)).tocsc()
                cost_s = cost_s * c_s
            else:
                r_s = c_s = None
                a_s = a
            _sub_native.update(
                key=key, a=a_s, a_csr=a_s.tocsr(), cost=cost_s,
                r=r_s, c=c_s)
        r_s, c_s = _sub_native["r"], _sub_native["c"]
        rl_s = np.asarray(_Relax.row_lower, float)
        ru_s = np.asarray(_Relax.row_upper, float)
        lo_s, up_s = lo3, up3
        if c_s is not None:
            rl_s = np.where(np.isfinite(rl_s), rl_s * r_s, rl_s)
            ru_s = np.where(np.isfinite(ru_s), ru_s * r_s, ru_s)
            lo_s = np.where(np.isfinite(lo3), lo3 / c_s, lo3)
            up_s = np.where(np.isfinite(up3), up3 / c_s, up3)
        st_s, found_s, x_s, obj_s, dual_s, nn_s, it_s = _dn.mip_solve(
            _sub_native["a"], _sub_native["a_csr"],
            _sub_native["cost"], lo_s, up_s, rl_s, ru_s, is_int,
            None, min(incumbent_obj, user_cutoff),
            _obj_scale or 0.0, 0.0, 0.0, lp.offset, -math.inf,
            feastol=feastol, max_nodes=node_budget,
            time_limit=tl,
            reliable=int(options.mip_pscost_minreliable),
            tol_scale=(np.concatenate([1.0 / c_s, r_s])
                       if c_s is not None else None),
            sym_gens=(np.concatenate(
                [np.asarray(g, np.int32) for g in sym_gens])
                if sym_gens else None))
        info.mip_node_count += nn_s
        info.iterations += it_s
        if found_s:
            x_rec = x_s * c_s if c_s is not None else x_s
            return try_incumbent(x_rec, source)
        return False

    _submip_spent = [0.0]  # cumulative sub-MIP wall time (effort cap)

    def run_submip(lo2, up2, source, node_budget=500):
        with _clk("sub_mip"):
            _ts = time.perf_counter()
            try:
                return _run_submip_impl(lo2, up2, source, node_budget)
            finally:
                _submip_spent[0] += time.perf_counter() - _ts

    def _run_submip_impl(lo2, up2, source, node_budget=500):
        """Sub-MIP plumbing (HighsPrimalHeuristics.cpp solveSubMip):
        solve the restricted MIP with tight budgets, feed any solution
        into the incumbent."""
        if sub_level >= 1:
            return False
        if time.perf_counter() - t0 > options.time_limit - 2.0:
            return False  # no budget left for a heuristic solve
        # effort cap (reference HighsPrimalHeuristics: heuristic lp
        # iterations budgeted against total effort): sub-MIP wall time
        # may not exceed ~a third of the whole solve's elapsed time —
        # on root-dominated instances the dozen RINS/RENS re-solves
        # were 40% of the wall clock (gesa2)
        if _submip_spent[0] > 0.3 + 0.25 * (time.perf_counter() - t0):
            return False
        if np.any(lo2 > up2 + feastol):
            return False
        ok2, lo3, up3 = prop.propagate(lo2, up2)
        if not ok2:
            return False
        remaining0 = options.time_limit - (time.perf_counter() - t0)
        if use_simplex and _Relax.a_csc is not None and \
                bool(is_int.any()) and not sos_sets and \
                not bool(is_semi.any()) and debug_sol is None:
            # native nodes are ~100x cheaper than Python-loop nodes:
            # scale the budget up so the sub-MIP usually solves to
            # proven optimality inside its box — but cap by instance
            # size so tiny models don't burn 20k-node heuristics.
            # The TIME box additionally grows with elapsed solve time:
            # a 1.5s heuristic dive inside the first seconds of a
            # small MIP costs more than the tree it could save
            # (sp150x300d: 5 x 1.7s of root RENS/RINS on an instance
            # whose root already closes the gap)
            _nb = min(40 * node_budget, max(2000, 8 * int(is_int.sum())))
            # restarted solves re-run the whole heuristic battery on a
            # shrunk model: the dives get cheaper boxes, so a fraction
            # of the budget finds the same incumbents (gesa2 restarts
            # 3x and its submips were 28% of wall-clock)
            _rc_nb = int(getattr(options, "_mip_restart_count", 0))
            if _rc_nb:
                _nb = max(1000, _nb // (2 * _rc_nb))
            return native_submip(
                lo3, up3, source, _nb,
                max(0.15, min(remaining0 * 0.1,
                              0.2 + 8.0 * options.mip_heuristic_effort)))
        sub = lp.copy()
        sub.col_lower = lo3
        sub.col_upper = up3
        sub_opts = _copy.copy(options)
        sub_opts._sub_mip_level = sub_level + 1
        sub_opts.mip_rel_gap = 0.0
        sub_opts.mip_abs_gap = 0.0
        sub_opts.mip_max_nodes = node_budget
        remaining = options.time_limit - (time.perf_counter() - t0)
        sub_opts.time_limit = max(1.0, min(
            remaining * 0.3,
            10.0 + 100.0 * options.mip_heuristic_effort))
        sub_opts.mip_heuristic_run_feasibility_jump = False
        sub_opts.mip_report_level = 0
        # inherit the current cutoff so the sub-MIP prunes on it
        if incumbent_obj < math.inf:
            sub_opts.objective_bound = sense * incumbent_obj + lp.offset
        try:
            st, sub_sol, _sub_info = solve_mip(sub, sub_opts, log=None,
                                               device=device)
        except RecursionError:
            return False
        if sub_sol.value_valid and sub_sol.col_value is not None:
            return try_incumbent(np.asarray(sub_sol.col_value), source)
        return False

    # ---- reduced-cost fixing from the root duals (reference
    # HighsRedcostFixing.cpp: dual bound + cutoff => global bound
    # tightening); re-applied whenever the incumbent improves -----------
    redcost_applied_at = math.inf

    def objective_cutoff_tighten(lo2, up2):
        """Bound tightening from the objective-cutoff row
        (reference HighsObjectiveFunction / ObjectivePropagation:
        c'x <= upper_limit propagated like any row).  Returns
        (lo, up, ntight)."""
        B = prune_limit()
        if not math.isfinite(B) or not _obj_scale:
            # only for integral objectives, where the cutoff steps a
            # full 1/scale below the incumbent: the continuous-case
            # epsilon-tightening pins variables to a degenerate cutoff
            # facet and measurably bloats the tree (makespan models:
            # 2x nodes) for no combinatorial gain
            return lo2, up2, 0
        c = sense * lp.col_cost
        nz = np.abs(c) > 1e-12
        if not nz.any():
            return lo2, up2, 0
        cmin = np.where(c > 0, c * lo2, c * up2)
        cmin = np.where(nz, cmin, 0.0)
        if not np.all(np.isfinite(cmin[nz])):
            return lo2, up2, 0
        S = float(cmin.sum())
        slack = B - S  # >= c_j*(x_j - argmin_j) for each j
        if not math.isfinite(slack) or slack < -feastol:
            return lo2, up2, 0
        lo3, up3 = lo2.copy(), up2.copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            ub_cand = np.where(nz & (c > 0), lo2 + slack / np.abs(c),
                               np.inf)
            lb_cand = np.where(nz & (c < 0), up2 - slack / np.abs(c),
                               -np.inf)
        ub_cand = np.where(is_int, np.floor(ub_cand + feastol), ub_cand)
        lb_cand = np.where(is_int, np.ceil(lb_cand - feastol), lb_cand)
        ntight = int(np.sum(ub_cand < up3 - feastol) +
                     np.sum(lb_cand > lo3 + feastol))
        np.minimum(up3, ub_cand, out=up3)
        np.maximum(lo3, lb_cand, out=lo3)
        return lo3, up3, ntight

    def apply_root_redcost_fixing():
        nonlocal root_lo_p, root_up_p, redcost_applied_at
        if root_z is None or root_x is None or \
                not math.isfinite(root_bound) or \
                incumbent_obj >= redcost_applied_at:
            return
        redcost_applied_at = incumbent_obj
        lo2, up2, ntight = heur.redcost_fixing(
            root_z, root_x, root_bound, incumbent_obj - abs_gap,
            root_lo_p, root_up_p, is_int, feastol)
        lo2, up2, ntight2 = objective_cutoff_tighten(lo2, up2)
        ntight += ntight2
        if ntight:
            if debug_sol is not None and debug_sol.active:
                debug_sol.check_bounds(lo2, up2,
                                       "reduced-cost fixing", feastol)
            ok2, lo3, up3 = prop.propagate(lo2, up2)
            if ok2:
                if debug_sol is not None and debug_sol.active:
                    debug_sol.check_bounds(
                        lo3, up3, "post-redcost propagation", feastol)
                root_lo_p, root_up_p = lo3, up3
                if log is not None:
                    log(f"MIP reduced-cost fixing tightened {ntight} "
                        f"bounds")

    abs_gap = options.mip_abs_gap
    rel_gap = options.mip_rel_gap

    def run_feasibility_jump(x_start, lo, up, seed=0, effort=1.0):
        """Feasibility-jump + LP completion (reference:
        mip_heuristic_run_feasibility_jump).  `effort` < 1 scales the
        time/move box down for in-tree retries (a full root-sized FJ
        per retry starves the node loop)."""
        # time-boxed per mip_heuristic_effort (reference option),
        # scaled to the instance: a 2s jump on a 500-column model
        # costs more than solving it
        # floor low enough that small / restarted models don't burn a
        # fixed 0.1s per attempt (p0548: 4 attempts ~ 0.4s against a
        # 0.1s reference solve)
        size_cap = max(0.03, 1e-6 * lp.num_nz + 1e-4 * lp.num_col)
        if int(getattr(options, "_mip_restart_count", 0)) > 0:
            size_cap = min(size_cap, 0.05)  # restarted model: light FJ
        budget = effort * min(
            max(2.0, options.mip_heuristic_effort *
                min(options.time_limit, 600.0)),
            size_cap)
        xfj = feasibility_jump(
            a_csr, lp.row_lower, lp.row_upper, lo, up,
            sense * lp.col_cost, is_int | is_semi,
            x0=x_start, feastol=feastol, seed=seed,
            max_moves=int(min(30000 * effort,
                              5000 + 100 * lp.num_col)),
            time_budget=budget)
        if xfj is None:
            return False
        # polish: fix integers, optimal continuous completion.  The
        # raw FJ point satisfies rows only to feastol — on ill-scaled
        # instances such edge points can undercut the true optimum
        # (reference-parity: incumbents come from LP-tight vertices)
        cand = round_and_repair(xfj, lo, up)
        if cand is not None:
            return try_incumbent(cand, "feasibility jump + LP") or True
        # completion LP failed: accept the raw point only if it is
        # strictly feasible
        ax = a_csr @ xfj if lp.num_row else np.zeros(0)
        if lp.num_row == 0 or (
                np.all(ax >= lp.row_lower - 1e-9) and
                np.all(ax <= lp.row_upper + 1e-9)):
            try_incumbent(xfj, "feasibility jump")
        return True

    # ---- root cut separation (reference: evaluateRootNode's
    # rootSeparationRound loop, HighsMipSolverData.cpp:1987+) ----------
    if use_simplex and root_x is not None and \
            math.isfinite(root_bound) and (is_int.any()):
        from .cuts import (CliqueTable, Cut, CutPool, separate_gomory,
                           select_diverse_cuts)
        cutpool = CutPool(lp.num_col, options.mip_pool_age_limit,
                          options.mip_pool_soft_limit)
        clique_table = CliqueTable(a_csr, lp.row_lower, lp.row_upper,
                                   root_lo_p, root_up_p, is_int, feastol)
        # root probing of fractional binaries (reference
        # HighsImplications): implication store for implied-bound cuts,
        # probing fixings applied to the root domain
        from .implications import Implications
        implications = Implications(prop, feastol)
        binary = is_int & (root_lo_p >= -feastol) & \
            (root_up_p <= 1.0 + feastol) & (root_up_p - root_lo_p > 0.5)
        frac = np.abs(root_x - np.round(root_x))
        probe_order = np.argsort(-np.where(binary, frac, -1.0))
        probe_cand = [int(j) for j in probe_order if binary[j]]
        # probe every binary when the model is small enough: besides
        # fixings/vbounds, pairwise probing builds the COVER GRAPH
        # (y_i + y_j >= 1 pairs) that feeds the objective clique
        # partition below (reference ObjectivePropagation)
        n_binary = int(binary.sum())
        probe_budget = min(64, max(8, lp.num_col // 4))
        if n_binary <= 512 and lp.num_row <= 20000 and \
                int(getattr(options, "_sub_mip_level", 0)) == 0:
            probe_budget = min(n_binary, 512)
        if int(getattr(options, "_mip_restart_count", 0)) > 0:
            # the pre-restart solve already probed this structure; the
            # re-presolved model only needs a light re-pass
            probe_budget = min(probe_budget, 24)
        new_lo, new_up = implications.probe(
            probe_cand, root_lo_p, root_up_p,
            max_probes=probe_budget)
        if implications.infeasible and \
                confirm_infeasible(root_lo_p, root_up_p) is True:
            # probing infeasibility is propagation-tolerance based:
            # confirm with the elastic LP before deciding the MIP
            # status (ill-scaled rows false-positive otherwise)
            if debug_sol is not None and debug_sol.active:
                debug_sol._report("root probing infeasibility")
            info.status = HighsModelStatus.kInfeasible
            info.solve_time = time.perf_counter() - t0
            return info.status, HighsSolution(), info
        if implications.infeasible:
            # unconfirmed probing infeasibility: tolerance artifact —
            # discard every probing result
            implications = Implications(prop, feastol)
            new_lo, new_up = root_lo_p, root_up_p
        if debug_sol is not None and debug_sol.active:
            debug_sol.check_bounds(new_lo, new_up, "root probing",
                                   feastol)
        if implications.fixed or np.any(new_lo > root_lo_p) or \
                np.any(new_up < root_up_p):
            root_lo_p, root_up_p = new_lo, new_up
            feasible, root_bound, root_x, root_basis = solve_node_lp(
                root_lo_p, root_up_p, warm_basis=root_basis)
            if not feasible or root_x is None:
                info.status = HighsModelStatus.kInfeasible
                info.solve_time = time.perf_counter() - t0
                return info.status, HighsSolution(), info
        # objective clique-partition rows (reference
        # ObjectivePropagation / setupCliquePartition):  for cliques C
        # in the probing cover graph, sum_{C} y >= |C|-1 is valid; as
        # LP rows they carry the combinatorial objective bound and let
        # propagation lift the incumbent cutoff into fixings
        clique_rows = implications.cover_clique_rows(
            root_lo_p, root_up_p, binary, sense * lp.col_cost)
        keep_cr = []
        for cr in clique_rows:
            if debug_sol is not None and debug_sol.active:
                dense_cr = np.zeros(lp.num_col)
                dense_cr[cr.cols] = cr.vals
                if not debug_sol.check_cut(dense_cr, cr.rhs,
                                           "cover clique row"):
                    continue
            keep_cr.append(cr)
        if keep_cr and use_simplex:
            rows_cr = _sp.csr_matrix(
                (np.concatenate([c.vals for c in keep_cr]),
                 (np.repeat(np.arange(len(keep_cr)),
                            [len(c.cols) for c in keep_cr]),
                  np.concatenate([c.cols for c in keep_cr]))),
                shape=(len(keep_cr), lp.num_col))
            _Relax.a_csc = _sp.vstack([_Relax.a_csc, rows_cr]).tocsc()
            _Relax.row_lower = np.concatenate(
                [_Relax.row_lower, np.full(len(keep_cr), -kHighsInf)])
            _Relax.row_upper = np.concatenate(
                [_Relax.row_upper,
                 np.array([c.rhs for c in keep_cr])])
            _Relax.num_cut_rows += len(keep_cr)
            if log is not None:
                log(f"MIP objective clique partition: "
                    f"{len(keep_cr)} cover-clique rows")
            warm_cr = None
            if root_basis is not None:
                # new clique-row logicals start basic (slack rows)
                warm_cr = np.concatenate(
                    [root_basis, np.ones(len(keep_cr), dtype=np.int8)])
            feasible, root_bound, root_x, root_basis = solve_node_lp(
                root_lo_p, root_up_p, warm_basis=warm_cr)
            root_z = last_duals["z"]
            if not feasible or root_x is None:
                info.status = HighsModelStatus.kInfeasible
                info.solve_time = time.perf_counter() - t0
                return info.status, HighsSolution(), info
        # incumbent BEFORE separation (reference evaluateRootNode runs
        # primal heuristics interleaved with the cut rounds): with an
        # incumbent in hand, the loop's gap-closure check can stop
        # separation — and skip the whole tree — the moment the root
        # bound crosses the integral pruning limit
        if options.mip_heuristic_run_feasibility_jump and \
                incumbent_obj == math.inf and \
                int(getattr(options, "_sub_mip_level", 0)) == 0:
            run_feasibility_jump(root_x, root_lo_p, root_up_p)

        # separation runs in the native round (hx_root_cuts: tableau-MIR,
        # c-MIR and path aggregation), which the JAX package takes
        # whenever its library loads; its Python separators (path
        # mixing, network cut-sets, mod-k) run only where the library
        # is missing, and measured on the anchored suite they HURT the
        # native trajectory (sp150x300d 1.9s/246 nodes -> 0.52s/31 nodes
        # with both off), so this solver never runs them
        stall = 0
        _sep_sub = int(getattr(options, "_sub_mip_level", 0))
        # sub-MIPs are heuristics: cheap separation only (reference
        # solveSubMip caps maxSepaRounds and reuses the parent's cuts)
        _max_rounds = 60 if _sep_sub == 0 else 8
        in_lp_keys: set = set()  # pooled cuts currently in the LP
        # per-round row aging (reference HighsLpRelaxation row aging,
        # mip_lp_age_limit): cut rows added by the loop are tracked by
        # key; rows slack at two consecutive root optima leave the LP
        # (the pool keeps them, and cutpool.violated() re-collects any
        # that become violated again).  Pre-loop rows (clique-partition
        # rows) are permanent.  This is what lets separation run to
        # reference-scale cut counts (~2600 on sp150x300d) without the
        # LP bloating: the ACTIVE set stays near the original row count.
        # non-ageable prefix = EVERY row currently in the relaxation
        # (original rows + clique-partition cut rows + symmetry-breaking
        # rows, the latter added without touching num_cut_rows) — the
        # ageable suffix starts at the actual current row count, not at
        # lp.num_row + num_cut_rows which misses the symmetry rows
        _m_perm = _Relax.a_csc.shape[0]
        lp_cut_keys: list = []  # keys of ageable cut rows, in row order
        lp_cut_age = np.zeros(0, dtype=int)
        _rens_mid = [False]  # one mid-loop RENS incumbent attempt
        first_root_bound = None  # bound before any cuts (stall basis)
        hard_stall = 0
        for _round in range(_max_rounds):
            if time.perf_counter() - t0 > 0.25 * options.time_limit:
                break
            # relaxation-growth safety cap: with per-round aging the
            # active cut-row count stays near the original row count,
            # so this should never bind on healthy instances
            if _Relax.num_cut_rows > max(2000, 10 * lp.num_row):
                break
            _sep_scope = _clk("separation")
            _sep_scope.__enter__()
            found = []
            sep_csr = _Relax.a_csc.tocsr()
            sep_rl = _Relax.row_lower
            sep_ru = _Relax.row_upper
            # ---- NATIVE batched separation (hx_root_cuts in
            # separate-only mode): ONE ctypes call runs tableau-MIR
            # (from the engine's own factorization of the passed
            # basis), single-row c-MIR over the relaxation rows, and
            # path-aggregation c-MIR — replacing the per-round Python
            # separate_gomory/tableau/mir/path calls at ~1/10 the
            # cost.  The returned cuts are postprocessed + diversity
            # filtered natively; efficacy is recomputed here for the
            # pool ordering.
            _nb = root_basis if root_basis is not None and \
                len(root_basis) == lp.num_col + sep_csr.shape[0] \
                else None
            (_ns, _ncuts_r, _nb_, _nx_, _nz_, _nbas_, _nit_,
             _nr_) = _dn.root_cuts(
                _Relax.a_csc, sep_csr, sense * lp.col_cost,
                root_lo_p, root_up_p, sep_rl, sep_ru,
                np.ascontiguousarray(is_int, dtype=np.int8),
                basis_in=_nb, feastol=feastol, max_cuts_round=1000,
                x_at=root_x, time_budget=2.0)
            if _ns == 0:
                for (cc, vv, rr) in _ncuts_r:
                    _viol = float(vv @ root_x[cc]) - rr
                    _nrm = float(np.linalg.norm(vv))
                    if _nrm > 0 and _viol / _nrm > 1e-6:
                        found.append(Cut(
                            cc.astype(np.int32), vv, float(rr),
                            _viol / _nrm))
            # pure-GMI stays Python-side in the early rounds (the
            # native loop's tableau path runs the c-MIR pipeline,
            # not the plain Gomory mixed-integer rounding)
            if root_basis is not None and _round < 3:
                try:
                    found += separate_gomory(
                        _Relax.a_csc, root_lo_p, root_up_p,
                        _Relax.row_lower, _Relax.row_upper,
                        root_basis, root_x, is_int, feastol)
                except _NUMERICAL:
                    pass
            found += implications.separate(root_x, root_lo_p, root_up_p)
            found += clique_table.separate(root_x)
            _sep_scope.__exit__()
            added = [c for c in found if cutpool.add(c)]
            # cut-POOL separation (reference HighsSeparation round
            # order ends with cut-pool separation): re-collect violated
            # pooled cuts that never made it into the LP — the
            # orthogonality filter below drops cuts each round, and
            # without this step the pool dedup silences them forever
            # (observed on sp150x300d: 1500+ pooled cuts lost, root
            # bound stuck 2 below the reference's)
            new_keys = {c.key() for c in added}
            for c in cutpool.violated(root_x, max_cuts=200):
                k = c.key()
                if k not in in_lp_keys and k not in new_keys:
                    new_keys.add(k)
                    added.append(c)
            if not added:
                break
            added = select_diverse_cuts(added, max_cuts=600)
            for c in added:
                in_lp_keys.add(c.key())
            lp_cut_keys.extend(c.key() for c in added)
            lp_cut_age = np.concatenate(
                [lp_cut_age, np.zeros(len(added), dtype=int)])
            cut_a, cut_rhs = cutpool.matrix(added)
            if debug_sol is not None and debug_sol.active:
                dense = cut_a.toarray()
                for r in range(dense.shape[0]):
                    if not debug_sol.check_cut(
                            dense[r], float(cut_rhs[r]),
                            f"root cut round {_round + 1} row {r}"):
                        break
            _Relax.a_csc = _sp.vstack(
                [_Relax.a_csc, cut_a]).tocsc()
            _Relax.row_lower = np.concatenate(
                [_Relax.row_lower, np.full(len(added), -kHighsInf)])
            _Relax.row_upper = np.concatenate(
                [_Relax.row_upper, cut_rhs])
            _Relax.num_cut_rows += len(added)
            # warm basis: new cut logicals enter basic
            warm = None
            if root_basis is not None:
                warm = np.concatenate(
                    [root_basis, np.ones(len(added), dtype=np.int8)])
            prev_bound = root_bound
            feasible, root_bound, root_x, root_basis = solve_node_lp(
                root_lo_p, root_up_p, warm_basis=warm)
            root_z = last_duals["z"]
            info.mip_node_count += 1
            if not feasible or root_x is None or \
                    not math.isfinite(root_bound):
                # numerical trouble — drop all cuts and restore the
                # original relaxation (a wrongly-infeasible root must
                # never decide the MIP status)
                _Relax.a_csc = lp.a_matrix.to_scipy().tocsc()
                _Relax.row_lower = lp.row_lower
                _Relax.row_upper = lp.row_upper
                _Relax.num_cut_rows = 0
                feasible, root_bound, root_x, root_basis = solve_node_lp(
                    root_lo_p, root_up_p)
                root_z = last_duals["z"]
                break
            if root_bound < prev_bound - 1e-6 * (1 + abs(prev_bound)):
                # adding valid rows can only raise the LP bound: a drop
                # means the re-solve failed numerically.  Keep the
                # proven bound; drop the matching duals (they belong to
                # the weaker solve and must not drive rc fixing).
                if log is not None:
                    log(f"MIP root cuts round {_round + 1}: re-solve "
                        f"regressed ({sense * root_bound + lp.offset:.6g}"
                        f" < {sense * prev_bound + lp.offset:.6g}), "
                        f"stopping separation")
                root_bound = prev_bound
                root_z = None
                break
            if log is not None:
                log(f"MIP root cuts round {_round + 1}: "
                    f"+{len(added)} cuts ({_Relax.num_cut_rows} total), "
                    f"bound {sense * root_bound + lp.offset:.10g}")
            # gap closure: once the root bound exceeds the strict
            # pruning limit (integral-objective rounding included),
            # the incumbent is optimal — no cut round or tree node can
            # improve on it (reference: upper_limit pruning applied at
            # the root like any node)
            if incumbent_obj < math.inf and root_bound > prune_limit():
                break
            # interleaved incumbent + domain tightening (reference
            # evaluateRootNode: primal heuristics and redcost fixing
            # run BETWEEN separation rounds, so cuts separate against
            # progressively tighter domains — this, not the cuts
            # alone, is where the reference's root bound strength
            # comes from on knapsack models like lseu/p0548)
            if _sep_sub == 0 and _round % 3 == 2:
                if not _rens_mid[0] and root_x is not None and \
                        current_gap(root_bound) > 0.02:
                    _rens_mid[0] = True
                    _lo2r, _up2r = heur.submip_bounds_rens(
                        is_int, root_x, root_lo_p, root_up_p)
                    run_submip(_lo2r, _up2r, "RENS")
                if incumbent_obj < redcost_applied_at:
                    _nfix_b = int(np.sum(root_lo_p >= root_up_p))
                    apply_root_redcost_fixing()
                    if int(np.sum(root_lo_p >= root_up_p)) > _nfix_b:
                        # domains changed: re-solve before separating
                        feasible, root_bound, root_x, root_basis = \
                            solve_node_lp(root_lo_p, root_up_p,
                                          warm_basis=root_basis)
                        root_z = last_duals["z"]
                        if not feasible or root_x is None:
                            break
            # per-round row aging: rows slack at two consecutive root
            # optima leave the LP (reference HighsLpRelaxation aging).
            # Only rows whose slack logical is BASIC are droppable —
            # a nonbasic tight row carries the bound.
            if lp_cut_keys:
                full_csr = _Relax.a_csc.tocsr()
                act = full_csr[_m_perm:] @ root_x
                ru_cut = _Relax.row_upper[_m_perm:]
                slackv = ru_cut - act
                tight = slackv <= 1e-6 * (1.0 + np.abs(ru_cut))
                lp_cut_age = np.where(tight, 0, lp_cut_age + 1)
                # lazy drop: only shed rows once the LP has actually
                # bloated (small instances keep every cut row — the
                # churn of early drops perturbs the separation
                # trajectory and costs more than the lean LP saves)
                if _Relax.num_cut_rows <= max(500, 2 * lp.num_row):
                    dropm = np.zeros(len(lp_cut_age), dtype=bool)
                else:
                    dropm = lp_cut_age >= 2
                if root_basis is not None:
                    rb_cut = root_basis[lp.num_col + _m_perm:]
                    dropm &= (rb_cut == 1)  # basic slack only
                if dropm.any():
                    keep = np.concatenate(
                        [np.ones(_m_perm, dtype=bool), ~dropm])
                    _Relax.a_csc = full_csr[keep].tocsc()
                    _Relax.row_lower = _Relax.row_lower[keep]
                    _Relax.row_upper = _Relax.row_upper[keep]
                    ndrop = int(dropm.sum())
                    _Relax.num_cut_rows -= ndrop
                    for i in np.flatnonzero(dropm):
                        in_lp_keys.discard(lp_cut_keys[i])
                    lp_cut_keys = [k for k, d in
                                   zip(lp_cut_keys, dropm) if not d]
                    lp_cut_age = lp_cut_age[~dropm]
                    if root_basis is not None:
                        root_basis = np.concatenate(
                            [root_basis[:lp.num_col + _m_perm],
                             rb_cut[~dropm]])
            # tailing-off, reference style (HighsMipSolverData.cpp:2264:
            # a round stalls when it grows the TOTAL progress since the
            # first root LP by less than 0.1%; three consecutive stalls
            # stop separation).  The old 2-rounds-below-1e-4-relative
            # rule quit during flat stretches that later jumped a full
            # unit (sp150x300d rounds 12-13: +0.002 then +0.97).
            if first_root_bound is None:
                first_root_bound = prev_bound
            prog_prev = prev_bound - first_root_bound
            # a round resets the stall only when it beats BOTH bars:
            # 0.1% of the total progress so far (reference
            # HighsMipSolverData.cpp:2264) and 1e-4 of the bound
            # magnitude.  The second bar matters because our python
            # rounds cost ~10-500ms (the reference's cost ~1ms): on
            # large-|bound| models (flugpl 1.2e6, gesa2 2.6e7) the
            # progress bar alone sits exactly at the per-round creep
            # and rides 25 paid rounds to nowhere.
            improve = root_bound - prev_bound
            bar = max(0.001 * max(prog_prev, 0.0),
                      1e-4 * (1.0 + abs(root_bound)))
            stall = stall + 1 if improve <= bar else 0
            # productive rounds (many cuts, bound still creeping) get
            # extra patience: compounding +0.03/round creep closed
            # sp150x300d's last 2 bound units only after round 20
            patience = 3 if len(added) < 30 else 6
            if stall >= patience:
                break
            # hard stall: a trickle round (a handful of cuts, bound
            # essentially unchanged in absolute terms) will not jump
            # later; two in a row stop.  Unlike the reference, our
            # python separation rounds cost ~0.5s each, so riding out
            # 20 trickle rounds (which the reference does for free)
            # costs more than the tree they would save (gesa2).
            trickle = (len(added) < 5 and
                       root_bound - prev_bound <=
                       1e-9 * max(1.0, abs(root_bound)))
            hard_stall = hard_stall + 1 if trickle else 0
            if hard_stall >= 2:
                break
        if _Relax.num_cut_rows and root_x is not None:
            # drop cut rows slack at the final root optimum — they
            # bloat every node re-solve without helping the bound
            # (reference: HighsLpRelaxation row aging, mip_lp_age_limit)
            m0 = lp.num_row
            full = _Relax.a_csc.tocsr()
            act = full @ root_x
            slack = _Relax.row_upper - act
            keep_cut = slack[m0:] <= 1e-6 * (
                1.0 + np.abs(_Relax.row_upper[m0:]))
            if not keep_cut.all():
                keep = np.concatenate(
                    [np.ones(m0, dtype=bool), keep_cut])
                _Relax.a_csc = full[keep].tocsc()
                _Relax.row_lower = _Relax.row_lower[keep]
                _Relax.row_upper = _Relax.row_upper[keep]
                dropped = int((~keep_cut).sum())
                _Relax.num_cut_rows -= dropped
                if log is not None:
                    log(f"MIP root cuts: kept "
                        f"{_Relax.num_cut_rows} active, dropped "
                        f"{dropped} slack")
                warm_drop = None
                if root_basis is not None and \
                        len(root_basis) == lp.num_col + len(keep):
                    # keep surviving rows' logical statuses; the
                    # factorization repairs any rank mismatch
                    warm_drop = np.concatenate(
                        [root_basis[:lp.num_col],
                         root_basis[lp.num_col:][keep]])
                feasible, root_bound, root_x, root_basis = \
                    solve_node_lp(root_lo_p, root_up_p,
                                  warm_basis=warm_drop)
                root_z = last_duals["z"]
        if _Relax.num_cut_rows:
            # stronger propagation with cut rows included
            full_csr = _Relax.a_csc.tocsr()
            prop = Propagator(full_csr, _Relax.row_lower,
                              _Relax.row_upper, is_int, feastol)
            prop.gen = 1  # invalidates incremental seeding of old nodes
            # re-propagate the ROOT box through the cut rows: covering
            # cuts with singleton support fix integers outright, which
            # both tightens every node and feeds the restart trigger
            # (reference: domain propagation runs inside every
            # separation round, HighsSeparation::separationRound)
            okr, rlo2, rup2 = prop.propagate(root_lo_p, root_up_p)
            if okr:
                if debug_sol is not None and debug_sol.active:
                    debug_sol.check_bounds(rlo2, rup2,
                                           "root cut propagation",
                                           feastol)
                root_lo_p, root_up_p = rlo2, rup2
            # RE-probe with the cut rows in the propagator: covering
            # cuts turn probing fixings y_i=0 => y_j=1 into many more
            # cover pairs, enriching the objective clique partition
            # (reference: root probing runs against the cut-augmented
            # domain, HighsImplications + CliqueTable)
            if n_binary and n_binary <= 512 and use_simplex and \
                    int(getattr(options, "_sub_mip_level", 0)) == 0:
                imp2 = Implications(prop, feastol)
                nl2, nu2 = imp2.probe(
                    [j for j in probe_cand
                     if root_up_p[j] - root_lo_p[j] > 0.5],
                    root_lo_p, root_up_p, max_probes=n_binary)
                if imp2.infeasible and \
                        confirm_infeasible(root_lo_p,
                                           root_up_p) is True:
                    if debug_sol is not None and debug_sol.active:
                        debug_sol._report("post-cut probing "
                                          "infeasibility")
                    info.status = HighsModelStatus.kInfeasible
                    info.solve_time = time.perf_counter() - t0
                    return info.status, HighsSolution(), info
                if imp2.infeasible:
                    # unconfirmed: discard post-cut probing entirely
                    imp2 = Implications(prop, feastol)
                    nl2, nu2 = root_lo_p, root_up_p
                if debug_sol is not None and debug_sol.active:
                    debug_sol.check_bounds(nl2, nu2,
                                           "post-cut probing", feastol)
                root_lo_p, root_up_p = nl2, nu2
                cr2 = imp2.cover_clique_rows(
                    root_lo_p, root_up_p, binary, sense * lp.col_cost)
                keep2 = []
                for cr in cr2:
                    if debug_sol is not None and debug_sol.active:
                        dcr = np.zeros(lp.num_col)
                        dcr[cr.cols] = cr.vals
                        if not debug_sol.check_cut(
                                dcr, cr.rhs, "post-cut cover clique"):
                            continue
                    keep2.append(cr)
                if keep2:
                    rows_cr = _sp.csr_matrix(
                        (np.concatenate([c.vals for c in keep2]),
                         (np.repeat(np.arange(len(keep2)),
                                    [len(c.cols) for c in keep2]),
                          np.concatenate([c.cols for c in keep2]))),
                        shape=(len(keep2), lp.num_col))
                    _Relax.a_csc = _sp.vstack(
                        [_Relax.a_csc, rows_cr]).tocsc()
                    _Relax.row_lower = np.concatenate(
                        [_Relax.row_lower,
                         np.full(len(keep2), -kHighsInf)])
                    _Relax.row_upper = np.concatenate(
                        [_Relax.row_upper,
                         np.array([c.rhs for c in keep2])])
                    _Relax.num_cut_rows += len(keep2)
                    if log is not None:
                        log(f"MIP post-cut clique partition: "
                            f"{len(keep2)} cover-clique rows")
                    full_csr = _Relax.a_csc.tocsr()
                    prop = Propagator(full_csr, _Relax.row_lower,
                                      _Relax.row_upper, is_int,
                                      feastol)
                    prop.gen = 2
                    warm2 = None
                    if root_basis is not None:
                        warm2 = np.concatenate(
                            [root_basis,
                             np.ones(len(keep2), dtype=np.int8)])
                    feasible, root_bound, root_x, root_basis = \
                        solve_node_lp(root_lo_p, root_up_p,
                                      warm_basis=warm2)
                    root_z = last_duals["z"]
                    if log is not None and math.isfinite(root_bound):
                        log(f"MIP root bound after clique rows: "
                            f"{sense * root_bound + lp.offset:.10g}")
        # another rounding attempt from the cut-tightened relaxation
        if root_x is not None:
            cand = round_and_repair(root_x, root_lo_p, root_up_p)
            if cand is not None:
                try_incumbent(cand, "rounding after cuts")

    if options.mip_heuristic_run_feasibility_jump and \
            incumbent_obj == math.inf and sub_level == 0:
        run_feasibility_jump(root_x, root_lo_p, root_up_p)

    _gap_closed = (incumbent_obj < math.inf and root_x is not None and
                   math.isfinite(root_bound) and
                   root_bound > prune_limit())
    if root_x is not None and is_int.any() and sub_level == 0 and \
            not _gap_closed:
        root_cost = sense * lp.col_cost
        if options.mip_heuristic_run_zi_round:
            cand = heur.zi_round(
                _Relax.a_csc, _Relax.row_lower, _Relax.row_upper,
                root_lo_p, root_up_p, root_cost, is_int, root_x, feastol)
            if cand is not None:
                try_incumbent(cand, "ZI-round")
        if options.mip_heuristic_run_shifting:
            cand = heur.shifting(
                _Relax.a_csc, _Relax.row_lower, _Relax.row_upper,
                root_lo_p, root_up_p, root_cost, is_int, root_x, feastol)
            if cand is not None:
                try_incumbent(cand, "shifting")
        # randomized rounding + repair (always-on internal heuristic)
        for rr_seed in (1, 2):
            xr = heur.randomized_rounding(
                a_csr, root_lo_p, root_up_p, is_int, root_x, seed=rr_seed)
            cand = round_and_repair(xr, root_lo_p, root_up_p)
            if cand is not None and try_incumbent(
                    cand, "randomized rounding"):
                break
        # central rounding: round the analytic centre of the relaxation
        # (reference: centralRounding via the IPX analytic centre,
        # HighsMipSolverData.cpp evaluateRootNode) — the centre sits far
        # from degenerate vertices, so its rounding often repairs well
        if incumbent_obj == math.inf and \
                int(getattr(options, "_mip_restart_count", 0)) == 0 \
                and lp.num_row * max(1, lp.num_col) <= 1_000_000:
            # above this size the JAX package's analytic-centre IPM
            # lands on its accelerator, whose one-off compile latency
            # dwarfs any heuristic value (gesa2: minutes of compile for
            # a 10s heuristic budget); the gate stays for parity.  A
            # numerical failure of the centring ends the heuristic.
            try:
                c_opts = node_options.copy()
                c_opts.run_centring = True
                c_opts.max_centring_steps = 30
                c_opts.time_limit = max(
                    1.0, min(10.0,
                             0.1 * (options.time_limit -
                                    (time.perf_counter() - t0))))
                # centre the ORIGINAL relaxation, not the cut-augmented
                # one: cut rows inflate the dense normal-equations
                # factor cubically (p0548: ~1.2k rows with cuts -> 2s
                # of centring for a rounding heuristic) and the centre
                # of the original polytope rounds just as well
                relax_c = dataclasses.replace(
                    relax,
                    a_matrix=lp.a_matrix,
                    row_lower=lp.row_lower, row_upper=lp.row_upper,
                    num_row=lp.num_row,
                    col_lower=root_lo_p, col_upper=root_up_p)
                st_c, sol_c, _ic = solve_lp_ipm_native(relax_c, c_opts,
                                                       device=device)
                if st_c == HighsModelStatus.kOptimal and \
                        sol_c.value_valid:
                    cand = round_and_repair(
                        np.asarray(sol_c.col_value), root_lo_p,
                        root_up_p)
                    if cand is not None:
                        try_incumbent(cand, "central rounding")
            except _NUMERICAL:
                pass
        if options.mip_heuristic_run_rens and incumbent_obj == math.inf:
            lo2, up2 = heur.submip_bounds_rens(
                is_int, root_x, root_lo_p, root_up_p)
            run_submip(lo2, up2, "RENS")
        if options.mip_heuristic_run_root_reduced_cost and \
                root_z is not None:
            lo2, up2, nfx = heur.submip_bounds_root_redcost(
                is_int, root_x, root_z, root_lo_p, root_up_p)
            if nfx:
                run_submip(lo2, up2, "root reduced cost")
        # root RINS to a fixpoint: each improved incumbent re-centres
        # the neighbourhood (the reference fires ~a dozen root sub-MIPs
        # this way before the first dive — see its dcmulti log)
        if options.mip_heuristic_run_rins:
            for _rins_round in range(6):
                if incumbent_obj >= math.inf or incumbent_x is None:
                    break
                lo2, up2, nfx = heur.submip_bounds_rins(
                    is_int, incumbent_x, root_x, root_lo_p, root_up_p,
                    feastol)
                if not nfx or not run_submip(lo2, up2, "RINS"):
                    break

    # ---- batched node evaluation (SURVEY §7.7: open nodes as one
    # vmapped device program; also the deterministic stand-in for the
    # reference's parallel workers, mip_search_simulate_concurrency) ----
    batch_k = int(getattr(options, "tpu_mip_batch_nodes", 0))
    if batch_k == 0 and options.mip_search_simulate_concurrency:
        batch_k = 8
    if batch_k == 0 and options.parallel == "on":
        # "parallel=on" maps to batched node rounds, the device's stand-in
        # for the reference's parallel MIP workers
        batch_k = max(2, options.threads) if options.threads else 8
    _batch_state = {"ev": None, "rows": -1}

    def close_batch_evaluator():
        """Free the evaluator's graphs and buffers: cuts changed the
        relaxation's rows, or the search ended."""
        if _batch_state["ev"] is not None:
            _batch_state["ev"].close()
            _batch_state["ev"] = None

    def get_batch_evaluator():
        """The evaluator of the current relaxation (rebuilt when cuts
        change its rows) on the MIP's device.  Unlike the JAX package, a
        failure to build it raises."""
        if not use_simplex or _Relax.a_csc is None:
            return None
        nrows = _Relax.a_csc.shape[0]
        if _batch_state["ev"] is None or _batch_state["rows"] != nrows:
            close_batch_evaluator()
            from .batch_nodes import BatchNodeEvaluator
            tmpl = HighsLp(
                num_col=lp.num_col, num_row=nrows,
                col_cost=lp.col_cost.copy(),
                col_lower=root_lo_p.copy(),
                col_upper=root_up_p.copy(),
                row_lower=np.asarray(_Relax.row_lower,
                                     dtype=np.float64).copy(),
                row_upper=np.asarray(_Relax.row_upper,
                                     dtype=np.float64).copy(),
                a_matrix=HighsSparseMatrix.from_scipy(_Relax.a_csc),
                sense=lp.sense)
            _batch_state["ev"] = BatchNodeEvaluator(tmpl, device=device)
            _batch_state["rows"] = nrows
        return _batch_state["ev"]

    # ---- restart on heavy root fixing (reference: restart-on-inactive-
    # columns, HighsMipSolverData.cpp:2127-2143 `percentageInactiveIntegers
    # >= 10`, mip_allow_restart): when root-bound work (probing, cut-driven
    # propagation, reduced-cost fixing vs the incumbent) fixed enough of
    # the integer variables, re-solving the tightened model lets presolve
    # shrink it and every structure (cuts, propagation, symmetry) rebuild
    # smaller.  The reference restarts repeatedly; cap at 3.
    abs_gap = options.mip_abs_gap
    rel_gap = options.mip_rel_gap
    apply_root_redcost_fixing()
    _restart_count = int(getattr(options, "_mip_restart_count", 0))
    if options.mip_allow_restart and sub_level == 0 and \
            _restart_count < 3 and bool(is_int.any()):
        n_int = int(is_int.sum())
        n_fixed_root = int(np.sum(is_int & (root_lo_p >= root_up_p)))
        newly_fixed = n_fixed_root - int(np.sum(
            is_int & (lp.col_lower >= lp.col_upper)))
        # reference trigger (HighsMipSolverData.cpp:2496-2499): the
        # FIRST restart fires on ANY root fixing; later ones need 2.5%.
        # Additionally fire the first restart when an incumbent with a
        # substantial gap exists: re-presolving under the objective-
        # cutoff row (added below) is what shrinks the model — the
        # reference gets the same effect because its restart presolve
        # runs against upper_limit.
        _root_gap = math.inf
        if incumbent_obj < math.inf and math.isfinite(root_bound):
            _root_gap = abs(incumbent_obj - root_bound) / max(
                1.0, abs(incumbent_obj))
        if _restart_count == 0:
            _want_restart = newly_fixed > 0 or \
                (incumbent_obj < math.inf and _root_gap > 0.02)
        else:
            _want_restart = newly_fixed > 0.025 * n_int
        if _want_restart and \
                time.perf_counter() - t0 > options.time_limit - 5.0:
            _want_restart = False  # not enough budget for a restart
        if n_int > 0 and _want_restart:
            if log is not None:
                log(f"MIP restart: {newly_fixed}/{n_int} integer "
                    f"variables fixed at the root")
            restart_lp = lp.copy()
            restart_lp.col_lower = root_lo_p.copy()
            restart_lp.col_upper = root_up_p.copy()
            # carry the ACTIVE cut rows into the restarted model: they
            # are globally valid (derived from original rows +
            # integrality + global bounds) and re-deriving them costs
            # the restarted solve its whole budget (reference: the
            # global cut pool survives performRestart)
            if use_simplex and _Relax.num_cut_rows:
                ncut = min(int(_Relax.num_cut_rows), 500)
                cut_block = _Relax.a_csc.tocsr()[-ncut:]
                restart_lp.a_matrix = HighsSparseMatrix.from_scipy(
                    _sp.vstack([lp.a_matrix.to_scipy().tocsr(),
                                cut_block]).tocsr())
                restart_lp.row_lower = np.concatenate(
                    [restart_lp.row_lower, _Relax.row_lower[-ncut:]])
                restart_lp.row_upper = np.concatenate(
                    [restart_lp.row_upper, _Relax.row_upper[-ncut:]])
                restart_lp.num_row += ncut
                if getattr(restart_lp, "row_names", None):
                    restart_lp.row_names = []
            # objective-cutoff row: the restarted presolve exploits the
            # incumbent the way the reference's restart presolve uses
            # upper_limit (dual fixing / dominated columns against the
            # cutoff).  With an integral objective the cutoff steps a
            # full gcd below the incumbent.
            _cutoff_added = False
            if incumbent_x is not None and math.isfinite(incumbent_obj):
                nz_cost = np.abs(lp.col_cost) > 1e-12
                int_obj_scale = 0.0
                if not np.any(nz_cost & ~is_int):
                    sc = integral_scale(
                        lp.col_cost[nz_cost], feastol, 1e-12)
                    if sc and sc > 0 and sc <= 1e6:
                        int_obj_scale = 1.0 / sc
                if int_obj_scale > 0:
                    cutoff_mval = incumbent_obj - int_obj_scale + \
                        1e-6 * int_obj_scale
                else:
                    # tight margin: the restart exists for presolve
                    # strength, not for hunting tolerance-level
                    # "improvements" just below the incumbent
                    cutoff_mval = incumbent_obj - max(
                        abs_gap, 1e-9 * (1.0 + abs(incumbent_obj)))
                obj_row = _sp.csr_matrix(
                    (sense * lp.col_cost[nz_cost],
                     (np.zeros(int(nz_cost.sum()), dtype=np.int64),
                      np.nonzero(nz_cost)[0])),
                    shape=(1, lp.num_col))
                restart_lp.a_matrix = HighsSparseMatrix.from_scipy(
                    _sp.vstack([restart_lp.a_matrix.to_scipy().tocsr(),
                                obj_row]).tocsr())
                restart_lp.row_lower = np.concatenate(
                    [restart_lp.row_lower, [-kHighsInf]])
                restart_lp.row_upper = np.concatenate(
                    [restart_lp.row_upper, [cutoff_mval]])
                restart_lp.num_row += 1
                if getattr(restart_lp, "row_names", None):
                    restart_lp.row_names = list(restart_lp.row_names) + \
                        ["__restart_cutoff__"]
                _cutoff_added = True
            r_opts = options.copy()
            r_opts._mip_restart_count = _restart_count + 1
            r_opts.time_limit = max(
                1.0, options.time_limit - (time.perf_counter() - t0))
            # re-presolve the fixed-up model (the point of restarting:
            # reference performRestart runs full presolve, shrinking
            # the model so cuts and propagation bite much harder)
            from ...presolve.presolve import postsolve_lp as _post_lp
            from ...presolve.presolve import presolve_lp as _pre_lp
            pres_r = None
            inner_lp = restart_lp
            if options.presolve != "off" and \
                    not getattr(restart_lp, "sos", None):
                try:
                    pres_r = _pre_lp(restart_lp, options, device)
                except _NUMERICAL:
                    pres_r = None
                if pres_r is not None and pres_r.status in (
                        HighsModelStatus.kInfeasible,
                        HighsModelStatus.kUnbounded,
                        HighsModelStatus.kUnboundedOrInfeasible):
                    # the tightened box lost every improving solution:
                    # the incumbent (if any) is optimal
                    if incumbent_x is not None:
                        info.status = HighsModelStatus.kOptimal
                        info.primal_obj = sense * incumbent_obj + \
                            lp.offset
                        info.mip_dual_bound = info.primal_obj
                        info.mip_gap = 0.0
                        info.solve_time = time.perf_counter() - t0
                        sol_i = HighsSolution(
                            value_valid=True, dual_valid=False,
                            col_value=incumbent_x,
                            row_value=(a_csr @ incumbent_x
                                       if lp.num_row else np.zeros(0)))
                        return info.status, sol_i, info
                    info.status = pres_r.status
                    info.solve_time = time.perf_counter() - t0
                    return info.status, HighsSolution(), info
                if pres_r is not None and pres_r.reduced:
                    inner_lp = pres_r.reduced_lp
                    if log is not None:
                        log(f"MIP restart presolve: "
                            f"{inner_lp.num_row} rows, "
                            f"{inner_lp.num_col} cols")
                else:
                    pres_r = None
                # a restart only pays when presolve meaningfully
                # shrank the model (reference: restarts are driven by
                # inactive-column percentage); otherwise re-deriving
                # the root cuts wastes the budget — keep the current
                # tree instead
                _shrink_frac = 0.95 if _cutoff_added else 0.85
                if newly_fixed < max(1.0, 0.02 * n_int) and (
                        pres_r is None or
                        inner_lp.num_col > _shrink_frac * lp.num_col):
                    if log is not None:
                        log("MIP restart skipped: presolve did not "
                            "shrink the model")
                    pres_r = None
                    _want_restart = False
            if _want_restart:
                # carry the incumbent through the restart (projected
                # into the re-presolved space; try_incumbent
                # revalidates it).  With a cutoff row the incumbent is
                # deliberately excluded from the restarted model — it
                # is folded back in below.
                if incumbent_x is not None and not _cutoff_added:
                    warm_x = incumbent_x
                    if pres_r is not None:
                        warm_x = incumbent_x[pres_r.keep_cols]
                    r_opts._warm_incumbent = np.asarray(
                        warm_x, dtype=np.float64)
                st_r, sol_r, info_r = solve_mip(
                    inner_lp, r_opts, log=log, callbacks=callbacks,
                    device=device)
                if pres_r is not None and sol_r.value_valid:
                    sol_r, _ = _post_lp(restart_lp, pres_r, sol_r)
                if sol_r.value_valid and \
                        len(sol_r.row_value) > lp.num_row:
                    # strip carried cut rows and the cutoff row
                    sol_r.row_value = sol_r.row_value[:lp.num_row]
                info_r.solve_time += time.perf_counter() - t0 - \
                    info_r.solve_time
                # the pre-restart root bound stays valid: never report
                # a weaker (or missing) dual bound after the restart
                if math.isfinite(root_bound):
                    pre_user = sense * root_bound + lp.offset
                    cur = getattr(info_r, "mip_dual_bound", -math.inf)
                    if not math.isfinite(cur) or \
                            sense * (cur - lp.offset) < root_bound:
                        info_r.mip_dual_bound = pre_user
                # fold in the incumbent found before restarting: with
                # a cutoff row, an infeasible / objective-bound
                # restarted solve PROVES the incumbent optimal;
                # otherwise it only matters when the restart hit a
                # limit early
                if incumbent_x is not None and (
                        not sol_r.value_valid or
                        sense * (info_r.primal_obj - lp.offset) >
                        incumbent_obj + 1e-12):
                    sol_r = HighsSolution(
                        value_valid=True, dual_valid=False,
                        col_value=incumbent_x,
                        row_value=(a_csr @ incumbent_x if lp.num_row
                                   else np.zeros(0)))
                    info_r.primal_obj = sense * incumbent_obj + \
                        lp.offset
                    if _cutoff_added and st_r in (
                            HighsModelStatus.kInfeasible,
                            HighsModelStatus.kObjectiveBound):
                        st_r = HighsModelStatus.kOptimal
                        info_r.status = st_r
                        info_r.mip_dual_bound = info_r.primal_obj
                        info_r.mip_gap = 0.0
                return st_r, sol_r, info_r

    pscost = _Pseudocost(lp.num_col, options.mip_pscost_minreliable)
    # strong-branching LP budget (reliability branching; reference
    # bounds strong-branching effort inside HighsSearch::branch)
    strong_branch_budget = [200 if sub_level == 0 else 0]
    # RINS cadence with multiplicative backoff on fruitless runs
    rins_interval = [100]
    rins_next_node = [100]

    heap: List[_Node] = []
    seq = 0
    # the root stays open even when its LP was inconclusive (no point,
    # a trivial bound): dropping it, as the JAX package does, reports the
    # incumbent optimal with no bound behind it
    heapq.heappush(heap, _Node(root_bound, seq, root_lo_p, root_up_p,
                               0, basis=root_basis))
    seq += 1
    abs_gap = options.mip_abs_gap
    rel_gap = options.mip_rel_gap
    status = HighsModelStatus.kNotset

    # ---- native branch-and-bound dive loop (hx_bb_solve) --------------
    # The per-node work is strictly scalar-sequential (reference:
    # HighsSearch dive loop is C++); route the tree search through the
    # native engine whenever no Python-side per-node feature is
    # requested.  Root cutting/heuristics/restarts stay above.
    _bb_status = -1
    # root-level external-solution query (reference
    # queryExternalSolution at kMipSolveRoot)
    _query_user_solution(origin=0)
    _native_ok = (
        bool(getattr(options, "tpu_mip_native_search", False))
        and use_simplex and _Relax.a_csc is not None
        and bool(is_int.any())
        and not sos_sets and not bool(is_semi.any())
        and debug_sol is None and batch_k <= 1
        and not options.mip_improving_solution_file
        and not math.isfinite(objective_target)
        and options.mip_max_improving_sols >= 10**9
        and heap)
    if _native_ok:
        a_bb = _Relax.a_csc
        cost_bb = sense * lp.col_cost
        lo_bb = root_lo_p
        up_bb = root_up_p
        rl_bb = np.asarray(_Relax.row_lower, float)
        ru_bb = np.asarray(_Relax.row_upper, float)
        sc_bb = _ruiz_scales(a_bb)
        if sc_bb is not None:
            r_bb, c_bb = sc_bb
            c_bb = np.where(is_int, 1.0, c_bb)  # keep integrality
            a_bb = (_sp.diags(r_bb) @ a_bb @ _sp.diags(c_bb)).tocsc()
            cost_bb = cost_bb * c_bb
            lo_bb = np.where(np.isfinite(lo_bb), lo_bb / c_bb, lo_bb)
            up_bb = np.where(np.isfinite(up_bb), up_bb / c_bb, up_bb)
            rl_bb = np.where(np.isfinite(rl_bb), rl_bb * r_bb, rl_bb)
            ru_bb = np.where(np.isfinite(ru_bb), ru_bb * r_bb, ru_bb)
        a_bb_csr = a_bb.tocsr()
        tol_bb = (np.concatenate([1.0 / c_bb, r_bb])
                  if sc_bb is not None else None)
        gens_bb = (np.concatenate([np.asarray(g, np.int32)
                                   for g in sym_gens])
                   if sym_gens else None)
        best_dual = heap[0].bound
        nodes_used = 0
        st_n = 2

        # progress hook out of the native search: wires the MIP
        # callback types (reference HighsCallbackType, HConst.h:
        # 233-245) and records improved incumbents as they appear
        _cb_interrupt = {"flag": False}

        def _native_cb(what, primal, dual, nds, lpit, xs):
            if what == 1 and xs is not None:
                x_rec = xs * c_bb if sc_bb is not None else xs
                try_incumbent(x_rec, "native search")
            if callbacks is not None and \
                    getattr(callbacks, "user_callback", None):
                callbacks.data_out.mip_node_count = \
                    info.mip_node_count + nds
                callbacks.data_out.running_time = \
                    time.perf_counter() - t0
                if math.isfinite(primal) and primal < 1e29:
                    callbacks.data_out.mip_primal_bound = \
                        sense * primal + lp.offset
                if math.isfinite(dual) and abs(dual) < 1e29:
                    callbacks.data_out.mip_dual_bound = \
                        sense * dual + lp.offset
                if callbacks.call(CbT.kCallbackMipLogging) or \
                        callbacks.call(CbT.kCallbackMipInterrupt):
                    _cb_interrupt["flag"] = True
                    return True
            return (time.perf_counter() - t0) > options.time_limit
        # ---- concurrent heuristic worker (reference parallel MIP
        # workers, HighsMipSolver.cpp:197-420: heuristics run on
        # worker threads and solutions sync at rounds).  The native
        # chunk releases the GIL, so a python thread runs
        # feasibility-jump restarts on the second core and publishes
        # improved objectives into a shared buffer the engine polls
        # for pruning; solution vectors are harvested through
        # try_incumbent between chunks.  An exception in a worker
        # thread is raised again on this thread once it is joined.
        _inc0 = min(incumbent_obj, user_cutoff)
        ext_upper = (_ct.c_double * 1)(
            _inc0 if math.isfinite(_inc0) else 1e30)
        _wk_stop = _thr.Event()
        _wk_lock = _thr.Lock()
        _wk_best = {"obj": math.inf, "x": None}
        _wk_errors: list = []

        def _conc_worker():
            seed = 1009
            fails = 0
            budget = max(0.2, min(1.0, 2e-6 * lp.num_nz +
                                  2e-4 * lp.num_col))
            start = (incumbent_x.copy()
                     if incumbent_x is not None else
                     (root_x.copy() if root_x is not None else None))
            while not _wk_stop.is_set() and fails < 25:
                seed += 1
                xfj = feasibility_jump(
                    a_csr, lp.row_lower, lp.row_upper, root_lo_p,
                    root_up_p, sense * lp.col_cost, is_int | is_semi,
                    x0=start, feastol=feastol, seed=seed,
                    max_moves=20000, time_budget=budget)
                if xfj is None:
                    fails += 1
                    continue
                x = np.asarray(xfj, float)
                ints = np.abs(x[is_int] - np.round(x[is_int]))
                if np.any(ints > feastol):
                    fails += 1
                    continue
                ax = a_csr @ x if lp.num_row else np.zeros(0)
                if (np.any(ax < lp.row_lower - feastol) or
                        np.any(ax > lp.row_upper + feastol) or
                        np.any(x < lp.col_lower - feastol) or
                        np.any(x > lp.col_upper + feastol)):
                    fails += 1
                    continue
                obj = sense * float(lp.col_cost @ x)
                with _wk_lock:
                    if obj < _wk_best["obj"] - 1e-12:
                        _wk_best["obj"] = obj
                        _wk_best["x"] = x.copy()
                        if obj < ext_upper[0] - 1e-12:
                            ext_upper[0] = obj
                fails += 1  # fresh seeds have diminishing returns

        def _in_thread(fn):
            def run():
                try:
                    fn()
                except BaseException as err:  # raised after the join
                    _wk_errors.append(err)
            return _thr.Thread(target=run, daemon=True)

        _wk_thread = None
        if (getattr(options, "mip_parallel_heuristics", True)
                and sub_level == 0 and
                options.mip_heuristic_run_feasibility_jump):
            _wk_thread = _in_thread(_conc_worker)
            _wk_thread.start()

        # ---- RACING second search worker (reference parallel MIP
        # search, HighsMipSolver.cpp:197-420: concurrent dives with
        # solution sync).  A second native B&B runs the SAME
        # subproblem with cheap strong branching (reliable=1 — a
        # different tree shape), both searches share the ext_upper
        # incumbent-objective buffer, and full solution vectors sync
        # at chunk boundaries on the main thread.  The ctypes call
        # releases the GIL, so the racer gets the second core.
        # Nondeterministic by nature (as is the reference's); one
        # thread (threads=1) disables it.
        _race_stop = [False]
        _race_best = {"obj": math.inf, "x": None}
        _race_thread = None

        def _race_cb(what, primal, dual, nds, lpit, xs):
            if what == 1 and xs is not None:
                with _wk_lock:
                    if primal < _race_best["obj"] - 1e-12:
                        _race_best["obj"] = primal
                        _race_best["x"] = np.asarray(
                            xs, dtype=np.float64).copy()
                        if primal < ext_upper[0] - 1e-12:
                            ext_upper[0] = primal
            return 1 if _race_stop[0] else 0

        def _race_worker():
            _dn.mip_solve(
                a_bb, a_bb_csr, cost_bb, lo_bb, up_bb, rl_bb, ru_bb,
                is_int, root_basis, min(incumbent_obj, user_cutoff),
                _obj_scale or 0.0, abs_gap, rel_gap, lp.offset,
                best_dual, feastol=feastol, max_nodes=10**12,
                time_limit=max(1.0, options.time_limit -
                               (time.perf_counter() - t0)),
                reliable=1, callback=_race_cb, tol_scale=tol_bb,
                sym_gens=gens_bb, ext_upper=ext_upper)

        _race_ok = (sub_level == 0 and options.threads != 1 and
                    debug_sol is None)

        # chunked search: interleave the native dive loop with the
        # Python heuristics (RINS around the best point) so exact
        # optima are found the way the reference's in-search
        # heuristics find them
        try:
            while True:
                remaining_bb = options.time_limit - (
                    time.perf_counter() - t0)
                if remaining_bb <= 0.2:
                    st_n = 2
                    break
                node_budget = int(min(options.mip_max_nodes,
                                      10**12)) - nodes_used
                if node_budget <= 0:
                    st_n = 2
                    break
                chunk = remaining_bb if incumbent_obj >= math.inf \
                    else min(remaining_bb, max(5.0,
                                               0.25 * remaining_bb))
                with _clk("native_search"):
                    st_n, found_n, x_n, obj_n, dual_n, nn, it_n = \
                        _dn.mip_solve(
                            a_bb, a_bb_csr, cost_bb, lo_bb, up_bb,
                            rl_bb, ru_bb, is_int, root_basis,
                            min(incumbent_obj, user_cutoff),
                            _obj_scale or 0.0, abs_gap, rel_gap,
                            lp.offset, best_dual, feastol=feastol,
                            max_nodes=node_budget, time_limit=chunk,
                            reliable=int(options.mip_pscost_minreliable),
                            callback=_native_cb, tol_scale=tol_bb,
                            sym_gens=gens_bb, ext_upper=ext_upper)
                # harvest the concurrent worker's best solution
                # (solution sync point, HighsMipSolver.cpp:336)
                if _wk_thread is not None:
                    with _wk_lock:
                        _wx = _wk_best["x"]
                    if _wx is not None:
                        try_incumbent(_wx, "parallel FJ worker")
                    if math.isfinite(incumbent_obj) and \
                            incumbent_obj < ext_upper[0] - 1e-12:
                        ext_upper[0] = incumbent_obj
                if _race_thread is not None:
                    with _wk_lock:
                        _rx = _race_best["x"]
                    if _rx is not None:
                        _rx_rec = _rx * c_bb if sc_bb is not None \
                            else _rx
                        try_incumbent(_rx_rec, "racing search worker")
                    if math.isfinite(incumbent_obj) and \
                            incumbent_obj < ext_upper[0] - 1e-12:
                        ext_upper[0] = incumbent_obj
                elif _race_ok and st_n == 2:
                    # the first chunk did NOT exhaust the tree: this
                    # instance is search-heavy — start the racing
                    # worker now (starting it up front taxed the many
                    # sub-second suite instances on a 2-core host)
                    _race_thread = _in_thread(_race_worker)
                    _race_thread.start()
                info.mip_node_count += nn
                info.iterations += it_n
                nodes_used += nn
                if found_n:
                    x_rec = x_n * c_bb if sc_bb is not None else x_n
                    if not try_incumbent(x_rec, "native search") and \
                            obj_n < incumbent_obj - 1e-9:
                        # near-miss (scaled-space feasible, unscaled
                        # violation above the absolute tolerance):
                        # fix the integers and re-solve the UNSCALED
                        # LP exactly — the reference's unscaled-
                        # feasibility cleanup solve
                        lo_f = root_lo_p.copy()
                        up_f = root_up_p.copy()
                        xr_i = np.round(x_rec[is_int])
                        lo_f[is_int] = xr_i
                        up_f[is_int] = xr_i
                        res_f, x_f, _yf, _zf, _bf, it_f = simplex_solve(
                            _Relax.a_csc, sense * lp.col_cost, lo_f,
                            up_f, _Relax.row_lower, _Relax.row_upper,
                            tol_p=1e-9, tol_d=1e-9, max_iter=20000,
                            scales=relax_scales(),
                            scaled_matrix=_Relax._scaled_a)
                        info.iterations += it_f
                        if not (res_f == RESULT_OPTIMAL and try_incumbent(
                                x_f, "native search (cleanup)")):
                            st_n = 3  # failed strict revalidation
                            break
                if st_n != 2:
                    break
                if math.isfinite(dual_n):
                    best_dual = max(best_dual, dual_n)
                if chunk >= remaining_bb - 0.2:
                    break  # the chunk covered the whole budget
                _query_user_solution(origin=1)
                # between chunks: RINS around the incumbent
                if incumbent_obj < math.inf and incumbent_x is not \
                        None and options.mip_heuristic_run_rins and \
                        root_x is not None:
                    lo2, up2, nfx = heur.submip_bounds_rins(
                        is_int, incumbent_x, root_x, root_lo_p,
                        root_up_p, feastol)
                    if nfx:
                        run_submip(lo2, up2, "RINS")
        finally:
            # retire the workers, whatever ended the search
            _wk_stop.set()
            _race_stop[0] = True
            if _wk_thread is not None:
                _wk_thread.join(timeout=5.0)
            if _race_thread is not None:
                _race_thread.join(timeout=10.0)
        if _wk_errors:
            raise _wk_errors[0]
        # take the workers' final harvest (a worker may have finished
        # after the last chunk)
        if _wk_thread is not None:
            with _wk_lock:
                _wx = _wk_best["x"]
            if _wx is not None:
                try_incumbent(_wx, "parallel FJ worker")
        if _race_thread is not None:
            with _wk_lock:
                _rx = _race_best["x"]
            if _rx is not None:
                _rx_rec = _rx * c_bb if sc_bb is not None else _rx
                try_incumbent(_rx_rec, "racing search worker")
        if st_n in (0, 2):
            if st_n == 0:
                heap.clear()
            elif st_n == 2:
                # keep the proven dual bound visible to the wrap-up
                heap.clear()
                heapq.heappush(heap, _Node(best_dual, seq, root_lo_p,
                                           root_up_p, 0))
                seq += 1
                status = (HighsModelStatus.kInterrupt
                          if _cb_interrupt["flag"]
                          else HighsModelStatus.kIterationLimit
                          if nodes_used >= options.mip_max_nodes
                          else HighsModelStatus.kTimeLimit)
        _bb_status = st_n
        # st_n == 3: numerical trouble or rejection — run the Python
        # loop (the heap still holds the root node)
    current = None
    nodes_since_fj = 0
    while (heap or current is not None) and _bb_status not in (0, 2):
        if time.perf_counter() - t0 > options.time_limit:
            status = HighsModelStatus.kTimeLimit
            break
        if info.mip_node_count >= options.mip_max_nodes:
            status = HighsModelStatus.kIterationLimit
            break
        if n_improving >= options.mip_max_improving_sols:
            status = HighsModelStatus.kSolutionLimit
            break
        if callbacks is not None and \
                getattr(callbacks, "user_callback", None):
            callbacks.data_out.mip_node_count = info.mip_node_count
            callbacks.data_out.running_time = time.perf_counter() - t0
            if incumbent_obj < math.inf:
                callbacks.data_out.mip_primal_bound = \
                    sense * incumbent_obj + lp.offset
            if callbacks.call(CbT.kCallbackMipInterrupt):
                status = HighsModelStatus.kInterrupt
                break
            if info.mip_node_count % 64 == 0:
                _query_user_solution(origin=1)
        if current is not None:
            node = current
            current = None
        else:
            node = heapq.heappop(heap)
        # heap is bound-ordered (_Node compares on (bound, seq)), so the
        # global dual bound is O(1) at the top
        dual_bound = min(node.bound,
                         heap[0].bound if heap else node.bound)
        if incumbent_obj < math.inf:
            if current_gap(dual_bound) <= rel_gap or \
                    abs(incumbent_obj - dual_bound) <= abs_gap:
                break
            # objective_target reached (reference kObjectiveTarget)
            if sense * incumbent_obj + lp.offset <= objective_target:
                status = HighsModelStatus.kObjectiveTarget
                break
        if node.bound > prune_limit():
            continue  # dominated node

        # intersect with globally tightened bounds (reduced-cost fixing)
        node_lo = np.maximum(node.lo, root_lo_p)
        node_up = np.minimum(node.up, root_up_p)
        if np.any(node_lo > node_up + feastol):
            continue
        node.lo, node.up = node_lo, node_up

        # conflict-pool propagation: prune boxes that violate a no-good
        # (reference ConflictPoolPropagation, HighsDomain.h:195)
        if conflict_pool:
            conflicted = False
            for js, coefs, rhs in conflict_pool:
                mx = float(np.sum(
                    np.where(coefs > 0, node.up[js], node.lo[js])
                    * coefs))
                if mx < rhs - feastol:
                    conflicted = True
                    break
            if conflicted:
                continue

        # fill a round of caches via the batched evaluator
        if batch_k > 1 and node.cached is None:
            ev = get_batch_evaluator()
            if ev is not None:
                round_nodes = [node]
                while heap and len(round_nodes) < batch_k:
                    nd2 = heapq.heappop(heap)
                    if nd2.bound > prune_limit():
                        continue
                    round_nodes.append(nd2)
                if len(round_nodes) > 1:
                    los = np.stack([nd.lo for nd in round_nodes])
                    ups = np.stack([nd.up for nd in round_nodes])
                    # a lane's numerical failure sends the round to the
                    # exact engine; any other error (the device's) leaves
                    # run(), where the JAX package swallows every one
                    try:
                        res = ev.evaluate(los, ups)
                    except (ArithmeticError, ValueError,
                            torch.linalg.LinAlgError):
                        res = None
                    if res is not None:
                        for nd, rr in zip(round_nodes, res):
                            nd.cached = rr
                for nd in round_nodes[1:]:
                    heapq.heappush(heap, nd)

        feasible, obj_bound, x, node_basis = solve_node_lp(
            node.lo, node.up, warm_basis=node.basis, cached=node.cached)
        if feasible and x is None and \
                time.perf_counter() - t0 > options.time_limit:
            # the node's LP stopped at the deadline: the node stays open,
            # so the dual bound still covers its subtree
            heapq.heappush(heap, node)
            status = HighsModelStatus.kTimeLimit
            break
        if feasible and obj_bound == -math.inf and \
                math.isfinite(node.bound):
            # numerical fallback kept the node with a trivial bound:
            # the parent's bound is still valid for the subtree
            obj_bound = node.bound
        info.mip_node_count += 1
        nodes_since_fj += 1
        if node.branch_j >= 0 and feasible and \
                math.isfinite(obj_bound):
            pscost.update(node.branch_j, node.branch_dir,
                          node.branch_frac,
                          obj_bound - node.parent_obj)
        if not feasible:
            # conflict extraction + debug check (an infeasible verdict
            # must never hold the debug solution)
            if debug_sol is not None and \
                    debug_sol.in_box(node.lo, node.up):
                debug_sol._report(
                    f"node infeasibility at depth {node.depth}")
            add_conflict(node.lo, node.up)
            continue
        if obj_bound > prune_limit():
            # debug check: a node containing the debug solution must
            # have an LP bound <= its objective (it is LP-feasible)
            if debug_sol is not None and debug_sol.active and \
                    debug_sol.in_box(node.lo, node.up) and \
                    obj_bound > sense * float(
                        lp.col_cost @ debug_sol.x) + 1e-6 * (
                            1.0 + abs(obj_bound)):
                debug_sol._report(
                    f"bound prune with wrong LP bound {obj_bound:.10g} "
                    f"at depth {node.depth}")
            continue
        if x is None:
            continue
        viol = violation(x)
        if viol <= feastol:
            if try_incumbent(x, "branching"):
                apply_root_redcost_fixing()
            continue

        # occasionally run heuristics during the search
        if info.mip_node_count % 20 == 0:
            cand = round_and_repair(x, node.lo, node.up)
            if cand is not None and try_incumbent(cand, "rounding"):
                apply_root_redcost_fixing()
        # node-level separation (option mip_allow_cut_separation_at_nodes;
        # reference: separation during search via HighsSeparation) — cuts
        # are derived from ROOT bounds, so they are globally valid rows
        if use_simplex and options.mip_allow_cut_separation_at_nodes \
                and is_int.any() and info.mip_node_count % 200 == 0 \
                and _Relax.num_cut_rows < 500:
            from .cuts import separate_mir
            node_cuts = separate_mir(
                a_csr, lp.row_lower, lp.row_upper, root_lo_p, root_up_p,
                x, is_int, feastol)
            strong = [c for c in node_cuts if c.efficacy > 1e-3][:20]
            keep_cuts = []
            for c in strong:
                if debug_sol is not None and debug_sol.active:
                    dense_c = np.zeros(lp.num_col)
                    dense_c[c.cols] = c.vals
                    if not debug_sol.check_cut(dense_c, c.rhs,
                                               "node cut"):
                        continue
                keep_cuts.append(c)
            if keep_cuts:
                data, rix, cix, rhs_list = [], [], [], []
                for r, c in enumerate(keep_cuts):
                    data.extend(c.vals.tolist())
                    rix.extend([r] * len(c.cols))
                    cix.extend(c.cols.tolist())
                    rhs_list.append(c.rhs)
                cut_block = _sp.csc_matrix(
                    (data, (rix, cix)),
                    shape=(len(keep_cuts), lp.num_col))
                _Relax.a_csc = _sp.vstack(
                    [_Relax.a_csc, cut_block]).tocsc()
                _Relax.row_lower = np.concatenate(
                    [_Relax.row_lower,
                     np.full(len(keep_cuts), -kHighsInf)])
                _Relax.row_upper = np.concatenate(
                    [_Relax.row_upper, np.asarray(rhs_list)])
                _Relax.num_cut_rows += len(keep_cuts)
                # stored warm bases grow by one basic logical per row
                ext = np.ones(len(keep_cuts), dtype=np.int8)
                for nd in heap:
                    if nd.basis is not None:
                        nd.basis = np.concatenate([nd.basis, ext])
                if node_basis is not None:
                    node_basis = np.concatenate([node_basis, ext])
                close_batch_evaluator()  # row count changed
                if log is not None:
                    log(f"MIP node separation: +{len(keep_cuts)} cuts "
                        f"({_Relax.num_cut_rows} total)")

        if sub_level == 0 and options.mip_heuristic_run_rins and \
                incumbent_obj < math.inf and incumbent_x is not None and \
                info.mip_node_count >= rins_next_node[0]:
            lo2, up2, nfx = heur.submip_bounds_rins(
                is_int, incumbent_x, x, node.lo, node.up, feastol)
            improved = nfx and run_submip(lo2, up2, "RINS",
                                          node_budget=200)
            if improved:
                apply_root_redcost_fixing()
                rins_interval[0] = 100
            else:
                # back off multiplicatively: each sub-MIP pays a full
                # root setup, so fruitless RINS must get rarer
                # (reference analogue: mip_heuristic_effort budgeting)
                rins_interval[0] = min(6400, rins_interval[0] * 2)
            rins_next_node[0] = info.mip_node_count + rins_interval[0]
        if incumbent_obj == math.inf and nodes_since_fj >= 200 and \
                options.mip_heuristic_run_feasibility_jump:
            nodes_since_fj = 0
            run_feasibility_jump(x, node.lo, node.up,
                                 seed=info.mip_node_count,
                                 effort=0.15)

        # ---- choose a branching variable ---------------------------------
        frac = np.abs(x - np.round(x))
        cand_int = np.nonzero(is_int & (frac > feastol))[0]
        semi_cand = []
        if is_semi.any():
            for j in np.nonzero(is_semi)[0]:
                if x[j] > feastol and x[j] < lp.col_lower[j] - feastol \
                        and node.up[j] > 0 and node.lo[j] <= 0:
                    semi_cand.append(j)
        sos_viol = sos_first_violated(x) if sos_sets else -1
        if len(cand_int) == 0 and not semi_cand and sos_viol < 0:
            # numerically integral
            try_incumbent(np.where(is_int, np.round(x), x), "snap")
            continue

        if len(cand_int) == 0 and not semi_cand and sos_viol >= 0:
            # ---- SOS branching (reference: HighsSearch SOS handling):
            # split the violated set at the weighted centre; each child
            # zeroes one half ------------------------------------------
            styp, members = sos_sets[sos_viol]
            absx = np.abs(x[members])
            tot = float(absx.sum())
            wpos = float((np.arange(len(members)) * absx).sum() / tot) \
                if tot > 0 else 0.5 * len(members)
            split = int(np.clip(round(wpos), 1, len(members) - 1))
            # SOS2 keeps one overlap member free in both children
            right0 = split + (1 if styp == 2 else 0)
            # zeroing a member = intersect its box with {0}: when the
            # node box excludes 0 the child is (correctly) infeasible
            lo1, up1 = node.lo.copy(), node.up.copy()
            zr = members[right0:]
            lo1[zr] = np.maximum(lo1[zr], 0.0)
            up1[zr] = np.minimum(up1[zr], 0.0)
            lo2, up2 = node.lo.copy(), node.up.copy()
            zl = members[:split]
            lo2[zl] = np.maximum(lo2[zl], 0.0)
            up2[zl] = np.minimum(up2[zl], 0.0)
            children = [(lo1, up1), (lo2, up2)]
            plunge_child = 0 if absx[:split].sum() >= \
                absx[split:].sum() else 1
            built = []
            sos_seeds = [zr, zl]
            for ci_s, (clo, cup) in enumerate(children):
                seed = sos_seeds[ci_s] \
                    if node.prop_gen == prop.gen else None
                okc, plo, pup = prop.propagate(clo, cup,
                                               seed_cols=seed)
                if not okc:
                    built.append(None)
                    continue
                child = _Node(obj_bound, seq, plo, pup, node.depth + 1,
                              basis=node_basis, prop_gen=prop.gen)
                seq += 1
                built.append(child)
            other = 1 - plunge_child
            if built[other] is not None:
                heapq.heappush(heap, built[other])
            if built[plunge_child] is not None and node.depth < 400 and \
                    batch_k <= 1:
                current = built[plunge_child]
            elif built[plunge_child] is not None:
                heapq.heappush(heap, built[plunge_child])
            continue

        if semi_cand:
            j = int(semi_cand[0])
            # branch: x_j = 0  vs  x_j >= l_j
            lo1, up1 = node.lo.copy(), node.up.copy()
            up1[j] = 0.0
            lo1[j] = min(lo1[j], 0.0)
            lo2, up2 = node.lo.copy(), node.up.copy()
            lo2[j] = lp.col_lower[j]
            children = [(lo1, up1), (lo2, up2)]
            plunge_child = 1 if x[j] >= 0.5 * lp.col_lower[j] else 0
        else:
            avg_up, avg_dn = pscost.averages()
            f = x[cand_int] - np.floor(x[cand_int])
            scores = np.array([
                pscost.score(j, fj, 1.0 - fj, avg_up, avg_dn)
                for j, fj in zip(cand_int, f)])

            # ---- reliability (strong) branching: initialize unreliable
            # pseudocosts by actually solving both children shallowly
            # (reference: strong branching under mip_pscost_minreliable,
            # HighsSearch::branch) ------------------------------------
            if use_simplex and strong_branch_budget[0] > 0 and \
                    node.depth <= 8 and math.isfinite(obj_bound):
                order = np.argsort(-scores)
                for oi in order[:3]:
                    jc = int(cand_int[oi])
                    if pscost.reliable(jc) or \
                            strong_branch_budget[0] <= 0:
                        continue
                    fjc = float(x[jc] - math.floor(x[jc]))
                    for dirn, bnd in ((-1, math.floor(x[jc])),
                                      (+1, math.ceil(x[jc]))):
                        lo_sb = node.lo.copy()
                        up_sb = node.up.copy()
                        if dirn < 0:
                            up_sb[jc] = bnd
                        else:
                            lo_sb[jc] = bnd
                        res_sb, x_sb, _ys, _zs, _bs, it_sb = simplex_solve(
                            _Relax.a_csc, sense * lp.col_cost, lo_sb,
                            up_sb, _Relax.row_lower, _Relax.row_upper,
                            basis_in=node_basis, tol_p=1e-9, tol_d=1e-9,
                            max_iter=500)
                        info.iterations += it_sb
                        strong_branch_budget[0] -= 1
                        frac_d = fjc if dirn < 0 else 1.0 - fjc
                        if res_sb == RESULT_OPTIMAL:
                            child_obj = float(sense * lp.col_cost @ x_sb)
                            pscost.update(jc, dirn, frac_d,
                                          child_obj - obj_bound)
                        elif res_sb == RESULT_INFEASIBLE:
                            # infeasible child: huge degradation signal
                            pscost.update(jc, dirn, frac_d,
                                          1e4 * (1.0 + abs(obj_bound)))
                scores = np.array([
                    pscost.score(j2, fj2, 1.0 - fj2, avg_up, avg_dn)
                    for j2, fj2 in zip(cand_int, f)])

            j = int(cand_int[int(np.argmax(scores))])
            fj = x[j] - math.floor(x[j])
            lo1, up1 = node.lo.copy(), node.up.copy()
            up1[j] = math.floor(x[j])  # down branch
            lo2, up2 = node.lo.copy(), node.up.copy()
            lo2[j] = math.ceil(x[j])  # up branch
            children = [(lo1, up1), (lo2, up2)]
            # plunge toward the nearer integer (depth-first dive,
            # reference: HighsSearch::dive / backtrackPlunge)
            plunge_child = 1 if fj > 0.5 else 0

        built = []
        for ci, (clo, cup) in enumerate(children):
            # both the integer and the semi branch change exactly one
            # column's bounds relative to the parent fixpoint —
            # incremental propagation seeds only its rows
            seed = np.array([j], dtype=np.int32) \
                if node.prop_gen == prop.gen else None
            ok, plo, pup = prop.propagate(clo, cup, seed_cols=seed)
            if debug_sol is not None and debug_sol.active and \
                    debug_sol.in_box(clo, cup):
                if not ok:
                    debug_sol._report("child propagation infeasible")
                else:
                    debug_sol.check_bounds(plo, pup,
                                           "child propagation")
            if not ok:
                built.append(None)
                continue
            child = _Node(obj_bound, seq, plo, pup, node.depth + 1,
                          basis=node_basis, prop_gen=prop.gen)
            if not semi_cand:
                child.branch_j = j
                # child 0 = down branch, child 1 = up branch
                child.branch_dir = -1 if ci == 0 else +1
                child.branch_frac = fj if ci == 0 else 1.0 - fj
                child.parent_obj = obj_bound
            seq += 1
            built.append(child)
        other = 1 - plunge_child
        if built[other] is not None:
            heapq.heappush(heap, built[other])
        if built[plunge_child] is not None and node.depth < 400 and \
                batch_k <= 1:
            current = built[plunge_child]
        elif built[plunge_child] is not None:
            heapq.heappush(heap, built[plunge_child])

    # ---- wrap up ----------------------------------------------------------
    close_batch_evaluator()
    open_bound = min((nd.bound for nd in heap), default=math.inf)
    if incumbent_obj < math.inf:
        dual_bound = min(open_bound, incumbent_obj)
        info.mip_dual_bound = sense * dual_bound + lp.offset
        info.mip_gap = current_gap(dual_bound)
        if status == HighsModelStatus.kNotset:
            status = HighsModelStatus.kOptimal
            info.mip_gap = 0.0 if not heap else info.mip_gap
        info.primal_obj = sense * incumbent_obj + lp.offset
        x = incumbent_x
        sol = HighsSolution(
            value_valid=True, dual_valid=False,
            col_value=x,
            row_value=(a_csr @ x if lp.num_row else np.zeros(0)))
    else:
        sol = HighsSolution()
        if status == HighsModelStatus.kNotset:
            # exhausted without incumbent: infeasible, unless the user
            # cutoff pruned the tree (reference kObjectiveBound)
            status = (HighsModelStatus.kObjectiveBound
                      if math.isfinite(user_cutoff)
                      else HighsModelStatus.kInfeasible)
    info.status = status
    info.solve_time = time.perf_counter() - t0
    return status, sol, info
