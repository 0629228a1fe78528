"""Active-set convex QP solver (QUASS parity).

Re-implements the behavior of the reference QUASS null-space active-set
method (qpsolver/a_quass.cpp solveqp :130 -> a_asm.cpp solveqp_actual ->
quass.cpp Quass::solve :309) in the slack formulation its README
describes (ASM <-> simplex duality over bounded variables):

    min 1/2 x'Qx + c'x   s.t.  Ax - s = 0,  L <= s <= U,  l <= x <= u

so every inequality is a BOUND on the combined vector v = (x, s) and the
active set is the set of components of v held at a bound.  Each
iteration solves the equality-constrained QP over the free components
via a dense KKT system (the reference uses its own LU, factor.hpp; at
TPU-relevant sizes the dense factorization is the MXU-friendly
equivalent), takes a ratio-test step (ratiotest.cpp), and prices the
active bounds' multipliers to release (Dantzig pricing; dantzigpricing.hpp).

Feasibility phase: a zero-objective LP solve with the native simplex
(reference: feasibility_highs.hpp runs a Highs LP), which also supplies
a crash active set.  Hot starts accept a prior active set
(qp_allow_hot_start).  Regularization `qp_regularization_value` is added
to the reduced Hessian diagonal; limits: `qp_iteration_limit`,
`time_limit`.

Two repairs against the JAX package's copy.  Its KKT solves carry the
constraint block's -delta I (delta = `qp_regularization_value`, 1e-7 by
default) into the step: A d = r + delta lam, so its iterates settle
where A x - s = delta lam, off the rows by up to 2.7e-4 on the generated
QPs of `utils/gen_mm_qp.py`, and it reports kOptimal there.  Here each
solve is refined against the unregularized saddle matrix, and a final
point whose rows or bounds are violated by more than
`primal_feasibility_tolerance` is reported kUnknown, never kOptimal.
With every variable at a bound the multipliers come from a
least-squares solve of [A -I]' lam = g (the JAX code names an undefined
matrix there).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ...constants import HighsModelStatus
from ...models.lp import HighsModel
from ...models.solution import HighsSolution
from ...options import HighsOptions
from ..ipm.sparse_ldl import LdlBlowup, SparseLdl
from ..simplex.native import RESULT_OPTIMAL, simplex_solve


@dataclasses.dataclass
class QpAsmInfo:
    status: HighsModelStatus = HighsModelStatus.kNotset
    iterations: int = 0
    primal_obj: float = math.inf
    solve_time: float = 0.0


def _phase1_start(a_csc, lo_v, up_v, n, m, time_limit=0.0):
    """Feasible start via zero-cost LP on  [A -I] v = 0, lo<=v<=up."""
    ident = sp.identity(m, format="csc")
    a_eq = sp.hstack([a_csc, -ident]).tocsc() if m else \
        sp.csc_matrix((0, n))
    rhs = np.zeros(m)
    result, v, _y, _z, basis, iters = simplex_solve(
        a_eq, np.zeros(n + m), lo_v, up_v, rhs, rhs,
        tol_p=1e-9, tol_d=1e-9, max_iter=100000,
        time_limit=time_limit)
    if result != RESULT_OPTIMAL:
        return None, None, iters
    return v, basis, iters


def _refine(solve, matvec, rhs, sol, max_steps: int = 10):
    """Iterative refinement of `sol` against the matrix of `matvec` with
    the regularized factor's `solve`, while each step at least halves the
    residual."""
    res = rhs - matvec(sol)
    norm = np.abs(res).max(initial=0.0)
    for _ in range(max_steps):
        cand = sol + solve(res)
        cres = rhs - matvec(cand)
        cnorm = np.abs(cres).max(initial=0.0)
        if not cnorm < norm:
            break
        sol, res, prev, norm = cand, cres, norm, cnorm
        if not norm < 0.5 * prev:
            break
    return sol


def _primal_violation(a_csc, x, lp) -> float:
    """Largest violation of L <= Ax <= U and l <= x <= u by x."""
    ax = a_csc @ x if lp.num_row else np.zeros(0)
    return float(max(
        np.max(np.maximum(lp.row_lower - ax, 0.0), initial=0.0),
        np.max(np.maximum(ax - lp.row_upper, 0.0), initial=0.0),
        np.max(np.maximum(lp.col_lower - x, 0.0), initial=0.0),
        np.max(np.maximum(x - lp.col_upper, 0.0), initial=0.0)))


def solve_qp_active_set(model: HighsModel, options: HighsOptions,
                        log=None, active_in: Optional[np.ndarray] = None
                        ) -> Tuple[HighsModelStatus, HighsSolution,
                                   QpAsmInfo]:
    t0 = time.perf_counter()
    info = QpAsmInfo()
    lp = model.lp
    n, m = lp.num_col, lp.num_row
    sense = float(lp.sense)
    feastol = options.primal_feasibility_tolerance
    dualtol = options.dual_feasibility_tolerance
    reg = max(options.qp_regularization_value, 0.0)
    max_iter = min(options.qp_iteration_limit, 100000)

    a_csc = lp.a_matrix.to_scipy().tocsc()
    # Q and A stay SPARSE end to end (reference QUASS keeps its own
    # sparse LU over them, qpsolver/factor.hpp; the former dense
    # materialization was the r02 parity gap)
    if model.hessian is not None and model.hessian.dim:
        q0 = model.hessian.to_scipy_full().tocsc()
        if q0.shape[0] < n:
            q0 = sp.csc_matrix(
                (q0.data, q0.indices, np.concatenate(
                    [q0.indptr,
                     np.full(n - q0.shape[0], q0.indptr[-1],
                             dtype=q0.indptr.dtype)])), shape=(n, n))
    else:
        q0 = sp.csc_matrix((n, n))
    q = (sense * 0.5) * (q0 + q0.T)  # symmetrize; sense folds into Q
    q = q.tocsc()
    c = sense * np.asarray(lp.col_cost, dtype=np.float64)

    nv = n + m
    lo_v = np.concatenate([lp.col_lower, lp.row_lower])
    up_v = np.concatenate([lp.col_upper, lp.row_upper])

    # combined equality system  [A -I] v = 0
    a_eq = (sp.hstack([a_csc, -sp.identity(m)]).tocsc() if m
            else sp.csc_matrix((0, nv)))

    v, _basis, p1_iters = _phase1_start(
        a_csc, lo_v, up_v, n, m,
        time_limit=min(options.time_limit, 1e18))
    info.iterations += p1_iters
    if v is None:
        info.status = HighsModelStatus.kInfeasible
        info.solve_time = time.perf_counter() - t0
        return info.status, HighsSolution(), info

    # active set: -1 at lower, +1 at upper, 0 free
    active = np.zeros(nv, dtype=np.int8)
    lo_fin = np.isfinite(lo_v)
    up_fin = np.isfinite(up_v)
    lo_f = np.where(lo_fin, lo_v, 0.0)
    up_f = np.where(up_fin, up_v, 0.0)
    at_lo = lo_fin & (v <= lo_f + feastol * (1.0 + np.abs(lo_f)))
    at_up = up_fin & (v >= up_f - feastol * (1.0 + np.abs(up_f)))
    active[at_lo] = -1
    active[at_up] = 1
    if active_in is not None and len(active_in) == nv and \
            options.qp_allow_hot_start:
        # hot start: adopt the prior active set where consistent
        cand = np.asarray(active_in, dtype=np.int8)
        keep = ((cand == -1) & np.isfinite(lo_v)) | \
            ((cand == 1) & np.isfinite(up_v)) | (cand == 0)
        active = np.where(keep, cand, active)
        v = np.where(active == -1, lo_v, v)
        v = np.where(active == 1, up_v, v)

    def grad(v):
        g = np.zeros(nv)
        g[:n] = q @ v[:n] + c
        return g

    def kkt_direction(free_idx, g, v_cur):
        """Solve  [Q_FF+regI  A_F'; A_F  -deltaI] [d_F; lam] = [-g_F; r]
        as a SPARSE quasi-definite system via the native signed LDL'
        (native/hipm.cpp hx_ldl_factor_signed) — the role of the
        reference QUASS's own LU (qpsolver/factor.hpp) without
        densifying Q or A."""
        nf = len(free_idx)
        kdim = nf + m
        xmask = free_idx < n
        xi = np.nonzero(xmask)[0]
        fx = free_idx[xmask]
        q_ff = q[fx][:, fx] if len(fx) else sp.csc_matrix((0, 0))
        qblk = sp.coo_matrix(
            (q_ff.tocoo().data,
             (xi[q_ff.tocoo().row], xi[q_ff.tocoo().col])),
            shape=(nf, nf)).tocsc()
        rr = max(reg, 1e-10)
        dd = max(reg, 1e-10)
        af = a_eq[:, free_idx] if m else sp.csc_matrix((0, nf))
        K = sp.bmat(
            [[qblk + rr * sp.identity(nf), af.T],
             [af, -dd * sp.identity(m) if m else None]],
            format="csc") if m else (qblk +
                                     rr * sp.identity(nf)).tocsc()
        K.sum_duplicates()
        # K0 = K + shift: the saddle matrix without the constraint
        # block's -deltaI, the refinement target, so that the step keeps
        # A v - s = 0
        shift = np.concatenate([np.zeros(nf), np.full(m, dd)])
        rhs = np.zeros(kdim)
        rhs[:nf] = -g[free_idx]
        if m:
            # constraint residual correction: restores A v - s = 0 when
            # a hot-started active set moved v off the equality manifold
            rhs[nf:] = -(a_eq @ v_cur)
        signs = np.concatenate([np.ones(nf, np.int8),
                                -np.ones(m, np.int8)])
        try:
            h = SparseLdl(K, max_work=120 * K.nnz + 1_000_000,
                          max_fill=80 * K.nnz + 1_000_000)
            try:
                h.factor_signed(K, signs, reg_floor=1e-13)
                sol = _refine(h.solve, lambda v: K @ v + shift * v, rhs,
                              h.solve(rhs))
            finally:
                h.close()
        except (LdlBlowup, ValueError):
            sol = None
        if sol is None or not np.all(np.isfinite(sol)):
            sol, *_ = np.linalg.lstsq(K.toarray() + np.diag(shift), rhs,
                                      rcond=None)
        # the block system solves (Q+regI)d + A'lam_raw = -g, so the
        # conventional multiplier (g - A'lam = 0 at stationarity on the
        # free set) is -lam_raw
        return sol[:nf], -sol[nf:]

    status = HighsModelStatus.kNotset
    lam = np.zeros(m)
    # Devex reference weights (reference qpsolver/devexpricing.hpp):
    # release candidate maximizes mu^2 / w; weights updated from the
    # released variable's step component, reset to 1 past 1e7
    devex_w = np.ones(nv)
    last_released = -1
    nullspace_limit = int(getattr(options, "qp_nullspace_limit", 4000)
                          or 4000)
    for it in range(max_iter):
        if time.perf_counter() - t0 > options.time_limit:
            status = HighsModelStatus.kTimeLimit
            break
        info.iterations += 1
        g = grad(v)
        free_idx = np.nonzero(active == 0)[0]
        if len(free_idx) > nullspace_limit:
            # reference: QpModelStatus::kLargeNullspace
            # (quass.cpp:364) — the null-space method is the wrong
            # tool once the reduced space gets this big
            if log is not None:
                log(f"QP ASM: nullspace dimension {len(free_idx)} "
                    f"exceeds qp_nullspace_limit {nullspace_limit}")
            status = HighsModelStatus.kUnknown
            break
        if len(free_idx):
            d_f, lam = kkt_direction(free_idx, g, v)
            d = np.zeros(nv)
            d[free_idx] = d_f
        else:
            d = np.zeros(nv)
            # multipliers from the equality system alone
            if m:
                lam, *_ = np.linalg.lstsq(a_eq.T.toarray(), g, rcond=None)
            else:
                lam = np.zeros(m)

        dnorm = float(np.linalg.norm(d, ord=np.inf))
        if dnorm <= 1e-11 * (1.0 + float(np.linalg.norm(v, ord=np.inf))):
            # stationary on the active set: price multipliers
            mu = g - (a_eq.T @ lam if m else 0.0)
            # release rule: at lower needs mu >= 0, at upper mu <= 0
            viol_lo = (active == -1) & (mu < -dualtol) & (lo_v < up_v)
            viol_up = (active == 1) & (mu > dualtol) & (lo_v < up_v)
            viol = np.where(viol_lo, -mu, 0.0) + np.where(viol_up, mu, 0.0)
            if not np.any(viol > dualtol):
                status = HighsModelStatus.kOptimal
                break
            # Devex: maximize mu^2 / weight among admissible violations
            score = np.where(viol > dualtol,
                             viol * viol / devex_w, 0.0)
            j = int(np.argmax(score))
            active[j] = 0
            last_released = j
            continue

        # ratio test: largest alpha <= 1 keeping bounds
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            t_up = np.where(d > feastol, (up_v - v) / d, np.inf)
            t_lo = np.where(d < -feastol, (lo_v - v) / d, np.inf)
        t_lim = np.minimum(t_up, t_lo)
        t_lim[active != 0] = np.inf
        jblk = int(np.argmin(t_lim))
        alpha_max = float(t_lim[jblk])

        # curvature along d
        dx = d[:n]
        curv = float(dx @ (q @ dx))
        gd = float(g @ d)
        # relative curvature: lambda_min along d, not an absolute scale
        # (an absolute cutoff misreads tiny quadratic polish steps as
        # linear and terminates early)
        if curv <= 1e-12 * float(dx @ dx):
            # linear along d: either blocked or unbounded
            if not math.isfinite(alpha_max):
                if gd < -dualtol:
                    status = HighsModelStatus.kUnbounded
                    break
                status = HighsModelStatus.kOptimal
                break
            alpha = alpha_max
        else:
            # Newton step is alpha=1 by construction (d solves the EQP);
            # cap by the ratio test
            alpha = min(1.0, alpha_max)

        # Devex weight update from the released variable's step
        # component (devexpricing.hpp update_weights: the pivot
        # element analogue is d[last_released])
        if last_released >= 0:
            dp = d[last_released]
            if abs(dp) > 1e-12:
                wp = devex_w[last_released]
                # reference devexpricing.hpp rule: MAX-update against
                # the candidate weight (d_j/d_p)^2 * w_p, and the
                # released variable's weight floored at 1 so it cannot
                # collapse toward 0 and explode its next score
                ratio = (d * d) / (dp * dp)
                devex_w = np.maximum(devex_w, ratio * wp)
                devex_w[last_released] = max(wp / (dp * dp), 1.0)
                devex_w[devex_w > 1e7] = 1.0
            last_released = -1

        v = v + alpha * d
        if alpha >= alpha_max - 1e-13 and math.isfinite(alpha_max):
            # activate the blocking bound
            if d[jblk] > 0:
                active[jblk] = 1
                v[jblk] = up_v[jblk]
            else:
                active[jblk] = -1
                v[jblk] = lo_v[jblk]
    else:
        status = HighsModelStatus.kIterationLimit

    if status == HighsModelStatus.kNotset:
        status = HighsModelStatus.kIterationLimit

    x = v[:n]
    if status == HighsModelStatus.kOptimal:
        viol = _primal_violation(a_csc, x, lp)
        if viol > feastol:
            if log is not None:
                log(f"QP ASM: final point violates its rows or bounds by "
                    f"{viol:.3e} > {feastol:g}: not optimal")
            status = HighsModelStatus.kUnknown
    obj = float(0.5 * x @ (q @ x) + c @ x)
    info.primal_obj = sense * obj + lp.offset
    info.solve_time = time.perf_counter() - t0
    info.status = status
    if status not in (HighsModelStatus.kOptimal,):
        return status, HighsSolution(), info

    # duals: row duals = lam (for Ax - s = 0), reduced costs mu on x
    g = grad(v)
    mu = g - (a_eq.T @ lam if m else 0.0)
    sol = HighsSolution(
        value_valid=True, dual_valid=True,
        col_value=x.copy(),
        row_value=(a_csc @ x if m else np.zeros(0)),
        col_dual=sense * mu[:n],
        # s-part multipliers ARE the row duals: column i of [A -I] for
        # s_i is -e_i, so mu_s = 0 - (-lam) = lam = y
        row_dual=sense * (mu[n:] if m else np.zeros(0)))
    # store the active set for hot starts
    sol.qp_active_set = active.copy()
    return status, sol, info
