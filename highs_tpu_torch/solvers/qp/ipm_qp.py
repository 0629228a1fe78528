"""Convex QP interior-point solver on torch.

The JAX package's `solvers/qp/ipm_qp.py` (replacing the reference's
QUASS active set, qpsolver/a_quass.cpp, and HiPO-QP, Highs.cpp:4160) as
torch f64 on the solver's device:

    min 1/2 x'Qx + c'x   s.t.  L <= Ax <= U,  l <= x <= u,  Q psd

Standard form as in the LP IPM (`solvers/ipm/solver.py`): equality rows
first, surplus slacks on inequality rows.  With H = blockdiag(Q, 0) the
Newton reduction is

    dv = (H + D)^-1 (A_std' dy - rhs_v)
    [A (Q+Dx)^-1 A' + diag(slack)/Ds + reg] dy = rb + A_std (H+D)^-1 rhs_v

so one iteration is a dense Cholesky of Q + Dx (n_std x n_std), the
triangular solves W = (Q+Dx)^-1 A' (n_std x m), the GEMM A W and a
dense Cholesky of the m x m Schur complement, all on the device
(cuSOLVER and cuBLAS on a card), and one read of the iteration's
metrics by the host.  A failed factor gives NaN (`cholesky_ex`), which
the solve loop answers by restoring the iterate and raising the
regularization, with no extra sync.  Q and A are built dense on the
device from their sparse triplets; the host never holds them dense.

Where that loop ends short of optimal, `solve_qp_ipm` runs a repaired
pass (see there) whose iterations factor the reduced KKT matrix whole:

    [[Q + Dx, -A'], [A, diag(slack)/Ds + reg]] (dx, dy) = ...

by LU with partial pivoting, one factor an iteration, and refine each
direction through it.  The Schur complement above is what loses the
degenerate QPs: as mu falls, Dx spans 1e-10 to 1e12 and A (Q+Dx)^-1 A'
has eigenvalues far below reg_d and below its own rounding, so
K dv = rb - reg_d dy leaves the primal residual where it is, and the
duals of such QPs (up to 3e8 on CVXQP3_L) make that residual the gap.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ...constants import HessianFormat, HighsModelStatus
from ...device import resolve_device
from ...models.lp import HighsHessian, HighsModel
from ...models.solution import HighsSolution
from ...ops.linops import dense_from_csc
from ...options import HighsOptions
from ...utils.timer import span
from ..ipm.solver import (EPS, F64, IpmProblem, IpmRunInfo, PhaseClock,
                          cho_solve, cholesky, starting_point)
from ..pdlp.preprocess import preprocess_lp, recover_solution

# the phases of one iteration timed into the facade's clocks (`qp_*`):
# the Cholesky of Q + Dx, the solves W = (Q+Dx)^-1 A', the GEMM A W and
# the Cholesky of the Schur complement; in the repaired pass the LU of
# the reduced KKT matrix
PHASES = ("factor_q", "solve_at", "gemm", "factor_m", "factor_kkt")
# dense triangular factors of the iterations, by device type (two an
# iteration: the two Cholesky factors, or an LU's L and U): read like
# the kernels' launch counters, so that a run can show where they ran
DENSE_FACTORS = {"cuda": 0, "cpu": 0}
# repaired passes (`solve_qp_ipm`), by device type
REPAIRS = {"cuda": 0, "cpu": 0}
# the repaired pass: rounds of refinement of each direction, and its
# regularization (primal, dual), far below the first pass's 1e-9
REFINE = 2
REPAIR_REGS = (1e-12, 1e-12)
# the terms of one block of columns in `reduced_costs`
BLOCK_TERMS = 2 ** 24


class QpIpmProblem(NamedTuple):
    a: torch.Tensor  # (m, n_std) dense
    q: torch.Tensor  # (n_std, n_std) dense psd Hessian (slack rows/cols 0)
    b: torch.Tensor
    c: torch.Tensor
    slack_mask: torch.Tensor
    lo: torch.Tensor
    up: torch.Tensor
    lo_fin: torch.Tensor
    up_fin: torch.Tensor
    active: torch.Tensor
    norm_c: torch.Tensor
    norm_b: torch.Tensor


class QpIpmState(NamedTuple):
    x: torch.Tensor
    xl: torch.Tensor
    xu: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor


class QpIpmMetrics(NamedTuple):
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    mu: torch.Tensor
    primal_obj: torch.Tensor
    comp_gap: torch.Tensor
    alpha_p: torch.Tensor
    alpha_d: torch.Tensor


def _mv(problem: QpIpmProblem, xs: torch.Tensor) -> torch.Tensor:
    n = problem.a.shape[1]
    return problem.a @ xs[:n] - problem.slack_mask * xs[n:]


def _rmv(problem: QpIpmProblem, y: torch.Tensor) -> torch.Tensor:
    return torch.cat([y @ problem.a, -problem.slack_mask * y])


def _residuals(problem: QpIpmProblem, state: QpIpmState):
    m, n = problem.a.shape
    qx = problem.q @ state.x[:n]
    grad = torch.cat([problem.c + qx, qx.new_zeros(m)])
    rb = problem.b - _mv(problem, state.x)
    rc = (grad - _rmv(problem, state.y) - state.zl + state.zu)
    rc = rc * problem.active
    rl = (problem.lo - state.x + state.xl) * problem.lo_fin
    ru = (problem.up - state.x - state.xu) * problem.up_fin
    return rb, rc, rl, ru, qx


def qp_ipm_step(problem: QpIpmProblem, state: QpIpmState, regs,
                settings: Tuple, clock: Optional[PhaseClock] = None,
                kkt: bool = False) -> Tuple[QpIpmState, QpIpmMetrics]:
    """One Mehrotra predictor-corrector iteration on the problem's
    device.  `regs` = (reg_primal, reg_dual); `settings` = (sigma_min,
    sigma_max, ftb, theta_max); `clock` times the phases of `PHASES`.
    With `kkt` the Newton systems go through the LU of the reduced KKT
    matrix, each direction refined `REFINE` times (the repaired pass);
    without, through the Schur complement (the JAX package's step)."""
    def phase(name):
        return clock.phase(name) if clock is not None else \
            contextlib.nullcontext()
    sigma_min, sigma_max, ftb, theta_max = settings
    reg_p, reg_d = float(regs[0]), float(regs[1])
    n = problem.a.shape[1]
    lo_fin, up_fin = problem.lo_fin, problem.up_fin

    rb, rc, rl, ru, _ = _residuals(problem, state)

    n_fin = torch.clamp_min(lo_fin.sum() + up_fin.sum(), 1.0)
    gap_sum = ((state.xl * state.zl * lo_fin).sum() +
               (state.xu * state.zu * up_fin).sum())
    mu = gap_sum / n_fin

    xl_safe = torch.clamp_min(state.xl, EPS)
    xu_safe = torch.clamp_min(state.xu, EPS)
    d = state.zl / xl_safe * lo_fin + state.zu / xu_safe * up_fin + reg_p
    # fixed vars: huge D freezes them (dv ~ 0)
    d = torch.where(problem.active > 0,
                    torch.clamp_min(d, 1.0 / theta_max), theta_max)
    d_x, d_s = d[:n], d[n:]

    if kkt:
        m = problem.a.shape[0]
        theta_s = problem.slack_mask / d_s
        with phase("factor_kkt"):
            mat = problem.q.new_zeros((n + m, n + m))
            mat[:n, :n] = problem.q
            mat[:n, :n].diagonal().add_(d_x)
            mat[:n, n:] = -problem.a.T
            mat[n:, :n] = problem.a
            mat[n:, n:].diagonal().add_(theta_s + reg_d)
            lu, piv, _ = torch.linalg.lu_factor_ex(mat)
            del mat
        DENSE_FACTORS[lu.device.type] += 2

        def kkt_solve(f, g):
            """(dv, dy) with (H + D) dv - K'dy = f, K dv + reg_d dy = g:
            the slacks eliminated, (dx, dy) through the LU."""
            f_s = f[n:]
            rhs = torch.cat([f[:n], g + problem.slack_mask * f_s / d_s])
            sol = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
            dy = sol[n:]
            return torch.cat([sol[:n], (f_s - problem.slack_mask * dy) /
                              d_s]), dy

        def hd_mul(v):
            """(H + D) v over stacked vars."""
            return torch.cat([problem.q @ v[:n] + d_x * v[:n],
                              d_s * v[n:]])

        def solve_newton(rmu_l, rmu_u):
            rhs_v = (rc - rmu_l / xl_safe * lo_fin -
                     state.zl * rl / xl_safe * lo_fin +
                     rmu_u / xu_safe * up_fin -
                     state.zu * ru / xu_safe * up_fin)
            dv, dy = kkt_solve(-rhs_v, rb)
            for _ in range(REFINE):
                # the residuals of the factored system, solved again
                ddv, ddy = kkt_solve(
                    _rmv(problem, dy) - rhs_v - hd_mul(dv),
                    rb - _mv(problem, dv) - reg_d * dy)
                dv, dy = dv + ddv, dy + ddy
            dxl = (dv - rl) * lo_fin
            dxu = (ru - dv) * up_fin
            dzl = ((rmu_l - state.zl * dxl) / xl_safe) * lo_fin
            dzu = ((rmu_u - state.zu * dxu) / xu_safe) * up_fin
            return dv, dy, dxl, dxu, dzl, dzu
    else:
        # factor (Q + Dx) once per iteration
        with phase("factor_q"):
            qd = problem.q.clone()
            qd.diagonal().add_(d_x)
            chol_qd = cholesky(qd)
            del qd
        # W = (Q+Dx)^-1 A'  (n x m)
        with phase("solve_at"):
            w = torch.cholesky_solve(problem.a.T, chol_qd)
        theta_s = problem.slack_mask / d_s
        with phase("gemm"):
            mmat = problem.a @ w
            mmat.diagonal().add_(theta_s + reg_d)
            del w
        with phase("factor_m"):
            chol_m = cholesky(mmat)
            del mmat
        DENSE_FACTORS[chol_qd.device.type] += 2

        def hd_solve(v):
            """(H + D)^-1 v over stacked vars."""
            return torch.cat([cho_solve(chol_qd, v[:n]), v[n:] / d_s])

        def solve_newton(rmu_l, rmu_u):
            rhs_v = (rc - rmu_l / xl_safe * lo_fin -
                     state.zl * rl / xl_safe * lo_fin +
                     rmu_u / xu_safe * up_fin -
                     state.zu * ru / xu_safe * up_fin)
            wv = hd_solve(rhs_v)
            rhs_y = rb + _mv(problem, wv)
            dy = cho_solve(chol_m, rhs_y)
            dv = hd_solve(_rmv(problem, dy) - rhs_v)
            dxl = (dv - rl) * lo_fin
            dxu = (ru - dv) * up_fin
            dzl = ((rmu_l - state.zl * dxl) / xl_safe) * lo_fin
            dzu = ((rmu_u - state.zu * dxu) / xu_safe) * up_fin
            return dv, dy, dxl, dxu, dzl, dzu

    def max_step(v, dv, mask):
        ratio = torch.where((dv < 0) & (mask > 0),
                            -v / torch.clamp_max(dv, -EPS), torch.inf)
        return torch.clamp_max(ratio.min(), 1.0)

    def steps(dxl, dxu, dzl, dzu):
        return (torch.minimum(max_step(state.xl, dxl, lo_fin),
                              max_step(state.xu, dxu, up_fin)),
                torch.minimum(max_step(state.zl, dzl, lo_fin),
                              max_step(state.zu, dzu, up_fin)))

    rmu_l_aff = -state.xl * state.zl * lo_fin
    rmu_u_aff = -state.xu * state.zu * up_fin
    _, _, dxla, dxua, dzla, dzua = solve_newton(rmu_l_aff, rmu_u_aff)
    ap_aff, ad_aff = steps(dxla, dxua, dzla, dzua)
    mu_aff = (((state.xl + ap_aff * dxla) *
               (state.zl + ad_aff * dzla) * lo_fin).sum() +
              ((state.xu + ap_aff * dxua) *
               (state.zu + ad_aff * dzua) * up_fin).sum()) / n_fin
    sigma = torch.clamp((mu_aff / torch.clamp_min(mu, EPS)) ** 3,
                        sigma_min, sigma_max)

    rmu_l = (sigma * mu - state.xl * state.zl - dxla * dzla) * lo_fin
    rmu_u = (sigma * mu - state.xu * state.zu - dxua * dzua) * up_fin
    dv, dy, dxl, dxu, dzl, dzu = solve_newton(rmu_l, rmu_u)

    alpha_p, alpha_d = steps(dxl, dxu, dzl, dzu)
    # QP: primal and dual influence each other through Q — use the joint
    # step to keep the Newton system consistent
    alpha = torch.minimum(ftb * alpha_p, ftb * alpha_d)

    new_state = QpIpmState(
        x=state.x + alpha * dv,
        xl=torch.where(lo_fin > 0, state.xl + alpha * dxl, 1.0),
        xu=torch.where(up_fin > 0, state.xu + alpha * dxu, 1.0),
        y=state.y + alpha * dy,
        zl=torch.where(lo_fin > 0, state.zl + alpha * dzl, 0.0),
        zu=torch.where(up_fin > 0, state.zu + alpha * dzu, 0.0))

    rb2, rc2, _, _, qx2 = _residuals(problem, new_state)
    gap2 = ((new_state.xl * new_state.zl * lo_fin).sum() +
            (new_state.xu * new_state.zu * up_fin).sum())
    x_part = new_state.x[:n]
    pobj = 0.5 * torch.dot(x_part, qx2) + torch.dot(problem.c, x_part)
    metrics = QpIpmMetrics(
        primal_res=torch.linalg.norm(rb2), dual_res=torch.linalg.norm(rc2),
        mu=gap2 / n_fin, primal_obj=pobj, comp_gap=gap2,
        alpha_p=alpha, alpha_d=alpha)
    return new_state, metrics


def dense_hessian(hessian: HighsHessian, n_std: int, sense: float,
                  device) -> torch.Tensor:
    """sense * Q (the full symmetric Q of `hessian`) in the leading
    block of an n_std x n_std zero matrix on `device`."""
    dim = hessian.dim
    q = dense_from_csc(hessian.start, hessian.index, hessian.value,
                       (n_std, n_std), device)
    if hessian.format == HessianFormat.kTriangular:
        # the stored lower triangle, symmetrized as to_scipy_full does
        diag = q.diagonal()[:dim].clone()
        q = q + q.T
        q.diagonal()[:dim].sub_(diag)
    if sense != 1.0:
        q.mul_(sense)
    return q


def _lp_view(problem: QpIpmProblem, c: torch.Tensor) -> IpmProblem:
    """The QP's constraints with the cost `c`, as the LP IPM's problem."""
    return IpmProblem(
        a=problem.a, b=problem.b, c=c, slack_mask=problem.slack_mask,
        lo=problem.lo, up=problem.up, lo_fin=problem.lo_fin,
        up_fin=problem.up_fin, active=problem.active,
        norm_c=torch.linalg.norm(c), norm_b=problem.norm_b)


def qp_starting_point(problem: QpIpmProblem) -> QpIpmState:
    """The LP IPM's least-squares start with the objective's gradient
    at its x0 in place of c: y0 fits c + Q x0, z0 is what y0 leaves of
    it, and the duals' shift scales with that gradient.  The LP start
    takes y0 and z0 from c alone, so where Q's weights dwarf c the
    first dual residual is Q x0 whole and the joint step stays tiny
    (CVXQP2: 5.8e5 from the first iteration to the stall)."""
    n = problem.a.shape[1]
    chol = cholesky(problem.a @ problem.a.T +
                    torch.diag(problem.slack_mask + 1e-8))

    def solve_gram(rhs):
        return cho_solve(chol, rhs)
    x0 = starting_point(_lp_view(problem, problem.c), solve_gram).x
    grad = problem.c + problem.q @ x0[:n]
    return QpIpmState(*starting_point(_lp_view(problem, grad), solve_gram))


def certificate(problem: QpIpmProblem, state: QpIpmState) -> torch.Tensor:
    """The optimality certificate of the iterate's x and y in standard
    form, with the reduced costs z = c + Qx - K'y that the solution
    reports (so stationarity holds by construction), on the device:
    the primal residual and bound violation over 1 + |b|, the weight of
    z on infinite bounds over 1 + |c|, and the gap between c'x +
    1/2 x'Qx and the dual objective b'y - 1/2 x'Qx + the finite bound
    terms over 1 + |both|."""
    n = problem.a.shape[1]
    x_std = state.x[:n]
    qx = problem.q @ x_std
    z = torch.cat([problem.c + qx, qx.new_zeros(problem.a.shape[0])]) - \
        _rmv(problem, state.y)
    # infinite bounds are stored as -+1e30
    lo_f, up_f = problem.lo > -1e29, problem.up < 1e29
    zp, zn = torch.clamp_min(z, 0.0), torch.clamp_max(z, 0.0)
    viol = torch.cat([
        problem.b - _mv(problem, state.x),
        torch.where(lo_f, torch.clamp_min(problem.lo - state.x, 0.0), 0.0),
        torch.where(up_f, torch.clamp_min(state.x - problem.up, 0.0), 0.0)])
    wrong = torch.cat([torch.where(lo_f, 0.0, zp),
                       torch.where(up_f, 0.0, zn)])
    pobj = torch.dot(problem.c, x_std) + 0.5 * torch.dot(x_std, qx)
    dobj = (torch.dot(problem.b, state.y) - 0.5 * torch.dot(x_std, qx) +
            torch.where(lo_f, problem.lo * zp, 0.0).sum() +
            torch.where(up_f, problem.up * zn, 0.0).sum())
    return torch.stack([
        torch.linalg.norm(viol) / (1.0 + problem.norm_b),
        torch.linalg.norm(wrong) / (1.0 + problem.norm_c),
        torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))])


class _Loop:
    """The iterations of one solve, shared by the first pass and the
    repaired one: each step, the host's one read of its metrics, and
    the stopping rules.  At most `ipm_iteration_limit` iterations in
    all, and 200 a pass."""

    def __init__(self, problem, options, clock, t0, log):
        self.problem = problem
        self.options = options
        self.clock = clock
        self.t0 = t0
        self.log = log
        self.tol = options.ipm_optimality_tolerance
        # reading these waits for the set-up
        self.norm_b = float(problem.norm_b)
        self.norm_c = float(problem.norm_c)
        self.iterations = 0

    def left(self) -> int:
        """The iterations the next pass may take."""
        return min(self.options.ipm_iteration_limit - self.iterations, 200)

    def run(self, state: QpIpmState, repaired: bool = False):
        """Iterate from `state`: (status, state).  The repaired pass
        steps through the KKT matrix's LU at `REPAIR_REGS` and stops
        optimal on the `certificate` at the tolerance; the first pass is
        the JAX package's loop."""
        sett = (1e-4, 0.9, 0.9995, 1e10)
        regs = np.array(REPAIR_REGS if repaired else [1e-9, 1e-9])
        limit = self.left()
        stall = 0
        best_err = np.inf
        nan_retries = 0
        it = 0
        status = HighsModelStatus.kNotset
        while it < limit:
            prev = state
            state, metrics = qp_ipm_step(self.problem, state, regs, sett,
                                         clock=self.clock, kkt=repaired)
            it += 1
            self.iterations += 1
            read = list(metrics)
            if repaired:
                read += list(certificate(self.problem, state))
            read = torch.stack(read).cpu().tolist()
            mh, cert = QpIpmMetrics(*read[:7]), read[7:]
            self.clock.collect()
            if not math.isfinite(mh.mu):
                state = prev
                nan_retries += 1
                regs = regs * 100.0
                if nan_retries > 4:
                    status = HighsModelStatus.kUnknown
                    break
                continue
            rel_p = mh.primal_res / (1.0 + self.norm_b)
            rel_d = mh.dual_res / (1.0 + self.norm_c)
            rel_mu = mh.mu / (1.0 + abs(mh.primal_obj))
            if self.log is not None:
                self.log(f"qp-ipm {self.iterations:3d} "
                         f"pobj={mh.primal_obj:.10e} mu={mh.mu:.2e} "
                         f"rp={rel_p:.2e} rd={rel_d:.2e}" +
                         "".join(f" {k}={v:.2e}" for k, v in
                                 zip(("cp", "cs", "cg"), cert)))
            err = rel_p + rel_d + rel_mu
            if err < best_err * 0.99:
                best_err = err
                stall = 0
            else:
                stall += 1
            if cert and max(cert) < self.tol or not repaired and \
                    rel_p < self.tol and rel_d < self.tol and \
                    rel_mu < self.tol:
                status = HighsModelStatus.kOptimal
                break
            if stall > 12:
                status = HighsModelStatus.kUnknown
                break
            if time.perf_counter() - self.t0 > self.options.time_limit:
                status = HighsModelStatus.kTimeLimit
                break
        if status == HighsModelStatus.kNotset:
            status = HighsModelStatus.kIterationLimit
        return status, state

    def short(self, status, state) -> bool:
        """Whether the first pass ended short of optimal: a stall, the
        iteration cap with iterations left, or an optimal stop whose
        certificate misses the tolerance."""
        if status == HighsModelStatus.kOptimal:
            cert = certificate(self.problem, state).cpu().tolist()
            return max(cert) >= self.tol
        return status == HighsModelStatus.kUnknown or \
            status == HighsModelStatus.kIterationLimit and self.left() > 0


def _halves(u: torch.Tensor):
    """Dekker's split of u into hi + lo, each of at most 26 bits."""
    t = 134217729.0 * u  # 2^27 + 1
    hi = t - (t - u)
    return hi, u - hi


def reduced_costs(problem: QpIpmProblem, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """c + Qx - K'y over the structural columns, on the device, every
    product and sum compensated: where the duals reach 1e8 (CVXQP3_L),
    a plain float64 K'y rounds each of its terms by 1e-8 and more.

    Column j's terms c_j, Q_kj x_k and -A_ij y_i are each split into a
    part on the grid of sigma_j, a power of two above the column's
    count times its largest term, and the rest (Rump's extraction): the
    parts add up exactly in any order, the rests and the products'
    errors (Dekker) are of the order eps sigma_j, so the result is the
    exact sum rounded but for rounding of the order eps^2.  The columns
    go in blocks of about `BLOCK_TERMS` terms."""
    m, n = problem.a.shape
    terms = n + m + 1
    # 2^k >= terms + 1
    grid = float(2 ** math.ceil(math.log2(terms + 1)))
    vec = torch.cat([x.new_ones(1), x, -y])
    v_hi, v_lo = (h[:, None] for h in _halves(vec))
    vec = vec[:, None]
    z = torch.empty_like(x)
    step = max(1, BLOCK_TERMS // terms)
    for j in range(0, n, step):
        cols = slice(j, j + step)
        mat = torch.cat([problem.c[None, cols], problem.q[:, cols],
                         problem.a[:, cols]])
        p = mat * vec
        a_hi, a_lo = _halves(mat)
        err = (((a_hi * v_hi - p) + a_hi * v_lo + a_lo * v_hi) +
               a_lo * v_lo).sum(0)
        del mat, a_hi, a_lo
        mu = p.abs().amax(0)
        mu = torch.where(mu > 0, mu, 1.0)
        mant, _ = torch.frexp(mu)
        # mu / mant is the power of two just above mu, exactly
        sigma = mu / mant * grid
        q = (sigma + p) - sigma
        z[j:j + step] = q.sum(0) + ((p - q).sum(0) + err)
    return z


def solve_qp_ipm(model: HighsModel, options: HighsOptions, log=None,
                 device=None
                 ) -> Tuple[HighsModelStatus, HighsSolution, IpmRunInfo]:
    """Solve a convex QP with the dense QP IPM on `device` (default
    CUDA).  The facade's clocks (`getTimer()`) and, under a profiler,
    spans "highs.<clock>": `qp_setup` (`qp.prepare`: standard form, Q
    and A dense on the device; `qp.start`: the starting point),
    `qp_iterations` (calls = iterations), the iterations' phases
    `qp_factor_q`, `qp_solve_at`, `qp_gemm`, `qp_factor_m` and
    `qp_factor_kkt`, `qp.repair` (the repaired pass) and `qp.recover`
    (the solution in the model's space).

    The first pass is the JAX package's.  Where it ends short of
    optimal (`_Loop.short`), the repaired pass restarts from the
    gradient-aware `qp_starting_point`, steps through the LU of the
    reduced KKT matrix and stops on the `certificate`; `REPAIRS` counts
    these passes by device.  The
    reported reduced costs are c + Qx - A'y in compensated arithmetic
    (`reduced_costs`), on the device."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    timer = getattr(options, "_timer", None)
    info = IpmRunInfo()
    lp = model.lp
    sense = float(lp.sense)

    with span(timer, "qp_setup"):
        with span(timer, "qp.prepare"):
            std = preprocess_lp(lp)
            m, n_std = std.num_row, std.num_col
            a_csc = sp.csc_matrix(std.a)

            is_ineq = (np.arange(m) >= std.num_eq).astype(np.float64)
            lo = np.concatenate([std.col_lower, np.zeros(m)])
            up = np.concatenate([std.col_upper,
                                 np.where(is_ineq > 0, np.inf, 0.0)])
            fixed = np.zeros(n_std + m, dtype=bool)
            with np.errstate(invalid="ignore"):
                fixed[:n_std] = (np.isfinite(lo[:n_std]) &
                                 np.isfinite(up[:n_std]) &
                                 (up[:n_std] - lo[:n_std] <=
                                  1e-14 * (1.0 + np.abs(lo[:n_std]))))
            fixed[n_std:] = is_ineq == 0
            big = 1e30

            def dev(v):
                return torch.as_tensor(v, dtype=F64, device=device)
            problem = QpIpmProblem(
                a=dense_from_csc(a_csc.indptr, a_csc.indices, a_csc.data,
                                 (m, n_std), device),
                # sense: minimize sense*(c'x + 1/2 x'Qx); preprocess
                # scaled c
                q=dense_hessian(model.hessian, n_std, sense, device),
                b=dev(std.b), c=dev(std.c), slack_mask=dev(is_ineq),
                lo=dev(np.where(np.isfinite(lo), lo, -big)),
                up=dev(np.where(np.isfinite(up), up, big)),
                lo_fin=dev(np.isfinite(lo) & ~fixed),
                up_fin=dev(np.isfinite(up) & ~fixed),
                active=dev(~fixed),
                norm_c=dev(np.linalg.norm(std.c)),
                norm_b=dev(np.linalg.norm(std.b)))
        with span(timer, "qp.start"):
            # starting point: the LP IPM's least-squares heuristic
            state = QpIpmState(*starting_point(
                _lp_view(problem, problem.c)))
            clock = PhaseClock(device, PHASES)
            loop = _Loop(problem, options, clock, t0, log)

    with span(timer, "qp_iterations") as scope:
        status, state = loop.run(state)
        scope.calls = loop.iterations
    if loop.short(status, state):
        with span(timer, "qp.repair"):
            REPAIRS[torch.device(device).type] += 1
            if log is not None:
                log(f"qp-ipm: {status.name} after {loop.iterations} "
                    "iterations; the repaired pass restarts")
            with span(timer, "qp.start"):
                state = qp_starting_point(problem)
            first = loop.iterations
            with span(timer, "qp_iterations") as scope:
                status, state = loop.run(state, repaired=True)
                scope.calls = loop.iterations - first
    it = loop.iterations
    if timer is not None:
        for name, seconds in clock.seconds.items():
            timer.add(f"qp_{name}", seconds, calls=it)

    with span(timer, "qp.recover"):
        x_std = state.x[:n_std]
        z_std = reduced_costs(problem, x_std, state.y)
        x_h, y_h, z_h = (v.cpu().numpy() for v in (x_std, state.y, z_std))
        col_value, row_dual, col_dual = recover_solution(std, x_h, y_h, z_h)
        row_value = lp.a_matrix.to_scipy() @ col_value
        sol = HighsSolution(value_valid=True, dual_valid=True,
                            col_value=col_value, col_dual=col_dual,
                            row_value=row_value, row_dual=row_dual)
        info.primal_obj = (float(lp.col_cost @ col_value) + lp.offset +
                           model.hessian.quad_value(col_value))
    info.status = status
    info.iterations = it
    info.ipm_iterations = it
    info.solve_time = time.perf_counter() - t0
    return status, sol, info
