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
from ..ipm.solver import (EPS, F64, IpmProblem, IpmRunInfo, PhaseClock,
                          cho_solve, cholesky, starting_point)
from ..pdlp.preprocess import preprocess_lp, recover_solution

# the phases of one iteration timed into the facade's clocks (`qp_*`):
# the Cholesky of Q + Dx, the solves W = (Q+Dx)^-1 A', the GEMM A W and
# the Cholesky of the Schur complement
PHASES = ("factor_q", "solve_at", "gemm", "factor_m")
# dense Cholesky factors of the iterations, by device type: read like
# the kernels' launch counters, so that a run can show where they ran
DENSE_FACTORS = {"cuda": 0, "cpu": 0}


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
                settings: Tuple, clock: Optional[PhaseClock] = None
                ) -> Tuple[QpIpmState, QpIpmMetrics]:
    """One Mehrotra predictor-corrector iteration on the problem's
    device.  `regs` = (reg_primal, reg_dual); `settings` = (sigma_min,
    sigma_max, ftb, theta_max); `clock` times the phases of `PHASES`."""
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


def _host_metrics(metrics: QpIpmMetrics) -> QpIpmMetrics:
    """The metrics as Python floats, in one device-to-host read."""
    return QpIpmMetrics(*torch.stack(list(metrics)).cpu().tolist())


def solve_qp_ipm(model: HighsModel, options: HighsOptions, log=None,
                 device=None
                 ) -> Tuple[HighsModelStatus, HighsSolution, IpmRunInfo]:
    """Solve a convex QP with the dense QP IPM on `device` (default
    CUDA).  The iterations' phases land in the facade's clocks
    (`qp_setup`, `qp_iterations`, `qp_factor_q`, `qp_solve_at`,
    `qp_gemm`, `qp_factor_m`)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    info = IpmRunInfo()
    lp = model.lp
    sense = float(lp.sense)

    std = preprocess_lp(lp)
    m, n_std = std.num_row, std.num_col
    a_csc = sp.csc_matrix(std.a)

    is_ineq = (np.arange(m) >= std.num_eq).astype(np.float64)
    lo = np.concatenate([std.col_lower, np.zeros(m)])
    up = np.concatenate([std.col_upper,
                         np.where(is_ineq > 0, np.inf, 0.0)])
    fixed = np.zeros(n_std + m, dtype=bool)
    with np.errstate(invalid="ignore"):
        fixed[:n_std] = (np.isfinite(lo[:n_std]) & np.isfinite(up[:n_std])
                         & (up[:n_std] - lo[:n_std] <=
                            1e-14 * (1.0 + np.abs(lo[:n_std]))))
    fixed[n_std:] = is_ineq == 0
    big = 1e30

    def dev(v):
        return torch.as_tensor(v, dtype=F64, device=device)
    problem = QpIpmProblem(
        a=dense_from_csc(a_csc.indptr, a_csc.indices, a_csc.data,
                         (m, n_std), device),
        # sense: minimize sense*(c'x + 1/2 x'Qx); preprocess scaled c
        q=dense_hessian(model.hessian, n_std, sense, device),
        b=dev(std.b), c=dev(std.c), slack_mask=dev(is_ineq),
        lo=dev(np.where(np.isfinite(lo), lo, -big)),
        up=dev(np.where(np.isfinite(up), up, big)),
        lo_fin=dev(np.isfinite(lo) & ~fixed),
        up_fin=dev(np.isfinite(up) & ~fixed),
        active=dev(~fixed),
        norm_c=dev(np.linalg.norm(std.c)),
        norm_b=dev(np.linalg.norm(std.b)))

    # starting point: the LP IPM's least-squares heuristic
    st0 = starting_point(IpmProblem(
        a=problem.a, b=problem.b, c=problem.c,
        slack_mask=problem.slack_mask, lo=problem.lo, up=problem.up,
        lo_fin=problem.lo_fin, up_fin=problem.up_fin,
        active=problem.active, norm_c=problem.norm_c,
        norm_b=problem.norm_b))
    state = QpIpmState(*st0)

    tol = options.ipm_optimality_tolerance
    sett = (1e-4, 0.9, 0.9995, 1e10)
    regs = np.array([1e-9, 1e-9])
    # reading these waits for the set-up
    norm_b_h = float(problem.norm_b)
    norm_c_h = float(problem.norm_c)
    clock = PhaseClock(device, PHASES)
    t_loop = time.perf_counter()
    status = HighsModelStatus.kNotset
    it = 0
    stall = 0
    best_err = np.inf
    nan_retries = 0
    limit = min(options.ipm_iteration_limit, 200)
    while it < limit:
        prev = state
        state, metrics = qp_ipm_step(problem, state, regs, sett,
                                     clock=clock)
        it += 1
        mh = _host_metrics(metrics)
        clock.collect()
        if not math.isfinite(mh.mu):
            state = prev
            nan_retries += 1
            regs = regs * 100.0
            if nan_retries > 4:
                status = HighsModelStatus.kUnknown
                break
            continue
        rel_p = mh.primal_res / (1.0 + norm_b_h)
        rel_d = mh.dual_res / (1.0 + norm_c_h)
        rel_mu = mh.mu / (1.0 + abs(mh.primal_obj))
        if log is not None:
            log(f"qp-ipm {it:3d} pobj={mh.primal_obj:.10e} "
                f"mu={mh.mu:.2e} rp={rel_p:.2e} rd={rel_d:.2e}")
        err = rel_p + rel_d + rel_mu
        if err < best_err * 0.99:
            best_err = err
            stall = 0
        else:
            stall += 1
        if rel_p < tol and rel_d < tol and rel_mu < tol:
            status = HighsModelStatus.kOptimal
            break
        if stall > 12:
            status = HighsModelStatus.kUnknown
            break
        if time.perf_counter() - t0 > options.time_limit:
            status = HighsModelStatus.kTimeLimit
            break
    if status == HighsModelStatus.kNotset:
        status = HighsModelStatus.kIterationLimit
    timer = getattr(options, "_timer", None)
    if timer is not None:
        # the facade's named clocks (getTimer()): host seconds before the
        # first iteration (standard form, the dense Q and A built on the
        # device, the starting point) and of the iterations, and their
        # phases
        timer.add("qp_setup", t_loop - t0)
        timer.add("qp_iterations", time.perf_counter() - t_loop, calls=it)
        for name, seconds in clock.seconds.items():
            timer.add(f"qp_{name}", seconds, calls=it)

    # reduced costs: grad - K'y restricted to x block
    x_std = state.x[:n_std]
    z_std = problem.q @ x_std + problem.c - state.y @ problem.a
    x_h, y_h, z_h = (v.cpu().numpy() for v in (x_std, state.y, z_std))
    col_value, row_dual, col_dual = recover_solution(std, x_h, y_h, z_h)
    row_value = lp.a_matrix.to_scipy() @ col_value
    sol = HighsSolution(value_valid=True, dual_valid=True,
                        col_value=col_value, col_dual=col_dual,
                        row_value=row_value, row_dual=row_dual)
    info.status = status
    info.iterations = it
    info.ipm_iterations = it
    info.primal_obj = (float(lp.col_cost @ col_value) + lp.offset +
                       model.hessian.quad_value(col_value))
    info.solve_time = time.perf_counter() - t0
    return status, sol, info
