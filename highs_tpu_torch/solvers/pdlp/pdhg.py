"""Restarted PDHG on a torch device, in two engine modes.

"halpern" re-implements the algorithmic behavior of the reference HiPDLP
solver (highs/pdlp/hipdlp/pdhg.cc, the cuPDLPx-style reflected-Halpern
restarted PDHG with kUseCupdlpx = true, pdhg.hpp:35), as the JAX package
does:

- each inner step is 2 SpMVs + elementwise ops (performHalpernPdhgStep,
  pdhg.cc:961): primal gradient step + box projection, reflection, dual
  step + cone projection, reflection, then the Halpern anchor blend with
  weight (k+1)/(k+2); the elementwise chain is two kernels on a card
  (`ops/pdhg_step.py`);
- a block of 40-step windows (PDHG_CHECK_INTERVAL, pdhg.cc:32) runs
  with the restart check of every window on the device (tensors and
  `torch.where`, no host sync), then the host reads the convergence
  metrics once, as one stacked tensor; on one card each window and the
  metrics are replayed CUDA graphs (`graph.py`);
- the host runs termination, infeasibility detection, stall damping and
  the step-size logic between blocks;
- step size eta = 0.998 / ||A||_2 from a power method (initializeStepSizes
  pdhg.cc:1944, powerMethod :1529); primal weight omega balances primal
  and dual steps.

"average" is the average-iterate restarted PDHG of cuPDLP-C
(cupdlp_solver.c PDHG_Solve, cupdlp_restart.c GetRestartIterate): plain
PDHG steps that keep running sums of the iterates, metrics at the
current and at the average iterate read in one host copy per block, and
the KKT-error restart check on the host between the ramped blocks.

Convergence is assessed on the UNSCALED problem (relative L2 residuals
and gap, checkConvergence pdhg.cc:1474,1518-1526) by keeping the inverse
scaling vectors on the device.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...constants import HighsModelStatus
from ...ops import pdhg_step
from ...ops.linops import LinOp, cast_linop, linop_dtype
from ...utils.timer import span


class PdhgProblem(NamedTuple):
    """Device-side scaled standard-form problem."""

    k_op: LinOp  # scaled K
    b: torch.Tensor  # scaled rhs q~
    c: torch.Tensor  # scaled cost c~
    lo: torch.Tensor  # scaled lower bounds
    up: torch.Tensor  # scaled upper bounds
    is_eq: torch.Tensor  # (m,) 1.0 for equality rows
    lo_fin: torch.Tensor  # (n,) 1.0 where lower bound finite
    up_fin: torch.Tensor  # (n,) 1.0 where upper bound finite
    inv_row_scale: torch.Tensor  # 1/Dr diagonal (unscaling residuals)
    inv_col_scale: torch.Tensor  # 1/Dc diagonal
    norm_b: torch.Tensor  # scalar: ||unscaled b||_2
    norm_c: torch.Tensor  # scalar: ||unscaled c||_2
    # Dual lower bound on inequality rows (default None = 0), used by the
    # shifted-iterate refinement rounds (wrapper): the delta problem's
    # dual must keep y_base + dy in the cone, i.e. dy >= -y_base.
    y_lo: Optional[torch.Tensor] = None


class PdhgState(NamedTuple):
    x: torch.Tensor  # Halpern iterate (primal)
    y: torch.Tensor  # Halpern iterate (dual)
    x_pd: torch.Tensor  # last un-reflected PDHG iterate
    y_pd: torch.Tensor
    x_anchor: torch.Tensor
    y_anchor: torch.Tensor
    aty: torch.Tensor  # K' y cache
    k: torch.Tensor  # inner iteration count since restart (int32)
    eta: torch.Tensor  # step size
    omega: torch.Tensor  # primal weight


class PdhgMetrics(NamedTuple):
    primal_res: torch.Tensor  # unscaled L2 primal residual
    dual_res: torch.Tensor  # unscaled L2 dual residual
    primal_obj: torch.Tensor
    dual_obj: torch.Tensor
    fp_err: torch.Tensor  # weighted fixed-point error of the halpern iterate
    dx_norm: torch.Tensor  # || x_pd - x_anchor ||
    dy_norm: torch.Tensor  # || y_pd - y_anchor ||
    # infeasibility-certificate diagnostics from the normalized
    # anchor-difference direction:
    inf_dual_ray_obj: torch.Tensor  # b' dy / ||dy|| (positive => primal infeas)
    inf_dual_ray_res: torch.Tensor  # || proj-violation of K' dy || / ||dy||
    inf_primal_ray_obj: torch.Tensor  # c' dx / ||dx|| (negative => unbounded)
    inf_primal_ray_res: torch.Tensor  # constraint violation of dx direction


@dataclasses.dataclass
class PdhgSettings:
    eps_optimal: float = 1e-7
    eps_infeasible: float = 1e-10
    iteration_limit: int = 2**31 - 1
    time_limit: float = math.inf
    check_interval: int = 40
    halpern_gamma: float = 1.0  # reflection coefficient rho
    restart_strategy: int = 2  # 0 none / 1 fixed / 2 adaptive-Halpern
    # restart constants (reference restart.hpp:85-95)
    sufficient_decay: float = 0.2
    necessary_decay: float = 0.8
    artificial_restart_fraction: float = 0.36
    omega_smoothing: float = 0.5
    omega_init: Optional[float] = None
    power_method_iters: int = 30
    dtype: str = "float64"
    # checkpoint/resume for long runs
    checkpoint_file: str = ""
    checkpoint_interval: int = 50  # blocks between checkpoint writes
    # mixed-precision stepping: "" = off, "bfloat16" = run the step
    # products on a bf16 copy of K until residuals reach
    # `step_dtype_switch_tol`, then switch to full precision
    step_dtype: str = ""
    step_dtype_switch_tol: float = 1e-3
    # engine mode: "halpern" = reflected-Halpern (HiPDLP / cuPDLPx),
    # "average" = average-iterate restarted PDHG (cuPDLP-C) -- the two
    # option values "hipdlp" and "pdlp"
    mode: str = "halpern"
    # Refinement rounds (wrapper): a delta round terminates on primal +
    # dual residuals alone (the host re-checks the true gap in f64
    # between rounds) and must not detect infeasibility (the shifted
    # problem has tiny rhs/cost by construction).
    ignore_gap: bool = False
    detect_infeasibility: bool = True
    # optional host-side convergence oracle, called with the scaled PDHG
    # iterates as float64 numpy arrays; returning True terminates with
    # kOptimal.  The refinement rounds stop with it as soon as the true
    # f64 KKT of the accumulated iterate clears the user's tolerance.
    host_check: object = None
    # residual level at which the oracle starts being consulted
    host_check_gate: float = 0.0
    # step-size strategy (reference pdlp_step_size_strategy): "fixed",
    # "adaptive" or "malitsky_pock", re-estimated between device blocks
    step_size_strategy: str = "fixed"
    # ramp stages to skip (refinement rounds continue a converging solve
    # at full block size; 0 = cold ramp)
    ramp_start: int = 0
    # run the reference restart check (checkRestartCriteria) every
    # `check_interval` steps on the device; False = per-block host logic
    device_restarts: bool = True


@dataclasses.dataclass
class PdhgResult:
    status: HighsModelStatus
    x: np.ndarray  # unscaled standard-form primal
    y: np.ndarray  # unscaled standard-form dual
    z: np.ndarray  # unscaled reduced costs c - K'y
    iterations: int
    primal_obj: float
    dual_obj: float
    primal_res: float
    dual_res: float
    rel_gap: float
    solve_time: float
    restarts: int = 0


def _pdhg_step(problem: PdhgProblem, state: PdhgState, op, gamma: float,
               mode: str):
    """The projected PDHG update both engine modes make from
    (x, y, K'y): the primal half (`ops/pdhg_step.py` `primal_step`:
    x_pd = proj(x - tau (c - K'y)) and x_r = 2 x_pd - x), the product
    K x_r, and the dual half (`dual_step`: y_pd = proj(y + sigma (b -
    K x_r))), each half also forming the mode's new iterate or running
    sum.  Under `torch.func.vmap` each half is one batched launch (the
    operators' vmap rule).  Returns (x_pd, y_pd, x_out, y_out, k + 1)."""
    x_pd, x_r, x_out = pdhg_step.primal_step(
        state.x, problem.c, state.aty, problem.lo, problem.up,
        state.x_anchor, state.eta, state.omega, state.k, gamma, mode)
    ax_r = op.mv(x_r.to(linop_dtype(op))).to(x_r.dtype)
    y_pd, y_out, k_next = pdhg_step.dual_step(
        state.y, problem.b, ax_r, problem.is_eq, problem.y_lo,
        state.y_anchor, state.eta, state.omega, state.k, gamma, mode)
    return x_pd, y_pd, x_out, y_out, k_next


def _halpern_step(problem: PdhgProblem, state: PdhgState,
                  gamma: float, step_op=None) -> PdhgState:
    """One reflected-Halpern PDHG step (pdhg.cc:961 behavior): the two
    halves of `_pdhg_step` in Halpern mode, then K' y_new.

    `step_op` optionally replaces the stepping products with a
    low-precision copy of K; the iterates stay in the state dtype."""
    op = problem.k_op if step_op is None else step_op
    x_pd, y_pd, x_new, y_new, k_next = _pdhg_step(
        problem, state, op, gamma, "halpern")
    aty_new = op.rmv(y_new.to(linop_dtype(op))).to(y_new.dtype)
    return state._replace(x=x_new, y=y_new, x_pd=x_pd, y_pd=y_pd,
                          aty=aty_new, k=k_next)


class RestartCtl(NamedTuple):
    """On-device restart-control scalars (reference pdhg.cc:556-690
    state: initial_fpe_, last_trial_fpe, halpern/total counters)."""
    fpe_init: torch.Tensor   # FPE at the first major step after a restart
    fpe_last: torch.Tensor   # FPE at the previous 40-step check
    fresh: torch.Tensor      # bool: capture fpe_init at the next major step
    total_k: torch.Tensor    # int32 cumulative iteration count
    n_restarts: torch.Tensor  # int32


def _halpern_step_fpe(problem: PdhgProblem, state: PdhgState,
                      gamma: float, step_op=None):
    """Major Halpern step that also returns the fixed-point error
    (computeFixedPointError pdhg.cc:709) without the cross term
    2 eta dx'K'dy: fpe = sqrt(max(0, omega|dx|^2 + |dy|^2/omega)), with
    dx/dy the pre-step iterate minus the projected iterate.  (The JAX
    package measured the same iteration counts with and without the
    cross term and ships it off; so does this port.)"""
    x_before, y_before = state.x, state.y
    new_state = _halpern_step(problem, state, gamma, step_op)
    dx = x_before - new_state.x_pd
    dy = y_before - new_state.y_pd
    movement = (state.omega * torch.sum(dx * dx) +
                torch.sum(dy * dy) / state.omega)
    fpe = torch.sqrt(torch.clamp_min(movement, 0.0))
    return new_state, fpe


def restart_window(problem: PdhgProblem, state: PdhgState,
                   ctl: RestartCtl, gamma: float, interval: int,
                   theta: torch.Tensor, step_op=None):
    """One window of `interval` steps, ending with the reference restart
    check (checkRestartCriteria pdhg.cc:901) on the device.  Nothing here
    reads a device value on the host: every decision is a tensor and a
    `torch.where`, so a CUDA graph can capture the window whole
    (`graph.py`).  Returns (state, ctl)."""
    dtype = state.x.dtype
    inf = torch.full((), math.inf, dtype=dtype, device=state.x.device)
    # step 1 (major): capture initial_fpe right after a restart
    state, fpe1 = _halpern_step_fpe(problem, state, gamma, step_op)
    ctl = ctl._replace(
        fpe_init=torch.where(ctl.fresh, fpe1, ctl.fpe_init),
        fresh=torch.zeros_like(ctl.fresh))

    # steps 2 .. interval-1 (minor)
    for _ in range(interval - 2):
        state = _halpern_step(problem, state, gamma, step_op)

    # step `interval` (major) + restart check
    state, fpe = _halpern_step_fpe(problem, state, gamma, step_op)
    ctl = ctl._replace(total_k=ctl.total_k + interval)
    forced = ctl.total_k == interval  # very first check ever
    sufficient = fpe <= 0.2 * ctl.fpe_init
    necessary = (fpe <= 0.8 * ctl.fpe_init) & (fpe > ctl.fpe_last)
    artificial = state.k.to(dtype) >= 0.36 * ctl.total_k.to(dtype)
    do_r = forced | sufficient | necessary | artificial

    # the restart candidates are computed every window and selected
    # with torch.where, so the decision never leaves the device.
    # Primal-weight update (reference updatePrimalWeightAtRestart,
    # gated by theta: theta=0 keeps omega fixed, the FIXED-strategy
    # default).
    dxn = torch.linalg.vector_norm(state.x_pd - state.x_anchor)
    dyn = torch.linalg.vector_norm(state.y_pd - state.y_anchor)
    ok = (dxn > 1e-12) & (dyn > 1e-12)
    log_om = theta * torch.log(torch.clamp_min(dyn, 1e-300) /
                               torch.clamp_min(dxn, 1e-300)) + \
        (1.0 - theta) * torch.log(state.omega)
    new_om = torch.where(ok, torch.exp(torch.clamp(log_om, -12.0, 12.0)),
                         state.omega)
    op = problem.k_op if step_op is None else step_op
    aty_r = op.rmv(state.y_pd.to(linop_dtype(op))).to(dtype)
    state = state._replace(
        x=torch.where(do_r, state.x_pd, state.x),
        y=torch.where(do_r, state.y_pd, state.y),
        x_anchor=torch.where(do_r, state.x_pd, state.x_anchor),
        y_anchor=torch.where(do_r, state.y_pd, state.y_anchor),
        aty=torch.where(do_r, aty_r, state.aty),
        k=torch.where(do_r, torch.zeros_like(state.k), state.k),
        omega=torch.where(do_r, new_om, state.omega))
    ctl = ctl._replace(
        fresh=do_r,
        fpe_last=torch.where(do_r, inf, fpe),
        n_restarts=ctl.n_restarts + do_r.to(torch.int32))
    return state, ctl


def pdhg_block_windows(problem: PdhgProblem, state: PdhgState,
                       ctl: RestartCtl, n_windows: int, gamma: float,
                       interval: int, theta: torch.Tensor, step_op=None):
    """n_windows restart windows (`restart_window`), then the
    convergence metrics.  Returns (state, ctl, metrics)."""
    for _ in range(n_windows):
        state, ctl = restart_window(problem, state, ctl, gamma, interval,
                                    theta, step_op)
    metrics = _compute_metrics(problem, state)
    return state, ctl, metrics


def _compute_metrics(problem: PdhgProblem, state: PdhgState) -> PdhgMetrics:
    """Residuals/gap on the UNSCALED problem at the PDHG iterate."""
    norm = torch.linalg.vector_norm
    x, y = state.x_pd, state.y_pd
    ax = problem.k_op.mv(x)
    r = problem.b - ax
    # eq rows: |r|; ineq rows: violation of Kx >= q is max(r, 0)
    r_eff = torch.where(problem.is_eq > 0, r, torch.clamp_min(r, 0.0))
    primal_res = norm(r_eff * problem.inv_row_scale)

    z = problem.c - problem.k_op.rmv(y)
    z_plus = torch.clamp_min(z, 0.0) * problem.lo_fin
    z_minus = torch.clamp_max(z, 0.0) * problem.up_fin
    dual_res = norm((z - z_plus - z_minus) * problem.inv_col_scale)

    primal_obj = torch.dot(problem.c, x)
    lo_safe = torch.where(problem.lo_fin > 0, problem.lo, 0.0)
    up_safe = torch.where(problem.up_fin > 0, problem.up, 0.0)
    dual_obj = (torch.dot(problem.b, y) + torch.dot(lo_safe, z_plus) +
                torch.dot(up_safe, z_minus))

    # fixed-point error of the halpern iterate (omega-weighted)
    dxh = state.x_pd - state.x
    dyh = state.y_pd - state.y
    fp_err = torch.sqrt(state.omega * torch.sum(dxh * dxh) +
                        torch.sum(dyh * dyh) / state.omega)

    dx = x - state.x_anchor
    dy = y - state.y_anchor
    dx_norm = norm(dx)
    dy_norm = norm(dy)

    # --- infeasibility certificates from the anchor-difference rays -------
    dyn = dy / torch.clamp_min(dy_norm, 1e-30)
    # Farkas residual of K' dy: positive parts need a finite lower bound,
    # negative parts a finite upper bound
    kt_dy = problem.k_op.rmv(dyn)
    viol = (torch.clamp_min(kt_dy, 0.0) * (1.0 - problem.lo_fin) +
            torch.clamp_max(kt_dy, 0.0) * (1.0 - problem.up_fin))
    # Farkas dual objective: b'dy + l'[K'dy]_+ + u'[K'dy]_-
    ray_obj = (torch.dot(problem.b, dyn) +
               torch.dot(lo_safe, torch.clamp_min(kt_dy, 0.0)) +
               torch.dot(up_safe, torch.clamp_max(kt_dy, 0.0)))

    dxn = dx / torch.clamp_min(dx_norm, 1e-30)
    k_dx = problem.k_op.mv(dxn)
    prim_viol = torch.where(problem.is_eq > 0, torch.abs(k_dx),
                            torch.clamp_min(-k_dx, 0.0))
    # ray must respect bound directions: positive where upper infinite only
    bnd_viol = (torch.clamp_min(dxn, 0.0) * problem.up_fin +
                torch.clamp_max(dxn, 0.0) * problem.lo_fin)

    return PdhgMetrics(
        primal_res=primal_res, dual_res=dual_res,
        primal_obj=primal_obj, dual_obj=dual_obj, fp_err=fp_err,
        dx_norm=dx_norm, dy_norm=dy_norm,
        inf_dual_ray_obj=ray_obj,
        inf_dual_ray_res=norm(viol),
        inf_primal_ray_obj=torch.dot(problem.c, dxn),
        inf_primal_ray_res=torch.sqrt(torch.sum(prim_viol ** 2) +
                                      torch.sum(bnd_viol ** 2)))


def halpern_steps(problem: PdhgProblem, state: PdhgState, n_steps: int,
                  gamma: float, step_op=None) -> PdhgState:
    """n_steps Halpern steps on the device, no metrics."""
    for _ in range(n_steps):
        state = _halpern_step(problem, state, gamma, step_op)
    return state


def pdhg_block(problem: PdhgProblem, state: PdhgState, n_steps: int,
               gamma: float, step_op=None):
    """Run n_steps inner steps on the device, then compute metrics."""
    state = halpern_steps(problem, state, n_steps, gamma, step_op)
    return state, _compute_metrics(problem, state)


def _avg_pdhg_step(problem: PdhgProblem, state: PdhgState,
                   step_op=None) -> PdhgState:
    """One plain PDHG step with running-sum accumulation (cuPDLP-C
    PDHG_Update_Iterate): the iterate moves to (x_pd, y_pd), and the
    anchor fields hold the RUNNING SUMS of the iterates since the last
    restart, in the state's dtype (the two halves of `_pdhg_step` in
    average mode, then K' y_pd)."""
    op = problem.k_op if step_op is None else step_op
    x_pd, y_pd, x_sum, y_sum, k_next = _pdhg_step(
        problem, state, op, 1.0, "average")
    aty_new = op.rmv(y_pd.to(linop_dtype(op))).to(y_pd.dtype)
    return state._replace(
        x=x_pd, y=y_pd, x_pd=x_pd, y_pd=y_pd,
        x_anchor=x_sum, y_anchor=y_sum, aty=aty_new, k=k_next)


def avg_steps(problem: PdhgProblem, state: PdhgState, n_steps: int,
              step_op=None) -> PdhgState:
    """n_steps average-mode steps on the device, no metrics."""
    for _ in range(n_steps):
        state = _avg_pdhg_step(problem, state, step_op)
    return state


def avg_metrics(problem: PdhgProblem, state: PdhgState):
    """The average mode's metrics at BOTH the current and the average
    iterate (cuPDLP-C checks both and restarts to the better,
    cupdlp_restart.c).  Returns (current metrics, average metrics,
    x_avg, y_avg)."""
    kf = torch.clamp_min(state.k.to(state.x.dtype), 1.0)
    x_avg = state.x_anchor / kf
    y_avg = state.y_anchor / kf
    # current-iterate metrics, with the average as the "anchor" so that
    # the difference rays keep a meaningful direction
    m_cur = _compute_metrics(problem, state._replace(
        x_anchor=x_avg, y_anchor=y_avg))
    m_avg = _compute_metrics(problem, state._replace(
        x_pd=x_avg, y_pd=y_avg, x_anchor=state.x_pd, y_anchor=state.y_pd))
    return m_cur, m_avg, x_avg, y_avg


def pdhg_block_avg(problem: PdhgProblem, state: PdhgState, n_steps: int,
                   step_op=None):
    """Average-iterate device block: n_steps plain PDHG steps, then
    `avg_metrics`.  Returns (state, current metrics, average metrics,
    x_avg, y_avg)."""
    state = avg_steps(problem, state, n_steps, step_op)
    return (state, *avg_metrics(problem, state))


def _restart_state_avg(problem: PdhgProblem, state: PdhgState,
                       x_new: torch.Tensor, y_new: torch.Tensor,
                       new_omega: torch.Tensor) -> PdhgState:
    """Restart the average-iterate engine from (x_new, y_new), cuPDLP-C
    PDHG_Restart_Iterate: sums cleared, K'y refreshed."""
    return state._replace(
        x=x_new, y=y_new, x_pd=x_new, y_pd=y_new,
        x_anchor=torch.zeros_like(x_new),
        y_anchor=torch.zeros_like(y_new),
        aty=problem.k_op.rmv(y_new),
        k=torch.zeros_like(state.k), omega=new_omega)


def _init_aty(k_op: LinOp, y: torch.Tensor):
    return k_op.rmv(y)


def power_method(k_op: LinOp, n: int, iters: int, dtype,
                 device) -> torch.Tensor:
    """Estimate ||K||_2 via power iteration on K'K (pdhg.cc:1529)."""
    v = torch.full((n,), 1.0 / math.sqrt(n), dtype=dtype, device=device)
    for _ in range(iters):
        w = k_op.rmv(k_op.mv(v))
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    w = k_op.rmv(k_op.mv(v))
    lam = torch.dot(v, w)
    return torch.sqrt(torch.clamp_min(lam, 1e-30))


def _step_size_stats(problem: PdhgProblem, state: PdhgState,
                     x_prev: torch.Tensor, y_prev: torch.Tensor):
    """movement/interaction of the last block (cuPDLP linesearch
    quantities): movement = w/2 ||dx||^2 + 1/(2w) ||dy||^2,
    interaction = |dy' K dx|."""
    dx = state.x_pd - x_prev
    dy = state.y_pd - y_prev
    movement = (0.5 * state.omega * torch.sum(dx * dx) +
                0.5 / state.omega * torch.sum(dy * dy))
    interaction = torch.abs(torch.dot(dy, problem.k_op.mv(dx)))
    return movement, interaction


def _restart_state(state: PdhgState, new_omega: torch.Tensor) -> PdhgState:
    """Reset the Halpern anchor to the current PDHG iterate."""
    return state._replace(
        x=state.x_pd, y=state.y_pd,
        x_anchor=state.x_pd, y_anchor=state.y_pd,
        k=torch.zeros_like(state.k), omega=new_omega)


def read_metrics(metrics: PdhgMetrics, ctl: Optional[RestartCtl] = None):
    """All metric scalars (and the restart count) in ONE device-to-host
    copy: (PdhgMetrics of floats, restarts or None)."""
    vals = list(metrics)
    if ctl is not None:
        vals.append(ctl.n_restarts.to(vals[0].dtype))
    host = torch.stack(vals).cpu().tolist()
    restarts = int(host.pop()) if ctl is not None else None
    return PdhgMetrics(*host), restarts


def read_metric_pair(m_a: PdhgMetrics, m_b: PdhgMetrics):
    """Two metric sets (the average mode's current and average iterate)
    in ONE device-to-host copy, as two PdhgMetrics of floats."""
    host = torch.stack(list(m_a) + list(m_b)).cpu().tolist()
    k = len(PdhgMetrics._fields)
    return PdhgMetrics(*host[:k]), PdhgMetrics(*host[k:])


def _kkt_error(mm: PdhgMetrics, norm_b: float, norm_c: float,
               offset: float) -> float:
    """The average mode's KKT error of one metric set: the largest of
    the relative primal and dual residuals and the relative gap."""
    po = mm.primal_obj + offset
    do_ = mm.dual_obj + offset
    return max(mm.primal_res / (1.0 + norm_b),
               mm.dual_res / (1.0 + norm_c),
               abs(po - do_) / (1.0 + abs(po) + abs(do_)))


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def solve_pdhg(problem: PdhgProblem, n: int, m: int,
               settings: PdhgSettings,
               x0: Optional[np.ndarray] = None,
               y0: Optional[np.ndarray] = None,
               offset: float = 0.0,
               mesh=None,
               log=None,
               capture=None,
               timer=None) -> PdhgResult:
    """Host loop: restart/termination control around the device
    blocks.  The device is the one the problem's tensors live on.

    With `mesh`, the problem is laid out row-sharded over the mesh
    (`parallel/mesh.py` `shard_pdhg`): K's row blocks on the mesh's
    devices, every vector on its home device, where the loop runs.

    Where the loop runs on a CUDA card and the whole problem is on that
    card, each block is replays of captured CUDA graphs
    (`graph.GraphBlocks`); elsewhere (the CPU, a mesh over distinct
    cards) the blocks issue their operations one by one.  `capture`
    replaces the graph runner's capture step (the CPU tests pass
    `capture.eager_recorder`).  `timer` (a `HighsTimer`, or None) takes
    the clocks "pdhg.power", "pdhg.block" (each block with the host read
    of its metrics) and "pdhg.capture" (each graph capture, inside a
    block)."""
    if settings.mode not in ("halpern", "average"):
        raise ValueError(f"unknown PDHG mode {settings.mode!r}")
    t_start = time.perf_counter()
    dtype = torch.float64 if settings.dtype == "float64" else torch.float32
    if mesh is not None:
        from ...parallel.mesh import shard_pdhg
        problem, _ = shard_pdhg(problem, None, mesh)
    device = problem.b.device

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    with span(timer, "pdhg.power"):
        norm_k = power_method(problem.k_op, n, settings.power_method_iters,
                              dtype, device)
        eta0 = 0.998 / float(norm_k)

    norm_b = float(problem.norm_b)
    norm_c = float(problem.norm_c)
    if settings.omega_init is not None:
        omega0 = settings.omega_init
    elif norm_b > 1e-12 and norm_c > 1e-12:
        omega0 = norm_c / norm_b
    else:
        omega0 = 1.0

    x_init = (dev(x0) if x0 is not None else
              torch.minimum(torch.clamp_min(problem.lo, 0.0), problem.up))
    y_init = (dev(y0) if y0 is not None
              else torch.zeros((m,), dtype=dtype, device=device))

    state = PdhgState(
        x=x_init, y=y_init, x_pd=x_init, y_pd=y_init,
        x_anchor=x_init, y_anchor=y_init,
        aty=_init_aty(problem.k_op, y_init),
        k=dev(0, torch.int32),
        eta=dev(eta0),
        omega=dev(omega0))

    total_iters = 0
    restarts = 0
    fp_err_at_restart = None
    last_fp_err = None
    prev_iterates = None
    status = HighsModelStatus.kNotset
    eps = settings.eps_optimal
    gamma = settings.halpern_gamma
    infeas_hits = 0
    unbounded_hits = 0
    mlast = None
    # stall-adaptive reflection damping: full reflection (gamma=1) is
    # the fastest mode when it converges, but can cycle on degenerate
    # problems.  When the KKT merit sets no new best for `_STALL_CHECKS`
    # consecutive checks, damp the reflection to 0.9.
    _STALL_CHECKS = 150
    merit_best = None
    merit_stall = 0

    # --- mixed-precision step operator ------------------------------------
    step_op = None
    lowprec_best = None
    lowprec_stall = 0
    if settings.step_dtype == "bfloat16":
        step_op = cast_linop(problem.k_op, torch.bfloat16)

    # --- checkpoint/resume ------------------------------------------------
    ckpt = settings.checkpoint_file
    if ckpt and os.path.exists(ckpt):
        try:
            data = np.load(ckpt)
            if data["x"].shape == (n,) and data["y"].shape == (m,):
                y_ck = dev(data["y"])
                state = PdhgState(
                    x=dev(data["x"]), y=y_ck,
                    x_pd=dev(data["x_pd"]), y_pd=dev(data["y_pd"]),
                    x_anchor=dev(data["x_anchor"]),
                    y_anchor=dev(data["y_anchor"]),
                    aty=problem.k_op.rmv(y_ck),
                    k=dev(int(data["k"]), torch.int32),
                    eta=dev(float(data["eta"])),
                    omega=dev(float(data["omega"])))
                total_iters = int(data["total_iters"])
                restarts = int(data["restarts"])
                if mesh is not None:
                    from ...parallel.mesh import shard_pdhg
                    problem, state = shard_pdhg(problem, state, mesh)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass  # unreadable checkpoint: cold start

    def write_checkpoint():
        try:
            np.savez(
                ckpt,
                x=_to_host(state.x), y=_to_host(state.y),
                x_pd=_to_host(state.x_pd), y_pd=_to_host(state.y_pd),
                x_anchor=_to_host(state.x_anchor),
                y_anchor=_to_host(state.y_anchor),
                k=int(state.k), eta=float(state.eta),
                omega=float(state.omega),
                total_iters=total_iters, restarts=restarts)
        except OSError:
            pass

    blocks_since_ckpt = 0
    # Deterministic block-size ramp: each block ends in one host read of
    # the metrics; the block size doubles every 4 blocks up to 64x the
    # base interval.  The ramp depends only on the block count, never on
    # wall-clock, so iteration counts are reproducible across devices.
    base_steps = max(1, settings.check_interval)
    max_block = max(base_steps, min(2560, 64 * base_steps))
    n_blocks = 0

    avg_mode = settings.mode == "average"
    avg_err_at_restart = None
    avg_last_err = None
    avg_xy = None  # device tensors of the iterate the last check used
    # steps since the last restart (the device's state.k), kept on the
    # host so that the average mode's restart check needs no extra sync
    avg_inner = int(state.k) if avg_mode else 0

    # on-device restart windows (halpern mode); the average mode checks
    # its restarts on the host once per ramped block
    dev_restarts = (not avg_mode and settings.device_restarts and
                    settings.restart_strategy > 0)
    ctl = RestartCtl(
        fpe_init=dev(math.inf), fpe_last=dev(math.inf),
        fresh=torch.ones((), dtype=torch.bool, device=device),
        total_k=dev(total_iters, torch.int32),
        n_restarts=dev(restarts, torch.int32))
    # reference parity: the FIXED step-size strategy (hipdlp default)
    # performs NO primal-weight update at restarts (theta=0)
    theta_dev = dev(0.0 if settings.step_size_strategy == "fixed"
                    else settings.omega_smoothing)

    # the device blocks: replayed CUDA graphs on one card, else op by op.
    # The graphs' buffers are overwritten by the next block, so what the
    # host keeps across blocks (prev_iterates, avg_xy) is cloned.
    from ..capture import cuda_graph
    from .graph import EagerBlocks, GraphBlocks, on_one_card
    if capture is None and on_one_card(problem, device):
        capture = cuda_graph
    blocks = (EagerBlocks(problem) if capture is None
              else GraphBlocks(problem, base_steps, capture, timer=timer))

    while True:
        block_steps = min(max_block,
                          base_steps << min(6, (n_blocks +
                                                settings.ramp_start) // 4))
        with span(timer, "pdhg.block"):
            if avg_mode:
                state, m_cur_d, m_avg_d, x_avg, y_avg = blocks.block_avg(
                    state, block_steps, step_op)
                m_cur, m_avg = read_metric_pair(m_cur_d, m_avg_d)
                avg_inner += block_steps
                use_avg = (_kkt_error(m_avg, norm_b, norm_c, offset) <=
                           _kkt_error(m_cur, norm_b, norm_c, offset))
                mlast = m_avg if use_avg else m_cur
                avg_xy = ((x_avg.clone(), y_avg.clone()) if use_avg
                          else (state.x_pd.clone(), state.y_pd.clone()))
            elif dev_restarts:
                n_windows = max(1, block_steps // base_steps)
                block_steps = n_windows * base_steps
                state, ctl, metrics = blocks.windows(
                    state, ctl, n_windows, gamma, base_steps, theta_dev,
                    step_op)
                mlast, restarts = read_metrics(metrics, ctl)
            else:
                state, metrics = blocks.block(state, block_steps, gamma,
                                              step_op)
                mlast, _ = read_metrics(metrics)
        total_iters += block_steps
        n_blocks += 1
        blocks_since_ckpt += 1
        if ckpt and blocks_since_ckpt >= settings.checkpoint_interval:
            blocks_since_ckpt = 0
            write_checkpoint()

        pobj = mlast.primal_obj + offset
        dobj = mlast.dual_obj + offset
        rel_p = mlast.primal_res / (1.0 + norm_b)
        rel_d = mlast.dual_res / (1.0 + norm_c)
        rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))

        if log is not None:
            log(total_iters, pobj, dobj, rel_p, rel_d, rel_gap)

        if rel_p < eps and rel_d < eps and (settings.ignore_gap or
                                            rel_gap < eps):
            status = HighsModelStatus.kOptimal
            break
        if settings.host_check is not None and \
                rel_p < max(eps, settings.host_check_gate) and \
                rel_d < max(eps, settings.host_check_gate):
            hx, hy = avg_xy if avg_xy is not None else (state.x_pd,
                                                          state.y_pd)
            if settings.host_check(_to_host(hx), _to_host(hy)):
                status = HighsModelStatus.kOptimal
                break

        # --- stall-adaptive reflection damping ---------------------------
        if gamma > 0.9:
            # with ignore_gap the gap is f32-summation-noise-floored and
            # must not count as a stall
            merit = (max(rel_p, rel_d) if settings.ignore_gap
                     else max(rel_p, rel_d, rel_gap))
            if merit_best is None or merit < merit_best * (1 - 1e-3):
                merit_best = min(merit, merit_best or merit)
                merit_stall = 0
            else:
                merit_stall += 1
                if merit_stall >= _STALL_CHECKS:
                    gamma = 0.9
                    merit_stall = 0

        # mixed precision: switch to full precision once the bf16 phase
        # reaches its target resolution OR stalls
        if step_op is not None:
            cur = max(rel_p, rel_d, rel_gap)
            if lowprec_best is None or cur < 0.7 * lowprec_best:
                lowprec_best = min(cur, lowprec_best or cur)
                lowprec_stall = 0
            else:
                lowprec_stall += 1
            if cur < settings.step_dtype_switch_tol or lowprec_stall >= 15:
                step_op = None
                state = state._replace(aty=problem.k_op.rmv(state.y))

        # --- infeasibility detection via certificate rays ---------------
        if settings.detect_infeasibility:
            ray_obj = mlast.inf_dual_ray_obj
            ray_res = mlast.inf_dual_ray_res
            if (mlast.dy_norm > 1e-8 and ray_obj > 1e-6 and
                    ray_res < 1e-8 * max(1.0, ray_obj) and rel_p > eps):
                infeas_hits += 1
                if infeas_hits >= 3:
                    status = HighsModelStatus.kInfeasible
                    break
            else:
                infeas_hits = 0
            pray_obj = mlast.inf_primal_ray_obj
            pray_res = mlast.inf_primal_ray_res
            if (mlast.dx_norm > 1e-8 and pray_obj < -1e-6 and
                    pray_res < 1e-8 * max(1.0, -pray_obj)):
                unbounded_hits += 1
                if unbounded_hits >= 3:
                    status = HighsModelStatus.kUnbounded
                    break
            else:
                unbounded_hits = 0

        if total_iters >= settings.iteration_limit:
            status = HighsModelStatus.kIterationLimit
            break
        if time.perf_counter() - t_start > settings.time_limit:
            status = HighsModelStatus.kTimeLimit
            break

        # --- adaptive step size (between blocks) -------------------------
        if settings.step_size_strategy in ("adaptive", "malitsky_pock"):
            if prev_iterates is not None:
                movement, interaction = (float(v) for v in _step_size_stats(
                    problem, state, prev_iterates[0], prev_iterates[1]))
                eta_cur = float(state.eta)
                if interaction > 1e-300 and movement > 0.0:
                    eta_limit = movement / interaction
                    k = max(1, n_blocks)
                    if settings.step_size_strategy == "adaptive":
                        # cuPDLP reduction/growth exponents 0.3/0.6
                        # (defs.hpp:129-137), block-level
                        eta_new = min(eta_limit * (1.0 - (k + 1.0)**-0.3),
                                      eta_cur * (1.0 + (k + 1.0)**-0.6))
                    else:  # malitsky_pock: cautious multiplicative ratio
                        grow = min(1.0 + 0.5 / (k + 1.0), 1.2)
                        eta_new = min(eta_limit * 0.9, eta_cur * grow)
                    # capped at the spectral step eta0
                    eta_new = min(max(eta_new, 0.25 * eta0), eta0)
                    if eta_new > 0 and abs(eta_new - eta_cur) > \
                            1e-12 * eta_cur:
                        state = state._replace(eta=dev(eta_new))
            prev_iterates = (state.x_pd.clone(), state.y_pd.clone())

        # --- restart logic (average mode: cupdlp_restart.c
        # GetRestartIterate, KKT-error based; a restart always smooths
        # the primal weight, whatever the step-size strategy) ------------
        if avg_mode and settings.restart_strategy > 0:
            cand_err = _kkt_error(mlast, norm_b, norm_c, offset)
            do_restart = False
            if avg_err_at_restart is None:
                avg_err_at_restart = cand_err
            if cand_err <= settings.sufficient_decay * avg_err_at_restart:
                do_restart = True
            elif (cand_err <= settings.necessary_decay *
                  avg_err_at_restart and avg_last_err is not None
                  and cand_err > avg_last_err):
                do_restart = True
            elif avg_inner >= settings.artificial_restart_fraction * \
                    total_iters:
                do_restart = True
            avg_last_err = cand_err
            if do_restart:
                dxn = mlast.dx_norm
                dyn = mlast.dy_norm
                omega = float(state.omega)
                if dxn > 1e-12 and dyn > 1e-12:
                    theta = settings.omega_smoothing
                    log_om = (theta * math.log(dyn / dxn) +
                              (1.0 - theta) * math.log(omega))
                    omega = math.exp(min(max(log_om, -12.0), 12.0))
                state = _restart_state_avg(problem, state, avg_xy[0],
                                           avg_xy[1], dev(omega))
                avg_inner = 0
                restarts += 1
                avg_err_at_restart = None
                avg_last_err = None
        # --- restart logic (checkRestartCriteria behavior; host
        # fallback when device windows are off) ---------------------------
        if not avg_mode and not dev_restarts and \
                settings.restart_strategy > 0:
            fp_err = mlast.fp_err
            inner = int(state.k)
            do_restart = False
            if fp_err_at_restart is None:
                fp_err_at_restart = fp_err
            if fp_err <= settings.sufficient_decay * fp_err_at_restart:
                do_restart = True
            elif (fp_err <= settings.necessary_decay * fp_err_at_restart
                  and last_fp_err is not None and fp_err > last_fp_err):
                do_restart = True
            elif inner >= settings.artificial_restart_fraction * total_iters:
                do_restart = True
            last_fp_err = fp_err
            if do_restart:
                dxn = mlast.dx_norm
                dyn = mlast.dy_norm
                omega = float(state.omega)
                if dxn > 1e-12 and dyn > 1e-12:
                    theta = settings.omega_smoothing
                    log_om = (theta * math.log(dyn / dxn) +
                              (1.0 - theta) * math.log(omega))
                    omega = math.exp(min(max(log_om, -12.0), 12.0))
                state = _restart_state(state, dev(omega))
                restarts += 1
                fp_err_at_restart = None
                last_fp_err = None

    blocks.close()
    if avg_xy is not None:
        # report the iterate the last convergence check used
        state = state._replace(x_pd=avg_xy[0], y_pd=avg_xy[1])
    # unscale: x = Dc x~, y = Dr y~, z = Dc^-1 z~
    inv_col = _to_host(problem.inv_col_scale)
    inv_row = _to_host(problem.inv_row_scale)
    z_scaled = _to_host(problem.c - problem.k_op.rmv(state.y_pd))
    pobj = mlast.primal_obj + offset
    dobj = mlast.dual_obj + offset
    return PdhgResult(
        status=status,
        x=_to_host(state.x_pd) / inv_col,
        y=_to_host(state.y_pd) / inv_row,
        z=z_scaled * inv_col,
        iterations=total_iters,
        primal_obj=pobj, dual_obj=dobj,
        primal_res=mlast.primal_res, dual_res=mlast.dual_res,
        rel_gap=abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj)),
        solve_time=time.perf_counter() - t_start,
        restarts=restarts)
