"""PDLP solver pipeline: preprocess -> scale -> device solve -> recover.

Equivalent of the reference wrapper highs/pdlp/HiPdlpWrapper.cpp:26
(pipeline = preprocess, scale, solve, unscale, postprocess), returning a
HighsSolution plus iteration/status info to the Highs facade.  The
solve runs on the torch device the caller passes; nothing moves it to
another device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ...constants import HighsModelStatus
from ...device import resolve_device
from ...models.lp import HighsLp
from ...models.solution import HighsSolution
from ...options import HighsOptions
from ...ops import linops
from .pdhg import (AVERAGE_MODE_NOT_PORTED, PdhgProblem, PdhgSettings,
                   solve_pdhg)
from .preprocess import preprocess_lp, recover_solution
from .scaling import scale_problem


@dataclasses.dataclass
class PdlpRunInfo:
    status: HighsModelStatus = HighsModelStatus.kNotset
    iterations: int = 0
    primal_obj: float = 0.0
    dual_obj: float = 0.0
    rel_gap: float = math.inf
    solve_time: float = 0.0
    restarts: int = 0


def _bucket(x: int) -> int:
    """Padded dimension: next power of two (min 128) below 4096, then
    next multiple of 1024; whole 128-wide tiles for block-CSR."""
    if x <= 4096:
        r = 128
        while r < x:
            r *= 2
        return r
    return ((x + 1023) // 1024) * 1024


def _solve_bound_lp(lp: HighsLp) -> Tuple[HighsModelStatus, HighsSolution]:
    """LP with no rows: minimize each cost independently over its bounds
    (reference: unconstrained-LP direct solve, HighsSolve.cpp:178+)."""
    sense = float(lp.sense)
    c = sense * lp.col_cost
    lo, up = lp.col_lower, lp.col_upper
    if np.any(lo > up):
        return HighsModelStatus.kInfeasible, HighsSolution()
    x = np.where(c > 0, lo, np.where(c < 0, up, np.clip(0.0, lo, up)))
    unbounded = ((c > 0) & ~np.isfinite(lo)) | ((c < 0) & ~np.isfinite(up))
    if np.any(unbounded):
        return HighsModelStatus.kUnbounded, HighsSolution()
    sol = HighsSolution(
        value_valid=True, dual_valid=True,
        col_value=x.astype(np.float64),
        col_dual=(sense * c).astype(np.float64),
        row_value=np.zeros(0), row_dual=np.zeros(0))
    return HighsModelStatus.kOptimal, sol


def _resolve_dtype(options: HighsOptions, device: torch.device) -> str:
    """tpu_dtype 'choose': float64 on the CPU, float32 on CUDA (with
    shifted-iterate refinement to f64-grade KKT below the f32 floor)."""
    if options.tpu_dtype != "choose":
        return options.tpu_dtype
    return "float64" if device.type == "cpu" else "float32"


def solve_lp_pdlp(lp: HighsLp, options: HighsOptions,
                  x0: Optional[np.ndarray] = None,
                  y0: Optional[np.ndarray] = None,
                  log_callback=None, device=None
                  ) -> Tuple[HighsModelStatus, HighsSolution, PdlpRunInfo]:
    """Restarted-Halpern PDHG solve (reference solveLpHiPdlp,
    pdlp/HiPdlpWrapper.cpp:26) on `device` (default CUDA).

    f32 solves reach f64-grade KKT through shifted-iterate refinement
    rounds: each round solves the exact rewrite of the problem around
    the f64 host accumulator, whose data is as small as the current
    residual."""
    device = resolve_device(device)
    if options.solver == "pdlp":
        raise NotImplementedError(AVERAGE_MODE_NOT_PORTED)
    if options.tpu_mesh_shape:
        raise NotImplementedError(
            "tpu_mesh_shape (multi-device PDLP) is not yet ported: "
            "ROADMAP queue 1 item 9")

    info = PdlpRunInfo()
    if lp.num_row == 0:
        status, sol = _solve_bound_lp(lp)
        info.status = status
        if sol.value_valid:
            info.primal_obj = float(lp.col_cost @ sol.col_value) + lp.offset
            info.dual_obj = info.primal_obj
            info.rel_gap = 0.0
        return status, sol, info

    std = preprocess_lp(lp)
    dtype_name = _resolve_dtype(options, device)
    dtype = torch.float64 if dtype_name == "float64" else torch.float32

    scaled_a, scales = scale_problem(
        std.a, mode=options.pdlp_scaling_mode,
        ruiz_iterations=options.pdlp_ruiz_iterations)
    dr, dc = scales.row_scale, scales.col_scale

    b_s = dr * std.b
    c_s = dc * std.c
    with np.errstate(invalid="ignore"):
        lo_s = np.where(np.isfinite(std.col_lower), std.col_lower / dc,
                        std.col_lower)
        up_s = np.where(np.isfinite(std.col_upper), std.col_upper / dc,
                        std.col_upper)

    is_eq = (np.arange(std.num_row) < std.num_eq).astype(np.float64)
    lo_fin = np.isfinite(std.col_lower).astype(np.float64)
    up_fin = np.isfinite(std.col_upper).astype(np.float64)

    # bounds must be finite-representable on device: replace +-inf by huge
    big = np.asarray(np.finfo(np.float64 if dtype == torch.float64
                              else np.float32).max / 4)
    lo_dev = np.where(np.isfinite(lo_s), lo_s, -big)
    up_dev = np.where(np.isfinite(up_s), up_s, big)

    # pad (n, m) to bucketed sizes; padded columns are fixed at 0 with
    # zero cost, padded rows are 0 = 0 equalities: exact no-ops for
    # every iterate and metric
    n_std, m_std = std.num_col, std.num_row
    n_pad, m_pad = _bucket(n_std), _bucket(m_std)

    def padc(v, fill):
        return np.concatenate([v, np.full(n_pad - n_std, fill, dtype=v.dtype)])

    def padr(v, fill):
        return np.concatenate([v, np.full(m_pad - m_std, fill, dtype=v.dtype)])

    scaled_pad = sp.csr_matrix((scaled_a.data, scaled_a.indices,
                                np.concatenate([
                                    scaled_a.indptr,
                                    np.full(m_pad - m_std,
                                            scaled_a.indptr[-1],
                                            dtype=scaled_a.indptr.dtype)])),
                               shape=(m_pad, n_pad))
    # bucket-permuted ELL (fmt "bucketperm"): bake the bucket row and
    # column orders into the PROBLEM (rows of K sorted by nonzero-count
    # bucket, columns by transpose bucket), so the bucket-ladder products
    # need no un-permute gather.  Everything downstream (problem
    # vectors, warm start, refinement oracle) lives in the permuted
    # space; the inverse applies once at recovery.
    perm_maps = None
    if options.tpu_matrix_format == "bucketperm":
        row_perm = linops.bucket_row_perm(scaled_pad)
        col_perm = linops.bucket_row_perm(scaled_pad.T.tocsr())
        scaled_pad = scaled_pad[row_perm][:, col_perm].tocsr()
        padr_nat, padc_nat = padr, padc

        def padr(v, fill):  # noqa: F811
            return padr_nat(v, fill)[row_perm]

        def padc(v, fill):  # noqa: F811
            return padc_nat(v, fill)[col_perm]

        perm_maps = (np.argsort(row_perm), np.argsort(col_perm))
    k_op = linops.from_scipy(scaled_pad, fmt=options.tpu_matrix_format,
                             dtype=dtype, device=device)

    def dev(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    problem = PdhgProblem(
        k_op=k_op,
        b=dev(padr(b_s, 0.0)),
        c=dev(padc(c_s, 0.0)),
        lo=dev(padc(lo_dev, 0.0)),
        up=dev(padc(up_dev, 0.0)),
        is_eq=dev(padr(is_eq, 1.0)),
        lo_fin=dev(padc(lo_fin, 1.0)),
        up_fin=dev(padc(up_fin, 1.0)),
        inv_row_scale=dev(padr(1.0 / dr, 1.0)),
        inv_col_scale=dev(padc(1.0 / dc, 1.0)),
        norm_b=dev(np.linalg.norm(std.b)),
        norm_c=dev(np.linalg.norm(std.c)))

    _deadline = getattr(options, "_solve_deadline", None)
    _budget = options.time_limit
    if _deadline is not None:
        _budget = min(_budget, max(0.0, _deadline - time.perf_counter()))
    settings = PdhgSettings(
        eps_optimal=options.pdlp_optimality_tolerance,
        iteration_limit=options.pdlp_iteration_limit,
        time_limit=_budget,
        check_interval=options.tpu_check_interval,
        restart_strategy=options.pdlp_restart_strategy,
        dtype=dtype_name,
        checkpoint_file=options.pdlp_checkpoint_file,
        checkpoint_interval=options.pdlp_checkpoint_interval,
        step_dtype=options.tpu_step_dtype,
        device_restarts=bool(options.tpu_pdlp_device_restarts),
        # int codes follow the reference (cupdlp_step.c): 0 fixed,
        # 1 adaptive, 2 Malitsky-Pock.  The reflected-Halpern mode is
        # natively fixed-step (pdhg.cc kUseCupdlpx), so the default
        # adaptive code only engages when the restart strategy is not
        # the Halpern scheme.
        step_size_strategy=(
            "fixed" if options.pdlp_step_size_strategy == 0 or
            (options.pdlp_step_size_strategy == 1 and
             options.pdlp_restart_strategy >= 2) else
            "malitsky_pock" if options.pdlp_step_size_strategy == 2
            else "adaptive"))

    x0_s = None
    y0_s = None
    if x0 is not None and len(x0) == lp.num_col:
        # scale a warm start into standard form: pad slacks with row values
        x_std = np.concatenate([
            x0, np.zeros(std.num_col - std.orig_num_col)])
        slack_rows = np.nonzero(std.row_slack_col >= 0)[0]
        if len(slack_rows):
            ax = lp.a_matrix.to_scipy() @ x0
            x_std[std.row_slack_col[slack_rows]] = ax[slack_rows]
        x0_s = padc(x_std / dc, 0.0)
    if y0 is not None and len(y0) == lp.num_row:
        y_std = np.zeros(std.num_row)
        y_std[std.row_new_idx] = y0 * np.where(
            std.row_class == 2, -1.0, 1.0) * std.sense_mult
        y0_s = padr(y_std / dr, 0.0)

    eps = settings.eps_optimal
    # f32 device solves floor around ~1e-6 relative KKT; tighter targets
    # are reached by shifted-iterate refinement rounds below.
    f32_floor = 2e-6
    refine = dtype == torch.float32 and eps < f32_floor
    if refine:
        # the cold round stops on residuals alone: the f32 on-device gap
        # is floored at ~sqrt(n)*eps_f32 relative by summation noise,
        # while the refinement rounds measure the true gap in f64 on the
        # host between rounds
        settings.eps_optimal = max(eps, f32_floor)
        settings.ignore_gap = True

    t_all = time.perf_counter()
    result = solve_pdhg(problem, n_pad, m_pad, settings,
                        x0=x0_s, y0=y0_s, offset=std.offset,
                        log=log_callback)
    total_iterations = result.iterations
    total_restarts = result.restarts

    if result.status in (HighsModelStatus.kInfeasible,
                         HighsModelStatus.kUnbounded):
        info.status = result.status
        info.iterations = total_iterations
        info.rel_gap = result.rel_gap
        info.solve_time = result.solve_time
        info.restarts = total_restarts
        info.primal_obj = std.sense_mult * result.primal_obj
        info.dual_obj = std.sense_mult * result.dual_obj
        return result.status, HighsSolution(), info

    status = result.status
    if refine and result.status == HighsModelStatus.kOptimal:
        # ----- shifted-iterate refinement (f32 device -> f64 KKT) -----
        # The accumulated iterate (x_bar, y_bar) lives on the host in
        # f64 SCALED standard-form coordinates.  Each round solves the
        # EXACT rewrite of the original problem in delta variables
        #   x = x_bar + dx, y = y_bar + dy:
        #   b_eff = b - K x_bar, c_eff = c - K' y_bar,
        #   bounds l - x_bar <= dx <= u - x_bar, dual cone dy >= -y_bar
        # on inequality rows.  The shifted data is TINY (~ current
        # residual), so f32 represents it to ~1e-7 RELATIVE of the
        # shift — each round gains several digits of true KKT.  Keeping
        # problem.norm_b/norm_c at the ORIGINAL norms makes the device
        # convergence check measure the TRUE relative residuals directly.
        inv_col_p = padc(1.0 / dc, 1.0)
        inv_row_p = padr(1.0 / dr, 1.0)
        dc_p = padc(dc, 1.0)
        dr_p = padr(dr, 1.0)
        b_p = padr(b_s, 0.0)
        c_p = padc(c_s, 0.0)
        lo_p = padc(lo_s, 0.0)
        up_p = padc(up_s, 0.0)
        lo_fin_p = padc(lo_fin, 1.0) > 0
        up_fin_p = padc(up_fin, 1.0) > 0
        is_eq_p = padr(is_eq, 1.0) > 0
        lo_clip = np.where(np.isfinite(lo_p), lo_p, -np.inf)
        up_clip = np.where(np.isfinite(up_p), up_p, np.inf)
        k_host = scaled_pad  # padded scaled CSR, f64
        norm_b = float(np.linalg.norm(std.b))
        norm_c = float(np.linalg.norm(std.c))
        big_f = float(big)

        def kkt(x_bar, y_bar):
            r = b_p - k_host @ x_bar
            r_eff = np.where(is_eq_p, r, np.maximum(r, 0.0))
            rel_p = np.linalg.norm(r_eff * inv_row_p) / (1.0 + norm_b)
            z = c_p - k_host.T @ y_bar
            z_pos = np.where(lo_fin_p, np.maximum(z, 0.0), 0.0)
            z_neg = np.where(up_fin_p, np.minimum(z, 0.0), 0.0)
            rel_d = (np.linalg.norm((z - z_pos - z_neg) * inv_col_p) /
                     (1.0 + norm_c))
            pobj = float(c_p @ x_bar) + std.offset
            lo_safe = np.where(lo_fin_p, lo_p, 0.0)
            up_safe = np.where(up_fin_p, up_p, 0.0)
            dobj = (float(b_p @ y_bar) + float(lo_safe @ z_pos) +
                    float(up_safe @ z_neg) + std.offset)
            gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
            return rel_p, rel_d, gap, pobj, dobj, z

        # scaled standard-form accumulators from the cold round
        x_bar = np.asarray(result.x, np.float64) * inv_col_p
        y_bar = np.asarray(result.y, np.float64) * inv_row_p
        rel_p, rel_d, gap, pobj, dobj, z_bar = kkt(x_bar, y_bar)
        rounds = 0
        while (max(rel_p, rel_d, gap) > eps and rounds < 4 and
               time.perf_counter() - t_all < settings.time_limit):
            cur = max(rel_p, rel_d, gap)
            b_eff = b_p - k_host @ x_bar
            c_eff = c_p - k_host.T @ y_bar
            with np.errstate(invalid="ignore"):
                lo_eff = np.where(np.isfinite(lo_p), lo_p - x_bar, -big_f)
                up_eff = np.where(np.isfinite(up_p), up_p - x_bar, big_f)
            y_lo_eff = np.where(is_eq_p, 0.0, -y_bar)
            rproblem = problem._replace(
                b=dev(b_eff), c=dev(c_eff), lo=dev(lo_eff), up=dev(up_eff),
                y_lo=dev(y_lo_eff))

            # the delta round terminates on residuals; the true gap
            # (host f64) follows the complementarity error at roughly
            # gap ~ 3x residual, so drive residuals ~3x below the user's
            # eps and let the outer f64 check demand more only if that
            # round fell short.
            def _host_check(xd, yd, _xb=x_bar, _yb=y_bar):
                # xd/yd are the scaled delta iterates (same coordinates
                # as x_bar/y_bar), f64 numpy arrays
                xc = np.clip(_xb + xd, lo_clip, up_clip)
                yn = _yb + yd
                yc = np.where(is_eq_p, yn, np.maximum(yn, 0.0))
                hp, hd, hg, _, _, _ = kkt(xc, yc)
                return max(hp, hd, hg) <= eps
            rsettings = dataclasses.replace(
                settings,
                # deep residual target, but the host oracle stops the
                # round the moment the true f64 KKT clears eps
                eps_optimal=max(min(cur * 3e-3, eps * 0.3), 1e-9),
                ignore_gap=True,
                detect_infeasibility=False,
                host_check=_host_check,
                host_check_gate=eps,
                checkpoint_file="",
                ramp_start=24,  # continue at full block size
                time_limit=max(
                    1.0, settings.time_limit - (time.perf_counter() - t_all)))
            rres = solve_pdhg(rproblem, n_pad, m_pad, rsettings,
                              offset=0.0, log=log_callback)
            total_iterations += rres.iterations
            total_restarts += rres.restarts
            dx = rres.x * inv_col_p
            dy = rres.y * inv_row_p
            x_bar = np.clip(x_bar + dx, lo_clip, up_clip)
            y_new = y_bar + dy
            y_bar = np.where(is_eq_p, y_new, np.maximum(y_new, 0.0))
            new_p, new_d, new_gap, pobj, dobj, z_bar = kkt(x_bar, y_bar)
            rounds += 1
            if max(new_p, new_d, new_gap) >= 0.9 * cur:
                rel_p, rel_d, gap = new_p, new_d, new_gap
                break  # no progress: stop refining
            rel_p, rel_d, gap = new_p, new_d, new_gap
        if max(rel_p, rel_d, gap) <= eps:
            status = HighsModelStatus.kOptimal
        elif rounds:
            status = (rres.status if rres.status !=
                      HighsModelStatus.kOptimal else
                      HighsModelStatus.kIterationLimit)
        else:
            # zero refinement rounds ran (budget exhausted after the
            # cold round) but the true f64 KKT was just measured to
            # exceed the user tolerance: the cold round's relaxed
            # f32-floor kOptimal must not stand
            status = (HighsModelStatus.kTimeLimit
                      if time.perf_counter() - t_all >=
                      settings.time_limit else
                      HighsModelStatus.kIterationLimit)
        x_uns = x_bar * dc_p
        y_uns = y_bar * dr_p
        z_uns = z_bar / dc_p
        info.rel_gap = gap
        info.primal_obj = std.sense_mult * pobj
        info.dual_obj = std.sense_mult * dobj
    else:
        x_uns = result.x
        y_uns = result.y
        z_uns = result.z
        info.rel_gap = result.rel_gap
        info.primal_obj = std.sense_mult * result.primal_obj
        info.dual_obj = std.sense_mult * result.dual_obj

    info.status = status
    info.iterations = total_iterations
    info.solve_time = time.perf_counter() - t_all
    info.restarts = total_restarts

    if perm_maps is not None:
        inv_row, inv_col = perm_maps
        x_uns, y_uns, z_uns = x_uns[inv_col], y_uns[inv_row], z_uns[inv_col]
    col_value, row_dual, col_dual = recover_solution(
        std, x_uns[:n_std], y_uns[:m_std], z_uns[:n_std])
    row_value = (lp.a_matrix.to_scipy() @ col_value if lp.num_row
                 else np.zeros(0))
    sol = HighsSolution(
        value_valid=True, dual_valid=True,
        col_value=col_value, col_dual=col_dual,
        row_value=row_value, row_dual=row_dual)
    return status, sol, info
