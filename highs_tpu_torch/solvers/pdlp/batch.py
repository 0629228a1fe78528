"""Batched PDHG: solve many LP instances in one device program.

Each instance is preprocessed on the host, then scaled on the batch's
device and padded to the batch's common bucket shape as the single
solve does it (`wrapper.scale_std`; padding is an exact no-op for the
iteration), stacked along a leading batch dimension
(K dense per instance, (b, m_pad, n_pad)) and advanced by the
single-instance 40-step restart windows under `torch.func.vmap`.  vmap,
as `jax.vmap` in the JAX package, gives every instance its own
reductions (norms, dot products, the restart check), so no instance can
leak into another's scalars, and the single-instance code the Halpern
path runs stays as it is.  Under vmap each half of a step is one batched
launch of its kernel (`ops/pdhg_step.py`, the operators' vmap rule) and
each product one batched cuBLAS product.

The blocks run through the single-instance path's runner
(`graph.py`) with the vmapped window and metrics: on one card each
ramped block is replays of two captured CUDA graphs (one vmapped
restart window, then the metrics), as the JAX package runs the batch's
windows as one jitted program; on the CPU op by op.  The host loop keeps
per-instance termination state; finished instances are frozen by
zeroing their step size, and each reports the iterate (and restart
count) its convergence check passed, where the JAX package reports the
frozen instance's iterate at the end of the whole batch (ROADMAP,
"Decisions of the port").
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ...constants import HighsModelStatus
from ...device import resolve_device
from ...models.lp import HighsLp
from ...models.solution import HighsSolution
from ...ops.linops import DenseMatrix
from ...options import HighsOptions
from ...utils.timer import span
from ..capture import cuda_graph
from .graph import EagerBlocks, GraphBlocks, on_one_card
from .pdhg import (PdhgMetrics, PdhgProblem, PdhgState, RestartCtl,
                   _compute_metrics, power_method, restart_window)
from .preprocess import preprocess_lp, recover_solution
from .wrapper import PdlpRunInfo, _bucket, scale_std

_VECTORS = tuple(f for f in PdhgProblem._fields if f not in ("k_op", "y_lo"))


def resolve_batch_dtype(options: HighsOptions) -> str:
    """tpu_dtype 'choose' for the batch: float64 on every device.  A
    CUDA card has native FP64 and the batch has no f32 -> f64 refinement
    (in f32 the JAX package's batch stalls at its iteration limit on
    generated LPs); an explicit setting is kept."""
    if options.tpu_dtype != "choose":
        return options.tpu_dtype
    return "float64"


def _vectors(problem: PdhgProblem) -> dict:
    return {f: getattr(problem, f) for f in _VECTORS}


def batched_window(problem: PdhgProblem, state: PdhgState,
                   ctl: RestartCtl, gamma: float, interval: int,
                   theta: torch.Tensor, step_op=None):
    """One single-instance restart window (`pdhg.restart_window`),
    vmapped over the leading batch dimension of a dense-K problem, its
    state and its restart control: (state, ctl).  The batch has no
    low-precision step operator (`step_op` must be None)."""
    if step_op is not None:
        raise ValueError("the batch takes no step operator")

    def one(k_a, vecs, state, ctl):
        prob = PdhgProblem(k_op=DenseMatrix(k_a), **vecs)
        return restart_window(prob, state, ctl, gamma, interval, theta)
    return torch.func.vmap(one)(problem.k_op.a, _vectors(problem), state,
                                ctl)


def batched_metrics(problem: PdhgProblem, state: PdhgState) -> PdhgMetrics:
    """Each instance's convergence metrics (`pdhg._compute_metrics`,
    vmapped), as (b,) tensors."""
    def one(k_a, vecs, state):
        return _compute_metrics(PdhgProblem(k_op=DenseMatrix(k_a), **vecs),
                                state)
    return torch.func.vmap(one)(problem.k_op.a, _vectors(problem), state)


def batch_runner(problem: PdhgProblem, interval: int, capture=None):
    """The runner of the batch's blocks (`graph.py`) with the vmapped
    window and metrics: replayed CUDA graphs where the batch lies on one
    card (or with `capture`, as the CPU tests pass
    `capture.eager_recorder`), else op by op."""
    if capture is None and on_one_card(problem, problem.b.device):
        capture = cuda_graph
    if capture is None:
        return EagerBlocks(problem, batched_window, batched_metrics)
    return GraphBlocks(problem, interval, capture, batched_window,
                       batched_metrics)


def batched_pdhg_windows(problem: PdhgProblem, state: PdhgState,
                         ctl: RestartCtl, n_windows: int, gamma: float,
                         interval: int, theta: torch.Tensor):
    """n_windows vmapped restart windows (`batched_window`), then each
    instance's metrics, op by op: (state, ctl, metrics)."""
    return EagerBlocks(problem, batched_window, batched_metrics).windows(
        state, ctl, n_windows, gamma, interval, theta, None)


def batched_restart(state: PdhgState, flags: torch.Tensor,
                    omegas: torch.Tensor) -> PdhgState:
    """Reset the Halpern anchor for flagged instances only."""
    f = flags[:, None]
    return state._replace(
        x=torch.where(f, state.x_pd, state.x),
        y=torch.where(f, state.y_pd, state.y),
        x_anchor=torch.where(f, state.x_pd, state.x_anchor),
        y_anchor=torch.where(f, state.y_pd, state.y_anchor),
        k=torch.where(flags, 0, state.k),
        omega=torch.where(flags, omegas, state.omega))


def freeze_instances(state: PdhgState, frozen: torch.Tensor) -> PdhgState:
    """Stop finished instances: zero step size AND re-anchor at the
    current iterate so that the Halpern blend becomes the identity."""
    f = frozen[:, None]
    return state._replace(
        eta=torch.where(frozen, 0.0, state.eta),
        x_anchor=torch.where(f, state.x, state.x_anchor),
        y_anchor=torch.where(f, state.y, state.y_anchor))


class BatchStart(NamedTuple):
    """A batch ready for its first block: the stacked scaled problem, the
    cold state and restart control on the device, and what the host
    needs to judge and recover each instance."""
    problem: PdhgProblem
    state: PdhgState
    ctl: RestartCtl
    stds: list  # each instance's standard form (preprocess.py)
    scales: list  # each instance's (row scale, column scale)
    norms_b: np.ndarray  # ||b|| and ||c|| as the device holds them
    norms_c: np.ndarray


def prepare_batch(lps: Sequence[HighsLp], options: HighsOptions,
                  device) -> BatchStart:
    """Preprocess, scale, pad and stack `lps` on `device`, with each
    instance's step size from the vmapped power method and its primal
    weight from the norms of b and c."""
    b = len(lps)
    dtype_name = resolve_batch_dtype(options)
    dtype = torch.float64 if dtype_name == "float64" else torch.float32
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    stds = [preprocess_lp(lp) for lp in lps]
    n_pad = _bucket(max(s.num_col for s in stds))
    m_pad = _bucket(max(s.num_row for s in stds))
    scaled = [scale_std(std, options, n_pad, m_pad, dtype, device)
              for std in stds]
    # each instance's vectors, and its K densified
    arrays = [dict(sc.vectors(), a=sc.scaled_pad.toarray()) for sc in scaled]

    def stacked(name):
        return torch.as_tensor(
            np.stack([arr[name] for arr in arrays]).astype(np_dtype),
            device=device)
    problem = PdhgProblem(k_op=DenseMatrix(stacked("a")),
                          **{name: stacked(name) for name in _VECTORS})

    # per-instance step sizes from the vmapped power method
    norm_k = torch.func.vmap(
        lambda a: power_method(DenseMatrix(a), n_pad, 30, dtype, device))(
            problem.k_op.a)
    eta0 = 0.998 / np.maximum(norm_k.cpu().double().numpy(), 1e-12)
    # the norms as the device holds them (rounded to the solve's dtype)
    norms_b = problem.norm_b.cpu().double().numpy()
    norms_c = problem.norm_c.cpu().double().numpy()
    omega0 = np.where((norms_b > 1e-12) & (norms_c > 1e-12),
                      norms_c / np.maximum(norms_b, 1e-12), 1.0)

    zeros_n = torch.zeros((b, n_pad), dtype=dtype, device=device)
    zeros_m = torch.zeros((b, m_pad), dtype=dtype, device=device)
    x0 = torch.minimum(torch.maximum(zeros_n, problem.lo), problem.up)
    state = PdhgState(
        x=x0, y=zeros_m, x_pd=x0, y_pd=zeros_m,
        x_anchor=x0, y_anchor=zeros_m, aty=zeros_n,
        k=torch.zeros((b,), dtype=torch.int32, device=device),
        eta=torch.as_tensor(eta0, dtype=dtype, device=device),
        omega=torch.as_tensor(omega0, dtype=dtype, device=device))
    # per-instance on-device restart control, the same 40-step
    # checkRestartCriteria cadence as the single-instance path
    ctl = RestartCtl(
        fpe_init=torch.full((b,), np.inf, dtype=dtype, device=device),
        fpe_last=torch.full((b,), np.inf, dtype=dtype, device=device),
        fresh=torch.ones((b,), dtype=torch.bool, device=device),
        total_k=torch.zeros((b,), dtype=torch.int32, device=device),
        n_restarts=torch.zeros((b,), dtype=torch.int32, device=device))
    return BatchStart(problem, state, ctl, stds,
                      [(sc.dr, sc.dc) for sc in scaled], norms_b, norms_c)


def solve_lp_batch(lps: Sequence[HighsLp], options: HighsOptions,
                   log=None, device=None, capture=None
                   ) -> List[Tuple[HighsModelStatus, HighsSolution,
                                   PdlpRunInfo]]:
    """Solve a batch of LPs with one vmapped PDHG program on `device`
    (default CUDA), each block through `batch_runner` (`capture`
    replaces the graphs' capture step, as `pdhg.solve_pdhg`'s does)."""
    device = resolve_device(device)
    t_start = time.perf_counter()
    b = len(lps)
    # spans alone ("highs.batch.prepare", ".block", ".recover"): the
    # batch keeps no clocks
    with span(None, "batch.prepare"):
        problem, state, ctl, stds, scales, norms_b, norms_c = \
            prepare_batch(lps, options, device)
    dtype = problem.c.dtype

    eps = options.pdlp_optimality_tolerance
    check = options.tpu_check_interval
    iter_limit = min(options.pdlp_iteration_limit, 10**7)
    offsets = np.array([s.offset for s in stds])

    done = np.zeros(b, dtype=bool)
    status = np.full(b, int(HighsModelStatus.kNotset))
    iters_done = np.zeros(b, dtype=np.int64)
    total = 0
    restarts = np.zeros(b, dtype=np.int64)
    restarts_done = np.zeros(b, dtype=np.int64)
    final_pobj = np.zeros(b)
    final_dobj = np.zeros(b)
    # each finished instance's checked iterate, kept on the device
    x_fin = torch.zeros_like(state.x_pd)
    y_fin = torch.zeros_like(state.y_pd)

    # fixed step strategy: no primal-weight update at restarts
    theta_dev = torch.zeros((), dtype=dtype, device=device)

    # the blocks' runner: its state and restart control are buffers that
    # the next block overwrites (what the loop keeps, it copies)
    runner = batch_runner(problem, check, capture)
    n_blocks = 0
    max_block = max(check, min(2560, 64 * check))
    while True:
        # the single-instance loop's deterministic block-size ramp
        block_steps = min(max_block, check << min(6, n_blocks // 4))
        n_windows = max(1, block_steps // check)
        block_steps = n_windows * check
        with span(None, "batch.block"):
            state, ctl, metrics = runner.windows(
                state, ctl, n_windows, 1.0, check, theta_dev, None)
            # every instance's metrics and restart count in one host copy
            host = torch.stack(list(metrics) + [ctl.n_restarts.to(dtype)])
            host = host.cpu().double().numpy()
        mh = PdhgMetrics(*host[:-1])
        restarts = host[-1].astype(np.int64)
        total += block_steps
        n_blocks += 1
        pobj = mh.primal_obj + offsets
        dobj = mh.dual_obj + offsets
        rel_p = mh.primal_res / (1.0 + norms_b)
        rel_d = mh.dual_res / (1.0 + norms_c)
        rel_gap = np.abs(pobj - dobj) / (1.0 + np.abs(pobj) + np.abs(dobj))
        newly = ~done & (rel_p < eps) & (rel_d < eps) & (rel_gap < eps)
        if np.any(newly):
            status[newly] = int(HighsModelStatus.kOptimal)
            iters_done[newly] = total
            restarts_done[newly] = restarts[newly]
            done |= newly
            final_pobj[newly] = pobj[newly]
            final_dobj[newly] = dobj[newly]
            sel = torch.as_tensor(newly, device=device)[:, None]
            x_fin = torch.where(sel, state.x_pd, x_fin)
            y_fin = torch.where(sel, state.y_pd, y_fin)
            state = freeze_instances(
                state, torch.as_tensor(done, device=device))
        if log is not None:
            log(f"batch iter {total}: {int(done.sum())}/{b} done")
        if np.all(done):
            break
        if total >= iter_limit or \
                time.perf_counter() - t_start > options.time_limit:
            status[~done] = int(HighsModelStatus.kIterationLimit
                                if total >= iter_limit
                                else HighsModelStatus.kTimeLimit)
            iters_done[~done] = total
            restarts_done[~done] = restarts[~done]
            final_pobj[~done] = pobj[~done]
            final_dobj[~done] = dobj[~done]
            break
    runner.close()

    # ---- recover per-instance solutions ------------------------------
    with span(None, "batch.recover"):
        sel = torch.as_tensor(done, device=device)[:, None]
        xh = torch.where(sel, x_fin, state.x_pd).cpu().double().numpy()
        yh = torch.where(sel, y_fin, state.y_pd).cpu().double().numpy()
        results = []
        for i, (lp, std) in enumerate(zip(lps, stds)):
            dr, dc = scales[i]
            n_std, m_std = std.num_col, std.num_row
            x_std = xh[i, :n_std] * dc
            y_std = yh[i, :m_std] * dr
            z_std = std.c - std.a.T @ y_std
            info = PdlpRunInfo()
            info.status = HighsModelStatus(int(status[i]))
            info.iterations = int(iters_done[i])
            info.primal_obj = std.sense_mult * final_pobj[i]
            info.dual_obj = std.sense_mult * final_dobj[i]
            info.restarts = int(restarts_done[i])
            info.solve_time = time.perf_counter() - t_start
            col_value, row_dual, col_dual = recover_solution(
                std, x_std, y_std, z_std)
            sol = HighsSolution(
                value_valid=True, dual_valid=True,
                col_value=col_value, col_dual=col_dual,
                row_value=(lp.a_matrix.to_scipy() @ col_value
                           if lp.num_row else np.zeros(0)),
                row_dual=row_dual)
            results.append((info.status, sol, info))
    return results
