"""Batched MIP node-LP evaluation on a torch device.

The JAX package's `mip/batch_nodes.py`: open nodes share the relaxation
matrix and differ only in their bound vectors, so a round of K node LPs
is one program, the dense normal-equations IPM step (`ipm/solver.py`,
"chol" route) under `torch.func.vmap` over a (K, ...) batch of bounds,
states and regularizations.  The shared standard-form K, its rhs and
cost are not batched.

Each lane yields:
- a certified dual bound (the IPM dual objective once the lane's
  relative dual residual is below 1e-9) for cutoff pruning, and
- the primal iterate, mapped back to the relaxation's columns, once
  converged.

Lanes that do not converge report nothing and go to the exact sequential
node engine.  The JAX package builds the slack upper bounds of a round
with one row instead of K (`_problem_fields`), so every round of K >= 2
nodes raises there and its solver, which swallows the error, never
evaluates a batch; here they have K rows.

The JAX package compiles the vmapped starting point and step each into
one program (`jax.jit`, `highs_tpu/solvers/mip/batch_nodes.py:83,93`).
Here a round of K lanes works on static buffers (`_Round`: the lanes'
bounds and masks, the state, the previous state, the regularizations
and the (7, K) metrics), and on a card the starting point and the step
are each one captured CUDA graph over them (`solvers/capture.py`
`cuda_graph`), captured at the first round of that K and replayed by
every later one.  The step graph writes the new state into the state
buffers (and the old one into the previous-state buffers), so replays
chain; the host reads the metrics with one copy an iteration and runs
the convergence test, and it reverts a broken lane in the buffers, as
the JAX package's loop does between its jitted steps.  On the CPU the
same work runs op by op.  `close()` frees the graphs and their memory.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...models.lp import HighsLp
from ..ipm.solver import (IpmProblem, IpmSettings, IpmState, ipm_step,
                          scaled_dense_k, starting_point)
from ..capture import counted_capture, counted_replay, cuda_graph
from ..pdlp.preprocess import preprocess_lp, recover_solution

F64 = torch.float64
# batched rounds, their lanes, the lanes that converged and the batched
# IPM iterations, with the iterations by device type, and the graphs
# captured and replayed (a round's starting point and each of its
# steps): read like the kernels' launch counters (a batched step
# factors every lane at once, so `ipm/solver.py`'s DENSE_FACTORS counts
# it once)
COUNTS = {"rounds": 0, "lanes": 0, "converged": 0, "iterations": 0,
          "cuda": 0, "cpu": 0, "captures": 0, "replays": 0}


class _Round:
    """The static buffers of the rounds of K lanes, and the start and
    step graphs over them once captured (by name: (replay, counts))."""

    def __init__(self, K: int, n: int, m: int, device: torch.device):
        def empty(*shape):
            return torch.empty(shape, dtype=F64, device=device)

        def state():
            return IpmState(x=empty(K, n), xl=empty(K, n), xu=empty(K, n),
                            y=empty(K, m), zl=empty(K, n), zu=empty(K, n))
        # lo, up, lo_fin, up_fin, active over the n = n_std + m columns
        self.lanes = tuple(empty(K, n) for _ in range(5))
        self.state = state()
        self.prev = state()
        self.regs = empty(K, 2)
        self.metrics = empty(7, K)
        self.graphs: Dict[str, Tuple[Callable, dict]] = {}


class BatchNodeEvaluator:
    """K node LPs of one relaxation a round (module doc).  `capture` is
    the capture step of the rounds' graphs: by default `cuda_graph` on a
    card and None (op by op) on the CPU; the CPU tests pass
    `capture.eager_recorder`, and a measurement on the card sets the
    attribute to None to run the same rounds op by op."""

    def __init__(self, relax_lp: HighsLp, device=None,
                 tolerance: float = 1e-9, max_iters: int = 80,
                 capture: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.tolerance = tolerance
        self.max_iters = max_iters
        if capture is None and self.device.type == "cuda":
            capture = cuda_graph
        self.capture = capture
        self._rounds: Dict[int, _Round] = {}
        self.relax_lp = relax_lp
        self.n_orig = relax_lp.num_col

        std = preprocess_lp(relax_lp)
        self.std = std
        m, n_std = std.num_row, std.num_col
        self.m, self.n_std = m, n_std
        self.row_s, self.col_s, _, k = scaled_dense_k(std.a, self.device)
        self.b_scaled = self.row_s * std.b
        self.c_scaled = std.c * self.col_s
        self.is_ineq = (np.arange(m) >= std.num_eq).astype(np.float64)

        self._shared = dict(
            a=k, b=self._dev(self.b_scaled),
            c=self._dev(self.c_scaled), slack_mask=self._dev(self.is_ineq),
            norm_c=self._dev(np.linalg.norm(self.c_scaled)),
            norm_b=self._dev(np.linalg.norm(self.b_scaled)))
        sett = IpmSettings()
        self._sett_tuple = (sett.sigma_min, sett.sigma_max,
                            sett.fraction_to_boundary, sett.theta_max)
        self._regs = np.array([sett.reg_primal, sett.reg_dual])
        self._vstart = torch.func.vmap(
            lambda lanes: starting_point(self._problem(lanes)))
        self._vstep = torch.func.vmap(
            lambda lanes, state, regs: ipm_step(
                self._problem(lanes), state, regs, self._sett_tuple))

    def _dev(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=F64, device=self.device)

    def close(self) -> None:
        """Free the rounds' buffers and graphs (and the graphs' memory
        pools)."""
        self._rounds.clear()

    # --- the rounds' work on their buffers ----------------------------------
    def _start(self, r: _Round) -> None:
        for buf, new in zip(r.state, self._vstart(r.lanes)):
            buf.copy_(new)

    def _step(self, r: _Round) -> None:
        new, metrics = self._vstep(r.lanes, r.state, r.regs)
        for old, buf in zip(r.prev, r.state):
            old.copy_(buf)
        for buf, val in zip(r.state, new):
            buf.copy_(val)
        r.metrics.copy_(torch.stack(list(metrics)))

    def _run(self, r: _Round, name: str) -> None:
        """The round's start or step: op by op without a capture step,
        else a replay of its graph, captured at its first use."""
        work = self._start if name == "start" else self._step
        if self.capture is None:
            work(r)
            return
        scope = (torch.cuda.device(self.device)
                 if self.device.type == "cuda" else contextlib.nullcontext())
        with scope:
            if name not in r.graphs:
                def fn():
                    work(r)
                    return ()  # the buffers are the graph's outputs
                saved = [t.clone() for t in (*r.state, *r.prev)]
                replay, _, counts = counted_capture(self.capture, fn)
                # the warm-up (or a recorder's first call) ran the work
                for buf, val in zip((*r.state, *r.prev), saved):
                    buf.copy_(val)
                r.graphs[name] = (replay, counts)
                COUNTS["captures"] += 1
            counted_replay(*r.graphs[name])
        COUNTS["replays"] += 1

    def _problem(self, lanes) -> IpmProblem:
        lo, up, lo_fin, up_fin, active = lanes
        return IpmProblem(lo=lo, up=up, lo_fin=lo_fin, up_fin=up_fin,
                          active=active, **self._shared)

    def _problem_fields(self, los: np.ndarray, ups: np.ndarray):
        """Per-node (K, n_std + m) bound and mask arrays from node bounds
        over the relaxation's columns (K, n_orig)."""
        K = los.shape[0]
        m, n_std = self.m, self.n_std
        std = self.std
        with np.errstate(invalid="ignore"):
            lo_x = los / self.col_s[:self.n_orig][None, :]
            up_x = ups / self.col_s[:self.n_orig][None, :]
        # the standard form's own slack columns keep the template's bounds
        lo_rest = np.tile(std.col_lower[self.n_orig:] /
                          self.col_s[self.n_orig:], (K, 1))
        up_rest = np.tile(std.col_upper[self.n_orig:] /
                          self.col_s[self.n_orig:], (K, 1))
        lo_xs = np.concatenate([lo_x, lo_rest], axis=1)
        up_xs = np.concatenate([up_x, up_rest], axis=1)
        lo_sl = np.zeros((K, m))
        up_sl = np.tile(np.where(self.is_ineq > 0, np.inf, 0.0), (K, 1))
        lo = np.concatenate([lo_xs, lo_sl], axis=1)
        up = np.concatenate([up_xs, up_sl], axis=1)

        fixed = np.zeros((K, n_std + m), dtype=bool)
        with np.errstate(invalid="ignore"):
            fixed[:, :n_std] = np.isfinite(lo_xs) & np.isfinite(up_xs) & \
                (up_xs - lo_xs <= 1e-14 * (1.0 + np.abs(lo_xs)))
        fixed[:, n_std:] = self.is_ineq[None, :] == 0
        active = (~fixed).astype(np.float64)
        lo_fin = (np.isfinite(lo) & ~fixed).astype(np.float64)
        up_fin = (np.isfinite(up) & ~fixed).astype(np.float64)
        big = 1e30
        lo_dev = np.where(np.isfinite(lo), lo, -big)
        up_dev = np.where(np.isfinite(up), up, big)
        return lo_dev, up_dev, lo_fin, up_fin, active

    def evaluate(self, los: np.ndarray, ups: np.ndarray
                 ) -> List[Tuple[bool, float, Optional[np.ndarray]]]:
        """Evaluate K node relaxations.

        Returns per node (converged, dual_bound_min_space, x_orig);
        dual_bound is -inf where the lane produced no certified bound."""
        los = np.asarray(los, dtype=np.float64)
        ups = np.asarray(ups, dtype=np.float64)
        K = los.shape[0]
        r = self._rounds.get(K)
        if r is None:
            r = self._rounds[K] = _Round(K, self.n_std + self.m, self.m,
                                         self.device)
        for buf, f in zip(r.lanes, self._problem_fields(los, ups)):
            buf.copy_(torch.as_tensor(f))
        r.regs.copy_(torch.as_tensor(np.tile(self._regs, (K, 1))))
        self._run(r, "start")
        COUNTS["rounds"] += 1
        COUNTS["lanes"] += K

        norm_b = 1.0 + float(np.linalg.norm(self.b_scaled))
        norm_c = 1.0 + float(np.linalg.norm(self.c_scaled))
        tol = self.tolerance
        done = np.zeros(K, dtype=bool)
        best_dual = np.full(K, -np.inf)
        mh = None
        for it in range(self.max_iters):
            self._run(r, "step")
            COUNTS["iterations"] += 1
            COUNTS[self.device.type] += 1
            # the host reads the step's metrics, (7, K), once
            mh = r.metrics.cpu().numpy()
            primal_res, dual_res, mu, pobj, dobj = mh[:5]
            bad = ~np.isfinite(mu)
            if bad.any():
                # revert the broken lanes in the buffers, escalate their
                # regularization
                bad_dev = torch.as_tensor(bad, device=self.device)
                for buf, old in zip(r.state, r.prev):
                    buf.copy_(torch.where(
                        bad_dev.reshape((K,) + (1,) * (buf.ndim - 1)),
                        old, buf))
                r.regs.mul_(torch.where(bad_dev[:, None], 100.0, 1.0))
            rel_p = primal_res / norm_b
            rel_d = dual_res / norm_c
            rel_gap = np.abs(pobj - dobj) / (1.0 + np.abs(pobj) +
                                             np.abs(dobj))
            # certified dual bounds: nearly dual-feasible lanes
            cert = (rel_d < 1e-9) & np.isfinite(dobj) & ~bad
            best_dual[cert] = np.maximum(best_dual[cert], dobj[cert])
            done |= (rel_p < tol) & (rel_d < tol) & (rel_gap < tol)
            if it >= 10 and bool(done.all()):
                break

        if mh is None:
            return [(False, -np.inf, None)] * K
        xs = r.state.x.cpu().numpy()
        primal_res, dual_res, _, pobj, dobj = mh[:5]
        rel_p = primal_res / norm_b
        rel_d = dual_res / norm_c
        rel_gap = np.abs(pobj - dobj) / (1.0 + np.abs(pobj) + np.abs(dobj))
        results: List[Tuple[bool, float, Optional[np.ndarray]]] = []
        for k in range(K):
            converged = bool(rel_p[k] < tol and rel_d[k] < tol and
                             rel_gap[k] < tol)
            x_orig = None
            if converged:
                x_std = xs[k, :self.n_std] * self.col_s
                x_orig, _, _ = recover_solution(
                    self.std, x_std, np.zeros(self.m), np.zeros(self.n_std))
            results.append((converged, float(best_dual[k]), x_orig))
        COUNTS["converged"] += sum(r[0] for r in results)
        return results
