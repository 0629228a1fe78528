"""ICrash — iterative crash starting-point heuristic.

Re-implements the behavior of the reference ICrash
(highs/presolve/ICrash.cpp / ICrashX.cpp): an augmented-Lagrangian /
quadratic-penalty method that produces an approximately feasible,
low-cost point (and multiplier estimate) used to warm-start the LP
solvers (strategies kPenalty/kAdmm/kICA, ICrash.h:20-40).

Each outer iteration approximately minimizes

    Phi(x) = w c'x + lambda' r(x) + (1/(2 mu)) ||r(x)||^2,
    r(x) = Ax - clamp(Ax, rl, ru)

over the box [l, u] with `icrash_approx_iter` projected-gradient steps
on the device (a dense A when it has at most 4 M entries, else one
`torch.sparse_csr_tensor` per direction), then updates
lambda <- lambda + r/mu and tightens mu.  The objective weight w ramps
from icrash_starting_weight toward 1 so early iterations prioritize
feasibility (the reference's strategy)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.lp import HighsLp
from ..ops.linops import _sparse_csr
from ..options import HighsOptions
from .pdlp.wrapper import _resolve_dtype

DENSE_LIMIT = 4_000_000  # entries of a dense A


@dataclasses.dataclass
class ICrashInfo:
    """Mirror of the reference ICrashInfo record."""
    num_iterations: int = 0
    final_lambda_norm2: float = 0.0
    final_residual_norm2: float = 0.0
    starting_weight: float = 0.0
    total_time: float = 0.0
    x: object = None
    lambda_: object = None


def run_icrash(lp: HighsLp, options: HighsOptions, log=None,
               device=None) -> ICrashInfo:
    """iCrash on `device` (default CUDA), in f64 on the CPU and f32 on
    CUDA unless `tpu_dtype` says otherwise."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    info = ICrashInfo(starting_weight=options.icrash_starting_weight)
    n, m = lp.num_col, lp.num_row
    dtype = (torch.float64 if _resolve_dtype(options, device) == "float64"
             else torch.float32)

    def dev(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    a = lp.a_matrix.to_scipy().tocsr()
    sense = float(lp.sense)
    c = dev(sense * lp.col_cost)
    big = 1e20
    lo = dev(np.where(np.isfinite(lp.col_lower), lp.col_lower, -big))
    up = dev(np.where(np.isfinite(lp.col_upper), lp.col_upper, big))
    rl = dev(np.where(np.isfinite(lp.row_lower), lp.row_lower, -big))
    ru = dev(np.where(np.isfinite(lp.row_upper), lp.row_upper, big))

    if n * m and n * m <= DENSE_LIMIT:
        a_dense = a.toarray()
        a_dev = dev(a_dense)
        a_t = a_dev.T
        norm_a = float(np.linalg.norm(a_dense, 2)) if m else 1.0
    else:
        a_dev = _sparse_csr(a, dtype, device)
        a_t = _sparse_csr(a.T.tocsr(), dtype, device)
        # cheap spectral bound
        norm_a = float(np.sqrt(abs(a).sum(axis=0).max() *
                               abs(a).sum(axis=1).max())) if m else 1.0

    def residual(x):
        ax = a_dev @ x
        return ax - torch.clamp(ax, rl, ru)

    def inner(x, lam, w, rho):
        step = 1.0 / (rho * norm_a * norm_a + 1e-12)
        for _ in range(options.icrash_approx_iter):
            g = w * c + a_t @ (lam + rho * residual(x))
            x = torch.clamp(x - step * g, lo, up)
        return x, residual(x)

    x = torch.clamp(torch.zeros(n, dtype=dtype, device=device), lo, up)
    lam = torch.zeros(m, dtype=dtype, device=device)
    r = torch.zeros(m, dtype=dtype, device=device)
    w = options.icrash_starting_weight
    mu = 1.0
    ru_norm = float(torch.linalg.norm(ru))
    for k in range(max(1, min(options.icrash_iterations, 200))):
        rho = 1.0 / mu
        x, r = inner(x, lam, w, rho)
        lam = lam + rho * r
        res = float(torch.linalg.norm(r))
        if log is not None:
            log(f"iCrash {k + 1:3d}: residual {res:.3e} weight {w:.1e}")
        info.num_iterations = k + 1
        if res <= 1e-9 * (1.0 + ru_norm):
            break
        mu *= 0.7
        w = min(1.0, w * 10.0)

    info.final_residual_norm2 = float(torch.linalg.norm(r)) if m else 0.0
    info.final_lambda_norm2 = float(torch.linalg.norm(lam)) if m else 0.0
    info.total_time = time.perf_counter() - t0
    info.x = x.cpu().numpy().astype(np.float64)
    # multiplier for L <= Ax <= U in the original sense: y = -sense*lam
    info.lambda_ = -sense * lam.cpu().numpy().astype(np.float64)
    return info
