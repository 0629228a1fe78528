"""The control of the QP cell: a plain interior-point method for convex
QPs in float32 put in the program's place.

The QP configuration states float64; the control computes the same QPs
one precision below, in float32 on the card with TF32 off (on the CPU
in the tests), so that the comparison that decides `correct` is shown
to fail a solver that drops to that precision. In float64 it is the CPU
tests' reference solver. Plain PyTorch: Mehrotra's predictor-corrector
on

    min 1/2 w'Hw + g'w  s.t.  K w = r,  lo <= w <= up,

w the columns and a slack for each row with distinct bounds (K = [A, -I]
on those rows, r their zero or the equality's value), one step length
for the primal and the dual, and each Newton system solved whole: the
full KKT matrix [[-(H + D), K'], [K, -shift]] factored by LU. It imports
nothing of the program and is never timed.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

ITERATIONS = 100
# the plain method's own stop, below the tolerance it is judged by
STOP = 1e-10
DTYPE = torch.float32


class Handle:
    def __init__(self, qps, device):
        self.qps = qps
        self.device = device
        self.answers = None


def prepare(qps, options: dict, device) -> Handle:
    return Handle(qps, device)


def _step_length(v, dv, mask):
    """The largest a <= 1 with v + a dv >= 0 where `mask`."""
    neg = (dv < 0) & mask
    if not bool(neg.any()):
        return 1.0
    return min(1.0, float((-v[neg] / dv[neg]).min()))


def standard_form(qp):
    """(H, g, K, r, lo, up, slack rows) of `qp` in float64 NumPy."""
    m, n = qp.a.shape
    ineq = np.nonzero(qp.row_lower != qp.row_upper)[0]
    k = len(ineq)
    slack = sp.csr_matrix((-np.ones(k), (ineq, np.arange(k))), shape=(m, k))
    big_k = sp.hstack([qp.a, slack]).toarray()
    r = np.where(qp.row_lower == qp.row_upper, qp.row_lower, 0.0)
    h = np.zeros((n + k, n + k))
    h[:n, :n] = qp.q.toarray()
    g = np.concatenate([qp.c, np.zeros(k)])
    lo = np.concatenate([qp.col_lower, qp.row_lower[ineq]])
    up = np.concatenate([qp.col_upper, qp.row_upper[ineq]])
    return h, g, big_k, r, lo, up, ineq


def solve(qp, device, dtype=DTYPE):
    """(x, y, z, objective, iterations) of the QP `qp`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, g, big_k, r, lo, up, ineq = standard_form(qp)
    n = qp.a.shape[1]

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    hm, gv, km, rv = t(h), t(g), t(big_k), t(r)
    lo_f, up_f = torch.isfinite(t(lo)), torch.isfinite(t(up))
    lo_v = torch.where(lo_f, t(lo), 0.0)
    up_v = torch.where(up_f, t(up), 0.0)
    size, rows = gv.numel(), rv.numel()
    # start: mid-box, or one from the finite bound; multipliers 1
    w = torch.where(lo_f & up_f, (lo_v + up_v) / 2,
                    torch.where(lo_f, lo_v + 1.0,
                                torch.where(up_f, up_v - 1.0, 0.0)))
    y = torch.zeros(rows, dtype=dtype, device=device)
    zl = lo_f.to(dtype)
    zu = up_f.to(dtype)
    n_comp = max(int(lo_f.sum() + up_f.sum()), 1)
    norm_r, norm_g = float(rv.norm()), float(gv.norm())
    shift = 1e-4 * torch.finfo(dtype).eps ** 0.5
    best = (float("inf"), w, y, zl - zu)
    it = 0
    for it in range(1, ITERATIONS + 1):
        xl = torch.where(lo_f, w - lo_v, 1.0)
        xu = torch.where(up_f, up_v - w, 1.0)
        hw = hm @ w
        rp = rv - km @ w
        rd = gv + hw - km.T @ y - zl + zu
        mu = float((xl * zl)[lo_f].sum() + (xu * zu)[up_f].sum()) / n_comp
        pobj = float(gv @ w + 0.5 * w @ hw)
        dobj = float(rv @ y - 0.5 * w @ hw + (lo_v * zl)[lo_f].sum() -
                     (up_v * zu)[up_f].sum())
        err = max(float(rp.norm()) / (1 + norm_r),
                  float(rd.norm()) / (1 + norm_g),
                  abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj)))
        # the best iterate is the answer: past it, rounding takes over
        if err < best[0]:
            best = (err, w, y, zl - zu)
        if err < STOP:
            break
        d = torch.where(lo_f, zl / xl, 0.0) + torch.where(up_f, zu / xu, 0.0)
        kkt = torch.zeros(size + rows, size + rows, dtype=dtype,
                          device=device)
        kkt[:size, :size] = -hm
        kkt[:size, :size].diagonal().sub_(d)
        kkt[:size, size:] = km.T
        kkt[size:, :size] = km
        # a dual shift keeps the factor alive where rows repeat
        kkt[size:, size:].diagonal().fill_(-shift)
        lu, piv, info = torch.linalg.lu_factor_ex(kkt)
        del kkt
        if int(info) != 0:
            break

        def direction(rl_c, ru_c):
            rhs = torch.cat([rd - torch.where(lo_f, rl_c / xl, 0.0) +
                             torch.where(up_f, ru_c / xu, 0.0), rp])
            sol = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
            dw, dy = sol[:size], sol[size:]
            dzl = torch.where(lo_f, (rl_c - zl * dw) / xl, 0.0)
            dzu = torch.where(up_f, (ru_c + zu * dw) / xu, 0.0)
            return dw, dy, dzl, dzu

        def step(dw, dzl, dzu):
            return min(_step_length(xl, dw, lo_f),
                       _step_length(xu, -dw, up_f),
                       _step_length(zl, dzl, lo_f),
                       _step_length(zu, dzu, up_f))

        aff = direction(-xl * zl, -xu * zu)
        a_aff = step(aff[0], aff[2], aff[3])
        mu_aff = float(((xl + a_aff * aff[0]) * (zl + a_aff * aff[2]))[
            lo_f].sum() + ((xu - a_aff * aff[0]) *
                           (zu + a_aff * aff[3]))[up_f].sum()) / n_comp
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0
        dw, dy, dzl, dzu = direction(
            sigma * mu - xl * zl - aff[0] * aff[2],
            sigma * mu - xu * zu + aff[0] * aff[3])
        alpha = 0.99 * step(dw, dzl, dzu)
        w, y = w + alpha * dw, y + alpha * dy
        zl = torch.where(lo_f, zl + alpha * dzl, 0.0)
        zu = torch.where(up_f, zu + alpha * dzu, 0.0)
        if alpha < 1e-8 or not np.isfinite(mu):
            break
    _, w, y, z = best
    x = w[:n].double().cpu().numpy()
    y_rows = y.double().cpu().numpy()
    obj = float(qp.c @ x + 0.5 * x @ (qp.q @ x))
    return x, y_rows, z[:n].double().cpu().numpy(), obj, it


def call(handle: Handle) -> None:
    handle.answers = [solve(qp, handle.device) for qp in handle.qps]
    if handle.device.type == "cuda":
        torch.cuda.synchronize()


def finish(handle: Handle) -> dict:
    answers = [{"optimal": True, "status": "plain_qp_ipm_f32", "x": x,
                "y": y, "z": z, "objective": obj}
               for x, y, z, obj, _ in handle.answers]
    return {"answers": answers, "route": "plain_qp_ipm_f32", "api": {}}


def summary(rec: dict) -> dict:
    return {}
