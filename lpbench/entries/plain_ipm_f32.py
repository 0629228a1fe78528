"""The control of the IPM cell: a plain interior-point method in float32
put in the program's place.

The IPM cell's configuration states float64; the control computes the
same LPs one precision below, in float32 on the card with TF32 off
(on the CPU in the tests), so that the comparison that decides
`correct` is shown to fail a solver that drops to that precision. Plain
PyTorch: Mehrotra's predictor-corrector on

    min c'x  s.t.  A x - s = b,  x + w = u,  x, s, w >= 0,

with the dense normal equations (A D^-1 A' + S Y^-1) dy = r factored by
Cholesky. It imports nothing of the program and is never timed.
"""
from __future__ import annotations

import numpy as np
import torch

ITERATIONS = 80
# the plain method's own stop, below the tolerance it is judged by
STOP = 1e-9
DTYPE = torch.float32


class Handle:
    def __init__(self, lps, device):
        self.lps = lps
        self.device = device
        self.answers = None


def prepare(lps, options: dict, device) -> Handle:
    return Handle(lps, device)


def _step_length(v, dv):
    """The largest a <= 1 with v + a dv >= 0 (0.99 of the way)."""
    neg = dv < 0
    if not bool(neg.any()):
        return 1.0
    return min(1.0, 0.99 * float((-v[neg] / dv[neg]).min()))


def solve(lp, device):
    """(x, y, objective) of min c'x s.t. A x >= b, 0 <= x <= u."""
    torch.backends.cuda.matmul.allow_tf32 = False

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=DTYPE, device=device)
    a = t(lp.a.toarray())
    b, c, u = t(lp.b), t(lp.c), t(lp.upper)
    x = u / 2
    w = u - x
    s = torch.clamp_min(a @ x - b, 1.0)
    y = torch.ones_like(b)
    z = torch.ones_like(c)
    v = torch.ones_like(c)
    n_comp = 2 * c.numel() + b.numel()
    norm_b, norm_c = float(b.norm()), float(c.norm())
    best = (float("inf"), x, y)
    for _ in range(ITERATIONS):
        rb = b - (a @ x - s)
        ru = u - x - w
        rc = c - a.T @ y + v - z
        mu = (x @ z + w @ v + s @ y) / n_comp
        pobj, dobj = float(c @ x), float(b @ y - u @ v)
        err = max(float(rb.norm()) / (1 + norm_b),
                  float(rc.norm()) / (1 + norm_c),
                  abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj)))
        # the best iterate is the answer: past it, rounding takes over
        if err < best[0]:
            best = (err, x, y)
        if err < STOP:
            break
        d = z / x + v / w
        m = (a / d) @ a.T + torch.diag(s / y)
        # a small shift keeps the factor alive as the slacks vanish
        m.diagonal().add_(1e-12 * float(m.diagonal().max()))
        chol, info = torch.linalg.cholesky_ex(m)
        if int(info) != 0:
            break

        def direction(rxz, rwv, rsy):
            r1 = rc + (rwv - v * ru) / w - rxz / x
            rhs = rb + a @ (r1 / d) + rsy / y
            dy = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
            dx = (a.T @ dy - r1) / d
            dw = ru - dx
            dz = (rxz - z * dx) / x
            dv = (rwv - v * dw) / w
            ds = (rsy - s * dy) / y
            return dx, dw, ds, dy, dz, dv

        aff = direction(-x * z, -w * v, -s * y)
        ap = min(_step_length(x, aff[0]), _step_length(w, aff[1]),
                 _step_length(s, aff[2]))
        ad = min(_step_length(y, aff[3]), _step_length(z, aff[4]),
                 _step_length(v, aff[5]))
        mu_aff = ((x + ap * aff[0]) @ (z + ad * aff[4]) +
                  (w + ap * aff[1]) @ (v + ad * aff[5]) +
                  (s + ap * aff[2]) @ (y + ad * aff[3])) / n_comp
        sigma = float((mu_aff / mu) ** 3)
        dx, dw, ds, dy, dz, dv = direction(
            sigma * mu - x * z - aff[0] * aff[4],
            sigma * mu - w * v - aff[1] * aff[5],
            sigma * mu - s * y - aff[2] * aff[3])
        ap = min(_step_length(x, dx), _step_length(w, dw),
                 _step_length(s, ds))
        ad = min(_step_length(y, dy), _step_length(z, dz),
                 _step_length(v, dv))
        x, w, s = x + ap * dx, w + ap * dw, s + ap * ds
        y, z, v = y + ad * dy, z + ad * dz, v + ad * dv
        if max(ap, ad) < 1e-6 or not torch.isfinite(mu):
            break
    _, x, y = best
    xh = x.double().cpu().numpy()
    return xh, y.double().cpu().numpy(), float(lp.c @ xh)


def call(handle: Handle) -> None:
    handle.answers = [solve(lp, handle.device) for lp in handle.lps]
    if handle.device.type == "cuda":
        torch.cuda.synchronize()


def finish(handle: Handle) -> dict:
    answers = [{"optimal": True, "status": "plain_ipm_f32", "x": x, "y": y,
                "objective": obj} for x, y, obj in handle.answers]
    return {"answers": answers, "route": "plain_ipm_f32", "api": {}}


def summary(rec: dict) -> dict:
    return {}
