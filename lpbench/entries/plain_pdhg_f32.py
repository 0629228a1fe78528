"""The control of the PDLP cells: a plain restarted Halpern PDHG in
float32 put in the program's place.

The PDLP cells' configuration states float64-grade answers (the program
runs PDHG in float32 on the card and refines it in float64). The
control computes the same LPs one precision below, wholly in float32 on
the card (on the CPU in the tests), at the configured tolerance, so
that the comparison that decides `correct` is shown to fail a solver
that drops to that precision. Plain PyTorch, the method of PDLP as its
papers state it (Lu and Yang's reflected restarted Halpern PDHG) on

    min c'x  s.t.  A x >= b,  0 <= x <= u,

after Ruiz and Pock-Chambolle scaling (on the host, in float64): the
step 0.9 / ||A||_2, the primal weight updated at each restart, a
restart on sufficient or stalled decay of the fixed-point residual or
after 36% of the iterations, and a stop where its own KKT measures, in
its own precision, reach the tolerance, or at the iteration limit. It
imports nothing of the program and is never timed.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

DTYPE = torch.float32
# iterations between restart and termination checks
CHECK = 64


class Handle:
    def __init__(self, lps, device, limit, tolerance):
        self.lps = lps
        self.device = device
        self.limit = limit
        self.tolerance = tolerance
        self.answers = None


def prepare(lps, options: dict, device) -> Handle:
    return Handle(lps, device, int(options["pdlp_iteration_limit"]),
                  float(options["pdlp_optimality_tolerance"]))


def scale(a: sp.csr_matrix):
    """Row and column scales (d_r, d_c) of 10 Ruiz passes, then one
    Pock-Chambolle pass (alpha 1)."""
    m, n = a.shape
    dr, dc = np.ones(m), np.ones(n)
    abs_a = abs(a).tocsr()
    for _ in range(10):
        s = sp.diags(dr) @ abs_a @ sp.diags(dc)
        rmax = s.max(axis=1).toarray().ravel()
        cmax = s.max(axis=0).toarray().ravel()
        dr /= np.sqrt(np.where(rmax > 0, rmax, 1.0))
        dc /= np.sqrt(np.where(cmax > 0, cmax, 1.0))
    s = sp.diags(dr) @ abs_a @ sp.diags(dc)
    rsum = np.asarray(s.sum(axis=1)).ravel()
    csum = np.asarray(s.sum(axis=0)).ravel()
    dr /= np.sqrt(np.where(rsum > 0, rsum, 1.0))
    dc /= np.sqrt(np.where(csum > 0, csum, 1.0))
    return dr, dc


def csr(a: sp.csr_matrix, device, dtype):
    return torch.sparse_csr_tensor(
        torch.as_tensor(a.indptr, dtype=torch.int64),
        torch.as_tensor(a.indices, dtype=torch.int64),
        torch.as_tensor(a.data, dtype=dtype), size=a.shape).to(device)


def solve(lp, device, limit: int, tol: float, dtype=DTYPE):
    """(x, y, objective, converged, iterations) of the LP."""
    a = lp.a.tocsr()
    dr, dc = scale(a)
    a_s = (sp.diags(dr) @ a @ sp.diags(dc)).tocsr()

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    k, kt = csr(a_s, device, dtype), csr(a_s.T.tocsr(), device, dtype)
    b, c, u = t(dr * lp.b), t(dc * lp.c), t(lp.upper / dc)
    inv_dr, inv_dc = t(1.0 / dr), t(1.0 / dc)
    norm_b = float(np.linalg.norm(lp.b))
    norm_c = float(np.linalg.norm(lp.c))

    gen = torch.Generator(device=device).manual_seed(0)
    v = torch.rand(a.shape[1], generator=gen, device=device, dtype=dtype)
    for _ in range(50):
        v = kt @ (k @ v)
        v = v / torch.linalg.vector_norm(v)
    eta = 0.9 / math.sqrt(float(torch.linalg.vector_norm(kt @ (k @ v))))
    nb, nc = float(torch.linalg.vector_norm(b)), \
        float(torch.linalg.vector_norm(c))
    omega = nc / nb if nb > 0 and nc > 0 else 1.0

    def step(x, y, tau, sigma):
        xn = torch.clamp(x - tau * (c - kt @ y), min=torch.zeros_like(x),
                         max=u)
        yn = torch.clamp_min(y + sigma * (b - k @ (2 * xn - x)), 0.0)
        return xn, yn

    def kkt(x, y):
        """The relative primal residual, dual residual (0: y >= 0 and
        every column boxed) and gap, in the working precision."""
        r = torch.clamp_min(b - k @ x, 0.0) * inv_dr
        z = c - kt @ y
        pobj = float(c @ x)
        dobj = float(b @ y) + float(u @ torch.clamp_max(z, 0.0))
        rel_p = float(torch.linalg.vector_norm(r)) / (1.0 + norm_b)
        gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        return max(rel_p, gap), pobj

    def dist(dx, dy, w):
        return math.sqrt(w * float(dx @ dx) + float(dy @ dy) / w)

    x = torch.zeros(a.shape[1], dtype=dtype, device=device)
    y = torch.zeros(a.shape[0], dtype=dtype, device=device)
    x0, y0 = x, y  # the Halpern anchor, the last restart's point
    r_restart = r_last = None
    inner = total = 0
    converged = False
    xt, yt = x, y
    while total < limit:
        tau, sigma = eta / omega, eta * omega
        xt, yt = step(x, y, tau, sigma)
        total += 1
        if total % CHECK == 0:
            err, _ = kkt(xt, yt)
            if err <= tol:
                converged = True
                break
            r = dist(x - xt, y - yt, omega)
            if r_restart is None:
                r_restart = r
            elif (r <= 0.2 * r_restart or
                  (r <= 0.8 * r_restart and r > r_last) or
                  inner >= 0.36 * total):
                dx = float(torch.linalg.vector_norm(xt - x0))
                dy = float(torch.linalg.vector_norm(yt - y0))
                if dx > 0 and dy > 0:
                    omega = math.exp(0.5 * math.log(dy / dx) +
                                     0.5 * math.log(omega))
                x0, y0, x, y = xt, yt, xt, yt
                r_restart, r_last, inner = r, r, 0
                continue
            r_last = r
        # the reflected Halpern step towards the anchor
        w = (inner + 1) / (inner + 2)
        x = w * (2 * xt - x) + (1 - w) * x0
        y = w * (2 * yt - y) + (1 - w) * y0
        inner += 1
    _, pobj = kkt(xt, yt)
    x_out = (xt * t(dc)).double().cpu().numpy()
    y_out = (yt * t(dr)).double().cpu().numpy()
    return x_out, y_out, pobj, converged, total


def call(handle: Handle) -> None:
    handle.answers = [solve(lp, handle.device, handle.limit,
                            handle.tolerance) for lp in handle.lps]
    if handle.device.type == "cuda":
        torch.cuda.synchronize()


def finish(handle: Handle) -> dict:
    answers = [{"optimal": ok,
                "status": "kOptimal" if ok else "kIterationLimit",
                "x": x, "y": y, "objective": obj, "iterations": its}
               for x, y, obj, ok, its in handle.answers]
    return {"answers": answers, "route": "plain_pdhg_f32", "api": {}}


def summary(rec: dict) -> dict:
    return {"iterations": [a["iterations"] for a in rec["answers"]]}
