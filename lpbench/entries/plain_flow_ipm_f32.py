"""The control of the EMD cell: a plain interior-point method in float32
put in the program's place.

The EMD configuration states float64; the control computes the same
LPs one precision below, in float32 on the card with TF32 off (on the
CPU in the tests), so that the comparison that decides `correct` is
shown to fail a solver that drops to that precision. Plain PyTorch:
Mehrotra's predictor-corrector on

    min c'x  s.t.  A x = b,  x >= 0,

with the normal equations (A X Z^-1 A' + shift I) dy = r formed dense
(each column's outer products scattered into M) and factored by
Cholesky; the shift keeps the factor alive on the flow's singular
Laplacian. It imports nothing of the program and is never timed.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

ITERATIONS = 80
# the plain method's own stop, below the tolerance it is judged by
STOP = 1e-9
DTYPE = torch.float32
# M's diagonal shift, relative to its largest diagonal entry: 64 units
# of roundoff of the precision, with which the same method in float64
# reaches 1e-9 on the flow
SHIFT = 64.0


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


def _outer_pairs(a: sp.csc_matrix):
    """Every pair (i, k) of nonzeros of one column of `a`: their rows,
    the column and the product a_ij a_kj, so that M = sum over pairs of
    d_j a_ij a_kj at (i, k)."""
    a = sp.csc_matrix(a)
    a.sum_duplicates()
    counts = np.diff(a.indptr)
    squares = counts * counts
    col = np.repeat(np.arange(a.shape[1]), squares)
    # pair `local` of its column's counts^2: entries (p, q) of the column
    local = np.arange(len(col)) - np.repeat(np.cumsum(squares) - squares,
                                            squares)
    first = a.indptr[col] + local // counts[col]
    second = a.indptr[col] + local % counts[col]
    return (a.indices[first], a.indices[second], col,
            a.data[first] * a.data[second])


def solve(lp, device):
    """(x, y, objective) of min c'x s.t. A x = b, x >= 0."""
    torch.backends.cuda.matmul.allow_tf32 = False

    def t(v, dtype=DTYPE):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    m, n = lp.a.shape
    csr = sp.csr_matrix(lp.a, dtype=np.float64)
    a = torch.sparse_csr_tensor(t(csr.indptr, torch.int64),
                                t(csr.indices, torch.int64),
                                t(csr.data), size=(m, n),
                                check_invariants=False)
    a_t = a.t().to_sparse_csr()
    rows, cols, pcol, pval = (t(v, d) for v, d in zip(
        _outer_pairs(lp.a), (torch.int64, torch.int64, torch.int64,
                             DTYPE)))
    b, c = t(lp.b), t(lp.c)
    x = torch.ones_like(c)
    z = torch.ones_like(c)
    y = torch.zeros_like(b)
    norm_b, norm_c = float(b.norm()), float(c.norm())
    best = (float("inf"), x, y)
    mmat = torch.empty((m, m), dtype=DTYPE, device=device)
    for _ in range(ITERATIONS):
        rb = b - a @ x
        rc = c - a_t @ y - z
        mu = float(x @ z) / n
        pobj, dobj = float(c @ x), float(b @ y)
        err = max(float(rb.norm()) / (1 + norm_b),
                  float(rc.norm()) / (1 + norm_c),
                  abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj)))
        # the best iterate is the answer: past it, rounding takes over
        if err < best[0]:
            best = (err, x, y)
        if err < STOP:
            break
        d = x / z
        mmat.zero_()
        mmat.index_put_((rows, cols), pval * d[pcol], accumulate=True)
        mmat.diagonal().add_(SHIFT * torch.finfo(DTYPE).eps *
                             float(mmat.diagonal().max()))
        chol, info = torch.linalg.cholesky_ex(mmat)
        if int(info) != 0:
            break

        def direction(rxz):
            rhs = rb + a @ (d * (rc - rxz / x))
            dy = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
            dx = d * (a_t @ dy - rc + rxz / x)
            dz = (rxz - z * dx) / x
            return dx, dy, dz

        aff = direction(-x * z)
        ap = _step_length(x, aff[0])
        ad = _step_length(z, aff[2])
        mu_aff = float((x + ap * aff[0]) @ (z + ad * aff[2])) / n
        sigma = (mu_aff / mu) ** 3
        dx, dy, dz = direction(sigma * mu - x * z - aff[0] * aff[2])
        del chol
        ap, ad = _step_length(x, dx), _step_length(z, dz)
        x, y, z = x + ap * dx, y + ad * dy, z + ad * dz
        if max(ap, ad) < 1e-6 or not np.isfinite(mu):
            break
    del mmat
    _, x, y = best
    xh = x.double().cpu().numpy()
    return xh, y.double().cpu().numpy(), float(lp.c @ xh)


def call(handle: Handle) -> None:
    handle.answers = [solve(lp, handle.device) for lp in handle.lps]
    if handle.device.type == "cuda":
        torch.cuda.synchronize()


def finish(handle: Handle) -> dict:
    answers = [{"optimal": True, "status": "plain_flow_ipm_f32", "x": x,
                "y": y, "objective": obj} for x, y, obj in handle.answers]
    return {"answers": answers, "route": "plain_flow_ipm_f32", "api": {}}


def summary(rec: dict) -> dict:
    return {}
