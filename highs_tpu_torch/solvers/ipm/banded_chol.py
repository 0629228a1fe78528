"""Blocked BANDED Cholesky on the device for large SPD normal equations.

The JAX package's `ipm/banded_chol.py`: after a host RCM ordering, the
normal matrices that structured LPs produce at scale (grid and network
flows, staircase LPs) are banded, and a banded matrix factors as a
sliding window of dense 128 x 128 block operations — Cholesky,
triangular solves and products.  The JAX package runs them as one
`lax.scan`; here they are a Python loop over block rows of torch ops on
the solver's device, about 20 small launches a block row.

Layout: block rows of NB = 128; block bandwidth `w` (sub-diagonal block
columns).  `ab[i, d]` is the band block A[i, i - w + d] (d = w the
diagonal block, stored full).  The factor is kept as `lp`, of shape
(w + nblk, w + 1, NB, NB): its first w rows are seed rows (identity
diagonal, zero elsewhere) so that row i of L is `lp[w + i]` and the w
rows before it are always present.

Device math is float64, the IPM iterate's precision (the JAX package's
factor is float32); the IPM wraps each solve in f64 iterative
refinement on the host and reads the first Newton solve's residual.
On a card the factor's and the solve's block-row chains are each one
CUDA graph a band shape, captured at first use over static buffers
(M's slots and values and the factor; the right-hand side and the
solution) and replayed for every factor and solve: thousands of small
launches a call are bound by the host's launch rate, which a replay
does not pay.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ...device import resolve_device

NB = 128
# the shift of each diagonal entry before its block's Cholesky, in units
# of the working precision's epsilon times the entry of M
SHIFT_ULPS = 64
# graphs captured (one for the factor and one for the solve a band
# shape) and replayed, read like `pdlp.graph.COUNTS`
GRAPHS = Counter()


def _hcat(blocks: torch.Tensor) -> torch.Tensor:
    """(d, NB, NB) blocks side by side as one (NB, d * NB) matrix."""
    return blocks.transpose(0, 1).reshape(NB, -1)


def build_band(dst_ix: torch.Tensor, vals: torch.Tensor,
               pad_ix: torch.Tensor, nblk: int, w: int) -> torch.Tensor:
    """The band tensor ab (nblk, w + 1, NB, NB) on the device: the
    lower-triangle values scattered into their slots, each diagonal
    block's strict lower triangle mirrored, and a unit diagonal on the
    padding rows so that the trailing block stays SPD."""
    flat = torch.zeros(nblk * (w + 1) * NB * NB, dtype=vals.dtype,
                       device=vals.device)
    flat.index_put_((dst_ix,), vals)
    flat.index_fill_(0, pad_ix, 1.0)
    ab = flat.view(nblk, w + 1, NB, NB)
    diag = ab[:, w]
    ab[:, w] = diag + torch.tril(diag, -1).transpose(1, 2)
    return ab


def factor_band(ab: torch.Tensor):
    """Left-looking blocked Cholesky of the band `ab`; returns `lp` and
    the inverses of its diagonal blocks, `dinv` (w + nblk, NB, NB), seed
    rows first like `lp`'s.  An off-diagonal block is its row's update
    times the inverse of its column's diagonal block, one product in
    place of a triangular solve; each diagonal block is inverted once,
    by one triangular solve, as soon as it is factored.

    Each diagonal entry gets a shift of `SHIFT_ULPS` epsilons times its
    own value in M before its block's Cholesky (flow Laplacians are
    singular and late-IPM pivots vanish).  A shift by the block's largest
    entry instead perturbs the block's small rows far more than their
    own scale: on a 96^2 EMD flow the IPM's last Newton solves then kept
    a relative residual of 1.7e-9 after two host refinement rounds,
    against 5.6e-12 with the shift by entry.  A block whose Cholesky
    still fails becomes sqrt(scale) * I, scale its largest diagonal
    entry: its rows solve to about 0 and the outer refinement absorbs
    the error.  No host sync: a failure is found on the device, so the
    chain can be captured."""
    nblk, w = ab.shape[0], ab.shape[1] - 1
    eye = torch.eye(NB, dtype=ab.dtype, device=ab.device)
    shift = SHIFT_ULPS * torch.finfo(ab.dtype).eps
    lp = torch.zeros((w + nblk, w + 1, NB, NB), dtype=ab.dtype,
                     device=ab.device)
    lp[:w, w] = eye
    dinv = torch.zeros((w + nblk, NB, NB), dtype=ab.dtype,
                       device=ab.device)
    dinv[:w] = eye
    for i in range(nblk):
        row = lp[w + i]
        for d in range(w):
            # block column k = i - w + d, whose factor row is lp[i + d]
            acc = ab[i, d]
            if d:
                # minus sum over t < d of L[i, i-w+t] L[k, i-w+t]^T
                acc = torch.addmm(acc, _hcat(row[:d]),
                                  _hcat(lp[i + d, w - d:w]).T, alpha=-1)
            # L[i, k] = acc L[k, k]^-T
            torch.matmul(acc, dinv[i + d].T, out=row[d])
        left = _hcat(row[:w])
        diag = torch.addmm(ab[i, w], left, left.T, alpha=-1)
        scale = diag.diagonal().abs().max().clamp_min(1e-20)
        diag.diagonal().add_(ab[i, w].diagonal().abs(), alpha=shift)
        lii, info = torch.linalg.cholesky_ex(diag)
        bad = (info != 0) | ~torch.isfinite(lii).all()
        row[w] = torch.where(bad, eye * scale.sqrt(), lii)
        dinv[w + i] = torch.linalg.solve_triangular(row[w], eye,
                                                    upper=False)
    return lp, dinv


def solve_operators(lp: torch.Tensor, dinv: torch.Tensor):
    """The block rows of the two substitutions over the factor `lp` and
    its diagonal blocks' inverses `dinv` (`factor_band`), computed once
    a factor by batched products: `dinv` (nblk, NB, NB) the inverses
    L_ii^-1; `lower` (nblk, NB, w NB) the row L_ii^-1 [L_i,i-w ..
    L_i,i-1]; `upper` (nblk, NB, w NB) the row L_ii^-T [L_i+1,i' ..
    L_i+w,i'], zero past the last block row.  Each step of a sweep is
    then one product (`solve_band`) in place of a triangular solve and
    its neighbours' products: a sweep over 512 block rows is bound by
    its launches."""
    w = lp.shape[1] - 1
    nblk = lp.shape[0] - w
    rows = lp[w:]
    dinv = dinv[w:]
    lower = dinv @ rows[:, :w].transpose(1, 2).reshape(nblk, NB, w * NB)
    below = lp.new_zeros((nblk, w, NB, NB))
    for d in range(w):
        # block (i + 1 + d, i) sits in row i + 1 + d at offset w - 1 - d
        below[:nblk - 1 - d, d] = rows[1 + d:, w - 1 - d].transpose(1, 2)
    upper = dinv.transpose(1, 2) @ below.transpose(1, 2).reshape(
        nblk, NB, w * NB)
    return dinv, lower, upper


def factor_chain(dst_ix: torch.Tensor, vals: torch.Tensor,
                 pad_ix: torch.Tensor, nblk: int, w: int):
    """The whole factor on the device from M's values in their slots:
    the band, its factor and the factor's solve operators."""
    ab = build_band(dst_ix, vals, pad_ix, nblk, w)
    lp, dinv = factor_band(ab)
    return ab, lp, solve_operators(lp, dinv)


def solve_band(ops, b: torch.Tensor) -> torch.Tensor:
    """x with L L' x = b, by block forward and backward substitution over
    the factor's `solve_operators`."""
    dinv, lower, upper = ops
    nblk = dinv.shape[0]
    w = lower.shape[2] // NB
    # z rows behind w zero seed rows, x rows ahead of w zero rows; each
    # starts as its diagonal block's share and is updated in place
    zp = b.new_zeros((w + nblk, NB))
    zp[w:] = (dinv @ b.reshape(nblk, NB, 1))[..., 0]
    for i in range(nblk):
        zi = zp[w + i]
        torch.addmv(zi, lower[i], zp[i:i + w].reshape(-1), alpha=-1,
                    out=zi)
    xp = b.new_zeros((nblk + w, NB))
    xp[:nblk] = (dinv.transpose(1, 2) @ zp[w:, :, None])[..., 0]
    for i in range(nblk - 1, -1, -1):
        xi = xp[i]
        torch.addmv(xi, upper[i], xp[i + 1:i + 1 + w].reshape(-1),
                    alpha=-1, out=xi)
    return xp[:nblk].reshape(-1)


def band_matvec(ab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x for the symmetric band matrix stored (lower part) in `ab`."""
    nblk, w = ab.shape[0], ab.shape[1] - 1
    xb = x.reshape(nblk, NB)
    padded = torch.cat([xb.new_zeros((w, NB)), xb])
    xwin = torch.stack([padded[d:d + nblk] for d in range(w + 1)], dim=1)
    y = torch.einsum("idab,idb->ia", ab, xwin)
    # the mirrored upper part: block (i, i-w+d)^T feeds row i - (w-d)
    for d in range(w):
        s = w - d
        y[:nblk - s] += torch.einsum("iab,ia->ib", ab[s:, d], xb[s:])
    return y.reshape(-1)


def refined_solve(ops, ab: torch.Tensor, b: torch.Tensor,
                  refine: int) -> torch.Tensor:
    """A factor solve and `refine` rounds of band-matvec residual
    correction, all on the device."""
    x = solve_band(ops, b)
    for _ in range(refine):
        x = x + solve_band(ops, b - band_matvec(ab, x))
    return x


class _Graphs:
    """The factor's and the solve's graphs of one band shape (block rows,
    block bandwidth, counts of M's stored values and of padding rows),
    captured over static buffers that any structure of the shape fills:
    its slots, M's values, the right-hand side.  The graphs hold no
    data of a matrix, as the JAX package's compiled factor is one a
    shape; their outputs (band, factor, solve operators, solution)
    belong to the structure that factored last, `owner`."""

    def __init__(self, capture: Callable, slots, vals: torch.Tensor,
                 nblk: int, w: int):
        _, _, dst_ix, pad_ix = slots
        self.dst_ix, self.pad_ix, self.vals = dst_ix.clone(), \
            pad_ix.clone(), vals
        self.b = vals.new_zeros(nblk * NB)
        self.owner = None
        self.factor, (self.ab, self.lp, self.ops) = capture(
            lambda: factor_chain(self.dst_ix, self.vals, self.pad_ix,
                                 nblk, w))
        self.solve, self.x = capture(lambda: solve_band(self.ops, self.b))
        GRAPHS["captures"] += 2

    def take(self, owner, slots) -> None:
        """Hand the graphs to `owner`, whose slots they then read."""
        if self.owner is not owner:
            self.dst_ix.copy_(slots[2])
            self.pad_ix.copy_(slots[3])
            self.owner = owner


# the graphs of the last band shape factored, by (device, capture step,
# shape): an IPM solve factors one structure, and each solve of a
# permuted LP of the same size brings a new structure of the same shape
_GRAPH_CACHE: dict = {}


class BandedCholesky:
    """Banded Cholesky of an SPD matrix, f64 on `device`.

    `None` from the constructor probe (`from_spd`) means the matrix is
    not band-compressible: callers keep their other route.

    `capture` is the capture step of the factor's and the solve's
    graphs (`solvers/capture.py`): `cuda_graph` on a card, none (op by
    op) on the CPU; the CPU tests set `capture.eager_recorder`.  The
    graphs are kept for the last band shape and serve the structure
    that factored last: a solve after another structure of the same
    shape factored raises."""

    def __init__(self, perm: np.ndarray, nblk: int, w: int, device):
        self.perm = perm
        self.iperm = np.argsort(perm)
        self.nblk = nblk
        self.w = w
        self.m = len(perm)
        self.device = resolve_device(device)
        self.capture: Optional[Callable] = None
        if self.device.type == "cuda":
            # imported here: `solvers/capture.py` imports the IPM solver,
            # which imports this module
            from ..capture import cuda_graph
            self.capture = cuda_graph
        self._slots = None
        self._ab = None
        self._lp = None
        self._ops = None
        self._graphs = None

    @staticmethod
    def from_spd(mmat: sp.spmatrix, device=None, max_block_bw: int = 8
                 ) -> Optional["BandedCholesky"]:
        m = mmat.shape[0]
        perm = reverse_cuthill_mckee(mmat.tocsr(), symmetric_mode=True)
        coo = mmat.tocoo()
        ip = np.argsort(perm)
        bw = int(np.max(np.abs(ip[coo.row] - ip[coo.col]))) \
            if coo.nnz else 0
        nblk = -(-m // NB)
        w = max(1, -(-bw // NB))
        if w > max_block_bw:
            return None  # not banded enough: caller falls back
        # storage check: (nblk, w+1, 128, 128) f64
        if nblk * (w + 1) * NB * NB * 8 > (1 << 31):
            return None
        return BandedCholesky(np.asarray(perm), nblk, w, device)

    @property
    def lblocks(self) -> torch.Tensor:
        """The factor's block rows, (nblk, w + 1, NB, NB): row i holds
        L[i, i-w..i], as the JAX package's factor returns them."""
        return self._lp[self.w:]

    def _map_slots(self, coo: sp.coo_matrix):
        """COO entry -> band slot, once per pattern: the IPM's normal
        matrix keeps its pattern across iterations."""
        r = self.iperm[coo.row]
        c = self.iperm[coo.col]
        keep = c <= r  # lower triangle in permuted space
        br, lr = r // NB, r % NB
        bc, lc = c // NB, c % NB
        d = self.w - (br - bc)
        ok = keep & (d >= 0)
        flat = ((br * (self.w + 1) + d) * NB + lr) * NB + lc
        q = np.arange(self.m, self.nblk * NB)  # padding rows
        pad = ((q // NB * (self.w + 1) + self.w) * NB + q % NB) * NB + \
            q % NB
        self._slots = (coo.nnz, np.flatnonzero(ok),
                       torch.as_tensor(flat[ok], dtype=torch.int64,
                                       device=self.device),
                       torch.as_tensor(pad, dtype=torch.int64,
                                       device=self.device))

    def factor(self, mmat: sp.spmatrix) -> "BandedCholesky":
        coo = mmat.tocoo()
        if self._slots is None or self._slots[0] != coo.nnz:
            self._map_slots(coo)
        # upload only the nonzero values; the band is built on the device
        vals = torch.as_tensor(coo.data[self._slots[1]],
                               dtype=torch.float64)
        if self.capture is None:
            _, _, dst_ix, pad_ix = self._slots
            self._ab, self._lp, self._ops = factor_chain(
                dst_ix, vals.to(self.device), pad_ix, self.nblk, self.w)
            return self
        key = (self.device, self.capture, self.nblk, self.w, len(vals),
               len(self._slots[3]))
        graphs = _GRAPH_CACHE.get(key)
        if graphs is None:
            _GRAPH_CACHE.clear()
            graphs = _GRAPH_CACHE[key] = _Graphs(
                self.capture, self._slots, vals.to(self.device), self.nblk,
                self.w)
        graphs.take(self, self._slots)
        graphs.vals.copy_(vals)
        graphs.factor()
        GRAPHS["factor_replays"] += 1
        self._graphs = graphs
        self._ab, self._lp, self._ops = graphs.ab, graphs.lp, graphs.ops
        return self

    def _rhs(self, rhs: np.ndarray) -> torch.Tensor:
        b = np.zeros(self.nblk * NB)
        b[:self.m] = rhs[self.perm]
        return torch.as_tensor(b)

    def _unpermute(self, x: torch.Tensor) -> np.ndarray:
        out = np.empty(self.m, np.float64)
        out[self.perm] = x[:self.m].cpu().numpy()
        return out

    def solve_refined(self, rhs: np.ndarray,
                      refine: int = 3) -> np.ndarray:
        """Factor solve + `refine` rounds of band-matvec residual
        correction on the device, op by op (the JAX package's refined
        solve; the IPM refines on the host)."""
        return self._unpermute(refined_solve(
            self._ops, self._ab, self._rhs(rhs).to(self.device), refine))

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """x with M x = rhs through the factor, unrefined."""
        b = self._rhs(rhs)
        graphs = self._graphs
        if self.capture is None:
            return self._unpermute(solve_band(self._ops, b.to(self.device)))
        if graphs is None or graphs.owner is not self:
            raise RuntimeError("the band graphs serve another structure "
                               "now: factor this one again")
        graphs.b.copy_(b)
        graphs.solve()
        GRAPHS["solve_replays"] += 1
        return self._unpermute(graphs.x)
