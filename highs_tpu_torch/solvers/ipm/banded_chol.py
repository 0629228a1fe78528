"""Blocked BANDED Cholesky on the device for large SPD normal equations.

The JAX package's `ipm/banded_chol.py`: after a host RCM ordering, the
normal matrices that structured LPs produce at scale (grid and network
flows, staircase LPs) are banded, and a banded matrix factors as a
sliding window of dense 128 x 128 block operations — Cholesky,
triangular solves and products.  The JAX package runs them as one
`lax.scan`; here they are a Python loop over block rows of torch ops on
the solver's device (about 25 small launches a block row, so a factor
is bound by launches, not by the card's rates).

Layout: block rows of NB = 128; block bandwidth `w` (sub-diagonal block
columns).  `ab[i, d]` is the band block A[i, i - w + d] (d = w the
diagonal block, stored full).  The factor is kept as `lp`, of shape
(w + nblk, w + 1, NB, NB): its first w rows are seed rows (identity
diagonal, zero elsewhere) so that row i of L is `lp[w + i]` and the w
rows before it are always present.  Device math is f32 (no TF32: the
products are float32 matmuls, which PyTorch runs in full f32 unless
the caller turned TF32 on); the IPM wraps each solve in f64 iterative
refinement on the host and drops this route when its probe solve misses
f64-grade residuals.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ...device import resolve_device

NB = 128


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


def factor_band(ab: torch.Tensor) -> torch.Tensor:
    """Left-looking blocked Cholesky of the band `ab`; returns `lp`.

    A diagonal block gets a shift of 3e-6 times its largest diagonal
    entry before its Cholesky (flow Laplacians are singular and late-IPM
    pivots vanish in f32), and a block whose Cholesky still fails becomes
    sqrt(scale) * I: its rows solve to about 0 and the outer refinement
    absorbs the error.  No host sync: a failure is found on the device."""
    nblk, w = ab.shape[0], ab.shape[1] - 1
    eye = torch.eye(NB, dtype=ab.dtype, device=ab.device)
    lp = torch.zeros((w + nblk, w + 1, NB, NB), dtype=ab.dtype,
                     device=ab.device)
    lp[:w, w] = eye
    for i in range(nblk):
        row = lp[w + i]
        for d in range(w):
            # block column k = i - w + d, whose factor row is lp[i + d]
            acc = ab[i, d]
            if d:
                # minus sum over t < d of L[i, i-w+t] L[k, i-w+t]^T
                acc = acc - _hcat(row[:d]) @ _hcat(lp[i + d, w - d:w]).T
            # L[i, k] = acc L[k, k]^-T
            row[d] = torch.linalg.solve_triangular(
                lp[i + d, w].T, acc, upper=True, left=False)
        left = _hcat(row[:w])
        diag = ab[i, w] - left @ left.T
        scale = diag.diagonal().abs().max().clamp_min(1e-20)
        diag = diag + eye * (3e-6 * scale)
        lii, info = torch.linalg.cholesky_ex(diag)
        bad = (info != 0) | ~torch.isfinite(lii).all()
        row[w] = torch.where(bad, eye * scale.sqrt(), lii)
    return lp


def solve_band(lp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L' x = b, by block forward and backward substitution."""
    w = lp.shape[1] - 1
    nblk = lp.shape[0] - w
    bb = b.reshape(nblk, NB)
    # z rows behind w zero seed rows, x rows ahead of w zero rows
    zp = torch.zeros((w + nblk, NB), dtype=b.dtype, device=b.device)
    for i in range(nblk):
        rhs = bb[i]
        if w:
            rhs = rhs - _hcat(lp[w + i, :w]) @ zp[i:i + w].reshape(-1)
        zp[w + i] = torch.linalg.solve_triangular(
            lp[w + i, w], rhs[:, None], upper=False)[:, 0]
    xp = torch.zeros((nblk + w, NB), dtype=b.dtype, device=b.device)
    for i in range(nblk - 1, -1, -1):
        rhs = zp[w + i]
        for d in range(min(w, nblk - 1 - i)):
            # row j = i + 1 + d holds block (j, i) at offset w - 1 - d
            j = i + 1 + d
            rhs = rhs - lp[w + j, w - 1 - d].T @ xp[j]
        xp[i] = torch.linalg.solve_triangular(
            lp[w + i, w].T, rhs[:, None], upper=True)[:, 0]
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


def refined_solve(lp: torch.Tensor, ab: torch.Tensor, b: torch.Tensor,
                  refine: int) -> torch.Tensor:
    """A factor solve and `refine` rounds of band-matvec residual
    correction, all on the device."""
    x = solve_band(lp, b)
    for _ in range(refine):
        x = x + solve_band(lp, b - band_matvec(ab, x))
    return x


class BandedCholesky:
    """Banded Cholesky of an SPD matrix, f32 on `device`.

    `None` from the constructor probe (`from_spd`) means the matrix is
    not band-compressible: callers keep their other route."""

    def __init__(self, perm: np.ndarray, nblk: int, w: int, device):
        self.perm = perm
        self.iperm = np.argsort(perm)
        self.nblk = nblk
        self.w = w
        self.m = len(perm)
        self.device = resolve_device(device)
        self._slots = None
        self._ab = None
        self._lp = None

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
        # storage check: (nblk, w+1, 128, 128) f32
        if nblk * (w + 1) * NB * NB * 4 > (1 << 31):
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
        _, src_ix, dst_ix, pad_ix = self._slots
        # upload only the nonzero values; the band is built on the device
        vals = torch.as_tensor(coo.data[src_ix].astype(np.float32),
                               device=self.device)
        self._ab = build_band(dst_ix, vals, pad_ix, self.nblk, self.w)
        self._lp = factor_band(self._ab)
        return self

    def _rhs(self, rhs: np.ndarray) -> torch.Tensor:
        b = np.zeros(self.nblk * NB, np.float32)
        b[:self.m] = rhs[self.perm]
        return torch.as_tensor(b, device=self.device)

    def _unpermute(self, x: torch.Tensor) -> np.ndarray:
        out = np.empty(self.m, np.float64)
        out[self.perm] = x[:self.m].cpu().numpy()
        return out

    def solve_refined(self, rhs: np.ndarray,
                      refine: int = 3) -> np.ndarray:
        """Factor solve + `refine` rounds of band-matvec residual
        correction on the device, in f32; the caller's f64 host
        refinement tops it up."""
        return self._unpermute(
            refined_solve(self._lp, self._ab, self._rhs(rhs), refine))

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        return self._unpermute(solve_band(self._lp, self._rhs(rhs)))
