"""Problem scaling for PDHG.

Re-implements the behavior of the reference HiPDLP scaling
(highs/pdlp/hipdlp/scaling.cc): Ruiz equilibration (inf-norm, default 10
iterations, scaling.cc:56), optional Pock-Chambolle alpha=1
(scaling.cc:124) and optional L2 scaling (scaling.cc:182), combined
according to the `pdlp_scaling_mode` bitmask (1=Ruiz, 2=PC, 4=L2).

With x = Dc x~ and y = Dr y~ the scaled problem is
    A~ = Dr A Dc,  c~ = Dc c,  b~ = Dr b,
    l~ = Dc^-1 l,  u~ = Dc^-1 u,
and unscaling is x = Dc x~, y = Dr y~, z = Dc^-1 z~.

Host-side (numpy/scipy): scaling runs once per solve on the host, the
scaled problem is then shipped to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class ScalingVectors:
    row_scale: np.ndarray  # Dr diagonal
    col_scale: np.ndarray  # Dc diagonal


def _safe_inv_sqrt(v: np.ndarray) -> np.ndarray:
    out = np.ones_like(v)
    pos = v > 0
    out[pos] = 1.0 / np.sqrt(v[pos])
    return out


def ruiz_scale(a: sp.spmatrix, iterations: int = 10):
    """Ruiz equilibration in the infinity norm.

    Works directly on the CSR data array with per-entry row/col ids —
    per-iteration cost is three linear passes over nnz.  The former
    diags@a@diags form cost two sparse matmuls plus a sparse abs/max
    per iteration (~19s of the 25M-nnz block flagship's wall)."""
    a = a.tocsr().copy()
    a.sum_duplicates()
    m, n = a.shape
    row_scale = np.ones(m)
    col_scale = np.ones(n)
    row_of = np.repeat(np.arange(m, dtype=np.int64),
                       np.diff(a.indptr))
    col_of = a.indices
    data = np.abs(a.data.astype(np.float64, copy=True))
    sgn = np.sign(a.data)
    for _ in range(iterations):
        row_max = np.zeros(m)
        np.maximum.at(row_max, row_of, data)
        col_max = np.zeros(n)
        np.maximum.at(col_max, col_of, data)
        dr = _safe_inv_sqrt(row_max)
        dc = _safe_inv_sqrt(col_max)
        data *= dr[row_of]
        data *= dc[col_of]
        row_scale *= dr
        col_scale *= dc
        # converged when all norms within 1e-3 of 1
        if (np.all(np.abs(1.0 - row_max[row_max > 0]) < 1e-3) and
                np.all(np.abs(1.0 - col_max[col_max > 0]) < 1e-3)):
            break
    out = sp.csr_matrix((sgn * data, a.indices, a.indptr), shape=(m, n))
    return out, row_scale, col_scale


def pock_chambolle_scale(a: sp.spmatrix):
    """Pock-Chambolle diagonal scaling with alpha = 1:
    Dr_ii = 1/sqrt(sum_j |a_ij|), Dc_jj = 1/sqrt(sum_i |a_ij|)."""
    a = a.tocsr()
    absd = np.abs(a.data)
    m, n = a.shape
    row_of = np.repeat(np.arange(m, dtype=np.int64),
                       np.diff(a.indptr))
    row_sum = np.bincount(row_of, weights=absd, minlength=m)
    col_sum = np.bincount(a.indices, weights=absd, minlength=n)
    dr = _safe_inv_sqrt(row_sum)
    dc = _safe_inv_sqrt(col_sum)
    out = sp.csr_matrix((a.data * dr[row_of] * dc[a.indices],
                         a.indices, a.indptr), shape=(m, n))
    return out, dr, dc


def l2_scale(a: sp.spmatrix):
    """Scale by sqrt of row/col 2-norms."""
    a = a.tocsr()
    m, n = a.shape
    sq = a.data * a.data
    row_of = np.repeat(np.arange(m, dtype=np.int64),
                       np.diff(a.indptr))
    row_norm = np.sqrt(np.bincount(row_of, weights=sq, minlength=m))
    col_norm = np.sqrt(np.bincount(a.indices, weights=sq,
                                   minlength=n))
    dr = _safe_inv_sqrt(row_norm)
    dc = _safe_inv_sqrt(col_norm)
    out = sp.csr_matrix((a.data * dr[row_of] * dc[a.indices],
                         a.indices, a.indptr), shape=(m, n))
    return out, dr, dc


def scale_problem(a: sp.spmatrix, mode: int = 5, ruiz_iterations: int = 10):
    """Apply the combined scaling per `pdlp_scaling_mode` bitmask.

    Returns (scaled_a, ScalingVectors).
    """
    m, n = a.shape
    row_scale = np.ones(m)
    col_scale = np.ones(n)
    scaled = a.tocsr()
    if mode & 1:
        scaled, dr, dc = ruiz_scale(scaled, ruiz_iterations)
        row_scale *= dr
        col_scale *= dc
    if mode & 2:
        scaled, dr, dc = pock_chambolle_scale(scaled)
        row_scale *= dr
        col_scale *= dc
    if mode & 4:
        scaled, dr, dc = l2_scale(scaled)
        row_scale *= dr
        col_scale *= dc
    return scaled, ScalingVectors(row_scale=row_scale, col_scale=col_scale)
