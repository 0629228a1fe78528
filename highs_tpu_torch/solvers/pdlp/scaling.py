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

The numpy functions below are the host route and the reference.  With a
CUDA device, `scale_problem` takes the card route, `scale_on_device`: the
same arithmetic in the same order on the card, so the scaled values and
the scale vectors are the host route's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.segment_sum import segment_sum


@dataclasses.dataclass
class ScalingVectors:
    row_scale: np.ndarray  # Dr diagonal
    col_scale: np.ndarray  # Dc diagonal
    ruiz_passes: int = 0  # Ruiz passes run (the stop test may end early)
    on_device: bool = False  # computed by the card route


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
    passes = 0
    for _ in range(iterations):
        passes += 1
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
    return out, row_scale, col_scale, passes


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


def scale_problem(a: sp.spmatrix, mode: int = 5, ruiz_iterations: int = 10,
                  device=None):
    """Apply the combined scaling per `pdlp_scaling_mode` bitmask.

    Returns (scaled_a, ScalingVectors), on the host.  `device` None or
    the CPU runs the numpy route; a CUDA device runs the card route
    (`scale_on_device`), which gives the same bits.
    """
    if (device is not None and torch.device(device).type == "cuda" and
            mode & 7):
        return scale_on_device(a, mode, ruiz_iterations, device)
    m, n = a.shape
    row_scale = np.ones(m)
    col_scale = np.ones(n)
    scaled = a.tocsr()
    passes = 0
    if mode & 1:
        scaled, dr, dc, passes = ruiz_scale(scaled, ruiz_iterations)
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
    return scaled, ScalingVectors(row_scale=row_scale, col_scale=col_scale,
                                  ruiz_passes=passes)


def _sqrt_dev(v: torch.Tensor) -> torch.Tensor:
    """An IEEE-rounded f64 square root, as numpy's: CUDA's is, but the
    CPU's torch.sqrt goes through a vector library that misses by an ulp
    on about 1% of values, so the CPU takes numpy's."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.sqrt(v.numpy()))
    return torch.sqrt(v)


def _inv_sqrt_dev(v: torch.Tensor) -> torch.Tensor:
    """`_safe_inv_sqrt` on a device: an IEEE square root and division
    (never rsqrt)."""
    return torch.where(v > 0, torch.ones_like(v) / _sqrt_dev(v), 1.0)


def _ruiz_dev(data, rows, cols, m, n, iterations):
    """`ruiz_scale`'s passes over |a| (`data`, updated in place) with its
    entries' row and column ids: the maxima are exact in any order, the
    two multiplies and the running products keep the host's order, and
    the stop test reads one flag a pass."""
    row_scale = torch.ones(m, dtype=data.dtype, device=data.device)
    col_scale = torch.ones(n, dtype=data.dtype, device=data.device)
    passes = 0
    for _ in range(iterations):
        passes += 1
        row_max = torch.zeros_like(row_scale).scatter_reduce_(
            0, rows, data, "amax")
        col_max = torch.zeros_like(col_scale).scatter_reduce_(
            0, cols, data, "amax")
        dr = _inv_sqrt_dev(row_max)
        dc = _inv_sqrt_dev(col_max)
        data *= dr[rows]
        data *= dc[cols]
        row_scale *= dr
        col_scale *= dc
        # converged when all norms within 1e-3 of 1 (NaN is not)
        far = [(mx > 0) & ~(torch.abs(1.0 - mx) < 1e-3)
               for mx in (row_max, col_max)]
        if not bool(far[0].any() | far[1].any()):
            break
    return row_scale, col_scale, passes


def _sum_scale_dev(values, rows, cols, row_ptr, col_order, col_ptr,
                   square):
    """`pock_chambolle_scale` (sums of |a|) or `l2_scale` (sums of a * a,
    then a square root) on a device: each row's sum in CSR order, each
    column's in the order of its entries in the CSR, as np.bincount adds
    them.  Returns the rescaled values and (dr, dc)."""
    row_sum = segment_sum(values, row_ptr, square=square)
    col_sum = segment_sum(values, col_ptr, col_order, square=square)
    if square:
        row_sum, col_sum = _sqrt_dev(row_sum), _sqrt_dev(col_sum)
    dr = _inv_sqrt_dev(row_sum)
    dc = _inv_sqrt_dev(col_sum)
    return values * dr[rows] * dc[cols], dr, dc


def scale_on_device(a: sp.spmatrix, mode: int, ruiz_iterations: int,
                    device):
    """`scale_problem`'s arithmetic on `device`: K's CSR values, column
    indices and row pointer uploaded once, every enabled pass run there,
    the scaled values brought back in one copy beside the host's own
    indices and row pointer.  The scaled values and the scale vectors
    equal the numpy route's bit for bit (a CUDA device sums rows and
    columns with `csrc/segment_sum.cu`, the CPU with its plain version).
    Nothing allocated here outlives the call."""
    device = torch.device(device)
    m, n = a.shape
    if mode & 1:  # the canonical copy `ruiz_scale` makes
        a = a.tocsr().copy()
        a.sum_duplicates()
    else:
        a = a.tocsr()
    if a.dtype != np.float64:
        raise TypeError(f"the card route scales float64 values, not "
                        f"{a.dtype}")
    row_ptr = torch.from_numpy(a.indptr).to(device, torch.int64)
    cols = torch.from_numpy(a.indices).to(device).long()
    values = torch.from_numpy(a.data).to(device)
    rows = torch.repeat_interleave(
        torch.arange(m, device=device), row_ptr.diff(),
        output_size=a.nnz)
    row_scale = torch.ones(m, dtype=torch.float64, device=device)
    col_scale = torch.ones(n, dtype=torch.float64, device=device)
    passes = 0
    if mode & 1:
        data = values.abs()
        dr, dc, passes = _ruiz_dev(data, rows, cols, m, n, ruiz_iterations)
        values = values.sign() * data
        del data
        row_scale *= dr
        col_scale *= dc
    if mode & 6:
        # the entries by column, stably: each column's terms in CSR order
        col_order = torch.sort(cols, stable=True)[1]
        col_ptr = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.cumsum(torch.bincount(cols, minlength=n), 0)])
        for bit, square in ((2, False), (4, True)):
            if mode & bit:
                values, dr, dc = _sum_scale_dev(values, rows, cols, row_ptr,
                                                col_order, col_ptr, square)
                row_scale *= dr
                col_scale *= dc
    out = sp.csr_matrix((values.cpu().numpy(), a.indices, a.indptr),
                        shape=(m, n))
    return out, ScalingVectors(row_scale=row_scale.cpu().numpy(),
                               col_scale=col_scale.cpu().numpy(),
                               ruiz_passes=passes, on_device=True)
