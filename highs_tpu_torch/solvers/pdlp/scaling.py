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

One route, in torch on the device it is given: the JAX package's numpy
scaling (`highs_tpu/solvers/pdlp/scaling.py`, the tests' reference) in the
same arithmetic and the same order, so the scaled values and the scale
vectors are its bits on every device.
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
    ruiz_passes: int  # Ruiz passes run (the stop test may end early)


def _sqrt_dev(v: torch.Tensor) -> torch.Tensor:
    """An IEEE-rounded f64 square root, as numpy's: CUDA's is, but the
    CPU's torch.sqrt goes through a vector library that misses by an ulp
    on about 1% of values, so the CPU takes numpy's."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.sqrt(v.numpy()))
    return torch.sqrt(v)


def _inv_sqrt_dev(v: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(v) where v > 0, else 1 (the reference's `_safe_inv_sqrt`):
    an IEEE square root and division (never rsqrt)."""
    return torch.where(v > 0, torch.ones_like(v) / _sqrt_dev(v), 1.0)


def _ruiz_dev(data, rows, cols, m, n, iterations):
    """The reference's `ruiz_scale` passes over |a| (`data`, updated in
    place) with its entries' row and column ids: the maxima are exact in
    any order, the two multiplies and the running products keep the
    reference's order, and the stop test reads one flag a pass."""
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
    """The reference's `pock_chambolle_scale` (sums of |a|) or `l2_scale`
    (sums of a * a, then a square root): each row's sum in CSR order, each
    column's in the order of its entries in the CSR, as np.bincount adds
    them.  Returns the rescaled values and (dr, dc)."""
    row_sum = segment_sum(values, row_ptr, square=square)
    col_sum = segment_sum(values, col_ptr, col_order, square=square)
    if square:
        row_sum, col_sum = _sqrt_dev(row_sum), _sqrt_dev(col_sum)
    dr = _inv_sqrt_dev(row_sum)
    dc = _inv_sqrt_dev(col_sum)
    return values * dr[rows] * dc[cols], dr, dc


def scale_problem(a: sp.spmatrix, mode: int, ruiz_iterations: int,
                  device):
    """Apply the combined scaling per the `pdlp_scaling_mode` bitmask
    `mode` on `device`: (scaled_a, ScalingVectors), on the host.

    K's CSR values, column indices and row pointer are uploaded once,
    every enabled pass runs there, and the scaled values come back in one
    copy beside the host's own indices and row pointer.  The scaled
    values and the scale vectors equal the reference's bit for bit (a
    CUDA device sums rows and columns with `csrc/segment_sum.cu`, the
    CPU with its plain version).  Nothing allocated here outlives the
    call."""
    device = torch.device(device)
    m, n = a.shape
    if mode & 1:  # the canonical copy the reference's `ruiz_scale` makes
        a = a.tocsr().copy()
        a.sum_duplicates()
    else:
        a = a.tocsr()
    if a.dtype != np.float64:
        raise TypeError(f"the scaling takes float64 values, not "
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
                               ruiz_passes=passes)
