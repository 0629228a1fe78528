"""Device-side constraint-matrix operators.

The PDHG hot loop needs exactly two products: `A @ x` and `A' @ y`
(the reference's only PDLP kernel too, highs/pdlp/hipdlp/pdhg.cc).  The
right representation depends on size and sparsity:

- `DenseMatrix`: the matrix padded into one dense (m, n) array; both
  products are one `torch.mv` each.
- `EllMatrix`: padded ELL with a COO spill tail, for scattered sparsity
  too large to store dense.
- `BlockCsrMatrix` (ops/block_csr.py): dense 128x128 tiles in a
  CSR-of-blocks layout, with a hand-written CUDA kernel.

The JAX package's other formats (`panelell`, `bucketell`, `bucketperm`,
`bcoo`, `onehot`) are not ported yet and raise.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from .block_csr import BlockCsrMatrix, from_scipy_block_csr

# formats of the JAX package that this package does not have yet, with
# the ROADMAP item that ports them
NOT_YET_PORTED = {
    "panelell": "ROADMAP queue 1 item 2 (remaining linops formats)",
    "bucketell": "ROADMAP queue 1 item 2 (remaining linops formats)",
    "bucketperm": "ROADMAP queue 1 item 2 (remaining linops formats)",
    "bcoo": "ROADMAP queue 1 item 2 (remaining linops formats)",
    "onehot": "ROADMAP queue 2 items 2-3 (one-hot kernels)",
}


def not_yet_ported(fmt: str) -> NotImplementedError:
    return NotImplementedError(
        f"matrix format {fmt!r} is not yet ported: {NOT_YET_PORTED[fmt]}")


class DenseMatrix(NamedTuple):
    a: torch.Tensor  # (m, n)

    @property
    def shape(self):
        return tuple(self.a.shape)

    def mv(self, x):
        """A @ x."""
        return torch.mv(self.a, x)

    def rmv(self, y):
        """A' @ y."""
        return torch.mv(self.a.t(), y)


class EllMatrix(NamedTuple):
    """Padded-ELL operator with a COO spill tail.

    Each product is `sum(val * x[idx], axis=1)`, plus the entries of
    rows longer than the ELL width, summed into their rows with one
    `index_add_`."""
    idx: torch.Tensor       # (m, w)  int64 column indices, 0-padded
    val: torch.Tensor       # (m, w)  values, 0-padded
    idx_t: torch.Tensor     # (n, wt) transpose ELL
    val_t: torch.Tensor
    tail_seg: torch.Tensor    # (t,) row ids (sorted) of spilled entries
    tail_col: torch.Tensor    # (t,)
    tail_val: torch.Tensor    # (t,)
    tail_seg_t: torch.Tensor  # transpose spill
    tail_col_t: torch.Tensor
    tail_val_t: torch.Tensor

    @property
    def shape(self):
        return (self.idx.shape[0], self.idx_t.shape[0])

    @staticmethod
    def _half(x, idx, val, tail_seg, tail_col, tail_val):
        out = torch.sum(val * x[idx], dim=1)
        if tail_seg.shape[0]:
            out = out.index_add(0, tail_seg, tail_val * x[tail_col])
        return out

    def mv(self, x):
        return self._half(x, self.idx, self.val, self.tail_seg,
                          self.tail_col, self.tail_val)

    def rmv(self, y):
        return self._half(y, self.idx_t, self.val_t, self.tail_seg_t,
                          self.tail_col_t, self.tail_val_t)


def ell_layout(csr: sp.csr_matrix):
    """(idx, val, tail_seg, tail_col, tail_val) numpy arrays for one
    orientation: width min(max row, 4 * mean row + 4), longer rows
    spill to a row-sorted COO tail."""
    nr = csr.shape[0]
    cnt = np.diff(csr.indptr)
    mean_w = max(1.0, float(cnt.mean()))
    w = int(min(cnt.max() if nr else 1, np.ceil(4.0 * mean_w) + 4))
    idx = np.zeros((nr, w), np.int64)
    val = np.zeros((nr, w), np.float64)
    take = np.minimum(cnt, w)
    for k in range(w):
        sel = take > k
        pos = csr.indptr[:-1][sel] + k
        idx[sel, k] = csr.indices[pos]
        val[sel, k] = csr.data[pos]
    spill_rows = np.nonzero(cnt > w)[0]
    spill_len = cnt[spill_rows] - w
    seg = np.repeat(spill_rows, spill_len).astype(np.int64)
    pos = (np.repeat(csr.indptr[spill_rows] + w, spill_len) +
           np.arange(spill_len.sum()) -
           np.repeat(np.cumsum(spill_len) - spill_len, spill_len))
    return (idx, val, seg, csr.indices[pos].astype(np.int64),
            csr.data[pos].astype(np.float64))


def from_scipy_ell(mat: sp.spmatrix, dtype=torch.float64,
                   device="cpu") -> EllMatrix:
    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    halves = []
    for csr in (mat.tocsr(), mat.T.tocsr()):
        idx, val, seg, col, tval = ell_layout(csr)
        halves.append((dev(idx), dev(val, dtype), dev(seg), dev(col),
                       dev(tval, dtype)))
    (i_a, v_a, s_a, c_a, t_a), (i_t, v_t, s_t, c_t, t_t) = halves
    return EllMatrix(i_a, v_a, i_t, v_t, s_a, c_a, t_a, s_t, c_t, t_t)


LinOp = Union[DenseMatrix, EllMatrix, BlockCsrMatrix]


def linop_dtype(op) -> torch.dtype:
    """The value type of an operator's entries."""
    if isinstance(op, DenseMatrix):
        return op.a.dtype
    if isinstance(op, EllMatrix):
        return op.val.dtype
    if isinstance(op, BlockCsrMatrix):
        return op.dtype
    raise TypeError(f"unknown operator type {type(op).__name__}")


def cast_linop(op, dtype):
    """Low-precision copy of an operator (float values only), for
    mixed-precision PDHG stepping: the step products run on the copy,
    residuals and metrics on the full-precision operator.  Returns None
    when the operator type has no low-precision path (block-CSR)."""
    if isinstance(op, DenseMatrix):
        return DenseMatrix(op.a.to(dtype))
    if isinstance(op, EllMatrix):
        return op._replace(
            val=op.val.to(dtype), val_t=op.val_t.to(dtype),
            tail_val=op.tail_val.to(dtype),
            tail_val_t=op.tail_val_t.to(dtype))
    return None


def choose_format(mat: sp.spmatrix, dtype: torch.dtype) -> str:
    """The `choose` rule: dense while the dense array is at most 256 MB;
    beyond that block-CSR when the 128x128 tile structure is compact
    (fill >= 0.2, tiles <= 2 GB), else ELL.  (The JAX package picks a
    panel-gather ELL on the TPU there; on CUDA this package picks ELL.)"""
    m, n = mat.shape
    itemsize = dtype.itemsize
    if m * n * itemsize <= (256 << 20):
        return "dense"
    coo = mat.tocoo()
    n_col_tiles = (n + 127) // 128
    tiles = np.unique((coo.row.astype(np.int64) // 128) * n_col_tiles +
                      coo.col.astype(np.int64) // 128).size
    tile_bytes = max(1, tiles) * 128 * 128 * itemsize
    fill = mat.nnz * itemsize / tile_bytes
    if fill >= 0.2 and tile_bytes <= (2048 << 20):
        return "blockcsr"
    return "ell"


def from_scipy(mat: sp.spmatrix, fmt: str = "choose",
               dtype=torch.float64, device="cpu") -> LinOp:
    """Build a device operator from a scipy sparse matrix.

    fmt: "dense" / "ell" / "blockcsr" / "choose"; the JAX package's
    other format names raise NotImplementedError."""
    if fmt == "choose":
        fmt = choose_format(mat, dtype)
    if fmt in NOT_YET_PORTED:
        raise not_yet_ported(fmt)
    if fmt == "ell":
        return from_scipy_ell(mat, dtype=dtype, device=device)
    if fmt == "blockcsr":
        return from_scipy_block_csr(mat, dtype=dtype, device=device)
    if fmt == "dense":
        # full-precision products, as the JAX package's HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        return DenseMatrix(torch.as_tensor(mat.toarray(), dtype=dtype,
                                           device=device))
    raise ValueError(f"unknown matrix format {fmt!r}")
