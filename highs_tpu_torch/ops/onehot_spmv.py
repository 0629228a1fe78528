"""One-hot padded-cell SpMV for SCATTERED sparsity.

The reference layout is the JAX package's (`highs_tpu/ops/onehot_spmv.py`),
built on the host once by `cell_layout`: the nonzeros land in cells over
128x128 tile coordinates; cell (j, i) holds up to P nonzeros of column
block j and row block i (local column, local row, value), and the
nonzeros past P spill to a COO tail.  The JAX package computes y = K x
from it in four steps: a gather kernel (U = val * x_j[col], j-major), a
relayout of U into the scatter side's i-major order, a scatter kernel
(y_i[l] = sum_s [row == l] V), and the spill.  `spmv_cells_plain` is that
composition in plain PyTorch, over `build_cells`' tensors.

The card needs neither the padding nor the relayout: they answer the
TPU's lack of an addressable gather.  So `build_table` derives from the
cells, once, a table that holds every kept slot and every spilled entry
exactly once, grouped by output row (a row pointer over the padded rows,
global columns, values), and one hand-written kernel,
`csrc/onehot_spmv.cu`, computes the whole product from it in a single
launch (see the source for its design and bound).  `onehot_spmv_plain`
computes the kernel's function in plain PyTorch over the same table.
The wrapper `onehot_spmv` takes the plain version only for a CPU
tensor; a CUDA tensor launches the kernel or raises.

Unlike the JAX package, which stores the values in float32 whatever is
asked (`_build_cells`), the values keep the requested dtype, so an f64
operator computes in f64.  The index arrays are int32, as the JAX
package's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

BLOCK = 128
# the kernel indexes the table with int32
MAX_ENTRIES = 2 ** 31 - 1

# kernel launches in this process: each wrapper call that launches the
# kernel adds one (the plain versions never count)
LAUNCHES = {"onehot_spmv": 0}

_LIB = None


class OneHotCells(NamedTuple):
    """One direction (K or K') in the JAX package's padded-cell layout:
    the reference state of the table, and the input of
    `spmv_cells_plain`.

    gcol/gval: (nb, Rg, 128) gather-side slots, j-major: slot s of
    column block j holds cell (j, i=s//P, p=s%P), padded with value 0.
    srow: (mb, Rs, 128) scatter-side local rows, i-major (padding: 0).
    spill_*: the COO remainder past P slots per cell."""

    gcol: torch.Tensor
    gval: torch.Tensor
    srow: torch.Tensor
    spill_val: torch.Tensor
    spill_row: torch.Tensor
    spill_col: torch.Tensor
    shape: Tuple[int, int]  # padded (m, n)
    p_slots: int
    pad_cnt: int


class OneHotTable(NamedTuple):
    """One direction (K or K') as the kernel reads it: the entries of
    padded row r are row_ptr[r] .. row_ptr[r + 1] of col and val, in the
    cells' order (column block, slot), then the row's spill entries."""

    row_ptr: torch.Tensor  # (m + 1,) int32
    col: torch.Tensor  # (nnz,) int32, global column
    val: torch.Tensor  # (nnz,) the operator's dtype
    shape: Tuple[int, int]  # padded (m, n)
    p_slots: int
    pad_cnt: int  # entries that spilled past P slots


def _ceil_to(v: int, q: int) -> int:
    return -(-v // q) * q


def cell_layout(mat: sp.spmatrix, p_slots: int):
    """Host layout of one direction as numpy arrays: (gcol, gval, srow,
    spill_val, spill_row, spill_col, pad_cnt), values in float64."""
    coo = mat.tocoo()
    m, n = mat.shape
    mb = -(-m // BLOCK)
    nb = -(-n // BLOCK)
    jb = coo.col // BLOCK
    ib = coo.row // BLOCK
    cell = jb.astype(np.int64) * mb + ib
    order = np.argsort(cell, kind="stable")
    cell_s = cell[order]
    slot = np.arange(len(cell_s), dtype=np.int64)
    starts = np.searchsorted(cell_s, np.arange(nb * mb), side="left")
    slot = slot - starts[cell_s]
    keep = slot < p_slots
    ks = order[keep]
    cv = np.zeros((nb, mb, p_slots), dtype=np.float64)
    cc = np.zeros((nb, mb, p_slots), dtype=np.int32)
    cr = np.zeros((nb, mb, p_slots), dtype=np.int32)
    cv[jb[ks], ib[ks], slot[keep]] = coo.data[ks]
    cc[jb[ks], ib[ks], slot[keep]] = coo.col[ks] % BLOCK
    cr[jb[ks], ib[ks], slot[keep]] = coo.row[ks] % BLOCK
    # gather side: j-major slots padded to whole (8, 128) tiles
    rg = _ceil_to(mb * p_slots, 8 * BLOCK) // BLOCK
    gcol = np.zeros((nb, rg * BLOCK), dtype=np.int32)
    gval = np.zeros((nb, rg * BLOCK), dtype=np.float64)
    gcol[:, :mb * p_slots] = cc.reshape(nb, -1)
    gval[:, :mb * p_slots] = cv.reshape(nb, -1)
    # scatter side: i-major local rows, padding on row 0 (its value is 0)
    rs = _ceil_to(nb * p_slots, 8 * BLOCK) // BLOCK
    srow = np.zeros((mb, rs * BLOCK), dtype=np.int32)
    srow[:, :nb * p_slots] = np.transpose(cr, (1, 0, 2)).reshape(mb, -1)
    sp_ix = order[~keep]
    return (gcol.reshape(nb, rg, BLOCK), gval.reshape(nb, rg, BLOCK),
            srow.reshape(mb, rs, BLOCK), coo.data[sp_ix].astype(np.float64),
            coo.row[sp_ix].astype(np.int32), coo.col[sp_ix].astype(np.int32),
            int((~keep).sum()))


def table_layout(layout, p_slots: int):
    """The kernel's table derived from a `cell_layout`, as numpy arrays:
    (row_ptr, col, val), values in float64.  The slots of value zero are
    left out: every padding slot, and any explicit zero of the matrix,
    whose term is exactly zero."""
    gcol, gval, srow, s_val, s_row, s_col, _ = layout
    nb, mb = gcol.shape[0], srow.shape[0]
    p = p_slots
    # the kept slots, i-major: (mb, nb, p) as the scatter side holds them
    lcol = gcol.reshape(nb, -1)[:, :mb * p].reshape(nb, mb, p)
    lval = gval.reshape(nb, -1)[:, :mb * p].reshape(nb, mb, p)
    lcol, lval = lcol.transpose(1, 0, 2), lval.transpose(1, 0, 2)
    lrow = srow.reshape(mb, -1)[:, :nb * p].reshape(mb, nb, p)
    i = np.arange(mb, dtype=np.int64)[:, None, None]
    j = np.arange(nb, dtype=np.int64)[None, :, None]
    kept = lval != 0
    row = np.concatenate([(BLOCK * i + lrow)[kept], s_row.astype(np.int64)])
    col = np.concatenate([(BLOCK * j + lcol)[kept], s_col.astype(np.int64)])
    val = np.concatenate([lval[kept], s_val])
    if len(val) > MAX_ENTRIES:
        raise ValueError(f"{len(val)} entries: the one-hot kernel indexes "
                         f"at most {MAX_ENTRIES}")
    # a stable sort by row keeps the order above inside each row: cells
    # by (j, p), then the spill
    order = np.argsort(row, kind="stable")
    row_ptr = np.searchsorted(row[order], np.arange(mb * BLOCK + 1))
    return (row_ptr.astype(np.int32), col[order].astype(np.int32),
            val[order])


def build_cells(mat: sp.spmatrix, p_slots: int, dtype: torch.dtype,
                device=None) -> OneHotCells:
    """One direction in padded-cell layout on `device` (default CUDA),
    values in `dtype`."""
    device = resolve_device(device)
    gcol, gval, srow, s_val, s_row, s_col, pad_cnt = cell_layout(
        mat, p_slots)

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)
    return OneHotCells(
        gcol=dev(gcol), gval=dev(gval, dtype), srow=dev(srow),
        spill_val=dev(s_val, dtype), spill_row=dev(s_row),
        spill_col=dev(s_col),
        shape=(srow.shape[0] * BLOCK, gcol.shape[0] * BLOCK),
        p_slots=p_slots, pad_cnt=pad_cnt)


def build_table(mat: sp.spmatrix, p_slots: int, dtype: torch.dtype,
                device=None) -> OneHotTable:
    """One direction as the kernel's table on `device` (default CUDA),
    values in `dtype`."""
    device = resolve_device(device)
    layout = cell_layout(mat, p_slots)
    row_ptr, col, val = table_layout(layout, p_slots)
    return OneHotTable(
        row_ptr=torch.as_tensor(row_ptr, device=device),
        col=torch.as_tensor(col, device=device),
        val=torch.as_tensor(val, dtype=dtype, device=device),
        shape=(layout[2].shape[0] * BLOCK, layout[0].shape[0] * BLOCK),
        p_slots=p_slots, pad_cnt=layout[6])


def gather_plain(gcol: torch.Tensor, gval: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The JAX package's gather kernel in plain PyTorch."""
    nb = gcol.shape[0]
    picked = torch.gather(x.view(nb, BLOCK), 1, gcol.view(nb, -1).long())
    return (gval.view(nb, -1) * picked).view(gcol.shape)


def scatter_plain(srow: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's scatter kernel in plain PyTorch."""
    mb = srow.shape[0]
    y = torch.zeros((mb, BLOCK), dtype=v.dtype, device=v.device)
    y.scatter_add_(1, srow.view(mb, -1).long(), v.view(mb, -1))
    return y.view(mb * BLOCK)


def spmv_cells_plain(oc: OneHotCells, x: torch.Tensor) -> torch.Tensor:
    """y = K x as the JAX package computes it (`_spmv_cells`): gather,
    relayout j-major -> i-major into a zero-padded buffer, scatter,
    spill."""
    nb = oc.gcol.shape[0]
    mb = oc.srow.shape[0]
    p = oc.p_slots
    u = gather_plain(oc.gcol, oc.gval, x)
    u3 = u.view(nb, -1)[:, :mb * p].view(nb, mb, p)
    v = torch.zeros((mb, oc.srow.shape[1] * BLOCK), dtype=u.dtype,
                    device=u.device)
    v[:, :nb * p].view(mb, nb, p).copy_(u3.permute(1, 0, 2))
    y = scatter_plain(oc.srow, v.view(oc.srow.shape))
    return y.index_add_(0, oc.spill_row,
                        oc.spill_val * x.index_select(0, oc.spill_col))


def onehot_spmv_plain(tab: OneHotTable, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch over the same table: a
    gather of x, a multiply, `index_add_` into the rows."""
    m = tab.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(m, device=x.device), tab.row_ptr.diff(),
        output_size=tab.col.shape[0])
    y = torch.zeros(m, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, tab.val * x.index_select(0, tab.col))


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("onehot_spmv")
        for fn in (lib.onehot_spmv_f32, lib.onehot_spmv_f64):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def onehot_spmv(tab: OneHotTable, x: torch.Tensor) -> torch.Tensor:
    """y = K x for one direction, a new vector of tab.shape[0].  A CUDA
    tensor launches the kernel (one launch, no host sync, so a CUDA
    graph can capture it); a CPU tensor takes the plain version.  The
    table was checked when it was built; only x is checked here."""
    if x.dim() != 1 or x.shape[0] != tab.shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match a "
                         f"one-hot operator of shape {tab.shape}")
    if x.dtype != tab.val.dtype:
        raise TypeError(f"x is {x.dtype}, the operator {tab.val.dtype}")
    if x.device != tab.val.device or not x.is_contiguous():
        raise ValueError(f"x must be contiguous and on {tab.val.device}, "
                         f"not {x.device}")
    if x.device.type == "cpu":
        return onehot_spmv_plain(tab, x)
    if x.device.type != "cuda":
        raise ValueError(f"no one-hot kernel for device {x.device}")
    lib = _lib()
    fn = lib.onehot_spmv_f32 if x.dtype == torch.float32 else \
        lib.onehot_spmv_f64
    m = tab.shape[0]
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    # the pointers are read here, not kept in the table: a clone of the
    # table (CUDA graph timing cycles through clones) has its own
    rc = fn(tab.row_ptr.data_ptr(), tab.col.data_ptr(), tab.val.data_ptr(),
            x.data_ptr(), y.data_ptr(), m,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"onehot_spmv launch failed: CUDA error {rc}")
    LAUNCHES["onehot_spmv"] += 1
    return y


class OneHotSpmv(NamedTuple):
    """Bidirectional operator: K and K' as the kernel's tables."""

    fwd: OneHotTable
    bwd: OneHotTable

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd.val.dtype

    def mv(self, x):
        return onehot_spmv(self.fwd, x)

    def rmv(self, y):
        return onehot_spmv(self.bwd, y)


def choose_p(mat: sp.spmatrix) -> int:
    """Slot cap covering ~98% of the nonempty cells; the tail spills."""
    coo = mat.tocoo()
    mb = -(-mat.shape[0] // BLOCK)
    jb = (coo.col // BLOCK).astype(np.int64)
    ib = (coo.row // BLOCK).astype(np.int64)
    counts = np.bincount(jb * mb + ib)
    counts = counts[counts > 0]
    if not len(counts):
        return 1
    q = int(np.quantile(counts, 0.98))
    return int(max(1, min(12, q)))


def from_scipy_onehot(mat: sp.spmatrix, dtype=torch.float32,
                      p_slots: Optional[int] = None,
                      device=None) -> OneHotSpmv:
    """Both directions of `mat` on `device` (default CUDA)."""
    device = resolve_device(device)
    if p_slots is None:
        p_slots = choose_p(mat)
    return OneHotSpmv(fwd=build_table(mat, p_slots, dtype, device),
                      bwd=build_table(mat.T.tocsr(), p_slots, dtype, device))
