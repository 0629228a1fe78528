"""One-hot padded-cell SpMV for SCATTERED sparsity.

The layout is the JAX package's (`highs_tpu/ops/onehot_spmv.py`), built
on the host once: the nonzeros land in cells over 128x128 tile
coordinates; cell (j, i) holds up to P nonzeros of column block j and
row block i (local column, local row, value), and the nonzeros past P
spill to a COO tail.  One product y = K x runs

1. the gather kernel: U[j, s] = gval[j, s] * x[128 j + gcol[j, s]] for
   every slot s of column block j (j-major);
2. the relayout: the slots of U, stripped of their lane padding, are
   permuted j-major -> i-major into the scatter side's zero-padded
   buffer `vbuf` (one torch copy);
3. the scatter kernel: y[128 i + l] = sum_s [srow[i, s] == l] V[i, s];
4. the spill: `index_add_` of the COO tail.

The two kernels are `csrc/onehot_spmv.cu` (see the source for their
design and bound); `gather_plain` and `scatter_plain` compute the same
functions in plain PyTorch.  A wrapper takes its plain version only for
a CPU tensor; a CUDA tensor launches the kernel or raises.

Unlike the JAX package, which stores the values in float32 whatever is
asked (`_build_cells`), the values keep the requested dtype, so an f64
operator computes in f64.  The index arrays are the JAX package's, int32.

`vbuf` is scratch that every product of the operator overwrites (its
padding stays zero), so the products of one operator run in stream
order: do not run them concurrently on different CUDA streams.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

BLOCK = 128

# kernel launches in this process: each wrapper call that launches its
# kernel adds one (the plain versions never count)
LAUNCHES = {"onehot_gather": 0, "onehot_scatter": 0}

_LIB = None


class OneHotCells(NamedTuple):
    """One direction (K or K') in padded-cell layout.

    gcol/gval: (nb, Rg, 128) gather-side slots, j-major: slot s of
    column block j holds cell (j, i=s//P, p=s%P), padded with value 0.
    srow: (mb, Rs, 128) scatter-side local rows, i-major (padding: 0).
    spill_*: the COO remainder past P slots per cell.
    vbuf: (mb, Rs*128) scatter-side staging buffer, zero past nb*P."""

    gcol: torch.Tensor
    gval: torch.Tensor
    srow: torch.Tensor
    spill_val: torch.Tensor
    spill_row: torch.Tensor
    spill_col: torch.Tensor
    vbuf: torch.Tensor
    shape: Tuple[int, int]  # padded (m, n)
    p_slots: int
    pad_cnt: int


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


def build_cells(mat: sp.spmatrix, p_slots: int, dtype: torch.dtype,
                device=None) -> OneHotCells:
    """One direction on `device` (default CUDA), values in `dtype`."""
    device = resolve_device(device)
    gcol, gval, srow, s_val, s_row, s_col, pad_cnt = cell_layout(
        mat, p_slots)
    mb, rs = srow.shape[0], srow.shape[1]
    nb = gcol.shape[0]

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)
    return OneHotCells(
        gcol=dev(gcol), gval=dev(gval, dtype), srow=dev(srow),
        spill_val=dev(s_val, dtype), spill_row=dev(s_row),
        spill_col=dev(s_col),
        vbuf=torch.zeros((mb, rs * BLOCK), dtype=dtype, device=device),
        shape=(mb * BLOCK, nb * BLOCK), p_slots=p_slots, pad_cnt=pad_cnt)


def gather_plain(gcol: torch.Tensor, gval: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The gather kernel's function in plain PyTorch."""
    nb = gcol.shape[0]
    picked = torch.gather(x.view(nb, BLOCK), 1, gcol.view(nb, -1).long())
    return (gval.view(nb, -1) * picked).view(gcol.shape)


def scatter_plain(srow: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The scatter kernel's function in plain PyTorch."""
    mb = srow.shape[0]
    y = torch.zeros((mb, BLOCK), dtype=v.dtype, device=v.device)
    y.scatter_add_(1, srow.view(mb, -1).long(), v.view(mb, -1))
    return y.view(mb * BLOCK)


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("onehot_spmv")
        for fn in (lib.onehot_gather_f32, lib.onehot_gather_f64):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.onehot_scatter_f32, lib.onehot_scatter_f64):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_slots(name: str, index: torch.Tensor, values: torch.Tensor):
    if index.dtype != torch.int32:
        raise TypeError(f"{name}: the slot indices must be int32, not "
                        f"{index.dtype}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the values must be float32 or float64, "
                        f"not {values.dtype}")
    if index.dim() != 3 or index.shape[2] != BLOCK or \
            values.shape != index.shape:
        raise ValueError(f"{name}: indices {tuple(index.shape)} and values "
                         f"{tuple(values.shape)} must both be (blocks, "
                         f"tiles, {BLOCK})")
    if index.device != values.device:
        raise ValueError(f"{name}: indices on {index.device}, values on "
                         f"{values.device}")
    if not (index.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{name}: indices and values must be contiguous")


def _fail_or_count(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def onehot_gather(gcol: torch.Tensor, gval: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """U[j, s] = gval[j, s] * x[128 j + gcol[j, s]], shaped as gcol.  A
    CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    _check_slots("onehot_gather", gcol, gval)
    nb = gcol.shape[0]
    if x.dim() != 1 or x.shape[0] != nb * BLOCK:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match "
                         f"{nb} column blocks")
    if x.dtype != gval.dtype:
        raise TypeError(f"x is {x.dtype}, the values {gval.dtype}")
    if x.device != gval.device or not x.is_contiguous():
        raise ValueError(f"x must be contiguous and on {gval.device}")
    if x.device.type == "cpu":
        return gather_plain(gcol, gval, x)
    if x.device.type != "cuda":
        raise ValueError(f"no one-hot kernel for device {x.device}")
    lib = _lib()
    fn = (lib.onehot_gather_f32 if x.dtype == torch.float32
          else lib.onehot_gather_f64)
    u = torch.empty_like(gval)
    slots = gcol.shape[1] * BLOCK
    rc = fn(gcol.data_ptr(), gval.data_ptr(), x.data_ptr(), u.data_ptr(),
            nb, slots, torch.cuda.current_stream(x.device).cuda_stream)
    _fail_or_count("onehot_gather", rc)
    return u


def onehot_scatter(srow: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[128 i + l] = sum_s [srow[i, s] == l] v[i, s], a vector of
    srow.shape[0] * 128.  A CUDA tensor launches the kernel; a CPU tensor
    takes the plain version."""
    _check_slots("onehot_scatter", srow, v)
    if v.device.type == "cpu":
        return scatter_plain(srow, v)
    if v.device.type != "cuda":
        raise ValueError(f"no one-hot kernel for device {v.device}")
    lib = _lib()
    fn = (lib.onehot_scatter_f32 if v.dtype == torch.float32
          else lib.onehot_scatter_f64)
    mb = srow.shape[0]
    y = torch.empty(mb * BLOCK, dtype=v.dtype, device=v.device)
    rc = fn(srow.data_ptr(), v.data_ptr(), y.data_ptr(), mb,
            srow.shape[1] * BLOCK,
            torch.cuda.current_stream(v.device).cuda_stream)
    _fail_or_count("onehot_scatter", rc)
    return y


def spmv_cells(oc: OneHotCells, x: torch.Tensor, gather=onehot_gather,
               scatter=onehot_scatter) -> torch.Tensor:
    """y = K x for one direction: gather, relayout, scatter, spill.
    `gather`/`scatter` default to the kernels' wrappers; the chip smoke
    test passes the plain versions to time the plain product."""
    nb = oc.gcol.shape[0]
    mb = oc.srow.shape[0]
    p = oc.p_slots
    xd = x.to(oc.gval.dtype)
    u = gather(oc.gcol, oc.gval, xd)
    # j-major (nb, mb, p) -> i-major (mb, nb, p), lane padding left out
    u3 = u.view(nb, -1)[:, :mb * p].view(nb, mb, p)
    oc.vbuf[:, :nb * p].view(mb, nb, p).copy_(u3.permute(1, 0, 2))
    y = scatter(oc.srow, oc.vbuf.view(oc.srow.shape))
    if oc.spill_val.shape[0]:
        y.index_add_(0, oc.spill_row,
                     oc.spill_val * xd.index_select(0, oc.spill_col))
    return y


class OneHotSpmv(NamedTuple):
    """Bidirectional operator: K and K' in padded-cell layout."""

    fwd: OneHotCells
    bwd: OneHotCells

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd.gval.dtype

    def mv(self, x):
        return spmv_cells(self.fwd, x)

    def rmv(self, y):
        return spmv_cells(self.bwd, y)


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
    return OneHotSpmv(fwd=build_cells(mat, p_slots, dtype, device),
                      bwd=build_cells(mat.T.tocsr(), p_slots, dtype, device))
