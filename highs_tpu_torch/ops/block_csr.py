"""Block-CSR SpMV: dense 128x128 tiles in a CSR-of-blocks layout.

The PDHG hot loop needs `K x` and `K' y`.  For a matrix whose nonzeros
cluster into dense 128x128 tiles (staircase and multi-period models)
the product streams only the nonzero tiles.  `K'` is held as a second
block-CSR, so both directions run the same kernel.

The kernel, `csrc/block_csr_spmv.cu`, replaces the Pallas TPU kernel
`highs_tpu/ops/block_csr.py:_spmv_kernel`.  One CUDA thread block of 128
threads computes one 128-row block of y from that row's tiles.  It is
bound by the bytes of the tile stream: nnzb * 128 * 128 * itemsize per
product (see the source for the design).  `spmv_plain` computes the same
function with plain PyTorch operations; the CPU tests use it, and the
chip smoke test holds the kernel against it on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

BLOCK = 128

# launches of the CUDA kernel in this process (each wrapper call that
# launches it adds one)
LAUNCHES = 0

_LIB = None


class BlockCsr(NamedTuple):
    """One direction (K or K') in flat-tile block-CSR layout."""

    blocks: torch.Tensor  # (nnzb, BLOCK, BLOCK), tiles stored transposed
    block_row: torch.Tensor  # (nnzb,) int32, sorted
    block_col: torch.Tensor  # (nnzb,) int32
    first_in_row: torch.Tensor  # (nnzb,) int32
    row_ptr: torch.Tensor  # (mb + 1,) int32: row i owns tiles [ptr[i], ptr[i+1])
    shape: Tuple[int, int]


def block_csr_layout(mat: sp.spmatrix, padded_shape: Tuple[int, int]):
    """Host layout of one direction: (blocks, block_row, block_col,
    first_in_row, row_ptr) as numpy arrays.

    Tiles are stored transposed and sorted by block-row; every empty
    block-row gets one explicit zero tile, so every output block has at
    least one tile and is written by the kernel."""
    m, n = mat.shape
    mb = padded_shape[0] // BLOCK
    nb = padded_shape[1] // BLOCK
    mat = mat.tocsr()
    indptr = np.concatenate([
        mat.indptr,
        np.full(mb * BLOCK - m, mat.indptr[-1], dtype=mat.indptr.dtype)])
    padded = sp.csr_matrix((mat.data, mat.indices, indptr),
                           shape=(mb * BLOCK, nb * BLOCK))
    bsr = padded.tobsr(blocksize=(BLOCK, BLOCK))
    bsr.sort_indices()
    tiles_per_row = np.diff(bsr.indptr)
    blocks_list = [np.asarray(bsr.data)] if bsr.data.shape[0] else []
    block_row = np.repeat(np.arange(mb, dtype=np.int32), tiles_per_row)
    block_col = bsr.indices.astype(np.int32)
    empty_rows = np.nonzero(tiles_per_row == 0)[0].astype(np.int32)
    if len(empty_rows):
        blocks_list.append(np.zeros((len(empty_rows), BLOCK, BLOCK)))
        block_row = np.concatenate([block_row, empty_rows])
        block_col = np.concatenate(
            [block_col, np.zeros(len(empty_rows), dtype=np.int32)])
    if blocks_list:
        blocks = np.concatenate(blocks_list, axis=0)
    else:
        blocks = np.zeros((1, BLOCK, BLOCK))
        block_row = np.zeros(1, dtype=np.int32)
        block_col = np.zeros(1, dtype=np.int32)
    blocks = blocks.transpose(0, 2, 1)
    order = np.argsort(block_row, kind="stable")
    blocks = np.ascontiguousarray(blocks[order])
    block_row = block_row[order]
    block_col = block_col[order]
    first = np.ones(len(block_row), dtype=np.int32)
    first[1:] = (block_row[1:] != block_row[:-1]).astype(np.int32)
    row_ptr = np.searchsorted(block_row, np.arange(mb + 1)).astype(np.int32)
    return blocks, block_row, block_col, first, row_ptr


def _to_block_csr(mat: sp.spmatrix, dtype: torch.dtype,
                  padded_shape: Tuple[int, int],
                  device: torch.device) -> BlockCsr:
    blocks, block_row, block_col, first, row_ptr = block_csr_layout(
        mat, padded_shape)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return BlockCsr(
        blocks=torch.from_numpy(blocks.astype(np_dtype, copy=False)).to(
            device=device, dtype=dtype),
        block_row=torch.from_numpy(block_row).to(device),
        block_col=torch.from_numpy(block_col).to(device),
        first_in_row=torch.from_numpy(first).to(device),
        row_ptr=torch.from_numpy(row_ptr).to(device),
        shape=(padded_shape[0] // BLOCK * BLOCK,
               padded_shape[1] // BLOCK * BLOCK))


def spmv_plain(bc: BlockCsr, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather one x block per
    tile, a batched tile product, then a sum into block-rows."""
    mb = bc.shape[0] // BLOCK
    nb = bc.shape[1] // BLOCK
    xt = x.reshape(nb, BLOCK)[bc.block_col.long()]
    # tiles are stored transposed: x_block @ tile' == tile @ x_block
    prod = torch.einsum("bi,bij->bj", xt, bc.blocks)
    y = torch.zeros((mb, BLOCK), dtype=x.dtype, device=x.device)
    y.index_add_(0, bc.block_row.long(), prod)
    return y.reshape(mb * BLOCK)


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("block_csr_spmv")
        for fn in (lib.block_csr_spmv_f32, lib.block_csr_spmv_f64):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _spmv_cuda(bc: BlockCsr, x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    lib = _lib()
    fn = (lib.block_csr_spmv_f32 if x.dtype == torch.float32
          else lib.block_csr_spmv_f64)
    mb = bc.shape[0] // BLOCK
    y = torch.empty(mb * BLOCK, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(bc.blocks.data_ptr(), bc.block_col.data_ptr(),
            bc.row_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), mb, stream)
    if rc != 0:
        raise RuntimeError(f"block_csr_spmv launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y


def block_csr_spmv(bc: BlockCsr, x: torch.Tensor) -> torch.Tensor:
    """y = K x.  A CUDA tensor launches the kernel; a CPU tensor takes
    the plain version."""
    if x.dim() != 1 or x.shape[0] != bc.shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match a "
                         f"block-CSR operator of shape {bc.shape}")
    if x.dtype != bc.blocks.dtype or x.dtype not in (torch.float32,
                                                      torch.float64):
        raise TypeError(f"x is {x.dtype}, tiles are {bc.blocks.dtype}; "
                        "both must be float32 or both float64")
    if x.device != bc.blocks.device:
        raise ValueError(f"x is on {x.device}, the operator on "
                         f"{bc.blocks.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return spmv_plain(bc, x)
    if x.device.type != "cuda":
        raise ValueError(f"no block-CSR kernel for device {x.device}")
    return _spmv_cuda(bc, x)


class BlockCsrMatrix(NamedTuple):
    """Bidirectional operator: K in block-CSR and K' in block-CSR."""

    fwd: BlockCsr  # K
    bwd: BlockCsr  # K'

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd.blocks.dtype

    def mv(self, x):
        return block_csr_spmv(self.fwd, x)

    def rmv(self, y):
        return block_csr_spmv(self.bwd, y)


def from_scipy_block_csr(mat: sp.spmatrix, dtype=torch.float32,
                         device=None) -> BlockCsrMatrix:
    """Both directions of `mat` on `device` (default CUDA)."""
    m, n = mat.shape
    device = resolve_device(device)
    # pad both dims to whole tiles with consistent K / K' shapes
    mp = ((m + BLOCK - 1) // BLOCK) * BLOCK
    np_ = ((n + BLOCK - 1) // BLOCK) * BLOCK
    return BlockCsrMatrix(
        fwd=_to_block_csr(mat, dtype, (mp, np_), device),
        bwd=_to_block_csr(mat.T.tocsr(), dtype, (np_, mp), device))
