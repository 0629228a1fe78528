"""Row-sharded and 2-D-tiled sparse operators for PDHG over several devices.

The counterpart of the JAX package's `parallel/shard_ops.py`.  The 1-D
layout (`mesh.py`): K is partitioned into d equal row blocks, one per
device of the mesh axis.  Each shard holds BOTH directions of ITS row
block (the row tables for `K x` and the transpose tables of the same
rows for its partial `K_d' y_d`), so nothing is replicated:

    K x   ->  each shard's product with x, the row blocks joined
    K' y  ->  each shard's partial product with its slice of y, summed
              in shard order (`sum_partials`); in a job of several
              processes, where each rank holds its own row block, the
              sum is an all-reduce (`all_reduce_partials`)

Every local operator family of the JAX layout works (EllMatrix,
PanelEllMatrix, BlockCsrMatrix): each shard's operator is built on its
own row block and placed on its own device, and a CUDA block-CSR shard
launches `csrc/block_csr_spmv.cu` there.  The JAX package pads and
stacks the shards' leaves to one uniform shape for `shard_map`
(`_pad_leaf`, `_leaf_kinds`); a list of per-shard operators needs
neither, so neither is kept.  The row padding to a multiple of 128 d and
the equal row blocks are kept exactly: they fix m_pad, and so the
iterates.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import linops
from ..ops.block_csr import (BlockCsrMatrix, from_scipy_block_csr,
                             without_zero_tiles)
from .mesh import Mesh

# sums of several partial products (or all-reduces) made by K' y of a
# row-sharded operator and by the products of a 2-D one, in this process
REDUCTIONS = 0

def _block_csr_shard(mat: sp.spmatrix, dtype, device) -> BlockCsrMatrix:
    """A shard in block-CSR without the zero tile that the layout gives
    every empty block-row: a shard's K' has an empty block-row for every
    column block its rows miss (most of them on a mesh), and reading a
    zero tile there would double a banded shard's bytes."""
    op = from_scipy_block_csr(mat, dtype=dtype, device=device)
    return BlockCsrMatrix(without_zero_tiles(op.fwd),
                          without_zero_tiles(op.bwd))


_CONSTRUCTORS = {
    "ell": linops.from_scipy_ell,
    "panelell": linops.from_scipy_panel_ell,
    "blockcsr": _block_csr_shard,
}


def _constructor(fmt: str):
    # "choose" takes ELL, as the port's `choose` does on CUDA where the
    # JAX package takes the panel format (ROADMAP "Decisions")
    fmt = "ell" if fmt == "choose" else fmt
    if fmt not in _CONSTRUCTORS:
        raise ValueError(f"no sharded operator for format {fmt!r}: use "
                         f"one of {sorted(_CONSTRUCTORS)} or 'choose'")
    return _CONSTRUCTORS[fmt]


def sum_partials(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The partial products summed in shard order, on the device of the
    first: the same order, so the same bits, in every run."""
    global REDUCTIONS
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    if len(parts) > 1:
        REDUCTIONS += 1
    return acc


def all_reduce_partials(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """This process's partials summed in shard order, then summed over
    the processes of the job by `torch.distributed.all_reduce` (whose
    order across ranks is the backend's)."""
    global REDUCTIONS
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    torch.distributed.all_reduce(acc)
    REDUCTIONS += 1
    return acc


def _map_values(obj, fn):
    """`obj` with `fn` applied to every floating tensor in it."""
    if isinstance(obj, torch.Tensor):
        return fn(obj) if obj.is_floating_point() else obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_values(o, fn) for o in obj))
    if isinstance(obj, tuple):
        return tuple(_map_values(o, fn) for o in obj)
    return obj


class RowShardedOp:
    """Row-block operator: shard k, on `devices[k]`, computes the rows
    `row_bounds[k]` (start, stop) of this operator's row space.

    In one process the row space is all m_pad rows and `home` holds
    every input and output.  In a job of several processes a rank holds
    only its own shards, its row space is its own rows (`row_offset` is
    where they start in K), and K' y's sum is `all_reduce_partials`."""

    def __init__(self, shards: List, devices: List[torch.device],
                 row_bounds: List[Tuple[int, int]], shape: Tuple[int, int],
                 home: torch.device, reduce=sum_partials,
                 row_offset: int = 0):
        self.shards = list(shards)
        self.devices = [torch.device(d) for d in devices]
        self.row_bounds = list(row_bounds)
        self._shape = tuple(shape)
        self.home = torch.device(home)
        self.reduce = reduce
        self.row_offset = row_offset
        self.m_local = max(b - a for a, b in self.row_bounds)

    @property
    def shape(self):
        return self._shape

    def local_operators(self) -> List:
        return list(self.shards)

    def mv(self, x):
        """K @ x: x (n,) on the home device; the rows of this row space."""
        parts = [op.mv(x.to(dev)).to(self.home)
                 for op, dev in zip(self.shards, self.devices)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def rmv(self, y):
        """K' @ y: y the rows of this row space; (n,) on the home
        device, the shards' partials summed by `reduce`."""
        return self.reduce([
            op.rmv(y[a:b].to(dev)).to(self.home)
            for op, dev, (a, b) in zip(self.shards, self.devices,
                                       self.row_bounds)])

    def astype_values(self, dtype):
        """A copy with the values in `dtype` (mixed-precision stepping);
        index tensors keep their integer types."""
        shards = [_map_values(op, lambda t: t.to(dtype))
                  for op in self.shards]
        return RowShardedOp(shards, self.devices, self.row_bounds,
                            self._shape, self.home, self.reduce,
                            self.row_offset)

    def value_dtype(self) -> torch.dtype:
        return linops.linop_dtype(self.shards[0])


def make_row_sharded(mat: sp.spmatrix, mesh: Mesh, axis: str,
                     fmt: str = "choose", dtype=torch.float32
                     ) -> Tuple[RowShardedOp, int]:
    """Build a RowShardedOp from a scipy matrix.

    Rows are padded to a multiple of 128 d and split into d equal
    blocks, d the size of the mesh axis `axis`; each block's operator is
    built on its own device, its transpose tables covering only ITS
    rows.  On a mesh of several processes (`distributed.global_mesh`)
    each rank builds only its own blocks.  Returns (op, m_pad)."""
    build = _constructor(fmt)
    devices, processes = mesh.grid(axis)
    d = len(devices)
    m, n = mat.shape
    unit = 128 * d
    m_pad = ((m + unit - 1) // unit) * unit
    n_pad = ((n + 127) // 128) * 128
    csr = mat.tocsr().copy()
    csr.resize((m_pad, n_pad))
    m_local = m_pad // d

    owned = [k for k in range(d)
             if mesh.owns(None if processes is None else processes[k])]
    if not owned:
        raise ValueError("this process holds no row block of the mesh")
    shards = [build(csr[k * m_local:(k + 1) * m_local, :], dtype=dtype,
                    device=devices[k]) for k in owned]
    if processes is None:
        return RowShardedOp(shards, [devices[k] for k in owned],
                            [(k * m_local, (k + 1) * m_local)
                             for k in owned],
                            (m_pad, n_pad), mesh.home), m_pad
    # several processes: this rank's row space is its own blocks
    # (consecutive in the mesh order)
    if owned != list(range(owned[0], owned[-1] + 1)):
        raise ValueError("a process's row blocks must be consecutive")
    bounds = [((k - owned[0]) * m_local, (k - owned[0] + 1) * m_local)
              for k in owned]
    return RowShardedOp(shards, [devices[k] for k in owned], bounds,
                        (m_pad, n_pad), mesh.home,
                        reduce=all_reduce_partials,
                        row_offset=owned[0] * m_local), m_pad


class TwoDShardedOp:
    """2-D tiled operator: tile (i, j), on `devices[i, j]`, holds the
    rows `row_bounds[i]` and the columns `col_bounds[j]` of K with local
    indices (both directions of the same tile):

        K x   ->  each tile's product with its slice of x, summed over
                  the tiles of a row block (x and the result whole on
                  the home device)
        K' y  ->  each tile's transpose product with its slice of y,
                  summed over the tiles of a column block

    The sparse analogue of the dense 2-D layout of `mesh.shard_pdhg_2d`,
    the layout for one large LP over a grid of devices."""

    def __init__(self, tiles, devices: np.ndarray,
                 row_bounds: List[Tuple[int, int]],
                 col_bounds: List[Tuple[int, int]],
                 shape: Tuple[int, int], home: torch.device):
        self.tiles = [list(row) for row in tiles]
        self.devices = devices
        self.row_bounds = list(row_bounds)
        self.col_bounds = list(col_bounds)
        self._shape = tuple(shape)
        self.home = torch.device(home)
        self.m_local = max(b - a for a, b in self.row_bounds)
        self.n_local = max(b - a for a, b in self.col_bounds)

    @property
    def shape(self):
        return self._shape

    def local_operators(self) -> List:
        return [op for row in self.tiles for op in row]

    def mv(self, x):
        """K @ x: x (n,) and the result (m,) on the home device."""
        out = []
        for i, row in enumerate(self.tiles):
            out.append(sum_partials([
                op.mv(x[a:b].to(self.devices[i, j])).to(self.home)
                for j, (op, (a, b)) in enumerate(zip(row,
                                                     self.col_bounds))]))
        return torch.cat(out)

    def rmv(self, y):
        """K' @ y: y (m,) and the result (n,) on the home device."""
        out = []
        for j in range(len(self.col_bounds)):
            out.append(sum_partials([
                self.tiles[i][j].rmv(
                    y[a:b].to(self.devices[i, j])).to(self.home)
                for i, (a, b) in enumerate(self.row_bounds)]))
        return torch.cat(out)

    def astype_values(self, dtype):
        tiles = [[_map_values(op, lambda t: t.to(dtype)) for op in row]
                 for row in self.tiles]
        return TwoDShardedOp(tiles, self.devices, self.row_bounds,
                             self.col_bounds, self._shape, self.home)

    def value_dtype(self) -> torch.dtype:
        return linops.linop_dtype(self.tiles[0][0])


def make_2d_sharded(mat: sp.spmatrix, mesh: Mesh, row_axis: str,
                    col_axis: str, fmt: str = "choose",
                    dtype=torch.float32
                    ) -> Tuple[TwoDShardedOp, int, int]:
    """Build a TwoDShardedOp: pad to multiples of 128 R x 128 C, split
    into an R x C grid of tiles and build each tile's local operator
    (its index tables are tile-local by construction) on its device.
    Returns (op, m_pad, n_pad)."""
    build = _constructor(fmt)
    devices, processes = mesh.grid(row_axis, col_axis)
    if processes is not None:
        raise ValueError("the 2-D layout runs in one process")
    r, c = devices.shape
    m, n = mat.shape
    m_pad = ((m + 128 * r - 1) // (128 * r)) * (128 * r)
    n_pad = ((n + 128 * c - 1) // (128 * c)) * (128 * c)
    csr = mat.tocsr().copy()
    csr.resize((m_pad, n_pad))
    m_local = m_pad // r
    n_local = n_pad // c
    tiles = []
    for i in range(r):
        rows = csr[i * m_local:(i + 1) * m_local, :]
        tiles.append([
            build(rows[:, j * n_local:(j + 1) * n_local].tocsr(),
                  dtype=dtype, device=devices[i, j]) for j in range(c)])
    return (TwoDShardedOp(tiles, devices,
                          [(i * m_local, (i + 1) * m_local)
                           for i in range(r)],
                          [(j * n_local, (j + 1) * n_local)
                           for j in range(c)],
                          (m_pad, n_pad), mesh.home), m_pad, n_pad)
