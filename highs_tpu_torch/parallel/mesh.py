"""Device mesh and sharding layout for the PDHG solver.

The counterpart of the JAX package's `parallel/mesh.py`: data
parallelism over the constraint matrix.  Layout (1-D mesh, axis "rows"):
K is split into d equal row blocks, one per device of the mesh
(`shard_ops.RowShardedOp`), each holding both directions of its rows, so

- K x  -> each block's local product, the results joined;
- K' y -> each block's partial product of its slice of y, the partials
  summed in shard order (`shard_ops.sum_partials`; in a job of several
  processes an all-reduce, `parallel/distributed.py`).

One process drives every device of the mesh: the operator's shards live
on their devices, and the problem's and the state's vectors live whole on
the mesh's home device (its first), where the products bring their
results back.  So a PDHG step costs, per shard, one copy of x (n) and of
a row slice of y (m / d) out and of the products (m / d, n) back.  A
second mesh axis "batch" is used by the dry run's batched step
(`parallel/dryrun.py`); the 2-D layout (`shard_pdhg_2d`) shards rows and
columns.

On the CPU a d-device mesh is d views of the one CPU device (as the JAX
tests' virtual CPU devices), and an explicit device list may repeat a
device: the partition, the per-shard products and the sum run as on d
cards.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.linops import DenseMatrix

ROW_AXIS = "rows"
BATCH_AXIS = "batch"
COL_AXIS = "cols"


class Mesh:
    """A device array of shape `devices.shape` with one name per axis.

    `processes`, in a job of several processes (`distributed.
    global_mesh`), gives the rank that owns each device; None in one
    process, which then owns every device."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of shape {devices.shape} needs {devices.ndim} "
                f"axis names, got {len(axis_names)}: {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.processes = processes

    @property
    def shape(self) -> dict:
        """Axis name -> size, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _rank(self) -> int:
        return torch.distributed.get_rank()

    @property
    def home(self) -> torch.device:
        """Where the problem's vectors live: the first device, or in a
        job of several processes this process's own device."""
        if self.processes is None:
            return self.devices.flat[0]
        where = np.flatnonzero(self.processes.ravel() == self._rank())
        if not len(where):
            raise ValueError(f"process {self._rank()} holds no device of "
                             f"this mesh")
        return self.devices.flat[where[0]]

    def grid(self, *axes: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(devices, processes) over `axes` in that order, at index 0 of
        every other axis (a layout over some axes is replicated over the
        others, as a sharding that names only some axes)."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh axes {self.axis_names} have no "
                                 f"axis {a!r}")
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]

        def pick(arr):
            if arr is None:
                return None
            moved = np.transpose(arr, order + rest)
            return moved[(Ellipsis,) + (0,) * len(rest)] if rest else moved
        return pick(self.devices), pick(self.processes)

    def owns(self, process) -> bool:
        """Whether this process computes on a device owned by `process`
        (None: the mesh has one process)."""
        return process is None or int(process) == self._rank()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = (ROW_AXIS,),
              devices=None, device=None) -> Mesh:
    """A mesh of `shape` (default: one axis over every device) with the
    given axis names.

    Without `devices`, the mesh is over the devices of `device`'s type
    (default CUDA): on CUDA, `shape` needs that many distinct cards and
    raises ValueError naming the count otherwise; on the CPU, a d-device
    mesh is d views of the CPU.  An explicit `devices` list may repeat a
    device (several shards on one card)."""
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if not shape or min(shape) < 1:
            raise ValueError(f"mesh shape {shape}: every axis needs at "
                             f"least one device")
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            shape = shape or (count,)
            n = math.prod(shape)
            if n > count:
                raise ValueError(
                    f"a mesh of shape {shape} needs {n} CUDA devices; this "
                    f"machine has {count}")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            shape = shape or (1,)
            devices = [torch.device("cpu")] * math.prod(shape)
    else:
        devices = [torch.device(d) for d in devices]
        shape = shape or (len(devices),)
        n = math.prod(shape)
        if n > len(devices):
            raise ValueError(f"a mesh of shape {shape} needs {n} devices; "
                             f"{len(devices)} were given")
        devices = devices[:n]
    return Mesh(_device_array(devices, shape), axis_names)


def parse_mesh_shape(spec: str) -> Optional[Tuple[int, ...]]:
    """Parse an option string like '4x2' or '8'."""
    spec = spec.strip()
    if not spec:
        return None
    return tuple(int(p) for p in spec.split("x"))


def _place(obj, device):
    """`obj` (a tensor, or a NamedTuple or tuple of them) on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_place(o, device) for o in obj))
    if isinstance(obj, tuple):
        return tuple(_place(o, device) for o in obj)
    return obj


def _place_vectors(problem, state, home):
    problem = problem._replace(**{
        f: _place(getattr(problem, f), home)
        for f in problem._fields if f != "k_op"})
    if state is not None:
        state = _place(state, home)
    return problem, state


def _bounds(size: int, parts: int):
    """Equal (start, stop) blocks of range(size), the first ones one
    longer where `parts` does not divide `size`."""
    q, r = divmod(size, parts)
    edges = np.cumsum([0] + [q + 1] * r + [q] * (parts - r))
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def shard_pdhg(problem, state, mesh: Mesh, row_axis: str = ROW_AXIS):
    """Lay a PdhgProblem (and PdhgState, or None) out on the mesh's rows.

    A dense K is split into row blocks on the devices of `row_axis`; an
    operator of `shard_ops` keeps the placement it was made with; any
    other operator goes whole to the home device (the JAX layout
    replicates it).  Every vector goes to the home device.  Returns
    (problem, state)."""
    from .shard_ops import RowShardedOp, TwoDShardedOp

    home = mesh.home
    k_op = problem.k_op
    if isinstance(k_op, DenseMatrix):
        devices, processes = mesh.grid(row_axis)
        if processes is not None:
            raise ValueError("a dense operator is split in one process; "
                             "in a job of several processes build it "
                             "with shard_ops.make_row_sharded")
        bounds = _bounds(k_op.a.shape[0], len(devices))
        shards = [DenseMatrix(k_op.a[a:b].to(dev))
                  for (a, b), dev in zip(bounds, devices)]
        k_op = RowShardedOp(shards, list(devices), bounds, k_op.shape,
                            home)
    elif not isinstance(k_op, (RowShardedOp, TwoDShardedOp)):
        k_op = _place(k_op, home)
    problem, state = _place_vectors(problem._replace(k_op=k_op), state,
                                    home)
    return problem, state


def shard_pdhg_2d(problem, state, mesh: Mesh, row_axis: str = ROW_AXIS,
                  col_axis: str = COL_AXIS, mat=None, fmt: str = "ell"):
    """2-D block layout: K is partitioned into (rows x cols) tiles, tile
    (i, j) on the mesh's device (i, j) (`shard_ops.TwoDShardedOp`):

    - K x  -> each tile's local product, summed over the tiles of its
      row block;
    - K' y -> each tile's local transpose product, summed over the tiles
      of its column block.

    A dense K is tiled in place; a sparse operator is rebuilt per tile
    from the scipy matrix it came from, padded to the problem's shape
    (pass it as `mat`).  Every vector goes to the home device."""
    from .shard_ops import TwoDShardedOp, make_2d_sharded

    k_op = problem.k_op
    if isinstance(k_op, DenseMatrix):
        devices, processes = mesh.grid(row_axis, col_axis)
        if processes is not None:
            raise ValueError("the 2-D layout runs in one process")
        r, c = devices.shape
        rows = _bounds(k_op.a.shape[0], r)
        cols = _bounds(k_op.a.shape[1], c)
        tiles = [[DenseMatrix(k_op.a[ra:rb, ca:cb].to(devices[i, j]))
                  for j, (ca, cb) in enumerate(cols)]
                 for i, (ra, rb) in enumerate(rows)]
        k_op = TwoDShardedOp(tiles, devices, rows, cols, k_op.shape,
                             mesh.home)
    elif mat is not None:
        k_op, m2, n2 = make_2d_sharded(mat, mesh, row_axis, col_axis,
                                       fmt=fmt, dtype=problem.b.dtype)
        if (m2, n2) != (len(problem.b), len(problem.c)):
            raise ValueError(
                f"2D tiling changed the padded shape: {(m2, n2)} vs "
                f"{(len(problem.b), len(problem.c))}; pad the input "
                f"to multiples of 128*mesh dims first")
    else:
        raise ValueError(
            "2D block sharding of a sparse operator needs the scipy "
            "matrix via mat=; only DenseMatrix shards in place")
    return _place_vectors(problem._replace(k_op=k_op), state, mesh.home)
