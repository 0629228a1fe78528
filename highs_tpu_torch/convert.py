"""Build this package's objects from plain numpy data.

State computed elsewhere (for example by the JAX package, whose arrays
`np.asarray` turns into numpy) comes in as dictionaries of numpy arrays
and scalars, so that both packages can compute from the same operator
and the same iterate.  Every function here puts its tensors on the
device it is given, CUDA by default (`device.resolve_device`).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .constants import MatrixFormat, ObjSense
from .device import resolve_device
from .models.lp import HighsLp, HighsSparseMatrix
from .ops.block_csr import BLOCK, BlockCsr
from .ops.linops import DenseMatrix, EllMatrix
from .solvers.ipm.solver import IpmProblem, IpmState, sparse_k
from .solvers.pdlp.pdhg import PdhgProblem, PdhgState, RestartCtl

_LP_ARRAYS = ("col_cost", "col_lower", "col_upper", "row_lower",
              "row_upper")


def lp_from_numpy(d: Mapping) -> HighsLp:
    """HighsLp from a dict holding `num_col`, `num_row`, the bound and
    cost arrays, the matrix as `a_start`/`a_index`/`a_value` (column-wise
    unless `a_format` says MatrixFormat.kRowwise), and optionally
    `sense`, `offset` and `integrality`."""
    num_col, num_row = int(d["num_col"]), int(d["num_row"])
    a = HighsSparseMatrix(
        format=MatrixFormat(int(d.get("a_format", MatrixFormat.kColwise))),
        num_col=num_col, num_row=num_row,
        start=np.array(d["a_start"], dtype=np.int64),
        index=np.array(d["a_index"], dtype=np.int64),
        value=np.array(d["a_value"], dtype=np.float64))
    return HighsLp(
        num_col=num_col, num_row=num_row,
        a_matrix=a,
        sense=ObjSense(int(d.get("sense", ObjSense.kMinimize))),
        offset=float(d.get("offset", 0.0)),
        integrality=np.array(d.get("integrality", np.zeros(0)),
                             dtype=np.uint8),
        **{k: np.array(d[k], dtype=np.float64) for k in _LP_ARRAYS})


def block_csr_from_numpy(blocks, block_row, block_col, first_in_row,
                         shape: Tuple[int, int], device=None) -> BlockCsr:
    """One block-CSR direction from its layout arrays (tiles stored
    transposed and sorted by block-row, as `block_csr_layout` makes
    them); the row pointer is derived from the sorted `block_row`."""
    device = resolve_device(device)
    block_row = np.asarray(block_row, dtype=np.int32)
    mb = int(shape[0]) // BLOCK
    if np.any(np.diff(block_row) < 0):
        raise ValueError("block_row must be sorted")
    row_ptr = np.searchsorted(block_row, np.arange(mb + 1)).astype(np.int32)

    def dev(a, dt):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    blocks = np.asarray(blocks)
    dtype = torch.float32 if blocks.dtype == np.float32 else torch.float64
    return BlockCsr(
        blocks=dev(np.ascontiguousarray(blocks), dtype),
        block_row=dev(block_row, torch.int32),
        block_col=dev(block_col, torch.int32),
        first_in_row=dev(first_in_row, torch.int32),
        row_ptr=dev(row_ptr, torch.int32),
        shape=(int(shape[0]), int(shape[1])))


def linop_from_numpy(d: Mapping, device=None):
    """A dense (`{"a": ...}`) or ELL operator (the ten EllMatrix field
    names) from numpy arrays."""
    device = resolve_device(device)
    if "a" in d:
        return DenseMatrix(torch.as_tensor(np.array(d["a"]),
                                           device=device))
    fields = {}
    for name in EllMatrix._fields:
        arr = np.array(d[name])
        dt = torch.int64 if arr.dtype.kind in "iu" else None
        fields[name] = torch.as_tensor(arr, dtype=dt, device=device)
    return EllMatrix(**fields)


def pdhg_problem_from_numpy(d: Mapping, device=None) -> PdhgProblem:
    """PdhgProblem from numpy arrays named as its fields; `d["k_op"]` is
    an operator of this package (from `linop_from_numpy`, `from_scipy`,
    or a BlockCsrMatrix of `block_csr_from_numpy` halves)."""
    device = resolve_device(device)
    def dev(a):
        return torch.as_tensor(np.array(a), device=device)
    y_lo = d.get("y_lo")
    return PdhgProblem(
        k_op=d["k_op"],
        **{name: dev(d[name]) for name in PdhgProblem._fields
           if name not in ("k_op", "y_lo")},
        y_lo=None if y_lo is None else dev(y_lo))


def pdhg_state_from_numpy(d: Mapping, device=None) -> PdhgState:
    """PdhgState from numpy arrays named as its fields (`k` int32)."""
    device = resolve_device(device)
    fields = {name: torch.as_tensor(np.array(d[name]), device=device)
              for name in PdhgState._fields}
    fields["k"] = fields["k"].to(torch.int32)
    return PdhgState(**fields)


def restart_ctl_from_numpy(d: Mapping, device=None) -> RestartCtl:
    """RestartCtl from numpy scalars named as its fields."""
    device = resolve_device(device)
    fields = {name: torch.as_tensor(np.array(d[name]), device=device)
              for name in RestartCtl._fields}
    fields["fresh"] = fields["fresh"].to(torch.bool)
    fields["total_k"] = fields["total_k"].to(torch.int32)
    fields["n_restarts"] = fields["n_restarts"].to(torch.int32)
    return RestartCtl(**fields)


def ipm_problem_from_numpy(d: Mapping, device=None) -> IpmProblem:
    """IpmProblem from f64 arrays named as its fields; a scipy sparse `a`
    becomes the sparse routes' K (`SparseK`), a dense one a tensor."""
    device = resolve_device(device)
    a = d["a"]
    if sp.issparse(a):
        a = sparse_k(a, device)
    else:
        a = torch.as_tensor(np.array(a), dtype=torch.float64, device=device)
    return IpmProblem(a=a, **{
        name: torch.as_tensor(np.array(d[name]), dtype=torch.float64,
                              device=device)
        for name in IpmProblem._fields if name != "a"})


def ipm_state_from_numpy(d: Mapping, device=None) -> IpmState:
    """IpmState from f64 arrays named as its fields."""
    device = resolve_device(device)
    return IpmState(**{
        name: torch.as_tensor(np.array(d[name]), dtype=torch.float64,
                              device=device)
        for name in IpmState._fields})
