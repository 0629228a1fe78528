"""Segment sums in a fixed order: the rows' or the columns' sums of |a|
or a * a over a CSR's values, each segment's terms added one after
another, as numpy's `np.bincount(ids, weights)` adds them.

The PDLP scaling (`solvers/pdlp/scaling.py` `scale_problem`) must give
the bits of the JAX package's numpy scaling, and a sum's bits
depend on its order, so the sums are taken in the host's order: a row's
terms in CSR order, a column's in the order of a stable permutation of
the entries by column.  The kernel, `csrc/segment_sum.cu`, sums each
segment in one thread with every product and sum rounded by itself (see
the source for the design).  `segment_sum_plain` computes the same
function, in the same order, with plain PyTorch operations; the scaling
runs it on the CPU, and the chip smoke test holds the kernel against it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# launches of the CUDA kernel in this process
LAUNCHES = 0

_LIB = None


def segment_sum_plain(values: torch.Tensor, ptr: torch.Tensor,
                      order: Optional[torch.Tensor] = None,
                      square: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the k-th terms of every
    segment are added in step k, so each segment's sum runs over its
    terms in order."""
    terms = values * values if square else values.abs()
    if order is not None:
        terms = terms[order]
    start, end = ptr[:-1], ptr[1:]
    acc = torch.zeros(start.shape[0], dtype=values.dtype,
                      device=values.device)
    longest = int((end - start).max()) if start.shape[0] else 0
    last = max(terms.shape[0] - 1, 0)
    for k in range(longest):
        idx = start + k
        live = idx < end
        acc = torch.where(live, acc + terms[idx.clamp(max=last)], acc)
    return acc


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("segment_sum")
        ptr = ctypes.c_void_p
        lib.segment_sum_f64.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                        ctypes.c_int, ptr, ptr]
        lib.segment_sum_f64.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _segment_sum_cuda(values, ptr, order, square):
    global LAUNCHES
    lib = _lib()
    nseg = ptr.shape[0] - 1
    out = torch.empty(nseg, dtype=values.dtype, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.segment_sum_f64(
            values.data_ptr(), None if order is None else order.data_ptr(),
            ptr.data_ptr(), nseg, int(square), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def segment_sum(values: torch.Tensor, ptr: torch.Tensor,
                order: Optional[torch.Tensor] = None,
                square: bool = False) -> torch.Tensor:
    """out[s] = the sum of values[i] ** 2 (`square`) or |values[i]| for i
    over segment s, in order: i = ptr[s], ..., ptr[s + 1] - 1, or
    order[i] for those i.  f64 values, int64 `ptr` and `order`, all
    contiguous and on one device.  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    if values.dtype != torch.float64:
        raise TypeError(f"segment sums take float64 values, not "
                        f"{values.dtype}")
    for name, t in (("ptr", ptr), ("order", order)):
        if t is None:
            continue
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-d int64 tensor, not "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, the values on "
                             f"{values.device}")
    if values.dim() != 1 or ptr.shape[0] < 1:
        raise ValueError("values must be 1-d and ptr hold at least one "
                         "entry")
    if order is not None and order.shape[0] != values.shape[0]:
        raise ValueError(f"order has {order.shape[0]} entries for "
                         f"{values.shape[0]} values")
    if not all(t.is_contiguous() for t in (values, ptr, order)
               if t is not None):
        raise ValueError("values, ptr and order must be contiguous")
    if values.device.type == "cpu":
        return segment_sum_plain(values, ptr, order, square)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device "
                         f"{values.device}")
    return _segment_sum_cuda(values, ptr, order, square)
