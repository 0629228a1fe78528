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

`signed_dot` is the kernel's signed mode, for presolve's activity
bounds (`presolve/device.py`): a row's sums of its positive and of its
negative entries times two vectors, in CSR order, as scipy's
`csr_matvec` adds the products of max(A, 0) and min(A, 0);
`signed_dot_plain` is its plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# launches of the CUDA kernel in this process: the sum mode's
# (`segment_sum`) and the signed mode's (`signed_dot`)
LAUNCHES = 0
SIGNED_LAUNCHES = 0

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


def signed_dot_plain(values: torch.Tensor, cols: torch.Tensor,
                     ptr: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """The signed mode's function in plain PyTorch.  The segments are
    walked longest first, so the k-th terms of the segments that have k
    terms are a prefix, each product rounded before it is added; a
    term that the kernel skips is added here as +0 or -0, which leaves
    the sum as it was."""
    nseg = ptr.shape[0] - 1
    out = torch.zeros((nseg, 4), dtype=values.dtype, device=values.device)
    if nseg == 0 or values.shape[0] == 0:
        return out.T.contiguous()
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    pos, neg = values > 0, values < 0
    a, b = x1[cols], x2[cols]
    terms = torch.stack([torch.where(pos, values * a, zero),
                         torch.where(neg, values * b, zero),
                         torch.where(pos, values * b, zero),
                         torch.where(neg, values * a, zero)], 1)
    lengths = ptr.diff()
    order = torch.argsort(lengths, descending=True, stable=True)
    start = ptr[:-1][order]
    # live[k]: how many segments have more than k terms
    live = torch.bincount(lengths, minlength=int(lengths.max()) + 1)
    live = (nseg - torch.cumsum(live, 0)).tolist()
    acc = torch.zeros_like(out)
    for k, count in enumerate(live):
        if count == 0:
            break
        acc[:count] += terms[start[:count] + k]
    out[order] = acc
    return out.T.contiguous()


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("segment_sum")
        ptr = ctypes.c_void_p
        lib.segment_sum_f64.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                        ctypes.c_int, ptr, ptr]
        lib.segment_sum_f64.restype = ctypes.c_int
        lib.segment_signed_dot_f64.argtypes = [
            ptr, ptr, ptr, ctypes.c_longlong, ptr, ptr, ptr, ptr]
        lib.segment_signed_dot_f64.restype = ctypes.c_int
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


def signed_dot(values: torch.Tensor, cols: torch.Tensor, ptr: torch.Tensor,
               x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """A (4, nseg) tensor: for segment s, the sums of v * x1[j] over its
    entries (v, j) with v > 0, of v * x2[j] over v < 0, of v * x2[j] over
    v > 0 and of v * x1[j] over v < 0, each in segment order.  So for a
    CSR row and finite x1 = l, x2 = u, rows 0 + 1 and 2 + 3 are the
    least and the most activity that scipy's `max(A, 0) @ l + min(A, 0)
    @ u` and `max(A, 0) @ u + min(A, 0) @ l` give, bit for bit.  f64
    values and vectors, int32 column indices, an int64 `ptr`, all
    contiguous and on one device; a CUDA tensor launches the kernel, a
    CPU tensor takes the plain version."""
    global SIGNED_LAUNCHES
    for name, t, dtype in (("values", values, torch.float64),
                           ("cols", cols, torch.int32),
                           ("ptr", ptr, torch.int64),
                           ("x1", x1, torch.float64),
                           ("x2", x2, torch.float64)):
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-d {dtype} tensor, not "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, the values on "
                             f"{values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cols.shape[0] != values.shape[0] or ptr.shape[0] < 1 or \
            x1.shape[0] != x2.shape[0]:
        raise ValueError("cols must match the values, ptr hold at least "
                         "one entry and x1 match x2")
    if values.device.type == "cpu":
        return signed_dot_plain(values, cols, ptr, x1, x2)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device "
                         f"{values.device}")
    nseg = ptr.shape[0] - 1
    out = torch.empty((4, nseg), dtype=values.dtype, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = _lib().segment_signed_dot_f64(
            values.data_ptr(), cols.data_ptr(), ptr.data_ptr(), nseg,
            x1.data_ptr(), x2.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_signed_dot launch failed: CUDA error "
                           f"{rc}")
    SIGNED_LAUNCHES += 1
    return out
