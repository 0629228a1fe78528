"""The card's identity, its published peaks, and timing on it.

Shared by `chip_smoke.py` and the tools of this folder.  The peaks are
NVIDIA's data sheet figures for one H100 SXM at its full 700 W limit:
a card set to a lower limit runs slower under load, so every time
measured here is reported beside `card_line()`.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

# HBM3 rate and the non-tensor-core FMA rates of the two types the
# kernels take
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# the FP64 tensor-core rate, which float64 matrix products (DGEMM) reach
FP64_TENSOR_FLOPS = 67e12
# the inputs and outputs a timing cycles through: four times the
# H100's 50 MB L2, in at most MAX_COPIES clones of the inputs
COLD_BYTES = 200 << 20
MAX_COPIES = 512
MIN_CALLS = 20


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, device, runs: int = 25, warmup: int = 3) -> float:
    """Median time of one call of `fn` in ms, CUDA events around each of
    `runs` calls after `warmup` calls: the host's launch gaps count, as
    they do in a loop that calls `fn` (host clock on the CPU, for
    rehearsals only)."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _nbytes(obj) -> int:
    """Bytes of the tensors in `obj` (a tensor, a sparse CSR or BSR
    tensor, or a tuple of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.layout in (torch.sparse_csr, torch.sparse_bsr):
            return sum(_nbytes(t) for t in (
                obj.crow_indices(), obj.col_indices(), obj.values()))
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return 0


def _clone(obj):
    """A copy of `obj` with every tensor in it cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_clone(o) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(o) for o in obj)
    return obj


def time_ms(fn, device, *inputs, runs: int = 25, warmup: int = 3) -> float:
    """Device time of one call `fn(*inputs)` in ms, with a cold L2 as
    the PDLP loop finds it (its operator does not stay in the L2 from
    one product to the next).  At least MIN_CALLS calls are captured in
    one CUDA graph, cycling through enough clones of `inputs` that
    their inputs and outputs fill COLD_BYTES, four times the 50 MB L2;
    every output is kept, so each call writes fresh memory.  The time
    is the median of `runs` timed replays over the calls in one: the
    host's launch gaps drop out, and the write-back of the outputs is
    paid inside the replays.  `fn` must be capturable (no host reads
    of device values).  Host clock on the CPU, for rehearsals only."""
    if torch.device(device).type != "cuda":
        return call_ms(lambda: fn(*inputs), device, runs, warmup)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(warmup):
            out = fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    footprint = max(1, _nbytes(inputs) + _nbytes(out))
    copies = min(MAX_COPIES, -(-COLD_BYTES // footprint))
    sets = [inputs] + [_clone(inputs) for _ in range(copies - 1)]
    n = copies * -(-MIN_CALLS // copies)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*sets[k % copies]) for k in range(n)]
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs) / n
    del graph, outs, sets
    return ms


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
