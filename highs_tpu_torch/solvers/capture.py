"""Capture steps for work kept on one CUDA card as replayed CUDA graphs.

Two runners capture device work and replay it: the PDHG blocks
(`pdlp/graph.py`, the single and the batched LP solve) and the MIP's
batched node-LP rounds (`mip/batch_nodes.py`).  Both take the capture
step as an argument:

- `cuda_graph` on a card: one warm-up call, then one captured
  `torch.cuda.CUDAGraph`;
- `eager_recorder` in the CPU tests, which replays by running the
  captured function again and copying what it returns into the tensors
  its first call returned, as a replayed graph refreshes its static
  outputs.

The port's counters of device work (the kernels' launch counters,
`shard_ops.REDUCTIONS` and the IPM's `DENSE_FACTORS`) are Python
integers that a wrapper bumps when it runs, which under a graph is only
at capture.  `counted_capture` records one run's increments and leaves
the counters as it found them; `counted_replay` adds them on every
replay, so the counters stay true.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops import block_csr, onehot_spmv, pdhg_step
from ..parallel import shard_ops
from .ipm import solver as ipm_solver


def read_counts() -> dict:
    """The launch counters of the kernels, the shard reductions and the
    IPM's dense factors by device, by name."""
    return {"block_csr_spmv": block_csr.LAUNCHES,
            "onehot_spmv": onehot_spmv.LAUNCHES["onehot_spmv"],
            **pdhg_step.LAUNCHES,
            "shard_reductions": shard_ops.REDUCTIONS,
            **{"dense_factors_" + d: n
               for d, n in ipm_solver.DENSE_FACTORS.items()}}


def write_counts(counts: dict) -> None:
    block_csr.LAUNCHES = counts["block_csr_spmv"]
    onehot_spmv.LAUNCHES["onehot_spmv"] = counts["onehot_spmv"]
    for name in pdhg_step.LAUNCHES:
        pdhg_step.LAUNCHES[name] = counts[name]
    shard_ops.REDUCTIONS = counts["shard_reductions"]
    for d in ipm_solver.DENSE_FACTORS:
        ipm_solver.DENSE_FACTORS[d] = counts["dense_factors_" + d]


def cuda_graph(fn: Callable):
    """Capture step on a card: one warm-up call of `fn` on a side stream
    (cuBLAS sets up its workspace, the kernels' libraries load), then
    `fn` captured as one CUDA graph.  Returns (replay, outputs): each
    replay runs the captured work and refreshes `outputs` in place."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # another thread's CUDA calls (a MIP's heuristics) do not void it
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = fn()
    return graph.replay, outputs


def _copy_tree(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_tree(d, s)


def eager_recorder(fn: Callable):
    """Capture step for a run without a card: the first call of `fn`
    gives the outputs; a replay calls `fn` again and copies what it
    returns into them.  As a replayed graph runs no Python, a replay
    leaves the counters as it found them."""
    outputs = fn()

    def replay():
        counts = read_counts()
        _copy_tree(outputs, fn())
        write_counts(counts)
    return replay, outputs


def counted_capture(capture: Callable, fn: Callable):
    """`capture(fn)` with the counters left as they were before it (a
    warm-up or a recorder's first call runs the work): returns (replay,
    outputs, counts), where counts are one run's increments."""
    before = read_counts()
    one_run = {}

    def counted():
        start = read_counts()
        out = fn()
        one_run.clear()
        one_run.update({k: v - start[k] for k, v in read_counts().items()})
        return out
    replay, outputs = capture(counted)
    write_counts(before)
    return replay, outputs, dict(one_run)


def counted_replay(replay: Callable, counts: dict) -> None:
    """One replay, and the counters raised by one run of its work."""
    start = read_counts()
    replay()
    write_counts({k: v + counts.get(k, 0) for k, v in start.items()})
