"""The PDHG inner block kept on one CUDA card, as replayed CUDA graphs.

The JAX package runs each inner block of PDHG steps as ONE jitted
program that stays on the device (`highs_tpu/solvers/pdlp/pdhg.py:7-10`,
`_pdhg_windows_impl` :265-336, `pdhg_block` :418-432, `pdhg_block_avg`
:467-476), the TPU counterpart of the reference's CUDA-graph capture of
the same block (pdhg.cc:610-632).  PyTorch issues every operation from
the host, so `solve_pdhg` hands its blocks to one of two runners with
the same methods:

- `GraphBlocks` captures, each as one `torch.cuda.CUDAGraph` over
  static buffers that hold the state (and the restart control), one
  restart window (`pdhg.restart_window`), one chunk of `chunk` Halpern
  or average-mode steps, and the metrics (`_compute_metrics`, or the
  average mode's pair).  The window and metrics functions are the
  runner's arguments: the batched LP solve (`batch.py`) passes its
  vmapped window and metrics, so that the buffers hold the stacked
  (b, ...) state and (b,) restart control, and each of its blocks is
  replays too.  Each graph copies its new state into the
  buffers, so replays chain: a ramped block is n replays of the window
  (or chunk) graph and one of the metrics graph.  There is one graph
  per (kind, gamma, step operator, steps); a change of gamma or of the
  step operator captures anew and drops the graphs it replaces.
  Where the host replaced a field of the state between blocks (a new
  step size, a restart, the bf16 exit, a resumed checkpoint), the
  next block copies the new value into the buffers first.
- `EagerBlocks` issues the same functions op by op: the CPU, and a mesh
  whose shards sit on distinct cards (or in several processes).

The launch counters of the kernels (`block_csr.LAUNCHES`,
`onehot_spmv.LAUNCHES`, `pdhg_step.LAUNCHES`) and `shard_ops.REDUCTIONS`
are Python integers that a wrapper bumps when it runs, which under a
graph is only at capture.  The runner records each graph's counts at
capture and adds them on every replay, so the counters stay true.

The capture step is the runner's constructor argument: `cuda_graph` on
the card, `eager_recorder` in the CPU tests (`solvers/capture.py`,
which the MIP's batched node rounds share with this runner).
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...parallel import shard_ops
from ...utils.timer import span
from ..capture import counted_capture, counted_replay, cuda_graph
from .pdhg import (PdhgProblem, PdhgState, RestartCtl, _compute_metrics,
                   avg_metrics, avg_steps, halpern_steps, pdhg_block,
                   pdhg_block_avg, restart_window)

# graphs captured and replayed in this process; "metrics" counts the
# replays of a metrics graph, one a block
COUNTS = Counter()


def _assign(dst: tuple, src: tuple) -> None:
    """Copy each field of `src` into the buffer of `dst` it is not.  A
    source may be another buffer that is not written here (a restart
    sets x and x_anchor to x_pd)."""
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


class _Graph(NamedTuple):
    replay: Callable
    outputs: object
    counts: dict  # counter increments of one run of the captured work
    fn: Callable  # keeps what the graph reads (problem, theta, step op)


def _walk(obj):
    """The tensors, devices and operator objects inside `obj`."""
    if isinstance(obj, (torch.Tensor, torch.device)):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _walk(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _walk(o)
    elif isinstance(obj, np.ndarray) and obj.dtype == object:
        for o in obj.flat:
            yield from _walk(o)
    elif hasattr(obj, "__dict__") and not callable(obj):
        yield obj
        yield from _walk(vars(obj))


def _card(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def on_one_card(problem: PdhgProblem, device: torch.device) -> bool:
    """True where the loop runs on a CUDA card and every tensor of the
    problem, the operator's shards included, is on that card, in one
    process: the case the graphs take."""
    if device.type != "cuda":
        return False
    home = _card(device)
    for item in _walk(problem):
        if isinstance(item, torch.Tensor):
            if _card(item.device) != home:
                return False
        elif isinstance(item, torch.device):
            if _card(item) != home:
                return False
        elif getattr(item, "reduce", None) is shard_ops.all_reduce_partials:
            return False
    return True


class EagerBlocks:
    """The device blocks issued op by op.  `window(problem, state, ctl,
    gamma, interval, theta, step_op)` and `metrics(problem, state)` are
    the functions a Halpern block is made of."""

    def __init__(self, problem: PdhgProblem,
                 window: Callable = restart_window,
                 metrics: Callable = _compute_metrics):
        self.problem = problem
        self.window = window
        self.metrics = metrics

    def windows(self, state, ctl, n_windows, gamma, interval, theta,
                step_op):
        """n_windows windows, then the metrics: (state, ctl, metrics) as
        `pdhg_block_windows`."""
        for _ in range(n_windows):
            state, ctl = self.window(self.problem, state, ctl, gamma,
                                     interval, theta, step_op)
        return state, ctl, self.metrics(self.problem, state)

    def block(self, state, n_steps, gamma, step_op):
        return pdhg_block(self.problem, state, n_steps, gamma, step_op)

    def block_avg(self, state, n_steps, step_op):
        return pdhg_block_avg(self.problem, state, n_steps, step_op)

    def close(self) -> None:
        pass


class GraphBlocks:
    """The device blocks as replays of captured graphs (module doc).

    The methods take and return what `EagerBlocks`' do, and `window` and
    `metrics` are its functions; the state (and restart control) they
    return are the runner's buffers, which the next replay overwrites: a
    caller that keeps a field across blocks clones it.  The graphs read
    the problem where it lies (the runner copies nothing of it)."""

    def __init__(self, problem: PdhgProblem, chunk: int,
                 capture: Callable = cuda_graph,
                 window: Callable = restart_window,
                 metrics: Callable = _compute_metrics,
                 timer=None):
        self.problem = problem
        self.chunk = max(1, int(chunk))
        self.capture = capture
        self.window = window
        self.metrics = metrics
        self.device = problem.b.device
        self.state: Optional[PdhgState] = None
        self.ctl: Optional[RestartCtl] = None
        self.graphs = {}
        self.timer = timer  # a HighsTimer for the "pdhg.capture" clock

    # --- buffers ----------------------------------------------------------
    def _load(self, state: PdhgState, ctl: Optional[RestartCtl] = None):
        if self.state is None:
            self.state = PdhgState(*(t.clone() for t in state))
        else:
            _assign(self.state, state)
        if ctl is not None:
            if self.ctl is None:
                self.ctl = RestartCtl(*(t.clone() for t in ctl))
            else:
                _assign(self.ctl, ctl)

    def _buffers(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.state) + (tuple(self.ctl) if self.ctl else ())

    # --- capture and replay -----------------------------------------------
    def _device_scope(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _graph(self, key: tuple, fn: Callable) -> _Graph:
        g = self.graphs.get(key)
        if g is not None:
            return g
        # a new gamma or step operator retires the graphs of the old one
        for old in [k for k in self.graphs
                    if k[0] == key[0] and k[1:3] != key[1:3]]:
            del self.graphs[old]
        saved = tuple(t.clone() for t in self._buffers())
        with span(self.timer, "pdhg.capture"), self._device_scope():
            replay, outputs, counts = counted_capture(self.capture, fn)
            # a warm-up (or a recorder's first call) ran the work: put
            # the state back as it was before
            for buf, val in zip(self._buffers(), saved):
                buf.copy_(val)
        g = _Graph(replay, outputs, counts, fn)
        self.graphs[key] = g
        COUNTS["captures"] += 1
        return g

    def _replay(self, g: _Graph, kind: str) -> None:
        with self._device_scope():
            counted_replay(g.replay, g.counts)
        COUNTS["replays"] += 1
        COUNTS[kind] += 1

    def _chunks(self, n_steps: int):
        q, r = divmod(n_steps, self.chunk)
        return [self.chunk] * q + ([r] if r else [])

    @staticmethod
    def _op_key(step_op):
        return None if step_op is None else id(step_op)

    # --- the blocks ---------------------------------------------------------
    def _metrics(self):
        g = self._graph(("metrics",), lambda: self.metrics(
            self.problem, self.state))
        self._replay(g, "metrics")
        return g.outputs

    def windows(self, state, ctl, n_windows, gamma, interval, theta,
                step_op):
        """n_windows replays of the window graph, then the metrics
        graph: (state, ctl, metrics) as `pdhg_block_windows`."""
        self._load(state, ctl)

        def fn():
            st, c = self.window(self.problem, self.state, self.ctl, gamma,
                                interval, theta, step_op)
            _assign(self.state, st)
            _assign(self.ctl, c)
            return ()
        g = self._graph(("window", gamma, self._op_key(step_op), interval),
                        fn)
        for _ in range(n_windows):
            self._replay(g, "window")
        return self.state, self.ctl, self._metrics()

    def block(self, state, n_steps, gamma, step_op):
        """n_steps Halpern steps as replays of `chunk`-step graphs, then
        the metrics graph: (state, metrics) as `pdhg_block`."""
        self._load(state)
        for steps in self._chunks(n_steps):
            def fn(steps=steps):
                _assign(self.state, halpern_steps(
                    self.problem, self.state, steps, gamma, step_op))
                return ()
            self._replay(self._graph(
                ("steps", gamma, self._op_key(step_op), steps), fn), "steps")
        return self.state, self._metrics()

    def block_avg(self, state, n_steps, step_op):
        """n_steps average-mode steps as replays of `chunk`-step graphs,
        then the graph of both metric sets: (state, current metrics,
        average metrics, x_avg, y_avg) as `pdhg_block_avg`."""
        self._load(state)
        for steps in self._chunks(n_steps):
            def fn(steps=steps):
                _assign(self.state, avg_steps(self.problem, self.state,
                                              steps, step_op))
                return ()
            self._replay(self._graph(
                ("avg_steps", 1.0, self._op_key(step_op), steps), fn),
                "avg_steps")
        g = self._graph(("avg_metrics",),
                        lambda: avg_metrics(self.problem, self.state))
        self._replay(g, "metrics")
        return (self.state, *g.outputs)

    def close(self) -> None:
        """Free the graphs (and their memory pools)."""
        self.graphs.clear()

