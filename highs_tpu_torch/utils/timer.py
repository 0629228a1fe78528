"""Named-clock timer registry.

Equivalent of the reference HighsTimer (highs/util/HighsTimer.h): a
registry of named clocks with start/stop/read/num-calls, nesting-safe,
plus a report table like the per-layer clock sets (SimplexTimer,
FactorTimer, MipTimer, HiPdlpTimer).  These clocks time the host-visible
phases (presolve, solve dispatch, postsolve, IO) the way the reference's
named clocks do; a solver may add its own phase times to them (the IPM's
Newton phases, timed on the device by CUDA events).

While a torch profiler runs, each scope is also a
`torch.profiler.record_function` span named "highs.<clock>", on the
profiler's clock, around the same interval; `span` gives the same span
where there is no registry (the batch, `passModel`).  With no profiler
running, a scope tests one flag and reads the host clock twice.  Plain
counters (`count`, `counter`) sit beside the clocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "highs."


@dataclasses.dataclass
class _Clock:
    name: str
    total: float = 0.0
    num_calls: int = 0
    _start: Optional[float] = None

    @property
    def running(self) -> bool:
        return self._start is not None


class HighsTimer:
    """Named clock registry (reference util/HighsTimer.h)."""

    def __init__(self):
        self._clocks: Dict[str, _Clock] = {}
        self._counts: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    # -- whole-run wall clock --------------------------------------------
    def reset(self):
        self._clocks.clear()
        self._counts.clear()
        self._t0 = time.perf_counter()

    def read_run_highs_clock(self) -> float:
        return time.perf_counter() - self._t0

    # -- named clocks ------------------------------------------------------
    def clock_def(self, name: str) -> str:
        """Define (or fetch) a clock; returns its name as the handle."""
        if name not in self._clocks:
            self._clocks[name] = _Clock(name)
        return name

    def start(self, name: str):
        c = self._clocks.setdefault(name, _Clock(name))
        if c._start is None:
            c._start = time.perf_counter()

    def stop(self, name: str, calls: int = 1):
        c = self._clocks.get(name)
        if c is None or c._start is None:
            return
        c.total += time.perf_counter() - c._start
        c.num_calls += calls
        c._start = None

    def add(self, name: str, seconds: float, calls: int = 1):
        """Add time measured elsewhere (a solver's own phase clocks,
        device events among them) to a clock."""
        c = self._clocks.setdefault(name, _Clock(name))
        c.total += seconds
        c.num_calls += calls

    def read(self, name: str) -> float:
        c = self._clocks.get(name)
        if c is None:
            return 0.0
        t = c.total
        if c._start is not None:
            t += time.perf_counter() - c._start
        return t

    def num_calls(self, name: str) -> int:
        c = self._clocks.get(name)
        return c.num_calls if c else 0

    def scope(self, name: str) -> "Scope":
        """Context-manager clock: `with timer.scope('presolve'): ...`"""
        return Scope(self, name)

    # -- counters ----------------------------------------------------------
    def count(self, name: str, n: int = 1):
        self._counts[name] = self._counts.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counts.get(name, 0)

    # -- reporting (reference: reportClockList-style table) ----------------
    def report(self, min_fraction: float = 0.0,
               prefix: str = "") -> List[str]:
        """Render a clock table, then the counters; rows below
        min_fraction of total are dropped (like the reference's
        tolerance-per-percent report).  With `prefix`, only the clocks
        and counters whose names start with it, and no total."""
        total = self.read_run_highs_clock()
        lines = [f"{'Clock':<32}{'Calls':>8}{'Time(s)':>12}{'%':>7}"]
        for c in sorted(self._clocks.values(), key=lambda c: -c.total):
            frac = c.total / total if total > 0 else 0.0
            if frac < min_fraction or not c.name.startswith(prefix):
                continue
            lines.append(f"{c.name:<32}{c.num_calls:>8}"
                         f"{c.total:>12.4f}{100.0 * frac:>6.1f}%")
        if not prefix:
            lines.append(f"{'run':<32}{'':>8}{total:>12.4f}{100.0:>6.1f}%")
        counts = sorted(k for k in self._counts if k.startswith(prefix))
        if counts:
            lines.append(f"{'Counter':<32}{'Count':>8}")
            lines += [f"{k:<32}{self._counts[k]:>8}" for k in counts]
        return lines


class Scope:
    """One clock of a registry (or none) over a `with` block, and the
    span "highs.<name>" around it while a torch profiler runs.  `calls`,
    set inside the block, is what the clock counts for it (default 1)."""

    __slots__ = ("_timer", "_name", "_span", "calls")

    def __init__(self, timer: Optional[HighsTimer], name: str):
        self._timer = timer
        self._name = name
        self._span = None
        self.calls = 1

    def __enter__(self):
        # the profiler's own flag: a `record_function` costs microseconds
        # even with no profiler running
        if _autograd_profiler._is_profiler_enabled:
            self._span = torch.profiler.record_function(
                SPAN_PREFIX + self._name)
            self._span.__enter__()
        if self._timer is not None:
            self._timer.start(self._name)
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.stop(self._name, self.calls)
        if self._span is not None:
            # a bare `scope.__exit__()` closes the span too
            self._span.__exit__(*(exc or (None, None, None)))
            self._span = None
        return False


def span(timer: Optional[HighsTimer], name: str) -> Scope:
    """`timer.scope(name)`, or the span alone where `timer` is None."""
    return Scope(timer, name)
