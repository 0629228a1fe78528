"""Named-clock timer registry.

Equivalent of the reference HighsTimer (highs/util/HighsTimer.h): a
registry of named clocks with start/stop/read/num-calls, nesting-safe,
plus a report table like the per-layer clock sets (SimplexTimer,
FactorTimer, MipTimer, HiPdlpTimer).  Python-side timing only — device
kernels are profiled with the jax profiler; these clocks time the
host-visible phases (presolve, solve dispatch, postsolve, IO) the way
the reference's named clocks do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


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
        self._t0 = time.perf_counter()

    # -- whole-run wall clock --------------------------------------------
    def reset(self):
        self._clocks.clear()
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

    def stop(self, name: str):
        c = self._clocks.get(name)
        if c is None or c._start is None:
            return
        c.total += time.perf_counter() - c._start
        c.num_calls += 1
        c._start = None

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

    class _Scope:
        def __init__(self, timer: "HighsTimer", name: str):
            self._timer = timer
            self._name = name

        def __enter__(self):
            self._timer.start(self._name)
            return self

        def __exit__(self, *exc):
            self._timer.stop(self._name)
            return False

    def scope(self, name: str) -> "_Scope":
        """Context-manager clock: `with timer.scope('presolve'): ...`"""
        return HighsTimer._Scope(self, name)

    # -- reporting (reference: reportClockList-style table) ----------------
    def report(self, min_fraction: float = 0.0) -> List[str]:
        """Render a clock table; rows below min_fraction of total are
        dropped (like the reference's tolerance-per-percent report)."""
        total = self.read_run_highs_clock()
        lines = [f"{'Clock':<32}{'Calls':>8}{'Time(s)':>12}{'%':>7}"]
        for c in sorted(self._clocks.values(), key=lambda c: -c.total):
            frac = c.total / total if total > 0 else 0.0
            if frac < min_fraction:
                continue
            lines.append(f"{c.name:<32}{c.num_calls:>8}"
                         f"{c.total:>12.4f}{100.0 * frac:>6.1f}%")
        lines.append(f"{'run':<32}{'':>8}{total:>12.4f}{100.0:>6.1f}%")
        return lines
