"""The device trace of the traced run, reduced solve by solve.

Each timed call runs under its own `torch.profiler` profile (host and
CUDA activity), inside a span named by the benchmark ("passModel",
"run", "batch_call"). When the profile stops, its raw events are read
once and reduced to what the per-layer metrics need, then dropped: no
trace is kept or written, however many steps a solve takes.

- busy: the union of the device's kernel, copy and set intervals that
  lie inside the call's spans;
- kernels: device seconds and launches by kernel name;
- idle gaps: the stretches of the spans in which no device operation
  ran, labelled by the benchmark's span and the innermost host event
  (a torch op, a CUDA runtime call) that was running at the gap's
  middle, summed by label;
- host events: seconds and count by name of every host event (each
  `record_function` span of the program, each torch op, each CUDA
  runtime call), so that a metric can read a span by its name.
"""
from __future__ import annotations

import bisect
import collections
import contextlib

SPAN_PREFIX = "lpbench."


def union_length(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: int, end: int):
    """The stretches of [start, end] that no interval covers."""
    out = []
    cur = start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def innermost(host, starts, t: int):
    """The name of the latest-starting host event in `host` (sorted by
    start, `starts` their starts) that covers t, or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4097), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return None


class Trace:
    """What the traced calls of a run add up to."""

    def __init__(self):
        self.window_ns = 0
        self.busy_ns = 0
        self.kernels = collections.defaultdict(lambda: [0, 0])
        self.idle = collections.Counter()
        self.host = collections.defaultdict(lambda: [0, 0])

    def add(self, device, host, spans):
        """Fold one call in: `device` (start, end, name) of the device's
        operations, `host` (start, end, name) of the host's events,
        `spans` (start, end, name) of the benchmark's own spans (all in
        the profiler's ns)."""
        host = sorted(host)
        starts = [h[0] for h in host]
        for s, e, name in host:
            h = self.host[name]
            h[0] += e - s
            h[1] += 1
        for s0, e0, span in spans:
            inside = [(max(s, s0), min(e, e0)) for s, e, _ in device
                      if e > s0 and s < e0]
            self.window_ns += e0 - s0
            self.busy_ns += union_length(inside)
            for gs, ge in gaps(inside, s0, e0):
                op = innermost(host, starts, (gs + ge) // 2)
                label = span if op is None or op == SPAN_PREFIX + span \
                    else f"{span}: {op}"
                self.idle[label] += ge - gs
        for s, e, name in device:
            k = self.kernels[name]
            k[0] += e - s
            k[1] += 1

    def host_time(self, name: str):
        """(seconds, count) of the host events named `name`, summed over
        the traced calls: (0.0, 0) where none ran."""
        ns, count = self.host.get(name, (0, 0))
        return ns * 1e-9, count

    def kernel_time(self, part: str, itemsize: int):
        """(device seconds, launches) of the kernels whose name holds
        `part` and that compute in `itemsize`-byte floats (read from the
        name)."""
        sec, n = 0.0, 0
        for name, (ns, count) in self.kernels.items():
            if part in name and float_bytes(name) == itemsize:
                sec += ns * 1e-9
                n += count
        return sec, n

    def idle_percent(self):
        """The share of the traced window with no device operation, in %
        (None where the trace holds no device operation)."""
        if self.window_ns <= 0 or not self.kernels:
            return None
        return 100.0 * (1.0 - self.busy_ns / self.window_ns)

    def breakdown(self) -> dict:
        """The ten longest device operations and idle gaps, in s."""
        ops = sorted(((name[:160], ns * 1e-9) for name, (ns, _) in
                      self.kernels.items()), key=lambda kv: -kv[1])[:10]
        idle = sorted(((k[:160], ns * 1e-9) for k, ns in self.idle.items()),
                      key=lambda kv: -kv[1])[:10]
        return {"device_ops": [list(kv) for kv in ops],
                "idle_gaps": [list(kv) for kv in idle]}


def float_bytes(kernel_name: str):
    """The float width a kernel computes in, from its (demangled,
    templated) name: 8 for double, 4 for float, else None."""
    if "double" in kernel_name:
        return 8
    if "float" in kernel_name:
        return 4
    return None


def read_events(prof):
    """(device, host, spans) of a stopped profile, each a list of
    (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType
    device, host, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # a span shows on the device too, from its first kernel to
            # its last: a label, not work
            if not (ev.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                device.append((s, e, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((s, e, name[len(SPAN_PREFIX):]))
            host.append((s, e, name))
        else:
            host.append((s, e, name))
    return device, host, spans


@contextlib.contextmanager
def traced(trace: Trace, enabled: bool):
    """Run the body under a profile folded into `trace` when
    `enabled`; otherwise run it alone."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    trace.add(*read_events(prof))


def span(name: str):
    """A benchmark span around a part of a call (shows in the trace)."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)
