"""The program's own spans in the traced run, read by name.

The port opens a `torch.profiler.record_function` span named
"highs.<clock>" around each of its named clocks while a profiler runs
(`highs_tpu_torch/utils/timer.py`), so the trace holds every span of
every traced call by name (`Trace.host_time`). A metric sums a span
over the traced window and divides by the solves (or calls) that took
the span's route. Where the trace holds no span of the program at all,
as with a program that opens none, it reads nothing.
"""
from __future__ import annotations

PREFIX = "highs."


def seconds(run, name: str):
    """The seconds of the program's span `name` ("pdlp.setup" for
    "highs.pdlp.setup") summed over the traced calls, or None where the
    trace holds none."""
    if run.trace is None:
        return None
    sec, count = run.trace.host_time(PREFIX + name)
    return sec if count else None


def pdlp_solves(run) -> list:
    """The facade calls whose solve PDLP answered."""
    return [c for c in run.calls if "info" in c["api"]
            and c["api"]["info"].pdlp_iteration_count > 0]


def ipm_solves(run) -> list:
    """The facade calls whose solve the IPM answered."""
    return [c for c in run.calls if "info" in c["api"]
            and c["api"]["info"].ipm_iteration_count > 0]


def batch_calls(run) -> list:
    """The calls of `solve_lp_batch` that returned results."""
    return [c for c in run.calls if c["api"].get("results")]


def opened(run) -> bool:
    """Whether the traced calls hold any span of the program."""
    return run.trace is not None and any(
        name.startswith(PREFIX) for name in run.trace.host)


def per_call(run, names, calls):
    """The seconds of the spans `names` summed over the traced window
    (a span that did not run counts 0, as the refinement's oracle where
    the solve needs no refinement), divided by the number of `calls`:
    None where there is no call or the program opened no span."""
    if not calls or not opened(run):
        return None
    return sum(seconds(run, n) or 0.0 for n in names) / len(calls)
