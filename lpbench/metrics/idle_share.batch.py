"""idle_share.batch: the share of the batch calls' wall time in which no
kernel, copy or set ran on the device, in %, from the profiler's trace
over every call of the traced window."""


def read(run):
    return None if run.trace is None else run.trace.idle_percent()
