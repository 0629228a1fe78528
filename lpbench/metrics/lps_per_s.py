"""lps_per_s: the LPs answered in the window over its timed total (a
batch call counts as its LPs)."""


def read(run):
    if not run.calls or run.timed_s <= 0:
        return None
    return run.lps / run.timed_s
