"""solve_s: the summed time of the window's calls over their number, for
cells of one LP a call: the time to optimal per LP (host clock from
`passModel` to the end of `run()` and a device synchronize)."""


def read(run):
    if not run.calls or any(c["count"] != 1 for c in run.calls):
        return None
    return run.timed_s / len(run.calls)
