"""ipm_start_s: the IPM's seconds a solve in its starting point (its
factor, and the first host reads that wait for it): the program's span
"highs.ipm.start" over the traced window, divided by the solves that the
IPM answered."""

from lpbench import spans


def read(run):
    return spans.per_call(run, ["ipm.start"], spans.ipm_solves(run))
