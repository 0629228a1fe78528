"""ipm_prepare_s: the IPM's seconds a solve from the LP to the uploaded
problem (standard form, the route, the dense copy of K and its
geometric scaling, the upload): the program's span "highs.ipm.prepare"
over the traced window, divided by the solves that the IPM answered."""

from lpbench import spans


def read(run):
    return spans.per_call(run, ["ipm.prepare"], spans.ipm_solves(run))
