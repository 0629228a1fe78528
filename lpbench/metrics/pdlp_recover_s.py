"""pdlp_recover_s: the PDLP wrapper's recovery seconds a solve (the
inverse permutation, `recover_solution`, the row values): the
program's span "highs.pdlp.recover" over the traced window, divided by
the solves that PDLP answered."""

from lpbench import spans


def read(run):
    return spans.per_call(run, ["pdlp.recover"], spans.pdlp_solves(run))
