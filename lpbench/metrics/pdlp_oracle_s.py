"""pdlp_oracle_s: the seconds a solve of the refinement's f64 host
oracle (every KKT measure of the iterate, between the rounds and inside
them, and the shifted data of each round): the program's span
"highs.pdlp.oracle" over the traced window, divided by the solves that
PDLP answered."""

from lpbench import spans


def read(run):
    return spans.per_call(run, ["pdlp.oracle"], spans.pdlp_solves(run))
