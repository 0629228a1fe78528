"""pdlp_setup_s: the PDLP wrapper's set-up seconds a solve (standard
form, scaling, padding, the operator built and uploaded:
`pdlp_problem`): the program's span "highs.pdlp.setup" over the traced
window, divided by the solves that PDLP answered."""

from lpbench import spans


def read(run):
    return spans.per_call(run, ["pdlp.setup"], spans.pdlp_solves(run))
