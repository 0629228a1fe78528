"""ipm_factor_ms: the IPM's wall ms an iteration in the factor of M:
the engine's choice and its factor (the banded f32 Cholesky on the card
with its probe, SuperLU, the native LDL', or the dense Cholesky of the
"dense_m" route): the program's span "highs.ipm.factor" over the traced
window, divided by the iterations of the solves that the IPM answered
(`getInfo().ipm_iteration_count`). The span exists on the routes that
assemble M on the host ("ldl", "dense_m"); None where the trace holds
none."""

from lpbench import spans


def read(run):
    seconds = spans.seconds(run, "ipm.factor")
    iterations = sum(c["api"]["info"].ipm_iteration_count
                     for c in spans.ipm_solves(run))
    if seconds is None or iterations <= 0:
        return None
    return 1e3 * seconds / iterations
