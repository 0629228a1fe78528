"""ipm_normal_ms: the IPM's wall ms an iteration assembling the normal
matrix M on the host (`_host_normal`: K Theta K' + D with scipy): the
program's span "highs.ipm.normal" over the traced window, divided by
the iterations of the solves that the IPM answered
(`getInfo().ipm_iteration_count`). The span exists on the routes that
assemble M on the host ("ldl", "dense_m"); None where the trace holds
none."""

from lpbench import spans


def read(run):
    seconds = spans.seconds(run, "ipm.normal")
    iterations = sum(c["api"]["info"].ipm_iteration_count
                     for c in spans.ipm_solves(run))
    if seconds is None or iterations <= 0:
        return None
    return 1e3 * seconds / iterations
