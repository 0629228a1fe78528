"""qp_iter_ms: the QP IPM's wall ms an iteration: the program's span
"highs.qp_iterations" summed over the traced window, divided by the QP
iterations of its calls (`getInfo().qp_iteration_count`)."""

from lpbench import spans


def read(run):
    iterations = sum(c["api"]["info"].qp_iteration_count
                     for c in run.calls if "info" in c["api"])
    sec = spans.seconds(run, "qp_iterations")
    if not iterations or sec is None:
        return None
    return 1e3 * sec / iterations
