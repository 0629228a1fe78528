"""qp_recover_s: the QP IPM's seconds a solve from its last iterate to
the model's solution (reduced costs, `recover_solution`, row values,
objective): the program's span "highs.qp.recover" over the traced
window, divided by the solves that the QP IPM answered. None where the
trace holds no such span."""

from lpbench import spans


def read(run):
    solves = [c for c in run.calls if "info" in c["api"]
              and c["api"]["info"].qp_iteration_count > 0]
    sec = spans.seconds(run, "qp.recover")
    return None if sec is None or not solves else sec / len(solves)
