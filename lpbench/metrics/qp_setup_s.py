"""qp_setup_s: the QP IPM's set-up seconds a solve (standard form, Q and
A dense on the device, the starting point): the program's span
"highs.qp_setup" over the traced window, divided by the solves that the
QP IPM answered. None where the trace holds no such span."""

from lpbench import spans


def read(run):
    solves = [c for c in run.calls if "info" in c["api"]
              and c["api"]["info"].qp_iteration_count > 0]
    sec = spans.seconds(run, "qp_setup")
    return None if sec is None or not solves else sec / len(solves)
