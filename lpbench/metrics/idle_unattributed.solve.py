"""idle_unattributed.solve: of the solves' idle time on the device (the
trace's idle gaps, each labelled by the innermost host event at its
middle), the share, in %, that no layer claims: gaps labelled by the
benchmark's span alone, or by a program span that only encloses others
(ENCLOSING). None where the trace holds no program span."""

from lpbench import spans

ENCLOSING = ("highs.run", "highs.solve", "highs.presolve",
             "highs.pdlp_round", "highs.ipm_setup")


def unattributed(label: str) -> bool:
    """A gap's label is "<benchmark span>" or "<benchmark span>: <host
    event>"."""
    _, _, event = label.partition(": ")
    return not event or event in ENCLOSING


def read(run):
    if not spans.opened(run):
        return None
    total = sum(run.trace.idle.values())
    if total <= 0:
        return None
    return 100.0 * sum(ns for label, ns in run.trace.idle.items()
                       if unattributed(label)) / total
