"""batch_host_s: the batch's host seconds a call around its blocks: the
program's spans "highs.batch.prepare" (standard form, scaling and the
stacked upload, `prepare_batch`) and "highs.batch.recover" (each LP's
solution recovered), over the traced window, divided by the calls."""

from lpbench import spans


def read(run):
    return spans.per_call(run, ["batch.prepare", "batch.recover"],
                          spans.batch_calls(run))
