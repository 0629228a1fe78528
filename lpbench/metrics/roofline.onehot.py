"""roofline.onehot: the one-hot product's least time over its measured
time, in %: bytes counted from the instance
(`yardstick.scattered_product_bytes`, averaged over the window's
solves) over the published 3.35 TB/s, against the profiler's device time
of `onehot_spmv` over its launches, for each float width it ran in."""

from lpbench import yardstick


def read(run):
    if run.trace is None:
        return None
    return yardstick.roofline_percent(
        run.trace, "onehot_spmv",
        lambda item: yardstick.mean_call_bytes(
            run, lambda st: yardstick.scattered_product_bytes(st[0], item)))
