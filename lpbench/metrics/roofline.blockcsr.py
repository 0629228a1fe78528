"""roofline.blockcsr: the block-CSR product's least time over its
measured time, in %: the least time is the bytes of one product, counted
from the instance (`yardstick.block_product_bytes`, averaged over the
window's solves), over the published 3.35 TB/s; the measured time is
the profiler's device time of `block_csr_spmv` over its launches, for
each float width it ran in."""

from lpbench import yardstick


def read(run):
    if run.trace is None:
        return None
    return yardstick.roofline_percent(
        run.trace, "block_csr_spmv",
        lambda item: yardstick.mean_call_bytes(
            run, lambda st: yardstick.block_product_bytes(st[0], item)))
