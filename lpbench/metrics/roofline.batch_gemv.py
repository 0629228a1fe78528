"""roofline.batch_gemv: the batch's products (cuBLAS's strided-batched
gemv over the stacked dense K, K x and K'y) at their least time over
their measured time, in %: one product reads every stored entry of the
call's padded K's once (`yardstick.dense_batch_product_bytes`) at the
published 3.35 TB/s, against the profiler's device time of the `gemv`
kernels over their launches, for each float width they ran in."""

from lpbench import yardstick


def batch_bytes(stats, item):
    st = {"m": max(s["m"] for s in stats), "n": max(s["n"] for s in stats),
          "count": len(stats)}
    return yardstick.dense_batch_product_bytes(st, item)


def read(run):
    if run.trace is None:
        return None
    return yardstick.roofline_percent(
        run.trace, "gemv",
        lambda item: yardstick.mean_call_bytes(
            run, lambda stats: batch_bytes(stats, item)))
