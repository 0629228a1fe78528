"""The least bytes of one sparse product, counted from the instance, and
the published peak they are held against.

The count is made from the generated instance, never from the program's
operator, so that it is the same whatever format implements the
product: each stored value is read once, with the index its structure
needs (one 4-byte column index per dense 128 x 128 tile of the block
family, as `chip_smoke.py` `block_bound_ms` counts them; one per nonzero
where the nonzeros are scattered), a 4-byte row pointer per row of the
structure, x read once and y written once.  The vectors have the padded
lengths of `padded`, which is the rule the PDLP wrapper pads by
(`highs_tpu_torch/solvers/pdlp/wrapper.py` `_bucket`): the next power of
two from 128 up to 4,096, then the next multiple of 1,024.
"""
from __future__ import annotations

# NVIDIA's data sheet: HBM3 of one H100 SXM at its full 700 W limit
HBM_BYTES_PER_S = 3.35e12


def padded(x: int) -> int:
    """The padded length of a dimension of x."""
    if x <= 4096:
        r = 128
        while r < x:
            r *= 2
        return r
    return ((x + 1023) // 1024) * 1024


def block_product_bytes(st: dict, item: int) -> float:
    """One product of a block-tiled matrix (K x or K'y: the same count
    for the square family): the tiles' values, a column index per tile,
    a row pointer per block-row, x and y."""
    m, n = padded(st["m"]), padded(st["n"])
    block_rows = m // st["block"]
    return (st["tiles"] * st["block"] ** 2 * item + st["tiles"] * 4 +
            (block_rows + 1) * 4 + (m + n) * item)


def scattered_product_bytes(st: dict, item: int) -> float:
    """One product of a scattered sparse matrix: each nonzero's value and
    a 4-byte index, a row pointer per row, x and y."""
    m, n = padded(st["m"]), padded(st["n"])
    return st["nnz"] * (item + 4) + (m + 1) * 4 + (m + n) * item


def dense_batch_product_bytes(st: dict, item: int) -> float:
    """One product of the batch's stacked dense K: every stored entry of
    `count` padded m x n matrices once, and each instance's x and y."""
    m, n = padded(st["m"]), padded(st["n"])
    return st["count"] * (m * n * item + (m + n) * item)


def least_seconds(nbytes: float) -> float:
    """The least time in which the card can move `nbytes`."""
    return nbytes / HBM_BYTES_PER_S


def roofline_percent(trace, kernel: str, product_bytes):
    """The least time of the launches of the kernels whose name holds
    `kernel` over their measured device time, in %, each launch's least
    time from `product_bytes(item)` in the float width it ran in; None
    where the trace holds no such launch."""
    least = measured = 0.0
    for item in (4, 8):
        sec, n = trace.kernel_time(kernel, item)
        least += n * least_seconds(product_bytes(item))
        measured += sec
    return 100.0 * least / measured if measured > 0 else None


def mean_call_bytes(run, call_bytes) -> float:
    """The mean over the window's calls of `call_bytes(stats)`, where
    `stats` is the call's list of each LP's generator `stats`."""
    vals = [call_bytes(c["stats"]) for c in run.calls]
    return sum(vals) / len(vals)
