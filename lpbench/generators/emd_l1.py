"""The Earth Mover's Distance with the L1 ground metric between two
images of DOTmark's class WhiteNoise, as a min-cost flow on the
4-neighbour pixel grid (Ling and Okada, "An Efficient Earth Mover's
Distance Algorithm for Robust Histogram Comparison", IEEE TPAMI 29(5),
2007; DOTmark: Schrieber, Schuhmacher and Gottschlich, IEEE Access 5,
2017). Frozen: a change to the port cannot move the yardstick.

An image of the class is `res` x `res` i.i.d. uniform intensities on
[0, 1), image i from seed i (ten a class, seeds 0-9), scaled to one unit
of mass a pixel. Base k is the pair of images (2k, 2k + 1). The LP:

    min 1'x  s.t.  outflow_p - inflow_p = mu_p - nu_p  (one row a pixel),
                   x >= 0,

with one column an arc, two arcs (one each way) a pair of neighbours:
at 256 x 256, 65,536 rows, 261,120 columns and 522,240 nonzeros. Its
optimum is W1(mu, nu) under the L1 distance between pixel centres.

A fresh instance permutes the pixels (rows) and the arcs (columns),
drawn from (seed, call index): the optimum is the base's, while the
pattern that reaches the solver is new, so that no solve gains from a
cache keyed on the last pattern.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lpbench.flow_reference import FlowLp


def image(index: int, res: int) -> np.ndarray:
    """WhiteNoise image `index` at `res` x `res`, one unit of mass a
    pixel."""
    img = np.random.default_rng(int(index)).random((res, res))
    return img * (img.size / img.sum())


def emd_lp(mu: np.ndarray, nu: np.ndarray) -> FlowLp:
    """The min-cost flow whose optimum is W1(mu, nu) under the L1 ground
    metric, for two images of one shape and equal mass."""
    h, w = mu.shape
    idx = np.arange(h * w).reshape(h, w)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    tail = np.concatenate([u, v])
    head = np.concatenate([v, u])
    n = len(tail)
    rows = np.stack([tail, head], axis=1).ravel()
    vals = np.tile([1.0, -1.0], n)
    a = sp.csc_matrix((vals, rows, np.arange(0, 2 * n + 1, 2)),
                      shape=(h * w, n))
    a.sort_indices()
    return FlowLp(a, (mu - nu).ravel().astype(np.float64), np.ones(n))


def generate(params: dict) -> FlowLp:
    """Base `params["seed"]` at `params["res"]` squared pixels."""
    k, res = int(params["seed"]), int(params["res"])
    return emd_lp(image(2 * k, res), image(2 * k + 1, res))


def fresh(base: FlowLp, params: dict, rng) -> FlowLp:
    """`base` with its rows and its columns permuted, drawn from
    `rng`."""
    m, n = base.a.shape
    p = rng.permutation(m)
    q = rng.permutation(n)
    a = base.a[:, q].tocsr()[p, :].tocsc()
    return FlowLp(a, base.b[p], base.c[q])


def stats(base: FlowLp, params: dict) -> dict:
    """Sizes and nonzeros."""
    m, n = base.a.shape
    return {"m": m, "n": n, "nnz": int(base.a.nnz)}
