"""Dense and ELL operators and the `choose` rule: the port against the
JAX package (f64, atol 1e-12)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from highs_tpu.ops import block_csr as jbc
from highs_tpu.ops import linops as jlin
from highs_tpu_torch.convert import linop_from_numpy
from highs_tpu_torch.ops import block_csr as tbc
from highs_tpu_torch.ops import linops as tlin

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


def _scattered(m, n, density, seed, long_rows=0):
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=density, random_state=rng, format="lil")
    for r in range(long_rows):  # rows and columns longer than the ELL
        a[r, :] = rng.standard_normal(n)  # width spill to the COO tail
        a[:, r + 1] = rng.standard_normal((m, 1))
    return a.tocsr()


OPS = [("dense", "dense"), ("ell", "ell"), ("ell-spill", "ell")]


def _case(name):
    if name == "ell-spill":
        return _scattered(200, 150, 0.03, 5, long_rows=3)
    return _scattered(200, 150, 0.05, 4)


@pytest.mark.parametrize("name,fmt", OPS, ids=[o[0] for o in OPS])
def test_products_equal_jax(name, fmt):
    a = _case(name)
    jop = jlin.from_scipy(a, fmt=fmt, dtype=jnp.float64)
    top = tlin.from_scipy(a, fmt=fmt, dtype=torch.float64, device="cpu")
    assert tuple(top.shape) == tuple(jop.shape)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(a.shape[1])
    y = rng.standard_normal(a.shape[0])
    np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(),
                               np.asarray(jop.mv(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(top.rmv(torch.from_numpy(y)).numpy(),
                               np.asarray(jop.rmv(jnp.asarray(y))),
                               rtol=0, atol=1e-12)
    if name == "ell-spill":
        assert top.tail_seg.shape[0] > 0 and top.tail_seg_t.shape[0] > 0


def test_ell_layout_equals_jax():
    a = _case("ell-spill")
    jop = jlin.from_scipy_ell(a, dtype=jnp.float64)
    top = tlin.from_scipy_ell(a, dtype=torch.float64)
    for field in tlin.EllMatrix._fields:
        np.testing.assert_array_equal(getattr(top, field).numpy(),
                                      np.asarray(getattr(jop, field)),
                                      err_msg=field)
    # the JAX operator's arrays carry over through convert.py
    moved = linop_from_numpy({f: np.asarray(getattr(jop, f))
                              for f in tlin.EllMatrix._fields})
    x = np.random.default_rng(2).standard_normal(a.shape[1])
    np.testing.assert_allclose(moved.mv(torch.from_numpy(x)).numpy(),
                               np.asarray(jop.mv(jnp.asarray(x))),
                               rtol=0, atol=1e-12)


def _tile_matrix(m, n, tile_nnz, seed):
    """A matrix of one 128x128 tile holding `tile_nnz` entries, in an
    (m, n) frame: its dense copy size is m*n*8 bytes, its tile fill
    tile_nnz / 16384."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(128 * 128, size=tile_nnz, replace=False)
    return sp.csr_matrix((rng.standard_normal(tile_nnz),
                          (flat // 128, flat % 128)), shape=(m, n))


# 5800^2 * 8 bytes = 269.1 MB is just above the 256 MiB dense limit;
# a tile filled at 0.2075 is above the 0.2 fill threshold, 0.1953 below
CHOOSE_CASES = [
    ("small-dense", lambda: _scattered(300, 200, 0.05, 1), "dense"),
    ("big-full-tile", lambda: _tile_matrix(5800, 5800, 16384, 2),
     "blockcsr"),
    ("big-fill-above", lambda: _tile_matrix(5800, 5800, 3400, 3),
     "blockcsr"),
    ("big-fill-below", lambda: _tile_matrix(5800, 5800, 3200, 4), "ell"),
    ("big-scattered", lambda: _scattered(5800, 5800, 2e-5, 5), "ell"),
]


def _jax_format(op):
    if isinstance(op, jlin.DenseMatrix):
        return "dense"
    if isinstance(op, jbc.BlockCsrMatrix):
        return "blockcsr"
    if isinstance(op, jlin.EllMatrix):
        return "ell"
    return type(op).__name__


def _torch_format(op):
    return {tlin.DenseMatrix: "dense", tbc.BlockCsrMatrix: "blockcsr",
            tlin.EllMatrix: "ell"}[type(op)]


@pytest.mark.parametrize("name,make,want", CHOOSE_CASES,
                         ids=[c[0] for c in CHOOSE_CASES])
def test_choose_picks_the_jax_format(name, make, want):
    a = make()
    jop = jlin.from_scipy(a, fmt="choose", dtype=jnp.float64)
    top = tlin.from_scipy(a, fmt="choose", dtype=torch.float64)
    assert _jax_format(jop) == want
    assert _torch_format(top) == want
    assert tlin.choose_format(a, torch.float64) == want


def test_choose_dense_limit_in_bytes():
    # the limit is 256 MiB of the dense copy in the operator's own type
    # (decided from the shape alone: nothing is built here)
    below = sp.csr_matrix((5792, 5792))  # 268,378,112 bytes in f64
    above = sp.csr_matrix((5794, 5794))  # 268,563,488 bytes in f64
    assert tlin.choose_format(below, torch.float64) == "dense"
    assert tlin.choose_format(above, torch.float64) != "dense"
    assert tlin.choose_format(above, torch.float32) == "dense"


@pytest.mark.parametrize("fmt", sorted(tlin.NOT_YET_PORTED))
def test_format_not_yet_ported_raises(fmt):
    a = _case("dense")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tlin.from_scipy(a, fmt=fmt, dtype=torch.float64)


def test_unknown_format_raises():
    with pytest.raises(ValueError):
        tlin.from_scipy(_case("dense"), fmt="nope", dtype=torch.float64)


@pytest.mark.parametrize("fmt", ["dense", "ell", "blockcsr"])
def test_cast_linop_matches_jax(fmt):
    a = _case("dense")
    top = tlin.from_scipy(a, fmt=fmt, dtype=torch.float64)
    jop = jlin.from_scipy(a, fmt=fmt, dtype=jnp.float64)
    low = tlin.cast_linop(top, torch.bfloat16)
    jlow = jlin.cast_linop(jop, jnp.bfloat16)
    # block-CSR has no low-precision copy in either package
    assert (low is None) == (jlow is None) == (fmt == "blockcsr")
    assert tlin.linop_dtype(top) == torch.float64
    if low is not None:
        assert tlin.linop_dtype(low) == torch.bfloat16
