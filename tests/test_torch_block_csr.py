"""Block-CSR SpMV: the port against the JAX package's Pallas kernel.

On the CPU the JAX package runs its Pallas kernel in interpret mode and
the port's wrapper takes the plain PyTorch version; both must give the
same layout and the same products (f64, atol 1e-12).  The kernel itself
runs only on a CUDA card: its test compares it with the plain version
there and skips elsewhere.  A machine with a card but without JAX runs
this file's card tests alone, without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_block_csr.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.convert import block_csr_from_numpy
from highs_tpu_torch.ops import block_csr as tbc

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

SHAPES = [(300, 1500), (100, 90), (1024, 513), (128, 128)]


def _empty_rows_matrix():
    # entirely empty block-rows in K, and empty block-rows in K'
    return sp.csr_matrix(([3.0, -2.0], ([0, 400], [0, 100])),
                         shape=(512, 512))


def _matrices():
    rng = np.random.default_rng(42)
    cases = [(f"{m}x{n}", sp.random(m, n, density=0.05, random_state=rng,
                                    format="csr")) for m, n in SHAPES]
    cases.append(("empty-block-rows", _empty_rows_matrix()))
    return cases


CASES = _matrices()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def jax_block_csr():
    """Builds the JAX package's f64 block-CSR operator of a matrix and
    returns it with the function that makes a JAX array."""
    jnp = pytest.importorskip("jax.numpy")
    from highs_tpu.ops.block_csr import from_scipy_block_csr

    def build(a):
        return from_scipy_block_csr(a, dtype=jnp.float64), jnp.asarray
    return build


@pytest.mark.parametrize("name,a", CASES, ids=[c[0] for c in CASES])
def test_layout_equals_jax(jax_block_csr, name, a):
    jop, _ = jax_block_csr(a)
    top = tbc.from_scipy_block_csr(a, dtype=torch.float64, device="cpu")
    assert top.shape == jop.shape
    for jdir, tdir in ((jop.fwd, top.fwd), (jop.bwd, top.bwd)):
        assert tdir.shape == jdir.shape
        for field in ("blocks", "block_row", "block_col", "first_in_row"):
            np.testing.assert_array_equal(
                getattr(tdir, field).numpy(), np.asarray(getattr(jdir, field)),
                err_msg=field)
        # the row pointer delimits each block-row's contiguous tiles
        ptr = tdir.row_ptr.numpy()
        rows = tdir.block_row.numpy()
        assert ptr[0] == 0 and ptr[-1] == len(rows)
        for i in range(len(ptr) - 1):
            assert np.all(rows[ptr[i]:ptr[i + 1]] == i)
            assert ptr[i + 1] > ptr[i]  # every block-row has a tile


@pytest.mark.parametrize("name,a", CASES, ids=[c[0] for c in CASES])
def test_products_equal_jax(jax_block_csr, name, a):
    jop, jnp_asarray = jax_block_csr(a)
    top = tbc.from_scipy_block_csr(a, dtype=torch.float64, device="cpu")
    mp, np_ = top.shape
    rng = np.random.default_rng(7)
    x = rng.standard_normal(np_)
    y = rng.standard_normal(mp)
    np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(),
                               np.asarray(jop.mv(jnp_asarray(x))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(top.rmv(torch.from_numpy(y)).numpy(),
                               np.asarray(jop.rmv(jnp_asarray(y))),
                               rtol=0, atol=1e-12)
    a_pad = np.zeros((mp, np_))
    a_pad[:a.shape[0], :a.shape[1]] = a.toarray()
    np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(),
                               a_pad @ x, rtol=0, atol=1e-12)


def test_convert_carries_the_jax_operator(jax_block_csr):
    a = CASES[0][1]
    jop, jnp_asarray = jax_block_csr(a)
    fwd = block_csr_from_numpy(
        *(np.asarray(getattr(jop.fwd, f)) for f in
          ("blocks", "block_row", "block_col", "first_in_row")),
        shape=jop.fwd.shape)
    x = np.random.default_rng(3).standard_normal(jop.shape[1])
    np.testing.assert_allclose(
        tbc.block_csr_spmv(fwd, torch.from_numpy(x)).numpy(),
        np.asarray(jop.mv(jnp_asarray(x))), rtol=0, atol=1e-12)


def test_wrapper_checks_its_inputs():
    top = tbc.from_scipy_block_csr(CASES[1][1], dtype=torch.float64)
    n = top.shape[1]
    with pytest.raises(ValueError):
        top.mv(torch.zeros(n + 1, dtype=torch.float64))
    with pytest.raises(TypeError):
        top.mv(torch.zeros(n, dtype=torch.float32))
    with pytest.raises(ValueError):
        top.mv(torch.zeros(2 * n, dtype=torch.float64)[::2])
    # the plain version on the CPU never counts as a kernel launch
    before = tbc.LAUNCHES
    top.mv(torch.zeros(n, dtype=torch.float64))
    assert tbc.LAUNCHES == before


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("name,a", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_card(cuda_device, name, a, dtype, rtol):
    op = tbc.from_scipy_block_csr(a, dtype=dtype, device=cuda_device)
    abs_op = tbc.from_scipy_block_csr(abs(a), dtype=torch.float64,
                                      device=cuda_device)
    rng = np.random.default_rng(11)
    for direction in ("fwd", "bwd"):
        bc = getattr(op, direction)
        x = torch.as_tensor(rng.standard_normal(bc.shape[1]), dtype=dtype,
                            device=cuda_device)
        before = tbc.LAUNCHES
        got = tbc.block_csr_spmv(bc, x)
        torch.cuda.synchronize()
        assert tbc.LAUNCHES == before + 1
        want = tbc.spmv_plain(bc, x)
        # error relative to ||(|A| |x|)||_inf: the size of the sums
        scale = tbc.spmv_plain(getattr(abs_op, direction),
                               x.abs().double()).abs().max().item()
        err = (got.double() - want.double()).abs().max().item()
        assert err <= rtol * max(scale, 1e-300), (direction, err, scale)
