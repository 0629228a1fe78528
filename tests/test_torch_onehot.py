"""One-hot padded-cell SpMV: the port against the JAX package and scipy.

- The layout arrays equal the JAX package's `_build_cells` (indices and
  spill exactly, the values in float32, which is what the JAX package
  stores), and so does `choose_p`.
- float32 products equal the JAX package's, whose Pallas kernels run in
  interpret mode on the CPU (1e-5 relative to ||(|A| |x|)||_inf: both
  sum in f32, in different orders).
- float64 products equal scipy's A @ x (1e-12 relative): the port keeps
  the values in f64, where the JAX package truncates them to f32.

On the CPU the wrappers take the plain versions.  The CUDA kernels run
only on a card: their tests hold them against the plain versions there
and skip elsewhere.  A machine with a card but without JAX runs this
file's card tests without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_onehot.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.ops import onehot_spmv as toh

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

# the shapes of the JAX package's tests/test_onehot_spmv.py:13-19
SHAPES = [(300, 500, 0.01, 1), (1024, 1024, 0.002, 2), (257, 130, 0.05, 3),
          (128, 128, 0.3, 4), (1000, 200, 0.02, 5)]


def _spill_matrix():
    # a dense column block forces cell overflow into the COO spill
    a = sp.random(256, 256, density=0.001, random_state=7, format="lil")
    a[:64, 0] = 1.5  # 64 entries in one 128x128 cell
    return a.tocsr()


def _cases():
    cases = [(f"{m}x{n}", sp.random(m, n, density=d, random_state=s,
                                    format="csr"), None)
             for m, n, d, s in SHAPES]
    cases.append(("spill", _spill_matrix(), 4))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.fixture
def jax_onehot():
    """Builds the JAX package's one-hot operator of a matrix; returns
    (the module, jax.numpy)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX reference runs on the CPU, as "
                    "tests/conftest.py sets it")
    import jax.numpy as jnp
    from highs_tpu.ops import onehot_spmv as joh
    return joh, jnp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _vectors(op, a, seed):
    """x and y in the operator's padded lengths, zero in the padding."""
    rng = np.random.default_rng(seed)
    x = np.zeros(op.shape[1])
    x[:a.shape[1]] = rng.standard_normal(a.shape[1])
    y = np.zeros(op.shape[0])
    y[:a.shape[0]] = rng.standard_normal(a.shape[0])
    return x, y


def _rel_err(got, want, a_abs, v):
    """max |got - want| over ||(|A| |v|)||_inf."""
    scale = max(float(np.max(a_abs @ np.abs(v), initial=0.0)), 1e-300)
    return float(np.max(np.abs(got - want), initial=0.0)) / scale


@pytest.mark.parametrize("name,a,p", CASES, ids=IDS)
def test_layout_equals_jax(jax_onehot, name, a, p):
    joh, jnp = jax_onehot
    jop = joh.from_scipy_onehot(a, jnp.float32, p_slots=p)
    top = toh.from_scipy_onehot(a, torch.float32, p_slots=p, device="cpu")
    assert top.shape == tuple(jop.shape)
    for jdir, tdir in ((jop.fwd, top.fwd), (jop.bwd, top.bwd)):
        assert tdir.shape == jdir.shape
        assert (tdir.p_slots, tdir.pad_cnt) == (jdir.p_slots, jdir.pad_cnt)
        for field in ("gcol", "srow", "spill_row", "spill_col"):
            got = getattr(tdir, field).numpy()
            assert got.dtype == np.int32, field
            np.testing.assert_array_equal(
                got, np.asarray(getattr(jdir, field)), err_msg=field)
        for field in ("gval", "spill_val"):
            np.testing.assert_array_equal(
                getattr(tdir, field).numpy(),
                np.asarray(getattr(jdir, field), dtype=np.float32),
                err_msg=field)
        # the staging buffer is zero and shaped as the scatter side
        assert tdir.vbuf.shape == (tdir.srow.shape[0],
                                   tdir.srow.shape[1] * toh.BLOCK)
        assert not tdir.vbuf.any()
    if name == "spill":
        assert top.fwd.pad_cnt > 0


@pytest.mark.parametrize("name,a,p", CASES, ids=IDS)
def test_choose_p_equals_jax(jax_onehot, name, a, p):
    joh, _ = jax_onehot
    assert toh.choose_p(a) == joh.choose_p(a)
    assert 1 <= toh.choose_p(a) <= 12


@pytest.mark.parametrize("name,a,p", CASES, ids=IDS)
def test_f32_products_equal_jax(jax_onehot, name, a, p):
    joh, jnp = jax_onehot
    jop = joh.from_scipy_onehot(a, jnp.float32, p_slots=p)
    top = toh.from_scipy_onehot(a, torch.float32, p_slots=p, device="cpu")
    x, y = _vectors(top, a, seed=9)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    pad = abs(a).tocsr()
    pad.resize(top.shape)
    for got, want, mat, v in (
            (top.mv(torch.from_numpy(x32)), jop.mv(jnp.asarray(x32)), pad, x),
            (top.rmv(torch.from_numpy(y32)), jop.rmv(jnp.asarray(y32)),
             pad.T, y)):
        assert got.dtype == torch.float32
        assert _rel_err(got.numpy().astype(np.float64),
                        np.asarray(want, dtype=np.float64), mat, v) <= 1e-5


@pytest.mark.parametrize("name,a,p", CASES, ids=IDS)
def test_f64_products_equal_scipy(name, a, p):
    top = toh.from_scipy_onehot(a, torch.float64, p_slots=p, device="cpu")
    assert top.dtype == torch.float64
    x, y = _vectors(top, a, seed=10)
    m, n = a.shape
    got = top.mv(torch.from_numpy(x)).numpy()
    assert _rel_err(got[:m], a @ x[:n], abs(a), x[:n]) <= 1e-12
    assert not np.any(got[m:])
    got_t = top.rmv(torch.from_numpy(y)).numpy()
    assert _rel_err(got_t[:n], a.T @ y[:m], abs(a).T, y[:m]) <= 1e-12
    assert not np.any(got_t[n:])


def test_plain_versions_follow_their_definitions():
    rng = np.random.default_rng(3)
    nb, rg = 3, 2
    gcol = rng.integers(0, 128, (nb, rg, 128)).astype(np.int32)
    gval = rng.standard_normal((nb, rg, 128))
    x = rng.standard_normal(nb * 128)
    u = toh.gather_plain(torch.from_numpy(gcol), torch.from_numpy(gval),
                         torch.from_numpy(x)).numpy()
    want = gval * x[128 * np.arange(nb)[:, None, None] + gcol]
    np.testing.assert_array_equal(u, want)
    srow = rng.integers(0, 128, (nb, rg, 128)).astype(np.int32)
    y = toh.scatter_plain(torch.from_numpy(srow),
                          torch.from_numpy(gval)).numpy()
    want = np.zeros(nb * 128)
    for i in range(nb):
        np.add.at(want, 128 * i + srow[i].ravel(), gval[i].ravel())
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-12)


def test_wrappers_check_their_inputs():
    op = toh.from_scipy_onehot(CASES[0][1], torch.float64, device="cpu")
    oc = op.fwd
    x = torch.zeros(op.shape[1], dtype=torch.float64)
    with pytest.raises(TypeError):
        toh.onehot_gather(oc.gcol.long(), oc.gval, x)
    with pytest.raises(TypeError):
        toh.onehot_gather(oc.gcol, oc.gval, x.float())
    with pytest.raises(ValueError):
        toh.onehot_gather(oc.gcol, oc.gval, x[:-1])
    with pytest.raises(ValueError):
        toh.onehot_gather(oc.gcol, oc.gval,
                          torch.zeros(2 * op.shape[1],
                                      dtype=torch.float64)[::2])
    with pytest.raises(TypeError):
        toh.onehot_scatter(oc.srow.long(), oc.vbuf.view(oc.srow.shape))
    with pytest.raises(ValueError):
        toh.onehot_scatter(oc.srow, oc.vbuf)
    # the plain versions on the CPU never count as kernel launches
    before = dict(toh.LAUNCHES)
    op.mv(x)
    op.rmv(torch.zeros(op.shape[0], dtype=torch.float64))
    assert toh.LAUNCHES == before


# f64: 1e-12 relative to ||(|A| |x|)||_inf.  f32: 1e-5, the kernel and
# the plain version sum the same terms in different orders (the kernel's
# order is fixed, so it gives the same bits on every run).
CARD_TOL = [(torch.float64, 1e-12), (torch.float32, 1e-5)]


@pytest.mark.parametrize("dtype,rtol", CARD_TOL, ids=["f64", "f32"])
@pytest.mark.parametrize("name,a,p", CASES, ids=IDS)
def test_kernels_match_plain_on_card(cuda_device, name, a, p, dtype, rtol):
    op = toh.from_scipy_onehot(a, dtype, p_slots=p, device=cuda_device)
    abs_op = toh.from_scipy_onehot(abs(a), torch.float64, p_slots=p,
                                   device=cuda_device)
    rng = np.random.default_rng(11)
    for oc, abs_oc in ((op.fwd, abs_op.fwd), (op.bwd, abs_op.bwd)):
        x = torch.as_tensor(rng.standard_normal(oc.shape[1]), dtype=dtype,
                            device=cuda_device)
        before = dict(toh.LAUNCHES)
        u = toh.onehot_gather(oc.gcol, oc.gval, x)
        torch.cuda.synchronize()
        assert toh.LAUNCHES["onehot_gather"] == before["onehot_gather"] + 1
        # a product: every term once, so the gather is exact
        assert torch.equal(u, toh.gather_plain(oc.gcol, oc.gval, x))
        v = torch.as_tensor(rng.standard_normal(tuple(oc.srow.shape)),
                            dtype=dtype, device=cuda_device)
        got = toh.onehot_scatter(oc.srow, v)
        torch.cuda.synchronize()
        assert torch.equal(got, toh.onehot_scatter(oc.srow, v))  # same bits
        want = toh.scatter_plain(oc.srow, v)
        scale = toh.scatter_plain(oc.srow, v.abs().double()).abs().max()
        assert (got.double() - want.double()).abs().max() <= \
            rtol * max(float(scale), 1e-300)
        # the whole product against the plain product
        got = toh.spmv_cells(oc, x)
        want = toh.spmv_cells(oc, x, toh.gather_plain, toh.scatter_plain)
        scale = toh.spmv_cells(abs_oc, x.abs().double(), toh.gather_plain,
                               toh.scatter_plain).abs().max()
        assert (got.double() - want.double()).abs().max() <= \
            rtol * max(float(scale), 1e-300)
