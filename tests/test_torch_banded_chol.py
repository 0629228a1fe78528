"""The banded Cholesky of the IPM's sparse route: the port (f32, on the
CPU) against the JAX package's `BandedCholesky` on the same matrices.

On the 30 x 30 grid Laplacian of `tests/test_sparse_ipm.py`: the two
factors agree to 1e-5 relative (f32, sums in another order), the port's
unrefined solve has a relative residual of at most 1e-3 and reaches
1e-10 after three rounds of f64 refinement on the host, its one-call
refined solve agrees with the JAX package's, and an unstructured matrix
is rejected.  On a card, the factor and the refined solve are held
against the CPU run (a card-only case that skips here):

    python -m pytest --noconftest tests/test_torch_banded_chol.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.solvers.ipm import banded_chol
from highs_tpu_torch.solvers.ipm.banded_chol import BandedCholesky

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


def _laplacian(g):
    m = g * g
    return sp.diags([np.full(m, 8.0), np.full(m - 1, -1.0),
                     np.full(m - 1, -1.0), np.full(m - g, -1.0),
                     np.full(m - g, -1.0)], [0, 1, -1, g, -g], format="csr")


def _rel_residual(mat, x, rhs):
    return np.linalg.norm(mat @ x - rhs) / np.linalg.norm(rhs)


@pytest.fixture
def jax_banded():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX reference runs on the CPU, as "
                    "tests/conftest.py sets it")
    from highs_tpu.solvers.ipm.banded_chol import BandedCholesky as JB
    return JB


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor's device run")
    return torch.device("cuda")


def test_factor_and_solves_match_jax(jax_banded):
    lap = _laplacian(30)
    jb = jax_banded.from_spd(lap)
    jb.factor(lap)
    bc = BandedCholesky.from_spd(lap, device="cpu")
    assert bc is not None and (bc.nblk, bc.w) == (jb.nblk, jb.w)
    np.testing.assert_array_equal(bc.perm, jb.perm)
    before = banded_chol.FACTORS["cpu"]
    bc.factor(lap)
    assert banded_chol.FACTORS["cpu"] == before + 1
    want = np.asarray(jb._l)
    got = bc.lblocks.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    rhs = np.random.default_rng(3).standard_normal(lap.shape[0])
    x = bc.solve(rhs)
    assert _rel_residual(lap, x, rhs) <= 1e-3
    for _ in range(3):
        x = x + bc.solve(rhs - lap @ x)
    assert _rel_residual(lap, x, rhs) <= 1e-10
    # the refined device solve: f32 grade, as the JAX package's
    xr, xj = bc.solve_refined(rhs), jb.solve_refined(rhs)
    assert _rel_residual(lap, xr, rhs) <= 1e-6
    assert np.abs(xr - xj).max() <= 1e-5 * np.abs(xj).max()


@pytest.mark.parametrize("nblk,w", [(5, 1), (7, 2), (6, 3)])
def test_band_matvec_matches_the_matrix(nblk, w):
    """The band matvec of the refined solve against scipy on a random
    SPD band, and the factor's solve against it."""
    rng = np.random.default_rng(nblk * 10 + w)
    m = nblk * banded_chol.NB - 37
    g = sp.random(m, m, density=0.02, random_state=rng, format="coo")
    keep = np.abs(g.row - g.col) <= w * banded_chol.NB - 5
    g = sp.coo_matrix((g.data[keep], (g.row[keep], g.col[keep])),
                      shape=(m, m))
    mat = (g + g.T + sp.diags(np.full(m, 40.0))).tocsr()
    bc = BandedCholesky(np.arange(m), nblk, w, "cpu").factor(mat)
    x = rng.standard_normal(m)
    xp = torch.zeros(nblk * banded_chol.NB)
    xp[:m] = torch.as_tensor(x)
    got = banded_chol.band_matvec(bc._ab, xp)[:m].numpy()
    want = mat @ x
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert _rel_residual(mat, bc.solve_refined(want), want) <= 1e-6


def test_unstructured_matrix_is_rejected():
    r = sp.random(600, 600, density=0.05, random_state=1)
    r = (r + r.T + sp.diags(np.full(600, 50.0))).tocsr()
    assert BandedCholesky.from_spd(r, device="cpu", max_block_bw=2) is None


def test_failed_block_becomes_scaled_identity():
    """A singular diagonal block (an indefinite matrix) gives a finite
    factor, with no host sync to find it."""
    m = 2 * banded_chol.NB
    mat = sp.diags(np.concatenate([np.full(banded_chol.NB, 4.0),
                                   np.full(banded_chol.NB, -4.0)])).tocsr()
    bc = BandedCholesky(np.arange(m), 2, 1, "cpu").factor(mat)
    assert np.isfinite(bc.lblocks.numpy()).all()
    eye = np.eye(banded_chol.NB)
    # the first block: chol(4 (1 + 3e-6) I); the failed second block,
    # -4 I shifted by 3e-6 * 4: sqrt(scale) I with scale = 4
    np.testing.assert_allclose(bc.lblocks[0, 1].numpy(),
                               2 * np.sqrt(1 + 3e-6) * eye, rtol=1e-6)
    np.testing.assert_array_equal(bc.lblocks[1, 1].numpy(), 2 * eye)


def test_card_factor_matches_cpu(cuda_device):
    lap = _laplacian(90)
    runs = {}
    for dev in (cuda_device, "cpu"):
        before = banded_chol.FACTORS[torch.device(dev).type]
        bc = BandedCholesky.from_spd(lap, device=dev).factor(lap)
        assert banded_chol.FACTORS[torch.device(dev).type] == before + 1
        rhs = np.random.default_rng(4).standard_normal(lap.shape[0])
        runs[str(dev)] = (bc.lblocks.cpu().numpy(), bc.solve_refined(rhs),
                          rhs)
    (lc, xc, rhs), (lh, xh, _) = runs[str(cuda_device)], runs["cpu"]
    assert np.abs(lc - lh).max() <= 1e-5 * np.abs(lh).max()
    assert _rel_residual(lap, xc, rhs) <= 1e-6
    assert np.abs(xc - xh).max() <= 1e-5 * np.abs(xh).max()
