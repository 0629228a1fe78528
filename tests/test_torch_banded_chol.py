"""The banded Cholesky of the IPM's sparse route: the port (f64, on the
CPU) against the JAX package's `BandedCholesky` (f32) on the same
matrices.

On the 30 x 30 grid Laplacian of `tests/test_sparse_ipm.py`: the two
factors agree to 1e-5 relative (the JAX package's f32 rounding and its
shift), the port's unrefined solve has a relative residual of at most
1e-3 and reaches 1e-10 after three rounds of f64 refinement on the host,
its one-call refined solve agrees with the JAX package's, and an
unstructured matrix is rejected.  On a 64^2 EMD node-arc matrix with
scaled rows (the normal matrix K Theta K' + 1e-10 I of the IPM's flow,
Theta spread over up to 10^+-8), a right-hand side M v solves to 1e-12
after two host rounds, while a probe along the ones vector, which lies
along M's near-null direction, cannot pass the probe gate the route once
had.  The captured factor and solve (`capture.eager_recorder`) give the
op-by-op bits and count their captures and replays.  On a card, the
replayed factor and solve are held against the CPU run (card-only cases
that skip here):

    python -m pytest --noconftest tests/test_torch_banded_chol.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.solvers import capture
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
    bc.factor(lap)
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
    xp = torch.zeros(nblk * banded_chol.NB, dtype=torch.float64)
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
    # the first block: chol(4 (1 + 64 eps) I); the failed second block,
    # -4 I shifted by 64 eps * 4: sqrt(scale) I with scale = 4
    shift = banded_chol.SHIFT_ULPS * np.finfo(np.float64).eps
    assert bc.lblocks.dtype == torch.float64
    np.testing.assert_allclose(bc.lblocks[0, 1].numpy(),
                               2 * np.sqrt(1 + shift) * eye, rtol=1e-15)
    np.testing.assert_array_equal(bc.lblocks[1, 1].numpy(), 2 * eye)


def _emd_node_arc(g: int) -> sp.csc_matrix:
    """The node-arc matrix of an EMD flow on a g x g pixel grid: one arc
    each way between 4-neighbours, +1 at its tail and -1 at its head."""
    idx = np.arange(g * g).reshape(g, g)
    pairs = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], axis=1)])
    ends = np.concatenate([pairs, pairs[:, ::-1]])
    n = len(ends)
    return sp.csc_matrix((np.tile([1.0, -1.0], n), ends.ravel(),
                          np.arange(0, 2 * n + 1, 2)), shape=(g * g, n))


def _emd_normal_matrix(spread: float, g: int = 64, seed: int = 7):
    """M = K Theta K' + 1e-10 I for the node-arc matrix K of a g x g EMD
    flow with its rows scaled by e^U(-0.3, 0.3), Theta log-uniform over
    10^+-spread."""
    a = _emd_node_arc(g)
    rng = np.random.default_rng(seed)
    k = sp.diags(np.exp(rng.uniform(-0.3, 0.3, a.shape[0]))) @ a
    theta = 10.0 ** rng.uniform(-spread, spread, a.shape[1])
    mat = (k @ sp.diags(theta) @ k.T +
           1e-10 * sp.identity(a.shape[0])).tocsc()
    mat.sum_duplicates()
    return mat, rng


@pytest.mark.parametrize("spread", [0, 4, 8])
def test_emd_normal_matrix_solves_in_range_not_along_ones(spread):
    """The f64 factor solves a right-hand side in M's range, as the
    IPM's Newton systems are, to 1e-12 after two host refinement rounds,
    at every spread of Theta; the ones vector, which lies almost wholly
    along the null direction of K Theta K' (K' annihilates the inverse
    row scales), misses the probe gate's 1e-6 at every spread."""
    mat, rng = _emd_normal_matrix(spread)
    bc = BandedCholesky.from_spd(mat, device="cpu").factor(mat)
    rhs = mat @ rng.standard_normal(mat.shape[0])
    x = bc.solve(rhs)
    for _ in range(2):
        x = x + bc.solve(rhs - mat @ x)
    assert _rel_residual(mat, x, rhs) <= 1e-12
    ones = np.ones(mat.shape[0])
    probe = bc.solve_refined(ones, refine=3)
    assert not np.linalg.norm(mat @ probe - ones) / \
        np.sqrt(mat.shape[0]) < 1e-6


def _factor_and_solves(bc, mats, rhs):
    """Each matrix factored, then two solves: the factors and solutions."""
    out = []
    for mat in mats:
        bc.factor(mat)
        out += [bc.lblocks.clone(), bc.solve(rhs), bc.solve(2.0 * rhs)]
    return out


def test_captured_factor_and_solve_give_the_op_by_op_bits():
    """The factor and the solve through the capture step
    (`capture.eager_recorder`, a replay as a graph's) against op by op,
    bit for bit, over two matrices of one pattern, and the counts: one
    capture of each graph for the band structure, one replay a factor
    or a solve.  A matrix of another pattern on the same structure
    captures both again."""
    lap = _laplacian(40)
    mats = [lap, lap + sp.diags(np.linspace(0.5, 2.0, lap.shape[0]))]
    rhs = np.random.default_rng(5).standard_normal(lap.shape[0])
    want = _factor_and_solves(BandedCholesky.from_spd(lap, device="cpu"),
                              mats, rhs)
    bc = BandedCholesky.from_spd(lap, device="cpu")
    assert bc.capture is None
    bc.capture = capture.eager_recorder
    before = banded_chol.GRAPHS.copy()
    got = _factor_and_solves(bc, mats, rhs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert banded_chol.GRAPHS - before == {
        "captures": 2, "factor_replays": 2, "solve_replays": 4}
    # a pattern with fewer entries maps new slots: both graphs again
    fewer = sp.diags(lap.diagonal()).tocsc()
    bc.factor(fewer)
    x = bc.solve(rhs)
    np.testing.assert_allclose(fewer @ x, rhs, rtol=1e-12)
    assert (banded_chol.GRAPHS - before)["captures"] == 4


def test_card_factor_matches_cpu(cuda_device):
    """The card's replayed factor and solve against the CPU's op by op,
    to 1e-12 relative, on the 90^2 Laplacian; a second factor and solve
    replay the graphs captured for the first.  On the EMD normal matrix
    the card's solve of a right-hand side in M's range is held to the
    CPU test's residual, 1e-12 after two host rounds, at Theta unspread
    and at its widest spread (10^+-8).  The card's and the CPU's
    factors and solves part there by more than 1e-12: the last pivot
    of the singular flow Laplacian is the square root of a difference
    that cancels to its shift (3e-7 of itself at Theta unspread, on an
    H100), and the solves part along M's near-null direction, whose
    component the sums' rounding sets."""
    lap = _laplacian(90)
    rhs = np.random.default_rng(4).standard_normal(lap.shape[0])
    runs = {}
    before = banded_chol.GRAPHS.copy()
    for dev in (cuda_device, "cpu"):
        bc = BandedCholesky.from_spd(lap, device=dev)
        _factor_and_solves(bc, [lap], rhs)
        runs[str(dev)] = [np.asarray(t.cpu() if torch.is_tensor(t) else t)
                          for t in _factor_and_solves(bc, [lap], rhs)]
    assert banded_chol.GRAPHS - before == {
        "captures": 2, "factor_replays": 2, "solve_replays": 4}
    for c, h in zip(runs[str(cuda_device)], runs["cpu"]):
        assert np.abs(c - h).max() <= 1e-12 * np.abs(h).max()
    for spread in (0, 8):
        mat, rng = _emd_normal_matrix(spread)
        card = BandedCholesky.from_spd(mat, device=cuda_device).factor(mat)
        rhs = mat @ rng.standard_normal(mat.shape[0])
        x = card.solve(rhs)
        for _ in range(2):
            x = x + card.solve(rhs - mat @ x)
        assert _rel_residual(mat, x, rhs) <= 1e-12, spread
