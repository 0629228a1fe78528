"""Presolve's sweeps over the nonzeros, read from one copy of A on the
solve's device (`presolve/device.py` `DeviceMatrix`).

On the CPU the torch route must reduce each LP as the JAX package's
numpy presolve does, bit for bit: the same stack, the same reduced LP
(arrays and matrix), the same kept rows and columns.  Each case is an LP
on which one rule family reduces something (the port's counter
"presolve.<family>" says so).  The counters of the copy
(`presolve.device_builds`, `presolve.device_sweeps`) say how often it was
built and read.

The card tests skip without CUDA; on a card, without the repository's
conftest (and without the JAX package, which only the CPU tests read):

    python -m pytest --noconftest tests/test_torch_presolve.py -q -k card
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.ops import segment_sum as seg
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.presolve.presolve import presolve_lp
from highs_tpu_torch.utils.gen_block_lp import block_lp
from highs_tpu_torch.utils.gen_mip import set_cover
from highs_tpu_torch.utils.gen_synth_lp import synth_lp
from highs_tpu_torch.utils.timer import HighsTimer

# the tests run in parallel worker processes on shared cores
torch.set_num_threads(1)

LP_FIELDS = ("num_col", "num_row", "col_cost", "col_lower", "col_upper",
             "row_lower", "row_upper", "offset", "integrality")


def _dict(a, cost, lo, up, rl, ru, integrality=None):
    a = sp.csc_matrix(a, dtype=np.float64)
    a.sort_indices()
    m, n = a.shape
    d = dict(num_col=n, num_row=m, col_cost=np.asarray(cost, float),
             col_lower=np.asarray(lo, float), col_upper=np.asarray(up, float),
             row_lower=np.asarray(rl, float), row_upper=np.asarray(ru, float),
             a_start=a.indptr.astype(np.int64),
             a_index=a.indices.astype(np.int64),
             a_value=a.data.astype(np.float64))
    if integrality is not None:
        d["integrality"] = np.asarray(integrality, dtype=np.uint8)
    return d


def _base(rng, m, n, density=0.15):
    """A random sparse A with Ax >= b feasible at x* in [0, 1]."""
    a = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=rng.standard_normal, format="lil")
    return a


def _ge_rows(a, rng, slack=0.5):
    """Row bounds Ax >= b - slack at a point of [0, 1]^n."""
    x = rng.uniform(0.2, 0.8, a.shape[1])
    r = sp.csr_matrix(a) @ x
    return r - slack, np.full(a.shape[0], np.inf)


def parallel_rows():
    rng = np.random.default_rng(11)
    a = _base(rng, 30, 40)
    a[25, :] = 2.0 * a[3, :].toarray()
    a[26, :] = -3.0 * a[7, :].toarray()
    a[27, :] = 0.5 * a[3, :].toarray()
    rl, ru = _ge_rows(a, rng)
    rl[26], ru[26] = -np.inf, -3.0 * rl[7] + 0.1
    return _dict(a, rng.uniform(0.1, 1, 40), np.zeros(40), np.full(40, 5.0),
                 rl, ru)


def parallel_cols():
    rng = np.random.default_rng(12)
    a = _base(rng, 30, 40)
    cost = rng.uniform(0.1, 1, 40)
    for j, k, s in ((2, 30, 2.0), (5, 31, -1.5), (9, 32, 0.25)):
        a[:, k] = s * a[:, j].toarray()
        cost[k] = s * cost[j]
    rl, ru = _ge_rows(a, rng)
    return _dict(a, cost, np.zeros(40), np.full(40, 5.0), rl, ru)


def forcing_rows():
    rng = np.random.default_rng(13)
    a = _base(rng, 30, 40)
    rl, ru = _ge_rows(a, rng, slack=5.0)
    # rows whose least activity over 0 <= x is their upper bound
    for i, cols in ((28, [1, 4, 9]), (29, [12, 20])):
        a[i, :] = 0.0
        a[i, cols] = rng.uniform(0.5, 2.0, len(cols))
        rl[i], ru[i] = -np.inf, 0.0
    return _dict(a, rng.uniform(0.1, 1, 40), np.zeros(40), np.full(40, 5.0),
                 rl, ru)


def doubleton_eqs():
    rng = np.random.default_rng(14)
    a = _base(rng, 30, 40)
    rl, ru = _ge_rows(a, rng, slack=5.0)
    for i, (j, k) in zip((26, 27, 28, 29), ((1, 2), (5, 8), (11, 30),
                                            (17, 33))):
        a[i, :] = 0.0
        a[i, j], a[i, k] = rng.uniform(0.5, 2.0), -rng.uniform(0.5, 2.0)
        rl[i] = ru[i] = 0.1
    return _dict(a, rng.uniform(0.1, 1, 40), np.full(40, -5.0),
                 np.full(40, 5.0), rl, ru)


def free_col_sub():
    rng = np.random.default_rng(15)
    a = _base(rng, 30, 40)
    rl, ru = _ge_rows(a, rng, slack=5.0)
    lo, up = np.zeros(40), np.full(40, 5.0)
    for i, j in ((27, 38), (28, 39)):
        a[:, j] = 0.0
        a[i, :] = 0.0
        a[i, [j, 3, 6, 10]] = [1.5, 1.0, -2.0, 0.5]
        rl[i] = ru[i] = 1.0
        lo[j], up[j] = -np.inf, np.inf
    return _dict(a, rng.uniform(0.1, 1, 40), lo, up, rl, ru)


def dominated_cols():
    lp = synth_lp(m=300, n=400, seed=5)
    a = lp.a_matrix.to_scipy()
    return _dict(a, lp.col_cost, lp.col_lower, lp.col_upper, lp.row_lower,
                 lp.row_upper)


def sparsify():
    rng = np.random.default_rng(16)
    a = _base(rng, 30, 40, density=0.1)
    rl, ru = _ge_rows(a, rng, slack=5.0)
    # an equality row and two rows that hold a multiple of it
    a[27, :] = 0.0
    a[27, [2, 5, 7, 11]] = [1.0, 2.0, -1.0, 0.5]
    rl[27] = ru[27] = 1.0
    for i, lam in ((28, 3.0), (29, -2.0)):
        a[i, :] = 0.0
        a[i, [2, 5, 7, 11]] = lam * np.array([1.0, 2.0, -1.0, 0.5])
        a[i, 20 + i - 28] = 1.0
    return _dict(a, rng.uniform(0.1, 1, 40), np.full(40, -5.0),
                 np.full(40, 5.0), rl, ru)


def dependent_eqs():
    rng = np.random.default_rng(17)
    a = _base(rng, 30, 40, density=0.1)
    rl, ru = _ge_rows(a, rng, slack=5.0)
    rows = {25: ([1, 3, 8, 13], [1.0, 2.0, -1.0, 1.5]),
            26: ([15, 18, 22, 27], [2.0, -1.0, 1.0, 1.0])}
    x = rng.uniform(0.2, 0.8, 40)
    for i, (cols, vals) in rows.items():
        a[i, :] = 0.0
        a[i, cols] = vals
    a[27, :] = a[25, :].toarray() + 2.0 * a[26, :].toarray()
    for i in (25, 26, 27):
        rl[i] = ru[i] = float((a[i, :].toarray() @ x)[0])
    rl[27] = ru[27] = rl[25] + 2.0 * rl[26]
    return _dict(a, rng.uniform(0.1, 1, 40), np.full(40, -5.0),
                 np.full(40, 5.0), rl, ru)


def mip_set_cover():
    """A set cover whose first column is forced in by a singleton row and
    whose next two are forced out by a forcing row."""
    d = set_cover(nrows=60, ncols=120, density=0.08, seed=3)
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"])).tolil()
    a.resize(62, 120)
    a[60, 0] = 1.0
    a[61, [1, 2]] = 1.0
    return _dict(a, d["col_cost"], d["col_lower"], d["col_upper"],
                 np.append(d["row_lower"], [1.0, -np.inf]),
                 np.append(d["row_upper"], [np.inf, 0.0]),
                 d["integrality"])


CASES = {
    "duplicate_row": parallel_rows,
    "duplicate_col": parallel_cols,
    "forcing_row": forcing_rows,
    "doubleton_eq": doubleton_eqs,
    "free_col_sub": free_col_sub,
    "dominated_col": dominated_cols,
    "sparsify": sparsify,
    "dependent_eq": dependent_eqs,
    "mip": mip_set_cover,
}


def _jax_presolve(d):
    # the reference imports JAX: inside the test, so that the card tests
    # run without it
    import highs_tpu
    from highs_tpu.options import HighsOptions as JOptions
    from highs_tpu.presolve.presolve import presolve_lp as jax_presolve
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    lp = highs_tpu.HighsLp(
        num_col=d["num_col"], num_row=d["num_row"],
        col_cost=np.array(d["col_cost"]), col_lower=np.array(d["col_lower"]),
        col_upper=np.array(d["col_upper"]),
        row_lower=np.array(d["row_lower"]),
        row_upper=np.array(d["row_upper"]),
        a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(a), sense=1,
        integrality=np.array(d.get("integrality", np.zeros(0)),
                             dtype=np.uint8))
    return jax_presolve(lp, JOptions())


def _port_presolve(d, device="cpu"):
    opts = HighsOptions()
    opts._timer = timer = HighsTimer()
    return presolve_lp(lp_from_numpy(d), opts, device), timer


def _same(x, y) -> bool:
    """Equal in type, shape and every bit."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and \
            x.tobytes() == y.tobytes()
    if isinstance(x, (tuple, list)):
        return type(x) is type(y) and len(x) == len(y) and \
            all(_same(p, q) for p, q in zip(x, y))
    if isinstance(x, float) and isinstance(y, float):
        return np.float64(x).tobytes() == np.float64(y).tobytes()
    return type(x) is type(y) and x == y


def _assert_same_result(got, want):
    assert int(got.status) == int(want.status)
    assert got.reduced == want.reduced
    assert len(got.stack) == len(want.stack)
    for k, (g, w) in enumerate(zip(got.stack, want.stack)):
        assert _same(g, w), (k, g, w)
    if not want.reduced:
        return
    gl, wl = got.reduced_lp, want.reduced_lp
    for name in LP_FIELDS:
        assert _same(np.asarray(getattr(gl, name)),
                     np.asarray(getattr(wl, name))), name
    for part in ("start", "index", "value"):
        assert _same(getattr(gl.a_matrix, part),
                     getattr(wl.a_matrix, part)), part
    assert _same(got.keep_rows, want.keep_rows)
    assert _same(got.keep_cols, want.keep_cols)


@pytest.mark.parametrize("family", list(CASES))
def test_device_copy_reduces_like_jax(family):
    d = CASES[family]()
    got, timer = _port_presolve(d)
    if family == "mip":
        # probing runs on its binaries; the reduced MIP keeps integers
        assert timer.num_calls("presolve.probing") >= 1
        assert got.reduced and got.reduced_lp.integrality.any()
    else:
        assert timer.counter("presolve." + family) >= 1
    _assert_same_result(got, _jax_presolve(d))


def test_counters_read_the_copy():
    # presolve edits no entry of the staircase LP: one copy, many reads
    got, timer = _port_presolve(_dict(
        block_lp(nblocks=4).a_matrix.to_scipy(), *_block4_bounds()))
    assert not got.reduced
    assert timer.counter("presolve.device_builds") == 1
    assert timer.counter("presolve.device_sweeps") > 0
    assert timer.num_calls("presolve.upload") == 1
    # doubleton equations substitute entries: the copy is built again
    got, timer = _port_presolve(doubleton_eqs())
    assert timer.counter("presolve.doubleton_eq") >= 1
    assert timer.counter("presolve.device_builds") > 1
    assert timer.num_calls("presolve.upload") == \
        timer.counter("presolve.device_builds")


@pytest.mark.parametrize("presolve", ["off", "on"])
@pytest.mark.parametrize("lower", [1.0, -1.0])
def test_empty_row_check(presolve, lower):
    # row 1 has no entry: bounds that exclude 0 make the LP infeasible,
    # with presolve off too, which counts the rows on the host
    a = sp.csc_matrix(np.array([[1.0, 2.0], [0.0, 0.0], [3.0, -1.0]]))
    d = _dict(a, [1.0, 1.0], [0.0, 0.0], [4.0, 4.0], [-10.0, lower, -10.0],
              [10.0, np.inf, 10.0])
    opts = HighsOptions()
    opts.presolve = presolve
    opts._timer = timer = HighsTimer()
    got = presolve_lp(lp_from_numpy(d), opts, "cpu")
    assert (got.status == HighsModelStatus.kInfeasible) == (lower > 0)
    assert timer.counter("presolve.device_builds") == \
        (1 if presolve == "on" else 0)


def _block4_bounds():
    lp = block_lp(nblocks=4)
    return (lp.col_cost, lp.col_lower, lp.col_upper, lp.row_lower,
            lp.row_upper)


def test_signed_dot_plain_is_csr_matvec():
    _check_signed_dot(torch.device("cpu"), m=500, n=400, density=0.05)


def _check_signed_dot(device, m, n, density):
    """`signed_dot` against scipy's max(A, 0) @ l + min(A, 0) @ u, in
    every bit, on mixed signs, explicit zeros of both signs, values of
    very different sizes and bounds of 0."""
    rng = np.random.default_rng(21)
    a = sp.random(m, n, density=density, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz) * rng.choice([1e-9, 1.0, 1e7],
                                                     a.nnz)
    a.data[::13] = 0.0
    a.data[5::29] = -0.0
    lo = np.where(rng.uniform(size=n) < 0.2, 0.0, rng.standard_normal(n))
    up = lo + np.abs(rng.standard_normal(n)) * 100.0
    pos, neg = a.copy(), a.copy()
    pos.data = np.maximum(pos.data, 0.0)
    neg.data = np.minimum(neg.data, 0.0)
    out = seg.signed_dot(
        torch.from_numpy(a.data).to(device),
        torch.from_numpy(a.indices.astype(np.int32)).to(device),
        torch.from_numpy(a.indptr.astype(np.int64)).to(device),
        torch.from_numpy(lo).to(device), torch.from_numpy(up).to(device))
    got_min = (out[0] + out[1]).cpu().numpy()
    got_max = (out[2] + out[3]).cpu().numpy()
    assert _same(got_min, pos @ lo + neg @ up)
    assert _same(got_max, pos @ up + neg @ lo)


def test_signed_dot_checks_its_inputs():
    v = torch.ones(3, dtype=torch.float64)
    ptr = torch.tensor([0, 3])
    x = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(TypeError):
        seg.signed_dot(v, torch.zeros(3, dtype=torch.int64), ptr, x, x)
    with pytest.raises(ValueError):
        seg.signed_dot(v, torch.zeros(2, dtype=torch.int32), ptr, x, x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the signed segment-sum kernel has "
                    "no CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["block_lp16", "synth_lp2000"])
def test_card_presolve_matches_cpu(cuda_device, name):
    lp = block_lp(nblocks=16) if name == "block_lp16" else \
        synth_lp(m=2000, n=2000, seed=42)
    d = _dict(lp.a_matrix.to_scipy(), lp.col_cost, lp.col_lower,
              lp.col_upper, lp.row_lower, lp.row_upper)
    got, timer = _port_presolve(d, cuda_device)
    want, _ = _port_presolve(d, "cpu")
    _assert_same_result(got, want)
    assert timer.counter("presolve.device_builds") == 1


def test_card_signed_dot_is_csr_matvec(cuda_device):
    launches = seg.SIGNED_LAUNCHES
    _check_signed_dot(cuda_device, m=20000, n=10000, density=0.005)
    assert seg.SIGNED_LAUNCHES == launches + 1
