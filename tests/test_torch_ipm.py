"""The interior-point solver: the port against the JAX package on the CPU.

The same seeded inputs, made with numpy, go through the JAX function (on
the CPU in f64, as tests/conftest.py sets it) and the port's
counterpart:

- one predictor-corrector step (`ipm_step`) on the same problem and
  iterate, for the dense Cholesky and the CG route: every state field and
  metric agrees to 1e-10 (1e-8 for CG) relative to the field's largest
  magnitude (at least 1).  A free column makes the step far more
  sensitive to rounding: its Theta is 1 / reg_primal = 1e10, and the JAX
  package's own two backends (jitted and numpy) differ by up to 7e-7 on
  the same step; there the port is held to ten times that spread,
  measured in the test, and never more than 1e-5;
- the starting point, to 1e-10 in the same sense;
- whole solves (`solve_lp_ipm_native`, and `solve_lp_ipm` where the
  dualize path runs): the same status, iterations within 1, objectives
  to 1e-8 relative;
- the native LDL' through the port's binding, the classification of
  infeasible and unbounded LPs, and iCrash (x and the multipliers to
  1e-8);
- the dense routes' scale factors and K, built from K's nonzeros,
  against the dense host formula (kept here) bit for bit, and their
  builds as `DENSE_K` counts them.

The dense route on the card against the CPU is a card-only case; it
skips without one.  On a machine with a card but with JAX on the GPU,
run without the repository's conftest (the JAX-parity cases skip):

    python -m pytest --noconftest tests/test_torch_ipm.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.convert import (ipm_problem_from_numpy,
                                     ipm_state_from_numpy, lp_from_numpy)
from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers import classify, icrash
from highs_tpu_torch.solvers.pdlp.preprocess import preprocess_lp
from highs_tpu_torch.solvers.ipm import banded_chol, solver, wrapper
from highs_tpu_torch.solvers.ipm.sparse_ldl import LdlBlowup, SparseLdl
from highs_tpu_torch.utils.gen_grid_flow_lp import grid_flow_lp
from highs_tpu_torch.utils.gen_synth_lp import synth_lp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

SETTINGS = (1e-4, 0.9, 0.9995, 1e10)
REGS = (1e-10, 1e-10)
STATE_FIELDS = ("x", "xl", "xu", "y", "zl", "zu")
# the most a step with a free column may differ from the JAX package's
FREE_COLUMN_CEILING = 1e-5


@pytest.fixture
def jax_ref():
    """The JAX package's modules, with JAX on the CPU in f64."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX reference runs on the CPU, as "
                    "tests/conftest.py sets it")
    import highs_tpu
    from highs_tpu.options import HighsOptions as JOptions
    from highs_tpu.solvers import classify as jclassify
    from highs_tpu.solvers import icrash as jicrash
    from highs_tpu.solvers.ipm import solver as jsolver
    from highs_tpu.solvers.ipm import wrapper as jwrapper

    class Ref:
        jnp = jax.numpy
        pkg = highs_tpu
        solver = jsolver
        wrapper = jwrapper
        classify = jclassify
        icrash = jicrash

        @staticmethod
        def lp(tlp: HighsLp):
            """The same LP as the JAX package's HighsLp."""
            return highs_tpu.HighsLp(
                num_col=tlp.num_col, num_row=tlp.num_row,
                col_cost=tlp.col_cost.copy(),
                col_lower=tlp.col_lower.copy(),
                col_upper=tlp.col_upper.copy(),
                row_lower=tlp.row_lower.copy(),
                row_upper=tlp.row_upper.copy(),
                a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(
                    tlp.a_matrix.to_scipy()),
                sense=int(tlp.sense), offset=tlp.offset)

        @staticmethod
        def options(**opts):
            o = JOptions()
            for k, v in opts.items():
                setattr(o, k, v)
            return o
    return Ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dense route's device run")
    return torch.device("cuda")


def _options(**opts):
    o = HighsOptions()
    for k, v in opts.items():
        setattr(o, k, v)
    return o


def _problem_dict(free_column=True, seed=11):
    """A standard-form IPM problem as `solve_lp_ipm_native` builds it:
    equality and inequality rows (slacks s >= 0), a fixed column,
    one-sided bounds and, if asked, a free column (else that column is
    bounded below)."""
    rng = np.random.default_rng(seed)
    m_eq, m_in, n = 6, 9, 24
    m = m_eq + m_in
    a = rng.standard_normal((m, n)) * (rng.uniform(size=(m, n)) < 0.5)
    x_feas = rng.uniform(0.5, 1.5, n)
    b = a @ x_feas
    b[m_eq:] -= rng.uniform(0.1, 1.0, m_in)
    c = rng.uniform(-1.0, 1.0, n)
    lo_x, up_x = np.zeros(n), np.full(n, 3.0)
    lo_x[0] = up_x[0] = x_feas[0]   # fixed
    up_x[1] = np.inf
    if free_column:
        lo_x[1] = -np.inf
    up_x[2] = np.inf
    lo_x[3] = -np.inf
    is_ineq = (np.arange(m) >= m_eq).astype(np.float64)
    lo = np.concatenate([lo_x, np.zeros(m)])
    up = np.concatenate([up_x, np.where(is_ineq > 0, np.inf, 0.0)])
    fixed = np.zeros(n + m, dtype=bool)
    fixed[0] = True
    fixed[n:] = is_ineq == 0
    return dict(
        a=a, b=b, c=c, slack_mask=is_ineq,
        lo=np.where(np.isfinite(lo), lo, -1e30),
        up=np.where(np.isfinite(up), up, 1e30),
        lo_fin=(np.isfinite(lo) & ~fixed).astype(np.float64),
        up_fin=(np.isfinite(up) & ~fixed).astype(np.float64),
        active=(~fixed).astype(np.float64),
        norm_c=np.linalg.norm(c), norm_b=np.linalg.norm(b))


def _rel_diff(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    return float(np.max(np.abs(got - want), initial=0.0)) / scale


def _assert_close(got, want, rtol, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol:g} * {scale:.3e}"


def _jax_problem(ref, d):
    return ref.solver.IpmProblem(**{k: ref.jnp.asarray(v)
                                    for k, v in d.items()})


def test_starting_point_matches_jax(jax_ref):
    d = _problem_dict()
    jstate = jax_ref.solver._starting_point(_jax_problem(jax_ref, d))
    tstate = solver.starting_point(ipm_problem_from_numpy(d, device="cpu"))
    for name in STATE_FIELDS:
        _assert_close(getattr(tstate, name), getattr(jstate, name), 1e-10,
                      name)


@pytest.mark.parametrize("newton,rtol", [("chol", 1e-10), ("cg", 1e-8)])
@pytest.mark.parametrize("warm_steps", [0, 4])
@pytest.mark.parametrize("free_column", [False, True],
                         ids=["bounded", "free"])
def test_ipm_step_matches_jax(jax_ref, newton, rtol, warm_steps,
                              free_column):
    """One step from the starting point, and one from the iterate after
    four JAX steps (where Theta has spread)."""
    d = _problem_dict(free_column)
    jp = _jax_problem(jax_ref, d)
    jstate = jax_ref.solver._starting_point(jp)
    regs = jax_ref.jnp.asarray(REGS)
    for _ in range(warm_steps):
        jstate, _ = jax_ref.solver.ipm_step(jp, jstate, regs, SETTINGS,
                                            "chol")
    jnew, jmet = jax_ref.solver.ipm_step(jp, jstate, regs, SETTINGS, newton)
    host = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    # the JAX package's numpy backend on the same step: the step's own
    # sensitivity to the order of rounding
    nnew, nmet = jax_ref.solver.ipm_step_np(
        jax_ref.solver.IpmProblem(**d), jax_ref.solver.IpmState(**host),
        np.asarray(REGS), SETTINGS, newton)
    tnew, tmet = solver.ipm_step(ipm_problem_from_numpy(d, device="cpu"),
                                 ipm_state_from_numpy(host, device="cpu"),
                                 REGS, SETTINGS, newton)
    fields = [(getattr(tnew, f), getattr(nnew, f), getattr(jnew, f), f)
              for f in STATE_FIELDS] + \
        [(getattr(tmet, f), getattr(nmet, f), getattr(jmet, f), f)
         for f in solver.IpmMetrics._fields]
    spread = max(_rel_diff(n, j) for _, n, j, _ in fields)
    print(f"JAX jitted vs numpy step: {spread:.3e}")
    if not free_column:
        assert spread <= rtol / 10
    # the limit follows the reference's own spread, up to a fixed ceiling
    limit = min(max(rtol, 10 * spread), FREE_COLUMN_CEILING)
    for t, _, j, name in fields:
        _assert_close(t, j, limit, name)


def test_pcg_stops_by_the_jax_rule(jax_ref):
    """The port's CG against jax.scipy.sparse.linalg.cg on one SPD
    system, at a tolerance it reaches before maxiter (so the stopping
    iteration matters) and at one it never reaches."""
    import jax.scipy.sparse.linalg as jla
    rng = np.random.default_rng(3)
    g = rng.standard_normal((40, 40))
    mat = g @ g.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    diag = np.diag(mat).copy()
    tm, tb, td = (torch.as_tensor(v) for v in (mat, b, diag))
    jm, jb, jd = (jax_ref.jnp.asarray(v) for v in (mat, b, diag))
    for tol, maxiter in ((1e-6, 400), (1e-14, 30)):
        want, _ = jla.cg(lambda v: jm @ v, jb, M=lambda v: v / jd,
                         tol=tol, maxiter=maxiter)
        got = solver.pcg(lambda v: tm @ v, tb, lambda v: v / td, tol=tol,
                         maxiter=maxiter, check_every=4)
        _assert_close(got, want, 1e-12, f"cg tol {tol:g}")


def _mixed_lp(seed=0, m=60, n=90):
    """A small LP with equality, inequality and ranged rows, a fixed,
    a free and a one-sided column."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=0.1, random_state=rng, format="csc")
    r = a @ rng.uniform(0, 1, n)
    rl = np.where(rng.uniform(size=m) < 0.3, r,
                  r - np.abs(rng.standard_normal(m)))
    ru = np.where(rng.uniform(size=m) < 0.3, r + 1.0, np.inf)
    ru = np.where(rng.uniform(size=m) < 0.2, r, ru)
    rl = np.where(ru == r, r, rl)
    lo, up = np.zeros(n), np.full(n, 5.0)
    lo[3] = up[3] = 0.7
    lo[5], up[5] = -np.inf, np.inf
    up[6] = np.inf
    return lp_from_numpy(dict(
        num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1, n),
        col_lower=lo, col_upper=up, row_lower=rl, row_upper=ru,
        a_start=a.indptr, a_index=a.indices, a_value=a.data))


def _tall_lp(seed=1, m=400, n=20):
    """m >= 10 n: the wrapper solves the bounded-variable dual."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=0.3, random_state=rng, format="csc")
    r = a @ rng.uniform(0, 1, n)
    return lp_from_numpy(dict(
        num_col=n, num_row=m, col_cost=rng.uniform(-1, 1, n),
        col_lower=np.zeros(n), col_upper=np.full(n, 4.0),
        row_lower=np.full(m, -np.inf), row_upper=r + 0.5,
        a_start=a.indptr, a_index=a.indices, a_value=a.data))


SOLVES = {
    "dense": (_mixed_lp, {}, "native"),
    "grid40-ldl": (lambda: grid_flow_lp(40), {"tpu_ipm_newton": "ldl"},
                   "native"),
    "tall-dualize": (_tall_lp, {}, "wrapper"),
    "centring": (_mixed_lp, {"run_centring": True}, "native"),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_whole_solve_matches_jax(jax_ref, case):
    make, opts, entry = SOLVES[case]
    lp = make()
    if case.startswith("grid"):
        from test_sparse_ipm import _grid_flow_lp
        jgrid = _grid_flow_lp(40)
        assert (jgrid.a_matrix.to_scipy() != lp.a_matrix.to_scipy()).nnz == 0
        np.testing.assert_array_equal(jgrid.row_lower, lp.row_lower)
        np.testing.assert_array_equal(jgrid.col_cost, lp.col_cost)
    if entry == "native":
        jst, _, jinfo = jax_ref.solver.solve_lp_ipm_native(
            jax_ref.lp(lp), jax_ref.options(**opts))
        tst, tsol, tinfo = solver.solve_lp_ipm_native(
            lp, _options(**opts), device="cpu")
    else:
        jst, _, jinfo = jax_ref.wrapper.solve_lp_ipm(
            jax_ref.lp(lp), jax_ref.options(**opts))
        tst, tsol, tinfo = wrapper.solve_lp_ipm(lp, _options(**opts),
                                                device="cpu")
    print(f"{case}: JAX {int(jst)} {jinfo.iterations} iterations "
          f"{jinfo.primal_obj!r}; port {int(tst)} {tinfo.iterations} "
          f"{tinfo.primal_obj!r} ({tinfo.newton})")
    assert int(tst) == int(jst) == int(HighsModelStatus.kOptimal)
    assert abs(tinfo.iterations - jinfo.iterations) <= 1
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-8 * max(1.0, abs(jinfo.primal_obj))
    if case == "grid40-ldl":
        assert tinfo.newton == "ldl"
    if case == "tall-dualize":
        # the dual LP has one row per column of the tall LP
        assert len(tsol.col_value) == lp.num_col


def test_banded_caches_follow_the_pattern_and_the_solve(monkeypatch):
    """The banded structure is cached by K's pattern: an LP with the same
    pattern and new data reuses it, a new pattern builds its own.  A
    precision-gate rejection (the first Newton solve of a banded factor
    missing `BANDED_RESIDUAL`) lasts one solve: the next solve of the same
    pattern tries the banded factor again.  A pattern found not banded
    stays so.  Every iteration is factored by the banded factor or by
    SuperLU, never by the native LDL'."""
    monkeypatch.setattr(solver, "LARGE_M_ROWS", 0)
    for name, empty in (("_BANDED_CACHE", {}), ("_BANDED_REJECT", set()),
                        ("_BANDED_GATED", set())):
        monkeypatch.setattr(solver, name, empty)
    built, superlu = [], []
    from_spd = banded_chol.BandedCholesky.from_spd
    splu = solver.spla.splu

    def counted_from_spd(*args, **kwargs):
        built.append(1)
        return from_spd(*args, **kwargs)

    def counted_splu(*args, **kwargs):
        superlu.append(1)
        return splu(*args, **kwargs)
    monkeypatch.setattr(banded_chol.BandedCholesky, "from_spd",
                        staticmethod(counted_from_spd))
    monkeypatch.setattr(solver.spla, "splu", counted_splu)

    def run(lp):
        """Banded factors and structures built by one solve."""
        counts0 = dict(solver.SPARSE_FACTORS)
        handoffs0 = solver.BANDED_HANDOFFS["gate"]
        built0, superlu0 = len(built), len(superlu)
        st, _, info = solver.solve_lp_ipm_native(
            lp, _options(tpu_ipm_newton="ldl"), device="cpu")
        assert int(st) == int(HighsModelStatus.kOptimal)
        assert info.newton == "ldl"
        grew = {k: solver.SPARSE_FACTORS[k] - counts0[k] for k in counts0}
        factors = grew["banded_cpu"]
        # the iteration whose banded factor failed the gate also ran
        # SuperLU, and counts one hand-off
        gated = len(solver._BANDED_GATED)
        assert solver.BANDED_HANDOFFS["gate"] - handoffs0 == gated
        assert grew["superlu"] == len(superlu) - superlu0
        assert factors - gated + len(superlu) - superlu0 == info.iterations
        assert grew["ldl"] == grew["banded_cuda"] == 0
        return factors, len(built) - built0

    assert run(grid_flow_lp(20))[0] >= 1
    (key, dev), = solver._BANDED_CACHE
    structure = solver._BANDED_CACHE[(key, dev)]
    assert dev == torch.device("cpu") and not solver._BANDED_REJECT

    # same pattern, new supplies and costs: the cached structure serves
    factors, new = run(grid_flow_lp(20, seed=6))
    assert factors >= 1 and new == 0
    assert solver._BANDED_CACHE == {(key, dev): structure}

    # a gate failure hands this solve to SuperLU after one factor: a
    # band solve 1% off leaves a residual of 1e-6 after the host's two
    # refinement rounds, which the first Newton solve's gate reads ...
    solve = banded_chol.BandedCholesky.solve
    with monkeypatch.context() as patch:
        patch.setattr(banded_chol.BandedCholesky, "solve",
                      lambda self, v: 1.01 * solve(self, v))
        assert run(grid_flow_lp(20)) == (1, 0)
    assert solver._BANDED_GATED == {key}
    # ... and the next solve of the pattern tries the device again
    factors, new = run(grid_flow_lp(20))
    assert factors >= 1 and new == 0

    # a new pattern misses the cache and builds its own structure
    factors, new = run(grid_flow_lp(21))
    assert factors >= 1 and new == 1
    (key21, _), = solver._BANDED_CACHE
    assert key21 != key

    # a pattern found not banded goes to SuperLU, in this solve and later
    with monkeypatch.context() as patch:
        patch.setattr(banded_chol.BandedCholesky, "from_spd",
                      staticmethod(lambda *a, **k: built.append(1)))
        assert run(grid_flow_lp(22)) == (0, 1)
        assert run(grid_flow_lp(22, seed=6)) == (0, 0)
    assert len(solver._BANDED_REJECT) == 1


def test_dense_route_on_card_matches_cpu(cuda_device):
    lp = synth_lp(600, 1500, per_col=8)
    before = dict(solver.DENSE_FACTORS)
    runs = {dev: solver.solve_lp_ipm_native(lp, _options(), device=dev)
            for dev in (cuda_device, "cpu")}
    (cst, _, cinfo), (hst, _, hinfo) = runs[cuda_device], runs["cpu"]
    assert int(cst) == int(hst) == int(HighsModelStatus.kOptimal)
    assert cinfo.newton == "chol"
    assert abs(cinfo.iterations - hinfo.iterations) <= 1
    assert abs(cinfo.primal_obj - hinfo.primal_obj) <= \
        1e-8 * max(1.0, abs(hinfo.primal_obj))
    # every iteration factored its normal matrix on the card
    assert solver.DENSE_FACTORS["cuda"] - before["cuda"] >= \
        cinfo.iterations


def _dense_factor_run(device):
    lp = grid_flow_lp(40)
    opts = {"tpu_ipm_newton": "dense_m"}
    dense0 = dict(solver.DENSE_FACTORS)
    sparse0 = dict(solver.SPARSE_FACTORS)
    st, _, info = solver.solve_lp_ipm_native(lp, _options(**opts),
                                             device=device)
    kind = torch.device(device).type
    assert int(st) == int(HighsModelStatus.kOptimal)
    assert info.newton == "dense_m"
    # every factor a dense one on the device, none on the host
    assert solver.DENSE_FACTORS[kind] - dense0[kind] >= info.iterations
    grew = {k: solver.SPARSE_FACTORS[k] - sparse0[k] for k in sparse0}
    assert grew == {**dict.fromkeys(grew, 0),
                    "dense_" + kind: info.iterations}
    return info


def test_dense_factor_on_the_sparse_route(jax_ref):
    """The "dense_m" route (M assembled sparse on the host as on the
    "ldl" route, factored dense on the iterate's device) gives the JAX
    package's "ldl" iterations and objective on the grid flow."""
    info = _dense_factor_run("cpu")
    _, _, jinfo = jax_ref.solver.solve_lp_ipm_native(
        jax_ref.lp(grid_flow_lp(40)),
        jax_ref.options(tpu_ipm_newton="ldl"))
    assert abs(info.iterations - jinfo.iterations) <= 1
    assert abs(info.primal_obj - jinfo.primal_obj) <= \
        1e-8 * max(1.0, abs(jinfo.primal_obj))


def test_dense_factor_on_the_card_matches_the_host_ldl(cuda_device):
    """On a card the "dense_m" route factors M dense there; the CPU's
    host LDL' gives the same solve."""
    info = _dense_factor_run(cuda_device)
    _, _, hinfo = solver.solve_lp_ipm_native(
        grid_flow_lp(40), _options(tpu_ipm_newton="ldl"), device="cpu")
    assert abs(info.iterations - hinfo.iterations) <= 1
    assert abs(info.primal_obj - hinfo.primal_obj) <= \
        1e-8 * max(1.0, abs(hinfo.primal_obj))


def _host_scaled_k(a: sp.spmatrix):
    """The dense route's scaling as the host once built it: K dense,
    geometric-mean factors of its rows, then of the row-scaled columns,
    and row_s[:, None] * K * col_s[None, :]."""
    a_np = a.toarray()

    def geo(mat, axis):
        amax = mat.max(axis=axis, initial=0.0)
        amin = np.where(mat > 0, mat, np.inf).min(axis=axis, initial=np.inf)
        ok = (amax > 0) & np.isfinite(amin)
        with np.errstate(invalid="ignore"):
            return np.where(ok, 1.0 / np.sqrt(np.where(ok, amax * amin, 1.0)),
                            1.0)
    row_s = geo(np.abs(a_np), 1)
    col_s = geo(np.abs(row_s[:, None] * a_np), 0)
    return row_s, col_s, row_s[:, None] * a_np * col_s[None, :]


def _row_kinds_lp(seed=3, m=80, n=120):
    """Equality, ranged, <= and >= rows: the standard form gains slack
    columns for the ranged rows and flips the signs of the <= rows."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=0.08, random_state=rng, format="csc",
                  data_rvs=rng.standard_normal)
    r = a @ rng.uniform(0, 1, n)
    kind = np.arange(m) % 4
    rl = np.where(kind == 2, -np.inf, r - np.where(kind == 1, 1.0, 0.5))
    rl = np.where(kind == 0, r, rl)
    ru = np.where(kind == 3, np.inf, r + np.where(kind == 1, 1.0, 0.5))
    ru = np.where(kind == 0, r, ru)
    return lp_from_numpy(dict(
        num_col=n, num_row=m, col_cost=rng.uniform(-1, 1, n),
        col_lower=np.zeros(n), col_upper=np.full(n, 3.0), row_lower=rl,
        row_upper=ru, a_start=a.indptr, a_index=a.indices, a_value=a.data))


def _empty_lines_k():
    """The standard form of an LP with an empty row and an empty column,
    with an explicitly stored zero added to K."""
    rng = np.random.default_rng(5)
    a = sp.random(30, 40, density=0.15, random_state=rng, format="lil")
    a[7, :] = 0.0
    a[:, 11] = 0.0
    a = a.tocsc()
    lp = lp_from_numpy(dict(
        num_col=40, num_row=30, col_cost=rng.uniform(0.1, 1, 40),
        col_lower=np.zeros(40), col_upper=np.ones(40),
        row_lower=np.zeros(30), row_upper=np.full(30, np.inf),
        a_start=a.indptr, a_index=a.indices, a_value=a.data))
    k = preprocess_lp(lp).a.tocsr()
    # the zero goes into row 0, in a column that row holds nothing in,
    # other than the empty one
    j = np.setdiff1d(np.arange(40),
                     np.append(k.indices[k.indptr[0]:k.indptr[1]], 11))[0]
    coo = k.tocoo()
    return sp.csr_matrix((np.append(coo.data, 0.0),
                          (np.append(coo.row, 0), np.append(coo.col, j))),
                         shape=k.shape)


def _standard_k(case):
    if case == "synth240":
        return preprocess_lp(synth_lp(240, 2000, seed=7)).a
    if case == "row_kinds":
        lp = _row_kinds_lp()
        std = preprocess_lp(lp)
        assert std.num_col > lp.num_col  # slack columns
        assert (lp.row_lower == -np.inf).any()  # sign flips
        return std.a
    k = _empty_lines_k()
    assert (np.diff(k.indptr) == 0).any()  # the empty row
    assert (np.diff(k.tocsc().indptr) == 0).any()  # the empty column
    assert (k.data == 0.0).any()  # the stored zero
    return k


@pytest.mark.parametrize("case", ["synth240", "row_kinds", "empty_lines"])
def test_dense_k_from_nonzeros_is_the_host_formula(case):
    """The dense routes' scale factors and K, built from the nonzeros
    (K scattered on the device), are the host formula's bit for bit."""
    a = _standard_k(case)
    want_r, want_c, want_k = _host_scaled_k(a)
    row_s, col_s, a_sc, k = solver.scaled_dense_k(a, "cpu")
    assert np.array_equal(row_s, want_r)
    assert np.array_equal(col_s, want_c)
    assert k.dtype == torch.float64 and k.device.type == "cpu"
    assert torch.equal(k, torch.as_tensor(want_k))
    assert np.array_equal(a_sc.toarray(), want_k)


def test_dense_k_on_the_card_is_the_cpu_build(cuda_device):
    for case in ("synth240", "row_kinds", "empty_lines"):
        a = _standard_k(case)
        on_card = solver.scaled_dense_k(a, cuda_device)[3]
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu(), solver.scaled_dense_k(a, "cpu")[3])


@pytest.mark.parametrize("route,builds", [
    ("chol", 1), ("cg", 1), ("ldl", 0), ("dense_m", 0), ("batch_nodes", 1)])
def test_dense_k_counts_its_builds(route, builds):
    """`DENSE_K` counts one build a dense-route solve ("chol", the dense
    "cg" branch) and one a batched node evaluator, none on the sparse
    routes."""
    from highs_tpu_torch.solvers.mip.batch_nodes import BatchNodeEvaluator
    lp = _mixed_lp(seed=2, m=40, n=60)
    before = dict(solver.DENSE_K)
    if route == "batch_nodes":
        BatchNodeEvaluator(lp, device="cpu")
    else:
        opt = "cholesky" if route == "chol" else route
        st, _, info = solver.solve_lp_ipm_native(
            lp, _options(tpu_ipm_newton=opt), device="cpu")
        assert int(st) == int(HighsModelStatus.kOptimal)
        assert info.newton == route
    assert solver.DENSE_K == dict(before, cpu=before["cpu"] + builds)


def _cover_lp(nrows, ncols, seed=0):
    """The LP relaxation of a seeded set cover: its normal matrix fills
    in completely."""
    rng = np.random.default_rng(seed)
    a = sp.random(nrows, ncols, density=0.05, random_state=rng,
                  data_rvs=np.ones, format="csc")
    return HighsLp(
        num_col=ncols, num_row=nrows,
        col_cost=rng.integers(1, 101, ncols).astype(float),
        col_lower=np.zeros(ncols), col_upper=np.ones(ncols),
        row_lower=np.ones(nrows), row_upper=np.full(nrows, np.inf),
        a_matrix=HighsSparseMatrix.from_scipy(a))


@pytest.mark.parametrize("case", ["grid", "cover"])
def test_choose_takes_dense_m_where_the_factor_fills_in(case):
    """Between the dense route's 2,500 rows and the banded engine's
    20,000, `choose` reads the symbolic LDL' fill of M: a grid flow's
    (1.3% of the triangle) stays on the host LDL', a set cover's (all of
    it) takes "dense_m"; either way the optimum is scipy's."""
    from scipy.optimize import linprog
    lp = grid_flow_lp(52) if case == "grid" else _cover_lp(2600, 300)
    assert lp.num_row > 2500
    fills_in = solver._fills_in(preprocess_lp(lp).a)
    st, sol, info = solver.solve_lp_ipm_native(lp, _options(),
                                               device="cpu")
    assert fills_in == (case == "cover")
    assert info.newton == ("dense_m" if fills_in else "ldl")
    assert int(st) == int(HighsModelStatus.kOptimal)
    a = lp.a_matrix.to_scipy()
    if case == "grid":
        ref = linprog(lp.col_cost, A_eq=a, b_eq=lp.row_lower,
                      bounds=list(zip(lp.col_lower, lp.col_upper)))
    else:
        ref = linprog(lp.col_cost, A_ub=-a, b_ub=-lp.row_lower,
                      bounds=(0, 1))
    assert ref.status == 0
    assert abs(info.primal_obj - ref.fun) <= 1e-6 * max(1.0, abs(ref.fun))


def _spd(n, seed=0, density=0.01):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csc")
    m = (a @ a.T + sp.identity(n) * (n * density + 1.0)).tocsc()
    m.sum_duplicates()
    return m


@pytest.mark.parametrize("case", ["solve", "refactor", "blowup"])
def test_sparse_ldl_binding(case):
    """The native LDL' through the port's own binding."""
    if case == "blowup":
        # a near-dense pattern with a tiny work budget aborts cleanly
        with pytest.raises(LdlBlowup):
            SparseLdl(_spd(200, seed=4, density=0.5), max_work=10)
        return
    m = _spd(400, seed=1)
    h = SparseLdl(m)
    if case == "refactor":
        m = m.copy()
        m.data = m.data * 2.0
        assert h.matches(m)
        h.factor(m)
    rng = np.random.default_rng(2)
    for _ in range(3):
        b = rng.standard_normal(400)
        assert np.linalg.norm(m @ h.solve(b) - b) <= \
            1e-10 * np.linalg.norm(b)
    with pytest.raises(ValueError):
        h.solve(np.ones(399))


def _infeasible_lp():
    # rows 0 and 1 hold the same coefficients: a'x >= r0 + 1, a'x <= r0
    rng = np.random.default_rng(1)
    m, n = 40, 50
    a = sp.random(m, n, density=0.1, random_state=rng, format="lil")
    a[1, :] = a[0, :]
    a[0, 0] = a[1, 0] = 1.0
    a = a.tocsc()
    r = a @ rng.uniform(0, 1, n)
    rl, ru = r - 1, np.full(m, np.inf)
    rl[0], rl[1], ru[1] = r[0] + 1, -np.inf, r[0]
    return lp_from_numpy(dict(
        num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1, n),
        col_lower=np.zeros(n), col_upper=np.full(n, 5.0), row_lower=rl,
        row_upper=ru, a_start=a.indptr, a_index=a.indices, a_value=a.data))


def _unbounded_lp():
    # column 0 costs -1, has no upper bound, and only helps its >= rows
    rng = np.random.default_rng(2)
    m, n = 40, 50
    a = abs(sp.random(m, n, density=0.1, random_state=rng, format="csc"))
    r = a @ rng.uniform(0, 1, n)
    c = rng.uniform(0.1, 1, n)
    c[0] = -1.0
    up = np.full(n, 5.0)
    up[0] = np.inf
    return lp_from_numpy(dict(
        num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
        col_upper=up, row_lower=r - 0.5, row_upper=np.full(m, np.inf),
        a_start=a.indptr, a_index=a.indices, a_value=a.data))


@pytest.mark.parametrize("make,want", [
    (_infeasible_lp, HighsModelStatus.kInfeasible),
    (_unbounded_lp, HighsModelStatus.kUnbounded)],
    ids=["infeasible", "unbounded"])
def test_classify_inconclusive_matches_jax(jax_ref, make, want):
    lp = make()
    jverdict = jax_ref.classify.classify_inconclusive(
        jax_ref.lp(lp), jax_ref.options())
    verdict = classify.classify_inconclusive(lp, _options(), device="cpu")
    assert int(verdict) == int(jverdict) == int(want)


@pytest.mark.parametrize("shape", [(120, 150), (2100, 2000)],
                         ids=["dense", "sparse"])
def test_run_icrash_matches_jax(jax_ref, shape):
    """iCrash with a dense A (n m <= 4 M) and a sparse one."""
    lp = _mixed_lp(seed=4, m=shape[0], n=shape[1]) if shape[0] < 1000 \
        else synth_lp(shape[0], shape[1], per_col=4, seed=9)
    opts = dict(icrash_iterations=12, icrash_approx_iter=30)
    jinfo = jax_ref.icrash.run_icrash(jax_ref.lp(lp),
                                      jax_ref.options(**opts))
    tinfo = icrash.run_icrash(lp, _options(**opts), device="cpu")
    assert tinfo.num_iterations == jinfo.num_iterations
    _assert_close(tinfo.x, jinfo.x, 1e-8, "x")
    _assert_close(tinfo.lambda_, jinfo.lambda_, 1e-8, "lambda")
    assert abs(tinfo.final_residual_norm2 - jinfo.final_residual_norm2) \
        <= 1e-8 * max(1.0, jinfo.final_residual_norm2)
