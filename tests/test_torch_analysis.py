"""The analysis API (`analysis_api.py`, `utils/ranging.py`) of the port's
facade against the JAX package's, on the CPU, on generated LPs
(`utils/gen_synth_lp.py`: min c'x s.t. Ax >= b, 0 <= x <= 10).

Both facades solve these small LPs with the native simplex (`choose`),
so they hold the same optimal basis and the host computations on it
(ranging, κ, the basis solves) agree to 1e-10; the IIS's deletion filter
decides each row by a feasibility LP that the port solves with its IPM
on the facade's device, so the same rows, columns and bound statuses
show that every decision agreed (but for the strategies from the dual
ray, whose filter the JAX package never runs).  Multi-objective and feasibility-
relaxation optima agree to 1e-7 in the objective."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu_torch.utils.gen_synth_lp import synth_lp

torch.set_num_threads(1)

TOL = 1e-10  # host linear algebra on the same basis
RECORDS = ("col_cost_up", "col_cost_dn", "col_bound_up", "col_bound_dn",
           "row_bound_up", "row_bound_dn")


def _jax_lp(lp):
    return highs_tpu.HighsLp(
        num_col=lp.num_col, num_row=lp.num_row,
        col_cost=lp.col_cost.copy(), col_lower=lp.col_lower.copy(),
        col_upper=lp.col_upper.copy(), row_lower=lp.row_lower.copy(),
        row_upper=lp.row_upper.copy(),
        a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(
            lp.a_matrix.to_scipy()),
        sense=int(lp.sense), offset=lp.offset)


def _pair(lp, run=True, **opts):
    """(port facade on the CPU, JAX facade) holding the same LP."""
    port, jax = highs_tpu_torch.Highs(device="cpu"), highs_tpu.Highs()
    for h in (port, jax):
        h.setOptionValue("output_flag", False)
        for k, v in opts.items():
            h.setOptionValue(k, v)
    port.passModel(lp.copy())
    jax.passModel(_jax_lp(lp))
    if run:
        for h in (port, jax):
            h.run()
        assert port.getModelStatus().name == jax.getModelStatus().name
    return port, jax


def _optimal_pair():
    port, jax = _pair(synth_lp(40, 60, per_col=4, seed=3))
    assert port.getModelStatus().name == "kOptimal"
    assert port.getBasis().valid and jax.getBasis().valid
    return port, jax


def _infeasible_lp(m=30, n=40):
    """A generated LP with a contradictory pair of rows added:
    x0 + x1 >= 12 and x0 + x1 <= 8."""
    lp = synth_lp(m, n, per_col=4, seed=5)
    a = sp.vstack([lp.a_matrix.to_scipy(),
                   sp.csc_matrix(([1.0, 1.0, 1.0, 1.0],
                                  ([0, 0, 1, 1], [0, 1, 0, 1])),
                                 shape=(2, n))]).tocsc()
    return highs_tpu_torch.HighsLp(
        num_col=n, num_row=m + 2, col_cost=lp.col_cost,
        col_lower=lp.col_lower, col_upper=lp.col_upper,
        row_lower=np.concatenate([lp.row_lower, [12.0, -np.inf]]),
        row_upper=np.concatenate([lp.row_upper, [np.inf, 8.0]]),
        a_matrix=highs_tpu_torch.HighsSparseMatrix.from_scipy(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


def test_ranging_all_six_records():
    port, jax = _optimal_pair()
    (st, got), (st_j, want) = port.getRanging(), jax.getRanging()
    assert int(st) == int(st_j) == 0
    assert got.valid and want.valid
    for name in RECORDS:
        _close(getattr(got, name).value_, getattr(want, name).value_)
        _close(getattr(got, name).objective_,
               getattr(want, name).objective_)


@pytest.mark.parametrize("n_free", [1, 3])
def test_ranging_with_free_nonbasic_columns(n_free):
    """The ranging of a basis whose nonbasic columns include free ones
    (status kZero: their reduced cost must stay 0, which resets the
    cost ratio test where the JAX package meets them), through both
    packages' `compute_ranging` on the same data."""
    from highs_tpu.utils.ranging import compute_ranging as jax_ranging
    from highs_tpu_torch.utils.ranging import compute_ranging
    port, jax = _optimal_pair()
    basis, jax_basis = port.getBasis(), jax.getBasis()
    lower = [j for j, st in enumerate(basis.col_status) if int(st) == 0]
    for j in lower[3:3 + 4 * n_free:4]:
        basis.col_status[j] = highs_tpu_torch.HighsBasisStatus.kZero
        jax_basis.col_status[j] = highs_tpu.HighsBasisStatus.kZero
    objective = port.getObjectiveValue()
    got = compute_ranging(port.getLp(), port.getSolution(), basis,
                          objective)
    want = jax_ranging(jax.getLp(), jax.getSolution(), jax_basis,
                       objective)
    assert got.valid and want.valid
    for name in RECORDS:
        _close(getattr(got, name).value_, getattr(want, name).value_)
        _close(getattr(got, name).objective_,
               getattr(want, name).objective_)


@pytest.mark.parametrize("strategy", [0, 1, 4, 5, 12, 16])
def test_iis(strategy):
    port, jax = _pair(_infeasible_lp(), iis_strategy=strategy)
    assert port.getModelStatus().name == "kInfeasible"
    (st, got), (st_j, want) = port.getIis(), jax.getIis()
    assert int(st) == int(st_j) == 0
    assert got.valid and want.valid
    if strategy & 1:
        # from the dual ray: the JAX package's filter never runs (it
        # compares getDualRay's has_ray with HighsStatus.kOk, ROADMAP
        # queue 3), so its answer is the one without the ray; the port's
        # rows lie in the ray's support
        _, plain = _pair(_infeasible_lp(), iis_strategy=strategy & ~1)
        assert want.row_index == plain.getIis()[1].row_index
        has_ray, ray = port.getDualRay()
        assert has_ray
        assert all(abs(ray[i]) > 1e-9 for i in got.row_index)
    else:
        assert got.row_index == want.row_index
        assert got.col_index == want.col_index
        assert got.row_bound == want.row_bound
        assert got.col_bound == want.col_bound
    # the rows are an irreducible infeasible subsystem: infeasible
    # together, feasible with any one of them dropped
    lp = port.getLp()
    assert not _feasible_with_rows(lp, got.row_index)
    for i in got.row_index:
        assert _feasible_with_rows(lp, [k for k in got.row_index if k != i])


def _feasible_with_rows(lp, rows):
    """Whether `lp` with every row outside `rows` made free is feasible
    (the port's facade on the CPU)."""
    work = lp.copy()
    free = np.setdiff1d(np.arange(lp.num_row), rows)
    work.row_lower[free], work.row_upper[free] = -np.inf, np.inf
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    h.passModel(work)
    h.run()
    assert h.getModelStatus().name in ("kOptimal", "kInfeasible")
    return h.getModelStatus().name == "kOptimal"


def test_feasibility_relaxation():
    port, jax = _pair(_infeasible_lp(), run=False)
    for h in (port, jax):
        assert int(h.feasibilityRelaxation(1.0, 1.0, 1.0)) == 0
    assert port.getModelStatus().name == jax.getModelStatus().name == \
        "kOptimal"
    got, want = port.getObjectiveValue(), jax.getObjectiveValue()
    assert abs(got - want) <= 1e-7 * (1.0 + abs(want))
    x = np.asarray(port.getSolution().col_value)
    lp = port.getLp()
    assert np.all(x >= lp.col_lower - 1e-7)
    assert np.all(x <= lp.col_upper + 1e-7)


@pytest.mark.parametrize("blend", [True, False])
def test_multi_objective(blend):
    lp = synth_lp(40, 60, per_col=4, seed=3)
    rng = np.random.default_rng(11)
    port, jax = _pair(lp, run=False, blend_multi_objectives=blend)
    c2 = rng.uniform(-1.0, 1.0, lp.num_col)
    for h, pkg in ((port, highs_tpu_torch), (jax, highs_tpu)):
        h.passLinearObjectives([
            pkg.HighsLinearObjective(weight=1.0, priority=10,
                                     coefficients=lp.col_cost.copy(),
                                     abs_tolerance=1e-6, rel_tolerance=0.0),
            pkg.HighsLinearObjective(weight=0.5, priority=1,
                                     coefficients=c2.copy(),
                                     abs_tolerance=1e-6, rel_tolerance=0.0)])
        h.run()
    assert port.getModelStatus().name == jax.getModelStatus().name == \
        "kOptimal"
    got, want = port.getObjectiveValue(), jax.getObjectiveValue()
    assert abs(got - want) <= 1e-7 * (1.0 + abs(want))
    # the temporary rows of the lexicographic solve are gone again
    assert port.getNumRow() == jax.getNumRow() == lp.num_row


@pytest.mark.parametrize("exact", [True, False])
def test_kappa(exact):
    port, jax = _optimal_pair()
    (st, got), (st_j, want) = port.getKappa(exact), jax.getKappa(exact)
    assert int(st) == int(st_j) == 0
    assert got >= 1.0
    assert abs(got - want) <= TOL * want


@pytest.mark.parametrize("constraint,method", [(True, 0), (False, 0),
                                               (True, 1)])
def test_ill_conditioning(constraint, method):
    port, jax = _optimal_pair()
    kw = dict(ill_conditioning_bound=1e2) if method == 1 else {}
    st, got, measure = port.getIllConditioning(constraint, method, **kw)
    st_j, want, measure_j = jax.getIllConditioning(constraint, method, **kw)
    assert int(st) == int(st_j) == 0
    assert abs(measure - measure_j) <= 1e-7 * (1.0 + abs(measure_j))
    norm1 = sum(abs(r.multiplier) for r in got.record)
    assert abs(norm1 - 1.0) < 1e-4
    mags = [abs(r.multiplier) for r in got.record]
    assert mags == sorted(mags, reverse=True)


@pytest.mark.parametrize("method", [
    "getBasisSolve", "getBasisTransposeSolve", "getBasisInverseRow",
    "getBasisInverseCol", "getReducedRow", "getReducedColumn"])
def test_basis_solves(method):
    port, jax = _optimal_pair()
    m = port.getNumRow()
    rng = np.random.default_rng(4)
    if method in ("getBasisSolve", "getBasisTransposeSolve"):
        args = [(rng.standard_normal(m),) for _ in range(3)]
    elif method == "getReducedColumn":
        args = [(j,) for j in (0, 7, port.getNumCol() - 1)]
    else:
        args = [(i,) for i in (0, m // 2, m - 1)]
    for a in args:
        st, got = getattr(port, method)(*a)
        st_j, want = getattr(jax, method)(*a)
        assert int(st) == int(st_j) == 0
        _close(got, want)
    assert port.getBasicVariables()[1] == jax.getBasicVariables()[1]


def test_write_and_read_basis(tmp_path):
    port, jax = _optimal_pair()
    assert int(port.writeBasis(str(tmp_path / "t.bas"))) == 0
    assert int(jax.writeBasis(str(tmp_path / "j.bas"))) == 0
    assert (tmp_path / "t.bas").read_text() == \
        (tmp_path / "j.bas").read_text()
    fresh, _ = _pair(synth_lp(40, 60, per_col=4, seed=3), run=False)
    assert int(fresh.readBasis(str(tmp_path / "j.bas"))) == 0
    assert [int(s) for s in fresh.getBasis().col_status] == \
        [int(s) for s in port.getBasis().col_status]
    assert [int(s) for s in fresh.getBasis().row_status] == \
        [int(s) for s in port.getBasis().row_status]
    (tmp_path / "bad.bas").write_text("HiGHS v2\nInvalid\n")
    assert int(fresh.readBasis(str(tmp_path / "bad.bas"))) == -1
