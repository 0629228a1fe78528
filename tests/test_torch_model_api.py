"""The facade's model-editing API and its own methods, through both
facades: `highs_tpu.Highs` and `highs_tpu_torch.Highs(device="cpu")`.

- The eight tests of tests/test_model_api.py and six of the seven tests
  of tests/test_lp_solve.py that read no instance file, each as one test
  parametrised over the two facades, with the same expected results
  (the seventh, `test_dispatch_boundaries_solve_correctly`, is in
  tests/test_torch_dispatch_boundaries.py).
- `writeSolution` in every style writes the same text from both facades
  for the same solution.
- The rays, `freezeBasis`/`unfreezeBasis` and `presolve`/`postsolve`
  give the same results from both facades on seeded LPs.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

FACADES = ["jax", "torch"]


def _package(facade):
    return highs_tpu if facade == "jax" else highs_tpu_torch


def _highs(facade):
    h = highs_tpu.Highs() if facade == "jax" else \
        highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    return h


# ---------------------------------------------------------------------
# tests/test_model_api.py
# ---------------------------------------------------------------------
def build_small(facade):
    # min -x - 2y s.t. x + y <= 4, x + 3y <= 6; x,y in [0, inf)
    pkg = _package(facade)
    h = _highs(facade)
    inf = pkg.kHighsInf
    assert h.addCol(-1.0, 0.0, inf) == pkg.HighsStatus.kOk
    assert h.addCol(-2.0, 0.0, inf) == pkg.HighsStatus.kOk
    assert h.addRow(-inf, 4.0, 2, [0, 1], [1.0, 1.0]) == pkg.HighsStatus.kOk
    assert h.addRow(-inf, 6.0, 2, [0, 1], [1.0, 3.0]) == pkg.HighsStatus.kOk
    return h


@pytest.mark.parametrize("facade", FACADES)
def test_incremental_build_and_solve(facade):
    pkg = _package(facade)
    h = build_small(facade)
    assert h.getNumCol() == 2
    assert h.getNumRow() == 2
    assert h.getNumNz() == 4
    h.run()
    assert h.getModelStatus() == pkg.HighsModelStatus.kOptimal
    assert abs(h.getObjectiveValue() - (-5.0)) < 1e-6


@pytest.mark.parametrize("facade", FACADES)
def test_change_cost_and_bounds(facade):
    pkg = _package(facade)
    h = build_small(facade)
    h.run()
    assert h.changeColCost(0, -10.0) == pkg.HighsStatus.kOk
    h.run()
    # now optimum pushes x: x=4, y=0 -> -40
    assert abs(h.getObjectiveValue() - (-40.0)) < 1e-5
    assert h.changeColBounds(0, 0.0, 1.0) == pkg.HighsStatus.kOk
    h.run()
    # x=1; x+3y<=6 -> y<=5/3 binds: -10*1 - 2*5/3
    assert abs(h.getObjectiveValue() - (-10.0 - 10.0 / 3.0)) < 1e-5


@pytest.mark.parametrize("facade", FACADES)
def test_change_coeff(facade):
    pkg = _package(facade)
    h = build_small(facade)
    assert h.changeCoeff(1, 1, 1.0) == pkg.HighsStatus.kOk
    st, val = h.getCoeff(1, 1)
    assert val == 1.0
    h.run()
    # rows x+y<=4 and x+y<=6: min -x-2y -> x=0, y=4: -8
    assert abs(h.getObjectiveValue() - (-8.0)) < 1e-5


@pytest.mark.parametrize("facade", FACADES)
def test_delete_col(facade):
    pkg = _package(facade)
    h = build_small(facade)
    assert h.deleteCols(0, 0) == pkg.HighsStatus.kOk  # delete first col
    assert h.getNumCol() == 1
    h.run()
    # only y: min -2y, y <= 4, 3y <= 6 -> y=2 -> -4
    assert abs(h.getObjectiveValue() - (-4.0)) < 1e-6


@pytest.mark.parametrize("facade", FACADES)
def test_delete_row(facade):
    pkg = _package(facade)
    h = build_small(facade)
    assert h.deleteRows(1, 1) == pkg.HighsStatus.kOk
    assert h.getNumRow() == 1
    h.run()
    # only x+y<=4: min -x-2y -> y=4 -> -8
    assert abs(h.getObjectiveValue() - (-8.0)) < 1e-5


@pytest.mark.parametrize("facade", FACADES)
def test_integrality_change(facade):
    pkg = _package(facade)
    h = build_small(facade)
    assert h.changeColsIntegrality(
        2, [0, 1], [pkg.HighsVarType.kInteger, pkg.HighsVarType.kInteger]
    ) == pkg.HighsStatus.kOk
    h.changeColBounds(1, 0.0, 1.5)
    np.testing.assert_array_equal(h.getLp().integrality,
                                  [int(pkg.HighsVarType.kInteger)] * 2)
    assert h.getLp().col_upper[1] == 1.5
    h.run()
    assert h.getModelStatus() == pkg.HighsModelStatus.kOptimal
    sol = h.getSolution()
    assert abs(sol.col_value[1] - round(sol.col_value[1])) < 1e-6


@pytest.mark.parametrize("facade", FACADES)
def test_names(facade):
    pkg = _package(facade)
    h = build_small(facade)
    assert h.passColName(0, "xvar") == pkg.HighsStatus.kOk
    st, name = h.getColName(0)
    assert name == "xvar"
    st, idx = h.getColByName("xvar")
    assert idx == 0


@pytest.mark.parametrize("facade", FACADES)
def test_sense_and_offset(facade):
    pkg = _package(facade)
    h = build_small(facade)
    h.changeObjectiveSense(pkg.ObjSense.kMaximize)
    h.changeObjectiveOffset(5.0)
    assert h.getObjectiveSense() == pkg.ObjSense.kMaximize
    lp = h.getLp()
    lp.col_cost = -lp.col_cost
    h.run()
    assert abs(h.getObjectiveValue() - 10.0) < 1e-5


# ---------------------------------------------------------------------
# tests/test_lp_solve.py, the instance-free tests
# ---------------------------------------------------------------------
def _small_lp(pkg):
    # min -x - 2y  s.t. x + y <= 4, x + 3y <= 6, x,y >= 0
    a = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, 3.0]]))
    return pkg.HighsLp(
        num_col=2, num_row=2,
        col_cost=np.array([-1.0, -2.0]),
        col_lower=np.zeros(2), col_upper=np.array([np.inf, np.inf]),
        row_lower=np.array([-np.inf, -np.inf]),
        row_upper=np.array([4.0, 6.0]),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(a))


def _run(facade, lp):
    h = _highs(facade)
    h.passModel(lp)
    h.run()
    return h


@pytest.mark.parametrize("facade", FACADES)
def test_small_lp(facade):
    pkg = _package(facade)
    h = _run(facade, _small_lp(pkg))
    assert h.getModelStatus() == pkg.HighsModelStatus.kOptimal
    # optimum at x=3, y=1, obj=-5
    assert abs(h.getObjectiveValue() - (-5.0)) < 1e-5
    sol = h.getSolution()
    np.testing.assert_allclose(sol.col_value, [3.0, 1.0], atol=1e-4)
    assert sol.dual_valid


@pytest.mark.parametrize("facade", FACADES)
def test_maximize_sense(facade):
    pkg = _package(facade)
    lp = _small_lp(pkg)
    lp.col_cost = -lp.col_cost
    lp.sense = pkg.ObjSense.kMaximize
    h = _run(facade, lp)
    assert h.getModelStatus() == pkg.HighsModelStatus.kOptimal
    assert abs(h.getObjectiveValue() - 5.0) < 1e-5


def _bound_lp(pkg, cost, lower, upper):
    n = len(cost)
    return pkg.HighsLp(
        num_col=n, num_row=0, col_cost=np.array(cost),
        col_lower=np.array(lower), col_upper=np.array(upper),
        row_lower=np.zeros(0), row_upper=np.zeros(0),
        a_matrix=pkg.HighsSparseMatrix(num_col=n, num_row=0,
                                       start=np.zeros(n + 1,
                                                      dtype=np.int64)))


@pytest.mark.parametrize("facade", FACADES)
def test_bound_lp_no_rows(facade):
    pkg = _package(facade)
    h = _run(facade, _bound_lp(pkg, [1.0, -1.0], [-1.0, -2.0], [5.0, 3.0]))
    assert h.getModelStatus() == pkg.HighsModelStatus.kOptimal
    assert abs(h.getObjectiveValue() - (-1.0 - 3.0)) < 1e-9


@pytest.mark.parametrize("facade", FACADES)
def test_unbounded_lp(facade):
    pkg = _package(facade)
    h = _run(facade, _bound_lp(pkg, [-1.0], [0.0], [np.inf]))
    assert h.getModelStatus() == pkg.HighsModelStatus.kUnbounded


@pytest.mark.parametrize("facade", FACADES)
def test_infeasible_bounds(facade):
    pkg = _package(facade)
    lp = _small_lp(pkg)
    lp.col_lower = np.array([5.0, 0.0])
    lp.col_upper = np.array([4.0, 1.0])
    h = _run(facade, lp)
    assert h.getModelStatus() == pkg.HighsModelStatus.kInfeasible


@pytest.mark.parametrize("facade", FACADES)
def test_empty_model(facade):
    pkg = _package(facade)
    h = _highs(facade)
    h.run()
    assert h.getModelStatus() == pkg.HighsModelStatus.kModelEmpty


# ---------------------------------------------------------------------
# the facade's own methods, both facades on the same seeded LPs
# ---------------------------------------------------------------------
def _seeded_lp(pkg, seed=5, m=40, n=60):
    """A seeded LP with a fixed column and a singleton row, so that
    presolve has something to remove."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=0.1, random_state=rng, format="lil")
    a[m - 1, :] = 0.0
    a[m - 1, 3] = 2.0            # singleton row
    a = a.tocsc()
    r = a @ rng.uniform(0, 1, n)
    lo, up = np.zeros(n), np.full(n, 4.0)
    lo[7] = up[7] = 0.5          # fixed column
    return pkg.HighsLp(
        num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1.0, n),
        col_lower=lo, col_upper=up,
        row_lower=r - np.abs(rng.standard_normal(m)) * 0.1,
        row_upper=np.where(rng.uniform(size=m) < 0.2, r, np.inf),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(a), sense=1)


def _pair(make):
    """The port's and the JAX package's facades loaded with make(pkg)."""
    out = {}
    for facade in FACADES:
        h = _highs(facade)
        h.passModel(make(_package(facade)))
        out[facade] = h
    return out


def test_write_solution_same_text(tmp_path):
    hs = _pair(_seeded_lp)
    texts = {}
    for facade, h in hs.items():
        h.run()
        assert int(h.getModelStatus()) == \
            int(highs_tpu_torch.HighsModelStatus.kOptimal)
        for style in range(-1, 5):
            path = tmp_path / f"{facade}{style}.sol"
            assert int(h.writeSolution(str(path), style)) == 0
            texts[facade, style] = path.read_text()
    for style in range(-1, 5):
        assert texts["torch", style] == texts["jax", style], style
    assert hs["torch"].solutionStatusToString(2) == \
        hs["jax"].solutionStatusToString(2) == "Feasible"


def _infeasible_lp(pkg):
    lp = _seeded_lp(pkg, seed=6)
    # x_0 + x_1 <= -1 over x >= 0
    a = lp.a_matrix.to_scipy().tocsc()
    row = sp.csc_matrix(([1.0, 1.0], ([0, 0], [0, 1])), shape=(1, lp.num_col))
    return pkg.HighsLp(
        num_col=lp.num_col, num_row=lp.num_row + 1, col_cost=lp.col_cost,
        col_lower=lp.col_lower, col_upper=lp.col_upper,
        row_lower=np.append(lp.row_lower, -np.inf),
        row_upper=np.append(lp.row_upper, -1.0),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(
            sp.vstack([a, row], format="csc")), sense=1)


def _unbounded_lp(pkg):
    lp = _seeded_lp(pkg, seed=7)
    # column 0 loses its upper bound and its row entries, and gains -1 cost
    a = lp.a_matrix.to_scipy().tolil()
    a[:, 0] = 0.0
    lp.a_matrix = pkg.HighsSparseMatrix.from_scipy(a.tocsc())
    lp.col_upper[0] = np.inf
    lp.col_cost[0] = -1.0
    return lp


def test_rays_match():
    rays = {}
    for kind, make, status, get in (
            ("dual", _infeasible_lp, "kInfeasible", "getDualRay"),
            ("primal", _unbounded_lp, "kUnbounded", "getPrimalRay")):
        for facade, h in _pair(make).items():
            h.run()
            assert h.getModelStatus().name == status, (kind, facade)
            has, ray = getattr(h, get)()
            assert has, (kind, facade)
            rays[kind, facade] = ray
            # the ray is cached until the model changes
            assert getattr(h, get)()[1] is ray
            if kind == "primal":
                assert h.getDualUnboundednessDirection()[1] is ray
            assert getattr(h, "getDualRay" if kind == "primal"
                           else "getPrimalRay")() == (False, None)
    for kind in ("dual", "primal"):
        np.testing.assert_allclose(rays[kind, "torch"], rays[kind, "jax"],
                                   rtol=0, atol=1e-7)
    # a Farkas certificate of x_0 + x_1 <= -1 over x >= 0: its row carries
    # the ray
    assert abs(rays["dual", "jax"][-1]) > 1e-3


def test_freeze_unfreeze_basis():
    bases = {}
    for facade, h in _pair(_seeded_lp).items():
        assert h.freezeBasis()[0].name == "kError"   # no basis yet
        h.run()
        st, fid = h.freezeBasis()
        assert st.name == "kOk" and fid == 0
        basis0 = [int(s) for s in h.getBasis().col_status]
        h.changeColCost(0, 123.0)
        h.run()
        assert h.frozenBasisAllDataClear().name == "kError"
        assert h.unfreezeBasis(fid).name == "kOk"
        assert [int(s) for s in h.getBasis().col_status] == basis0
        assert h.unfreezeBasis(fid).name == "kError"  # the id is consumed
        assert h.frozenBasisAllDataClear().name == "kOk"
        h.setLogicalBasis()
        logical = h.getBasis()
        bases[facade] = (basis0, [int(s) for s in logical.col_status],
                         [int(s) for s in logical.row_status])
    assert bases["torch"] == bases["jax"]


def test_presolve_postsolve_match():
    got = {}
    for facade, h in _pair(_seeded_lp).items():
        assert int(h.postsolve(None)) == -1     # no presolve yet
        assert int(h.presolve()) == 0
        reduced = h.getPresolvedLp()
        assert h.getPresolvedNumCol() == reduced.num_col < 60
        assert h.getPresolvedNumRow() == reduced.num_row < 40
        assert h.getPresolvedNumNz() == reduced.num_nz
        inner = _highs(facade)
        inner.setOptionValue("presolve", "off")
        inner.passModel(reduced)
        inner.run()
        assert int(h.postsolve(inner.getSolution())) == 0
        sol = h.getSolution()
        got[facade] = (reduced.num_col, reduced.num_row,
                       np.asarray(sol.col_value),
                       h.getInfo().objective_function_value)
        direct = _run(facade, _seeded_lp(_package(facade)))
        assert h.getInfo().objective_function_value == pytest.approx(
            direct.getObjectiveValue(), rel=1e-9)
    assert got["torch"][:2] == got["jax"][:2]
    np.testing.assert_allclose(got["torch"][2], got["jax"][2], rtol=0,
                               atol=1e-9)
    assert got["torch"][3] == pytest.approx(got["jax"][3], rel=1e-12)


def test_facade_helpers_match(tmp_path):
    hs = _pair(_seeded_lp)
    for facade, h in hs.items():
        h.run()
    port, jax = hs["torch"], hs["jax"]
    for name in ("getNumCol", "getNumRow", "getNumNz", "getHessianNumNz",
                 "compilationDate"):
        assert getattr(port, name)() == getattr(jax, name)(), name
    assert port.modelStatusToString(port.getModelStatus()) == \
        jax.modelStatusToString(jax.getModelStatus()) == "Optimal"
    assert int(port.getScaledModelStatus()) == \
        int(jax.getScaledModelStatus())
    assert (port.versionMajor(), port.versionMinor(),
            port.versionPatch()) == tuple(
                int(v) for v in highs_tpu_torch.__version__.split("."))
    for name in ("presolve_time", "presolved_model_num_col"):
        assert port.getRunDataType(name) is jax.getRunDataType(name)
        assert port.getRunDataValue(name) == \
            getattr(port.getRunData(), name)
    # options round trip: write, change, reset, read back
    path = str(tmp_path / "opts.txt")
    port.setOptionValue("time_limit", 12.5)
    assert int(port.writeOptions(path)) == 0
    assert int(port.resetOptions()) == 0
    assert port.getOptionValue("time_limit") == \
        jax.getOptionValue("time_limit")
    assert int(port.readOptions(path)) == 0
    assert port.getOptionValue("time_limit") == 12.5
    # reportSolvedStats: the same lines from both facades
    lines = {}
    for facade, h in hs.items():
        lines[facade] = []
        h.setOptionValue("output_flag", True)
        h.setOptionValue("log_to_console", False)
        h.setOptionValue("timeless_log", True)
        h.setLogCallback(lambda _kind, msg, out=lines[facade]: out.append(msg))
        h.reportSolvedStats()
    assert lines["torch"] == lines["jax"]
    assert "Model status        : Optimal" in lines["torch"]
    # callbacks: start needs a registered callback; a logging callback
    # sees what the facade logs
    want = [line + "\n" for line in lines["torch"]]
    cb_type = highs_tpu_torch.HighsCallbackType.kCallbackLogging
    assert port.startCallback(cb_type).name == "kError"
    seen = []
    port.setCallback(lambda *args: seen.append(args[1]))
    assert port.startCallback(cb_type).name == "kOk"
    port.reportSolvedStats()
    assert seen == want
    assert port.stopCallback(cb_type).name == "kOk"
    port.reportSolvedStats()
    assert len(seen) == len(want)
    # clearSolver keeps the model, clearModel empties it
    assert port.clearSolver().name == "kOk"
    assert port.getModelStatus().name == "kNotset"
    assert port.getNumCol() == 60
    assert port.clear().name == "kOk" and port.getNumCol() == 0
