"""The QP active set (solver "qpasm"): the port against the JAX package
and against the spec, on the CPU.

- The four tests of tests/test_qp_active_set.py that read no instance
  file run as cases of one test, for each package's
  `solve_qp_active_set`.
- The generated QPs `gen_mm_style(7, n, n // 2, "full", 1e4, 0.3, 5 / n)`
  at n = 60 and n = 300 (`utils/gen_mm_qp.py`), through the port's
  facade with solver "qpasm": kOptimal at a point that violates no row
  or bound by more than 1e-7 (`primal_feasibility_tolerance`), with an
  objective within 1e-6 relative of the port's QP IPM; or, where the
  active set cannot conclude, the IPM's answer after the wrapper's
  fallback.  The JAX package breaks this spec: its active set reports
  kOptimal at points that violate their rows by 2.6e-5 (n = 60,
  objective 580.47037 against the IPM's 580.49593) and 2.7e-4 (n = 300,
  5122.1912 against 5123.5086), because its KKT solves keep the
  constraint block's -delta I in the step (see the port's
  `solvers/qp/active_set.py`).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu_torch
from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


class _Package:
    """The names a case needs from one package."""

    def __init__(self, name):
        if name == "jax":
            jax = pytest.importorskip("jax")
            if jax.default_backend() != "cpu":
                pytest.skip("the JAX reference runs on the CPU, as "
                            "tests/conftest.py sets it")
            from highs_tpu import models, options
            from highs_tpu.constants import HighsModelStatus as status
            from highs_tpu.solvers.qp import active_set
        else:
            from highs_tpu_torch import models, options
            from highs_tpu_torch.constants import HighsModelStatus as status
            from highs_tpu_torch.solvers.qp import active_set
        self.HighsLp = models.HighsLp
        self.HighsModel = models.HighsModel
        self.HighsHessian = models.HighsHessian
        self.HighsSparseMatrix = models.HighsSparseMatrix
        self.HighsOptions = options.HighsOptions
        self.status = status
        self.solve = active_set.solve_qp_active_set


def case_pure_box_qp(pkg):
    """min (x-2)^2 + (y+1)^2 over [0,1]^2 -> x=1, y=0: the active set on
    a box-only QP (no rows)."""
    # 1/2 x'Qx + c'x with Q = 2I, c = (-4, 2): == (x-2)^2 + (y+1)^2 - 5
    lp = pkg.HighsLp(
        num_col=2, num_row=0,
        col_cost=np.array([-4.0, 2.0]),
        col_lower=np.zeros(2), col_upper=np.ones(2),
        row_lower=np.zeros(0), row_upper=np.zeros(0),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(sp.csc_matrix((0, 2))))
    hess = pkg.HighsHessian(
        dim=2, start=np.array([0, 1, 2]), index=np.array([0, 1]),
        value=np.array([2.0, 2.0]))
    st, sol, info = pkg.solve(pkg.HighsModel(lp=lp, hessian=hess),
                              pkg.HighsOptions())
    assert st == pkg.status.kOptimal
    np.testing.assert_allclose(sol.col_value, [1.0, 0.0], atol=1e-8)
    # reduced costs: g = Qx + c = (-2, 2); at upper needs mu<=0, lower >=0
    np.testing.assert_allclose(sol.col_dual, [-2.0, 2.0], atol=1e-8)


def case_equality_qp(pkg):
    """min 1/2(x^2+y^2) s.t. x + y = 2 -> x=y=1."""
    lp = pkg.HighsLp(
        num_col=2, num_row=1,
        col_cost=np.zeros(2),
        col_lower=np.full(2, -np.inf), col_upper=np.full(2, np.inf),
        row_lower=np.array([2.0]), row_upper=np.array([2.0]),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(
            sp.csc_matrix(np.array([[1.0, 1.0]]))))
    hess = pkg.HighsHessian(
        dim=2, start=np.array([0, 1, 2]), index=np.array([0, 1]),
        value=np.array([1.0, 1.0]))
    st, sol, info = pkg.solve(pkg.HighsModel(lp=lp, hessian=hess),
                              pkg.HighsOptions())
    assert st == pkg.status.kOptimal
    np.testing.assert_allclose(sol.col_value, [1.0, 1.0], atol=1e-8)
    # y from Qx = A'y -> y = 1
    np.testing.assert_allclose(sol.row_dual, [1.0], atol=1e-8)


def _separable(pkg, n, seed, scale):
    """min 1/2||x||^2 - a'x subject to sum x = 1, -10 <= x <= 10."""
    a = np.random.default_rng(seed).standard_normal(n) * scale
    lp = pkg.HighsLp(
        num_col=n, num_row=1, col_cost=-a,
        col_lower=np.full(n, -10.0), col_upper=np.full(n, 10.0),
        row_lower=np.ones(1), row_upper=np.ones(1),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(
            sp.csc_matrix(np.ones((1, n)))), sense=1)
    hess = pkg.HighsHessian(
        dim=n, start=np.arange(n + 1, dtype=np.int64),
        index=np.arange(n, dtype=np.int64), value=np.ones(n))
    return a, pkg.HighsModel(lp=lp, hessian=hess)


def case_sparse_large_separable(pkg):
    """A 1200-variable separable QP stays sparse end to end: min
    1/2||x - a||^2 subject to sum x = 1 has the closed form
    x = a + (1 - sum a)/n."""
    n = 1200
    a, model = _separable(pkg, n, 9, 0.01)  # small a: no bound activates
    st, sol, info = pkg.solve(model, pkg.HighsOptions())
    assert st == pkg.status.kOptimal
    assert np.allclose(sol.col_value, a + (1.0 - a.sum()) / n, atol=1e-6)


def case_nullspace_limit(pkg):
    """A null space larger than `qp_nullspace_limit` gives kUnknown
    (reference: QpModelStatus::kLargeNullspace, quass.cpp:364)."""
    _, model = _separable(pkg, 60, 4, 1.0)
    opts = pkg.HighsOptions()
    opts.qp_nullspace_limit = 5
    st, sol, info = pkg.solve(model, opts)
    assert st == pkg.status.kUnknown


CASES = {"pure_box_qp": case_pure_box_qp,
         "equality_qp": case_equality_qp,
         "sparse_large_separable": case_sparse_large_separable,
         "nullspace_limit": case_nullspace_limit}


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_active_set_cases(case, package):
    CASES[case](_Package(package))


def _max_violation(lp, x):
    ax = lp.a_matrix.to_scipy() @ x
    return float(max(np.max(lp.row_lower - ax), np.max(ax - lp.row_upper),
                     np.max(lp.col_lower - x), np.max(x - lp.col_upper),
                     0.0))


@pytest.mark.parametrize("n", [60, 300])
def test_qpasm_is_feasible_where_it_says_optimal(n):
    model = mm_qp_model(7, n, n // 2)
    runs = {}
    for solver in ("qpasm", "choose"):
        logged = []
        h = highs_tpu_torch.Highs(device="cpu")
        h.setOptionValue("output_flag", True)
        h.setOptionValue("log_to_console", False)
        h.setLogCallback(lambda _kind, msg: logged.append(msg))
        h.setOptionValue("solver", solver)
        h.passModel(model)
        h.run()
        assert h.getModelStatus() == HighsModelStatus.kOptimal, solver
        x = h.getSolution().col_value
        runs[solver] = dict(obj=h.getObjectiveValue(), x=x, log=logged,
                            viol=_max_violation(model.lp, x),
                            iters=h.getInfo().qp_iteration_count)
    asm, ipm = runs["qpasm"], runs["choose"]
    tol = highs_tpu_torch.HighsOptions().primal_feasibility_tolerance
    assert tol == 1e-7
    assert asm["viol"] <= tol and ipm["viol"] <= tol
    assert asm["obj"] == pytest.approx(ipm["obj"], rel=1e-6)
    if any("falling back to IPM" in msg for msg in asm["log"]):
        # the active set could not conclude: the IPM's answer
        assert asm["iters"] == ipm["iters"]
        np.testing.assert_array_equal(asm["x"], ipm["x"])
