"""The convex QP path: the port against the JAX package on the CPU.

The QPs come from `highs_tpu_torch/utils/gen_mm_qp.py` (a copy of the
JAX package's `tools/qp_sweep.py` generator) at n = 60 and n = 300,
seed 7, and go through the JAX function (on the CPU in f64, as
tests/conftest.py sets it) and the port's counterpart:

- one step of the QP IPM (`qp_ipm_step`) on the problem and iterates
  that the JAX package's own solve builds (recorded at its first and its
  sixth iteration): every state field and metric agrees to 1e-10
  relative to the field's largest magnitude (at least 1);
- whole solves (`solve_qp_ipm`): the same status and iterations,
  objectives to 1e-9 relative and `col_value` to 1e-7;
- through both facades: a maximised QP, an MIQP (kError), a Hessian of
  the wrong dimension (kError), and a seeded infeasible and a seeded
  unbounded QP (the same status, found by the classification LPs).

The QP on the card against the CPU is a card-only case; it skips
without one.  On a machine with a card but with JAX on the GPU, run
without the repository's conftest (the JAX-parity cases skip):

    python -m pytest --noconftest tests/test_torch_qp.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu_torch
from highs_tpu_torch.constants import HighsModelStatus, HighsStatus
from highs_tpu_torch.convert import (qp_ipm_problem_from_numpy,
                                     qp_ipm_state_from_numpy)
from highs_tpu_torch.models.lp import HighsModel
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.qp import ipm_qp
from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model, status_qp_model

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

SIZES = [60, 300]
STATE_FIELDS = ("x", "xl", "xu", "y", "zl", "zu")
# the JAX QP IPM's step settings (ipm_qp.py:248-249)
SETTINGS = (1e-4, 0.9, 0.9995, 1e10)
# the iterations whose arguments are recorded from the JAX solve
RECORDED = (1, 6)


@pytest.fixture
def jax_ref():
    """The JAX package, with JAX on the CPU in f64."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX reference runs on the CPU, as "
                    "tests/conftest.py sets it")
    import highs_tpu
    return highs_tpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the QP IPM's device run")
    return torch.device("cuda")


def _jax_model(pkg, model: HighsModel):
    """The same model as the JAX package's HighsModel."""
    lp = model.lp
    jlp = pkg.HighsLp(
        num_col=lp.num_col, num_row=lp.num_row,
        col_cost=lp.col_cost.copy(), col_lower=lp.col_lower.copy(),
        col_upper=lp.col_upper.copy(), row_lower=lp.row_lower.copy(),
        row_upper=lp.row_upper.copy(),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(lp.a_matrix.to_scipy()),
        sense=int(lp.sense), offset=lp.offset,
        integrality=lp.integrality.copy())
    h = model.hessian
    return pkg.HighsModel(lp=jlp, hessian=pkg.HighsHessian(
        dim=h.dim, start=h.start.copy(), index=h.index.copy(),
        value=h.value.copy()))


def _assert_close(got, want, rtol, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol:g} * {scale:.3e}"


def _recorded_jax_steps(pkg, monkeypatch, n):
    """The (problem, state, regs) that the JAX package's `solve_qp_ipm`
    hands its step at the iterations of RECORDED, as numpy, and the
    step's result there."""
    import jax
    from highs_tpu.options import HighsOptions as JOptions
    from highs_tpu.solvers.qp import ipm_qp as jipm
    real_step = jipm.qp_ipm_step
    calls, recorded = [], []

    def host(tree):
        return {k: np.asarray(v)
                for k, v in jax.device_get(tree)._asdict().items()}

    def step(problem, state, regs, settings):
        new_state, metrics = real_step(problem, state, regs, settings)
        if len(calls) + 1 in RECORDED:
            recorded.append(dict(
                problem=host(problem), state=host(state),
                regs=np.asarray(regs), settings=settings,
                new_state=host(new_state), metrics=host(metrics)))
        calls.append(1)
        return new_state, metrics
    monkeypatch.setattr(jipm, "qp_ipm_step", step)
    jipm.solve_qp_ipm(_jax_model(pkg, mm_qp_model(7, n, n // 2)),
                      JOptions())
    return recorded


@pytest.mark.parametrize("n", SIZES)
def test_qp_ipm_step_matches_jax(jax_ref, monkeypatch, n):
    recorded = _recorded_jax_steps(jax_ref, monkeypatch, n)
    assert len(recorded) == len(RECORDED)
    for rec in recorded:
        assert rec["settings"] == SETTINGS
        problem = qp_ipm_problem_from_numpy(rec["problem"], device="cpu")
        state = qp_ipm_state_from_numpy(rec["state"], device="cpu")
        new_state, metrics = ipm_qp.qp_ipm_step(problem, state, rec["regs"],
                                                SETTINGS)
        for name in STATE_FIELDS:
            _assert_close(getattr(new_state, name), rec["new_state"][name],
                          1e-10, f"state.{name}")
        for name in ipm_qp.QpIpmMetrics._fields:
            _assert_close(getattr(metrics, name), rec["metrics"][name],
                          1e-10, f"metrics.{name}")


@pytest.mark.parametrize("n", SIZES)
def test_solve_qp_ipm_matches_jax(jax_ref, n):
    from highs_tpu.options import HighsOptions as JOptions
    from highs_tpu.solvers.qp.ipm_qp import solve_qp_ipm as jax_solve
    model = mm_qp_model(7, n, n // 2)
    jst, jsol, jinfo = jax_solve(_jax_model(jax_ref, model), JOptions())
    tst, tsol, tinfo = ipm_qp.solve_qp_ipm(model, HighsOptions(),
                                           device="cpu")
    assert int(tst) == int(jst) == int(HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    assert tinfo.primal_obj == pytest.approx(jinfo.primal_obj, rel=1e-9)
    np.testing.assert_allclose(tsol.col_value, jsol.col_value, rtol=0,
                               atol=1e-7)
    _assert_close(tsol.row_dual, jsol.row_dual, 1e-7, "row_dual")
    _assert_close(tsol.col_dual, jsol.col_dual, 1e-7, "col_dual")


def test_dense_hessian_is_built_on_the_device_as_scipy_builds_it():
    """The device build of sense * Q from the lower triangle equals
    the dense scipy matrix, with the slack block zero."""
    model = mm_qp_model(3, 40, 20)
    want = model.hessian.to_scipy_full().toarray()
    q = ipm_qp.dense_hessian(model.hessian, 45, -1.0, "cpu").numpy()
    np.testing.assert_array_equal(q[:40, :40], -want)
    assert not q[40:].any() and not q[:, 40:].any()


def _maximize_model(pkg):
    """max -x^2 + 2x, x in [-10, 10], x <= 5 (tests/test_qp.py)."""
    lp = pkg.HighsLp(
        num_col=1, num_row=1,
        col_cost=np.array([2.0]),
        col_lower=np.array([-10.0]), col_upper=np.array([10.0]),
        row_lower=np.array([-np.inf]), row_upper=np.array([5.0]),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(
            sp.csc_matrix(np.array([[1.0]]))),
        sense=pkg.ObjSense.kMaximize)
    hessian = pkg.HighsHessian(
        dim=1, start=np.array([0, 1]), index=np.array([0]),
        value=np.array([-2.0]))  # Q = -2 (concave for maximize)
    return pkg.HighsModel(lp=lp, hessian=hessian)


def _facades(jax_ref):
    return {"jax": (jax_ref, jax_ref.Highs()),
            "torch": (highs_tpu_torch, highs_tpu_torch.Highs(device="cpu"))}


def test_qp_maximize(jax_ref):
    """max -x^2 + 2x == min x^2 - 2x: x = 1, objective 1, in both."""
    got = {}
    for name, (pkg, h) in _facades(jax_ref).items():
        h.setOptionValue("output_flag", False)
        h.passModel(_maximize_model(pkg))
        h.run()
        assert h.getModelStatus() == pkg.HighsModelStatus.kOptimal, name
        assert abs(h.getObjectiveValue() - 1.0) < 1e-6, name
        assert abs(h.getSolution().col_value[0] - 1.0) < 1e-5, name
        got[name] = (h.getObjectiveValue(), h.getInfo().qp_iteration_count)
    assert got["torch"][1] == got["jax"][1] > 0
    assert got["torch"][0] == pytest.approx(got["jax"][0], rel=1e-9)


def test_miqp_and_a_wrong_hessian_give_errors(jax_ref):
    for name, (pkg, h) in _facades(jax_ref).items():
        h.setOptionValue("output_flag", False)
        model = _maximize_model(pkg)
        model.lp.integrality = np.ones(1, dtype=np.uint8)
        h.passModel(model)
        assert int(h.run()) == int(HighsStatus.kError), name
        assert int(h.getModelStatus()) == int(HighsModelStatus.kNotset)
        bad = pkg.HighsHessian(dim=2, start=np.array([0, 1, 2]),
                               index=np.array([0, 1]),
                               value=np.array([1.0, 1.0]))
        assert int(h.passHessian(bad)) == int(HighsStatus.kError), name
        good = pkg.HighsHessian(dim=1, start=np.array([0, 1]),
                                index=np.array([0]), value=np.array([1.0]))
        assert int(h.passHessian(good)) == int(HighsStatus.kOk), name
        assert h.getHessianNumNz() == 1


@pytest.mark.parametrize("kind", ["infeasible", "unbounded"])
def test_qp_status_matches_jax(jax_ref, kind):
    want = {"infeasible": HighsModelStatus.kInfeasible,
            "unbounded": HighsModelStatus.kUnbounded}[kind]
    model = status_qp_model(kind)
    port = highs_tpu_torch.Highs(device="cpu")
    jax = jax_ref.Highs()
    port.passModel(model)
    jax.passModel(_jax_model(jax_ref, model))
    for h in (port, jax):
        h.setOptionValue("output_flag", False)
        h.run()
    assert int(port.getModelStatus()) == int(jax.getModelStatus()) == \
        int(want)


def test_qp_on_card_matches_cpu(cuda_device):
    model = mm_qp_model(7, 300, 150)
    got = {}
    for device in (cuda_device, "cpu"):
        before = dict(ipm_qp.DENSE_FACTORS)
        h = highs_tpu_torch.Highs(device=device)
        h.setOptionValue("output_flag", False)
        h.passModel(model)
        h.run()
        assert h.getModelStatus() == HighsModelStatus.kOptimal
        factors = {k: ipm_qp.DENSE_FACTORS[k] - before[k] for k in before}
        iters = h.getInfo().qp_iteration_count
        assert factors[torch.device(device).type] == 2 * iters
        got[str(device)] = (h.getObjectiveValue(), iters)
    (obj_card, it_card), (obj_cpu, it_cpu) = got.values()
    assert it_card == it_cpu
    assert obj_card == pytest.approx(obj_cpu, rel=1e-9)
