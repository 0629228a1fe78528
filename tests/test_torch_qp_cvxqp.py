"""The Maros-Meszaros CVXQP family through the port's QP IPM on the CPU.

- The benchmark's generator (`lpbench/generators/cvxqp.py`, the
  family's defining formulas) against the optima of CVXQP1_S, CVXQP2_S,
  CVXQP3_S and CVXQP1_M, and its nonzeros at M size.
- The port (`Highs(device="cpu").run()`) against the benchmark's plain
  QP IPM in float64 (`lpbench/entries/plain_qp_ipm_f32.py`, full KKT
  system, plain PyTorch) on seeded `gen_mm_style` QPs and seeded
  permutations of the S instances: objectives to 2e-8 relative (the
  port stops at a relative gap of 1e-8 over 1 + |p| + |d|, which bounds
  its objective's error by about twice that), and both answers within
  1e-7 by the certificate of `lpbench/qp_reference.py`.
- The reported reduced costs c + Qx - A'y: the exact sum rounded, in one
  block of columns and in several.
- A QP solve opens the QP IPM's spans under `torch.profiler` and runs
  under the facade's `solve` clock.
- CVXQP2 at n = 2,600 and CVXQP3 at n = 3,000, the smallest n (in steps
  of 100) at which the first pass stalls: the repaired pass takes them
  to kOptimal, with no classification LP and no active set.
  CVXQP3's case takes about two minutes in one thread: its first pass
  runs 68 Schur iterations of 1.7 s before the stall rule ends it.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import highs_tpu_torch
from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.solvers.qp import ipm_qp, wrapper
from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model
from lpbench import qp_reference
from lpbench.entries import plain_qp_ipm_f32, qp_facade
from lpbench.generators import cvxqp

torch.set_num_threads(1)

CPU = torch.device("cpu")
# (variant, n) -> optimum: the S values agree with the published ones
# to their 8 digits; CVXQP1_M's is the one its certificate proves (the
# plain float64 IPM's, gap 6e-16): 3.2e-8 below 1087511.602179757, an
# answer whose own certificate gap was 1.6e-8
OPTIMA = {(1, 100): 11590.71811942728, (2, 100): 8120.940477272436,
          (3, 100): 11943.432203502372, (1, 1000): 1087511.5673215007}


def plain(qp):
    """The plain reference's answer in float64 and its worst measure."""
    x, y, z, obj, _ = plain_qp_ipm_f32.solve(qp, CPU, torch.float64)
    return obj, qp_reference.worst(
        qp_reference.certificate(qp, x, y, z, obj))


def port(qp):
    """The port's facade on the CPU: (status, objective, worst measure,
    the facade)."""
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    h.passModel(qp_facade.model_of(qp))
    h.run()
    sol = h.getSolution()
    obj = h.getObjectiveValue()
    worst = qp_reference.worst(qp_reference.certificate(
        qp, sol.col_value, sol.row_dual, sol.col_dual, obj))
    return h.getModelStatus(), obj, worst, h


def as_qp(model) -> qp_reference.Qp:
    lp = model.lp
    return qp_reference.Qp(
        q=model.hessian.to_scipy_full().tocsc(), c=lp.col_cost.copy(),
        a=lp.a_matrix.to_scipy().tocsc(), row_lower=lp.row_lower.copy(),
        row_upper=lp.row_upper.copy(), col_lower=lp.col_lower.copy(),
        col_upper=lp.col_upper.copy())


@pytest.mark.parametrize("variant,n", sorted(OPTIMA))
def test_generator_reproduces_the_optima(variant, n):
    qp = cvxqp.cvxqp(n, variant)
    want = OPTIMA[(variant, n)]
    obj, worst = plain(qp)
    assert worst <= 1e-9
    assert obj == pytest.approx(want, rel=1e-8)
    status, obj, worst, _ = port(qp)
    assert status == HighsModelStatus.kOptimal
    assert worst <= 1e-7
    assert obj == pytest.approx(want, rel=1e-8)


def test_generator_has_the_published_structure():
    # CVXQP1_M: 1,498 nonzeros in A, 2,984 below Q's diagonal
    qp = cvxqp.cvxqp(1000, 1)
    assert qp.a.shape == (500, 1000) and qp.a.nnz == 1498
    low = qp.q.tocoo()
    assert int((low.row > low.col).sum()) == 2984
    assert cvxqp.cvxqp(1000, 2).a.shape == (250, 1000)
    assert cvxqp.cvxqp(1000, 3).a.shape == (750, 1000)


def test_a_fresh_instance_keeps_the_optimum():
    base = cvxqp.cvxqp(100, 1)
    made = cvxqp.fresh(base, {"n": 100, "seed": 1},
                       np.random.default_rng(2 ** 33 + 7))
    assert (made.a != base.a).nnz > 0
    assert plain(made)[0] == pytest.approx(OPTIMA[(1, 100)], rel=1e-10)


# ("mm", seed, n): `mm_qp_model(seed, n, n // 2)`; ("cvxqp", variant,
# seed): the S instance permuted by a generator of that seed
@pytest.mark.parametrize("case", [("mm", 1, 60), ("mm", 2, 100),
                                  ("mm", 3, 100), ("cvxqp", 1, 11),
                                  ("cvxqp", 2, 12), ("cvxqp", 3, 13)])
def test_port_agrees_with_the_plain_reference(case):
    kind, first, second = case
    if kind == "mm":
        qp = as_qp(mm_qp_model(first, second, second // 2))
    else:
        qp = cvxqp.fresh(cvxqp.cvxqp(100, first), {"n": 100, "seed": first},
                         np.random.default_rng([second, 2 ** 40]))
    want, worst_plain = plain(qp)
    status, obj, worst, _ = port(qp)
    assert status == HighsModelStatus.kOptimal
    assert worst_plain <= 1e-7 and worst <= 1e-7
    assert obj == pytest.approx(want, rel=2e-8)


@pytest.mark.parametrize("block_terms", [2 ** 24, 40])
def test_reduced_costs_are_the_exact_sum_rounded(monkeypatch, block_terms):
    # duals of 3e8 against a reduced cost of 1e-3: a plain float64
    # c + Qx - A'y is off by about 1e-7; blocks of 40 terms take the 9
    # columns two at a time
    monkeypatch.setattr(ipm_qp, "BLOCK_TERMS", block_terms)
    rng = np.random.default_rng(5)
    m, n = 7, 9
    a = rng.integers(-3, 4, (m, n)).astype(float)
    b = rng.standard_normal((n, n))
    q = 1e4 * b @ b.T
    x = 10.0 * rng.standard_normal(n)
    y = 3e8 * rng.standard_normal(m)
    c = a.T @ y - q @ x + 1e-3 * rng.standard_normal(n)
    exact = np.array([float(
        Fraction(c[j]) + sum(Fraction(q[k, j]) * Fraction(x[k])
                             for k in range(n)) -
        sum(Fraction(a[i, j]) * Fraction(y[i]) for i in range(m)))
        for j in range(n)])
    assert np.abs(c + q @ x - a.T @ y - exact).max() > 1e-9

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64)
    problem = ipm_qp.QpIpmProblem(
        a=t(a), q=t(q), b=t(np.zeros(m)), c=t(c), slack_mask=t(np.zeros(m)),
        lo=t(np.zeros(n + m)), up=t(np.zeros(n + m)),
        lo_fin=t(np.zeros(n + m)), up_fin=t(np.zeros(n + m)),
        active=t(np.ones(n + m)), norm_c=t(0.0), norm_b=t(0.0))
    z = ipm_qp.reduced_costs(problem, t(x), t(y)).numpy()
    assert np.array_equal(z, exact)


def profiled(qp):
    """`port(qp)` under `torch.profiler`, and the names of the program's
    spans it recorded."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        out = port(qp)
    return out, {e.name for e in prof.events()
                 if e.name.startswith("highs.")}


def test_a_qp_solve_opens_its_spans_and_the_solve_clock():
    (status, _, _, h), names = profiled(cvxqp.cvxqp(100, 1))
    assert status == HighsModelStatus.kOptimal
    assert {"highs.run", "highs.solve", "highs.qp_setup", "highs.qp.prepare",
            "highs.qp.start", "highs.qp_iterations",
            "highs.qp.recover"} <= names
    assert "highs.qp.repair" not in names
    timer = h.getTimer()
    assert timer.num_calls("qp_iterations") == \
        h.getInfo().qp_iteration_count > 0
    assert 0 < timer.read("qp_setup") + timer.read("qp_iterations") <= \
        h.getRunData().solve_time


@pytest.mark.parametrize("variant,n", [(2, 2600), (3, 3000)])
def test_stalled_cvxqp_reaches_optimal_from_the_ipm_alone(monkeypatch,
                                                         variant, n):
    lines = []
    real = wrapper.solve_qp_ipm

    def logged(model, options, log=None, device=None):
        return real(model, options, log=lines.append, device=device)
    monkeypatch.setattr(wrapper, "solve_qp_ipm", logged)
    before = dict(ipm_qp.DENSE_FACTORS)
    repairs = ipm_qp.REPAIRS["cpu"]
    (status, obj, worst, h), names = profiled(cvxqp.cvxqp(n, variant))
    assert {"highs.qp.repair", "highs.qp.start", "highs.qp_iterations",
            "highs.qp.recover"} <= names
    assert "highs.qp.classify" not in names
    # the first pass stalls, the repaired pass answers
    assert any(line.startswith("qp-ipm: kUnknown after")
               for line in lines)
    assert status == HighsModelStatus.kOptimal
    assert ipm_qp.REPAIRS["cpu"] == repairs + 1
    # the IPM alone: two dense factors an iteration, no classification
    # LP (and so no active set after it)
    iterations = h.getInfo().qp_iteration_count
    assert ipm_qp.DENSE_FACTORS["cpu"] - before["cpu"] == 2 * iterations
    assert h.getTimer().num_calls("qp.classify") == 0
    assert qp_facade.route(before, dict(ipm_qp.DENSE_FACTORS), "cpu",
                           iterations, 0) == "qp_ipm"
    assert worst <= 1e-7
    assert h.getRunData().solve_time > 0
