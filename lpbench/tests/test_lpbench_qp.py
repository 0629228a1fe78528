"""The QP cell at a size a CPU test holds: the program comes out correct
and its float32 control does not, the judge `qp_kkt` reads a malformed
answer as the worst, an answer altered where it is produced comes out
not correct, and the reference loads nothing of the program or JAX."""
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import run_tiny
from lpbench import control, harness, qp_reference
from lpbench.generators import cvxqp
from lpbench.judges import qp_kkt

CPU = torch.device("cpu")
CELL = "cvxqp.solve10k"


def quiet(msg):
    pass


@pytest.mark.parametrize("seed", [2 ** 32 + 1, 2 ** 33 + 5, 2 ** 34 + 9])
def test_program_is_correct_and_its_float32_control_is_not(tiny_cell, seed):
    cell = tiny_cell(CELL)
    bases = harness.Bases(cell)
    sound = control.reading(cell, bases, seed, CPU, quiet, False)
    assert sound["correct"] and sound["route"] == "qp_ipm"
    assert sound["worst"] <= qp_kkt.limit(cell.config) == 1e-7
    low = control.reading(control.control_cell(cell), bases, seed, CPU,
                          quiet, True)
    assert low["route"] == "plain_qp_ipm_f32"
    assert low["correct"] is False
    assert low["worst"] > qp_kkt.limit(cell.config)
    # the same base both times: the failure is the precision's
    assert low["bases"] == sound["bases"]


def test_plain_reference_meets_the_limit_in_float64():
    from lpbench.entries import plain_qp_ipm_f32
    qp = cvxqp.cvxqp(300, 3)
    x, y, z, obj, its = plain_qp_ipm_f32.solve(qp, CPU, torch.float64)
    assert its < plain_qp_ipm_f32.ITERATIONS
    assert qp_reference.worst(qp_reference.certificate(qp, x, y, z, obj)) \
        <= 1e-9


def test_qp_kkt_reads_a_malformed_answer_as_the_worst():
    qp = cvxqp.cvxqp(40, 1)
    m, n = qp.a.shape
    cfg = {"kkt_tolerance": 1e-7}
    x, y, z = np.full(n, 1.0), np.zeros(m), np.zeros(n)
    good = qp_kkt.measure(qp, {"x": x, "y": y, "z": z, "objective": 1.0},
                          cfg)
    assert all(math.isfinite(v) for v in good.values())
    for ans in ({"x": x[:-1], "y": y, "z": z, "objective": 1.0},
                {"x": x, "y": y[:-1], "z": z, "objective": 1.0},
                {"x": x, "y": y, "z": z[:-1], "objective": 1.0},
                {"x": x, "y": y, "objective": 1.0},
                {"x": np.full(n, np.nan), "y": y, "z": z, "objective": 1.0},
                {"x": x, "y": y, "z": z, "objective": math.nan}):
        assert qp_kkt.worst(qp_kkt.measure(qp, ans, cfg)) == math.inf


def test_stationarity_is_summed_as_exactly_as_float64_holds_it():
    # duals of 1e8 (CVXQP3_L's reach 3e8): every plain float64 term of
    # A'y rounds by about 1e-8; the judge reads the residual that exact
    # rational arithmetic gives
    from fractions import Fraction
    qp = cvxqp.cvxqp(40, 1)
    m, n = qp.a.shape
    rng = np.random.default_rng(5)
    x = rng.uniform(0.1, 10, n)
    y = rng.uniform(-1e8, 1e8, m)
    z = qp.q @ x - qp.a.T @ y + rng.uniform(-1e-6, 1e-6, n)
    exact = [Fraction(0)] * n
    for mat, v, sign in ((qp.q.tocoo(), x, 1), (qp.a.T.tocoo(), y, -1)):
        for r, c, val in zip(mat.row, mat.col, mat.data):
            exact[r] += sign * Fraction(float(val)) * Fraction(float(v[c]))
    exact = np.array([float(e - Fraction(float(zj)))
                      for e, zj in zip(exact, z)])
    cert = qp_reference.certificate(qp, x, y, z, 0.0)
    assert cert["rel_stationarity"] == pytest.approx(
        np.linalg.norm(exact), rel=1e-9)
    plain = np.linalg.norm(qp.q @ x - qp.a.T @ y - z)
    assert abs(plain - np.linalg.norm(exact)) > 1e-6 * np.linalg.norm(exact)


def test_answer_altered_where_it_is_produced(tiny_cell, monkeypatch):
    import highs_tpu_torch
    real = highs_tpu_torch.Highs.getSolution

    def altered(self):
        sol = real(self)
        sol.col_value = np.asarray(sol.col_value, dtype=float).copy()
        sol.col_value[0] += 1e-4
        return sol
    monkeypatch.setattr(highs_tpu_torch.Highs, "getSolution", altered)
    result = run_tiny(tiny_cell(CELL))
    assert result["correct"] is False and result["failed"] > 0
    checks = result["checks"]
    assert checks["not_optimal"]["value"] == 0
    assert checks["qp_kkt_worst"]["value"] > checks["qp_kkt_worst"]["limit"]


def test_reference_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from lpbench import qp_reference, harness\n"
            "import lpbench.judges.qp_kkt\n"
            "import lpbench.generators.cvxqp\n"
            "import lpbench.entries.plain_qp_ipm_f32\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == "
            "'highs_tpu_torch'], 'the reference loads the program'\n"
            "print(harness.forbidden_modules())\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_new_metrics_read_nothing_from_a_program_without_the_qp_spans():
    # a traced run of a program that opens no QP span (the parent's):
    # the span readers stay silent, the clock and counter readers read
    class Timer:
        def read(self, name):
            return {"qp_factor_q": 0.5, "qp_factor_m": 0.25}.get(name, 0.0)

    class Info:
        qp_iteration_count = 10

    class Trace:
        def __init__(self, host):
            self.host = host

        def host_time(self, name):
            return self.host.get(name, (0.0, 0))
    # no span of the program at all, and the parent's: its run and solve
    # spans, none of the QP IPM's
    for host in ({"lpbench.run": (1.0, 1)},
                 {"lpbench.run": (1.0, 1), "highs.run": (0.9, 1),
                  "highs.pass_model": (0.01, 1)}):
        run = harness.Run()
        run.trace = Trace(host)
        run.calls = [{"api": {"info": Info(), "timer": Timer()},
                      "count": 1}]
        read = {name: harness.load_metric(name).read(run) for name in
                ("qp_setup_s", "qp_iter_ms", "qp_recover_s",
                 "qp_iterations", "qp_factor_ms")}
        assert read["qp_setup_s"] is None and read["qp_iter_ms"] is None
        assert read["qp_recover_s"] is None
        assert read["qp_iterations"] == 10
        assert read["qp_factor_ms"] == pytest.approx(75.0)
