"""The EMD cell at a size a CPU test holds: the program comes out correct
and its float32 control does not, faults planted where the answer is
produced come out not correct through the judge `flow_kkt` (a flipped
arc flow, a dual that breaks one arc's bound |y_u - y_v| <= 1, a NaN
objective), and the reference loads nothing of the program or JAX."""
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import run_tiny
from lpbench import control, flow_reference, harness
from lpbench.entries import plain_flow_ipm_f32
from lpbench.generators import emd_l1
from lpbench.judges import flow_kkt

CPU = torch.device("cpu")
CELL = "emd_l1.emd256"


def quiet(msg):
    pass


def judged(result):
    assert result["correct"] is False
    assert result["failed"] > 0
    return result["checks"]


@pytest.mark.parametrize("seed", [2 ** 32 + 1, 2 ** 33 + 5])
def test_program_is_correct_and_its_float32_control_is_not(tiny_cell, seed):
    cell = tiny_cell(CELL)
    bases = harness.Bases(cell)
    sound = control.reading(cell, bases, seed, CPU, quiet, False)
    assert sound["correct"] and sound["route"] == "ipm+ldl"
    assert sound["worst"] <= flow_kkt.limit(cell.config) == 1e-7
    low = control.reading(control.control_cell(cell), bases, seed, CPU,
                          quiet, True)
    assert low["route"] == "plain_flow_ipm_f32"
    assert low["correct"] is False
    assert low["worst"] > flow_kkt.limit(cell.config)
    # the same base both times: the failure is the precision's
    assert low["bases"] == sound["bases"]


def test_plain_ipm_meets_the_limit_in_float64(monkeypatch):
    # the control's failure is its precision's: the same method in
    # float64 reaches the configured tolerance
    monkeypatch.setattr(plain_flow_ipm_f32, "DTYPE", torch.float64)
    lp = emd_l1.generate({"res": 24, "seed": 0})
    x, y, obj = plain_flow_ipm_f32.solve(lp, CPU)
    assert flow_reference.worst(
        flow_reference.certificate(lp, x, y, obj)) <= 1e-7


def reverse_arc(a, j: int) -> int:
    """The column of the arc that runs against arc `j`."""
    col = a.getcol(j).tocoo()
    tail, head = col.row[col.data > 0][0], col.row[col.data < 0][0]
    at = a.tocsc()
    for k in range(a.shape[1]):
        rows = at.indices[at.indptr[k]:at.indptr[k + 1]]
        vals = at.data[at.indptr[k]:at.indptr[k + 1]]
        if set(zip(rows, vals)) == {(head, 1.0), (tail, -1.0)}:
            return k
    raise ValueError(f"arc {j} has no reverse")


def plant_in_solution(monkeypatch, alter):
    """`alter(a, sol)` applied to every solution the facade returns."""
    import highs_tpu_torch
    real = highs_tpu_torch.Highs.getSolution

    def altered(self):
        sol = real(self)
        alter(self.getLp().a_matrix.to_scipy().tocsc(), sol)
        return sol
    monkeypatch.setattr(highs_tpu_torch.Highs, "getSolution", altered)


def test_flipped_arc_flow(tiny_cell, monkeypatch):
    def flip(a, sol):
        x = np.asarray(sol.col_value, dtype=float).copy()
        j = int(np.argmax(x))
        k = reverse_arc(a, j)
        x[k], x[j] = x[j], x[k]
        sol.col_value = x
    plant_in_solution(monkeypatch, flip)
    checks = judged(run_tiny(tiny_cell(CELL)))
    assert checks["not_optimal"]["value"] == 0
    assert checks["kkt_worst"]["value"] > 1e-3


def test_dual_past_one_arc_bound(tiny_cell, monkeypatch):
    def lift(a, sol):
        y = np.asarray(sol.row_dual, dtype=float).copy()
        col = a.getcol(0).tocoo()
        tail, head = col.row[col.data > 0][0], col.row[col.data < 0][0]
        y[tail] = y[head] + 1.01
        sol.row_dual = y
    plant_in_solution(monkeypatch, lift)
    checks = judged(run_tiny(tiny_cell(CELL)))
    assert checks["not_optimal"]["value"] == 0
    assert checks["kkt_worst"]["value"] > flow_kkt.limit({
        "kkt_tolerance": 1e-7})


def test_nan_objective(tiny_cell, monkeypatch):
    import highs_tpu_torch
    monkeypatch.setattr(highs_tpu_torch.Highs, "getObjectiveValue",
                        lambda self: float("nan"))
    checks = judged(run_tiny(tiny_cell(CELL)))
    assert checks["kkt_worst"]["value"] == math.inf


def test_malformed_answers_read_as_the_worst():
    lp = emd_l1.generate({"res": 6, "seed": 0})
    m, n = lp.a.shape
    config = {"kkt_tolerance": 1e-7}
    for answer in ({"x": np.zeros(n), "y": np.zeros(m)},
                   {"x": np.zeros(n - 1), "y": np.zeros(m),
                    "objective": 0.0},
                   {"x": np.full(n, np.nan), "y": np.zeros(m),
                    "objective": 0.0}):
        assert flow_kkt.worst(flow_kkt.measure(lp, answer, config)) == \
            math.inf


@pytest.mark.parametrize("calls, share", [
    # one banded factor a solve that the gate hands off: none served
    ([{"banded_cuda": 1, "superlu": 17, "handoffs": 1}], 0.0),
    ([{"banded_cuda": 1, "superlu": 17, "handoffs": 1},
      {"banded_cuda": 16, "superlu": 0, "handoffs": 0}], 16 / 33 * 100),
    ([{"dense_cuda": 3, "ldl": 1, "handoffs": 0}], 75.0),
    # a CPU call's hand-offs are its own banded factors'
    ([{"banded_cpu": 1, "superlu": 3, "handoffs": 1}], 0.0),
    ([{"superlu": 0, "handoffs": 0}], None),
    ([{}], None),
])
def test_card_factors_count_the_factors_that_served(calls, share):
    run = harness.Run()
    run.calls = [{"factors": f} for f in calls]
    got = harness.load_metric("ipm_card_factors").read(run)
    assert got == share if share is None else got == pytest.approx(share)


def test_strip_closed_form_by_hand():
    # two cells: one unit of mass moves one step
    assert flow_reference.strip_w1([2.0, 0.0], [1.0, 1.0]) == 1.0
    # three cells, everything from the first to the last: two steps
    assert flow_reference.strip_w1([3.0, 0.0, 0.0], [0.0, 0.0, 3.0]) == 6.0


def test_reference_loads_no_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from lpbench import flow_reference\n"
            "from lpbench.judges import flow_kkt\n"
            "from lpbench.generators import emd_l1\n"
            "import lpbench.entries.plain_flow_ipm_f32\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('highs_tpu_torch', 'highs_tpu', 'jax', 'jaxlib')]\n"
            "print(bad)\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
