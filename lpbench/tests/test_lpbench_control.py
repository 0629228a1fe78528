"""The control of `correct`, at a size a test run holds: each cell's
configuration computed one precision below the one it states comes out
not correct through the harness's own judgement, while the program as
configured comes out correct."""
import json

import pytest
import torch

from lpbench import control, harness, reference
from lpbench.entries import plain_pdhg_f32

CPU = torch.device("cpu")


def quiet(msg):
    pass


@pytest.mark.parametrize("name", ["synth_lp.solve50k", "synth_lp.batch16",
                                  "synth_lp.ipm20k", "block_lp.solve64k"])
def test_control_fails_the_limit_and_the_program_meets_it(tiny_cell, name):
    cell = tiny_cell(name)
    ctl = control.control_cell(cell)
    if "pdlp_iteration_limit" in ctl.traffic["options"]:
        # at this size a few thousand steps show the stall
        ctl.traffic["options"]["pdlp_iteration_limit"] = 3000
    if "entry" not in cell.traffic["control"]:
        # the program's own lower-precision path
        assert ctl.options()["tpu_dtype"] == "float32"
    # the configured tolerance is the control's too
    assert ctl.options()["pdlp_optimality_tolerance"] == \
        cell.config["kkt_tolerance"]
    bases = harness.Bases(cell)
    sound = control.reading(cell, bases, 2 ** 32 + 1, CPU, quiet, False)
    assert sound["correct"] and sound["worst"] <= 1e-7
    low = control.reading(ctl, bases, 2 ** 32 + 1, CPU, quiet, True)
    assert low["correct"] is False
    assert low["worst"] > cell.config["kkt_tolerance"]


@pytest.mark.parametrize("params", [
    {"m": 300, "n": 300, "per_col": 10, "seed": 42, "upper": 10.0},
    {"m": 200, "n": 260, "per_col": 10, "seed": 3, "upper": 10.0}])
def test_plain_pdhg_meets_the_limit_in_float64(params):
    # the control's failure is its precision's: the same method in
    # float64 reaches the configured tolerance
    from lpbench.generators import synth_lp
    lp = synth_lp.generate(params)
    x, y, obj, ok, its = plain_pdhg_f32.solve(lp, CPU, 20000, 1e-7,
                                              torch.float64)
    assert ok and its < 20000
    assert reference.worst(reference.kkt(lp, x, y, obj)) <= 1e-7


def test_control_cli_writes_its_readings(tiny_cell, monkeypatch, tmp_path):
    cell = tiny_cell("synth_lp.ipm20k")
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    out = tmp_path / "readings.jsonl"
    assert control.main(["--workload", "synth_lp.ipm20k", "--seeds", "5,6",
                         "--control-seeds", "6", "--bases", "42,43",
                         "--device", "cpu", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["control"] for r in rows] == [False, False, True]
    assert [r["bases"] for r in rows[:2]] == [[42], [43]]
    assert rows[0]["correct"] and rows[1]["correct"]
    assert rows[0]["worst"] <= 1e-7 < rows[2]["worst"]
    assert rows[2]["correct"] is False
