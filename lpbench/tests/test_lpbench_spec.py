"""BENCHMARK.json against the files the harness finds by name, and the
check that nothing a run loads is JAX or the JAX package."""
import json
import re
import subprocess
import sys

import pytest

from lpbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lpbench"]
    assert BENCH["command"] == ["python3", "lpbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_workload_resolves_by_name(name):
    cell = harness.load_cell(name, BENCH)
    for part in ("generate", "fresh", "stats"):
        assert callable(getattr(cell.generator, part))
    for part in ("prepare", "call", "finish"):
        assert callable(getattr(cell.entry, part))
    assert cell.members(cell.traffic) and cell.members(cell.traffic["warm_up"])
    # the configuration names its judge, which states a positive limit
    assert cell.judge.__name__ == f"lpbench.judges.{cell.config['judge']}"
    assert isinstance(cell.judge.CHECK, str) and NAME.match(cell.judge.CHECK)
    assert cell.judge.CHECK not in harness.OWN_CHECKS
    assert cell.judge.limit(cell.config) > 0
    for part in ("limit", "measure", "worst"):
        assert callable(getattr(cell.judge, part))
    assert cell.chips == 1
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_metric(m["name"]).read)


def test_names_units_and_layers():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in metrics + BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["source"] == cfg["source"] and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_forbidden_names_compare_whole_top_level():
    loaded = {"highs_tpu_torch": 0, "highs_tpu_torch.ops": 0,
              "jaxtyping": 0, "flaxen": 0, "numpy": 0}
    assert harness.forbidden_modules(loaded) == []
    loaded.update({"jax": 0, "jaxlib.xla_client": 0, "flax.linen": 0,
                   "highs_tpu": 0, "highs_tpu.ops.block_csr": 0})
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "highs_tpu", "highs_tpu.ops.block_csr", "jax",
        "jaxlib.xla_client"]


def test_harness_and_reference_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from lpbench import harness, reference, yardstick, trace\n"
            "import lpbench.entries.plain_ipm_f32\n"
            "import lpbench.entries.plain_pdhg_f32\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == "
            "'highs_tpu_torch'], 'the reference loads the program'\n"
            "for name in %r:\n"
            "    cell = harness.load_cell(name)\n"
            "    cell.entry.counters()\n"
            "print(harness.forbidden_modules())\n") % (str(harness.ROOT), CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
