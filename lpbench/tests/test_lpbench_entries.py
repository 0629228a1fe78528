"""A tiny end-to-end pass of each cell's entry through the harness on the
CPU: set-up, one call, the judgement, the metrics."""
import pytest

from conftest import run_tiny, tiny_names
from lpbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", tiny_names())
@pytest.mark.parametrize("trace", [False, True])
def test_entry_end_to_end_on_the_cpu(tiny_cell, name, trace):
    cell = tiny_cell(name)
    result = run_tiny(cell, trace=trace)
    assert result["correct"] is True
    assert result["failed"] == 0
    assert result["attempted"] == len(cell.traffic["members"])
    assert list(result)[-1] == "checks"
    check = cell.judge.CHECK
    assert list(result["checks"])[0] == check
    assert result["checks"][check]["value"] <= cell.judge.limit(cell.config)
    wanted = cell.per_layer if trace else cell.end_to_end
    names = set(result["metrics"])
    if trace:
        # the CPU has no device trace: the readers of the trace find
        # nothing there and stay silent
        assert {m["name"] for m in wanted
                if m["source"] != "device_trace"} <= names
        assert result["device"]["busy_s"] == 0.0
        assert "breakdown" in result
    else:
        assert names == {m["name"] for m in wanted}
        assert result["metrics"]["setup_s"]["value"] > 0


def test_a_new_metric_reads_what_no_entry_names(tiny_cell, tmp_path):
    # a metric that BENCHMARK.json does not hold, added as a file alone:
    # it reads a clock and a count of the public API that neither the
    # entry nor another metric names, and a host event of the trace by
    # its name
    (tmp_path / "pdlp_restarts.py").write_text(
        "def read(run):\n"
        "    return run.mean(lambda c: c['api']['timer']"
        ".num_calls('pdlp_restart'))\n")
    (tmp_path / "run_clock_s.py").write_text(
        "def read(run):\n"
        "    return run.mean(lambda c: c['api']['timer'].read('run'))\n")
    (tmp_path / "run_span_s.py").write_text(
        "def read(run):\n"
        "    sec, count = run.trace.host_time('lpbench.run')\n"
        "    return sec / count if count else None\n")
    cell = tiny_cell("synth_lp.solve50k")
    from lpbench import harness
    import torch
    run = harness.Run()
    bases = harness.Bases(cell)
    harness.window(cell, run, bases, 2 ** 31 + 9, 0.0, True,
                   torch.device("cpu"), lambda msg: None)
    (rec,) = run.calls
    restarts = harness.load_metric("pdlp_restarts", tmp_path).read(run)
    assert restarts == rec["api"]["timer"].num_calls("pdlp_restart") > 0
    clock = harness.load_metric("run_clock_s", tmp_path).read(run)
    assert 0 < clock <= rec["seconds"]
    span = harness.load_metric("run_span_s", tmp_path).read(run)
    assert 0 < span <= rec["seconds"]
