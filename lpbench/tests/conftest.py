"""The benchmark's CPU tests: `python -m pytest lpbench/tests -q` from the
repository's root (about two minutes). The readings on the card come from
`lpbench/control.py` and the benchmark's own runs."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# each cell cut to a size a CPU test holds, with the route it takes there
# (the CPU runs no graphs and counts no kernel launches): `tiny/<cell>.json`
# holds its members, the options it adds and the route
TINY = pathlib.Path(__file__).resolve().parent / "tiny"


def tiny_names() -> list:
    """The cells that have a CPU cut, by the files under `tiny/`."""
    return sorted(p.stem for p in TINY.glob("*.json"))


@pytest.fixture
def tiny_cell():
    """A factory: the cell `name` of BENCHMARK.json cut to its
    `tiny/<name>.json`, its warm-up the same members, its options
    updated by `options`."""
    from lpbench import harness

    def make(name, options=None):
        cell = harness.load_cell(name)
        tiny = harness.load_json(TINY / f"{name}.json")
        opts = {**cell.traffic.get("options", {}),
                **tiny.get("options", {}), **(options or {})}
        cell.traffic.update(members=tiny["members"], options=opts,
                            route=tiny["route"],
                            warm_up={"members": tiny["members"]})
        return cell
    return make


def run_tiny(cell, seed=2 ** 31 + 5, trace=False):
    """One call of `cell` on the CPU through the harness, as a result."""
    import time
    import torch
    from lpbench import harness
    return harness.run_cell(cell, seed, 0.0, trace, torch.device("cpu"),
                            time.perf_counter(), lambda msg: None)
