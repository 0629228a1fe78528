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
# (the CPU runs no graphs and counts no kernel launches)
TINY = {
    "block_lp.solve64k": ({"members": [{"nblocks": 2, "seed": 2024}],
                           "options": {"solver": "hipdlp",
                                       "tpu_matrix_format": "blockcsr"}},
                          "pdlp"),
    "synth_lp.solve50k": ({"members": [{"m": 300, "n": 300, "seed": 42}]},
                          "pdlp"),
    "synth_lp.batch16": ({"members": [{"m": 100 + 4 * j, "n": 100 + 4 * j,
                                       "seed": j} for j in range(4)]},
                         "batch"),
    "synth_lp.ipm20k": ({"members": [{"m": 200, "n": 1600, "seed": 42}],
                         "options": {"solver": "ipm",
                                     "run_crossover": "off"}},
                        "ipm+chol"),
}


@pytest.fixture
def tiny_cell():
    """A factory: the cell `name` of BENCHMARK.json cut to TINY's size,
    its warm-up the same members, its options updated by `options`."""
    from lpbench import harness

    def make(name, options=None):
        cell = harness.load_cell(name)
        traffic, route = TINY[name]
        opts = {**cell.traffic.get("options", {}),
                **traffic.get("options", {}), **(options or {})}
        cell.traffic.update(traffic, options=opts, route=route,
                            warm_up={"members": traffic["members"]})
        return cell
    return make


def run_tiny(cell, seed=2 ** 31 + 5, trace=False):
    """One call of `cell` on the CPU through the harness, as a result."""
    import time
    import torch
    from lpbench import harness
    return harness.run_cell(cell, seed, 0.0, trace, torch.device("cpu"),
                            time.perf_counter(), lambda msg: None)
