"""The benchmark's machinery, driven by `BENCHMARK.json` and data files.

A cell (an entry of `workloads`) names a configuration and a traffic
mix; the harness finds everything else by name:

- `configs/<config>.json`: the problem family, its generator
  (`generators/<generator>.py`), the options it runs with, the judge
  of its answers (`judges/<judge>.py`) and the limit the judge reads;
- `traffic/<traffic>.json`: the entry (`entries/<entry>.py`), the
  members of a call (sizes and the pool of base seeds each draws from),
  the options the user asks for, the route the solves must take and the
  warm-up;
- `metrics/<metric>.py`: one reader per metric, `read(run)`, which
  returns the metric's value or None when the run holds nothing to
  read. A reader sees each call's record whole: the objects the
  program's public API returned for it (`api`), and in a traced run
  every host event and device operation by name (`Trace`).

One caller sends calls back to back (a closed loop). Each call gets
fresh instances: each member's base LP, taken in turn from its pool
(the turn's start drawn from the seed, so every run solves the same
set of LPs in another order), made fresh by the generator's `fresh`
from (seed, call index). The client's work (generation, building the
model) lies outside the timed call. The window starts calls until their
timed total reaches the run's seconds; every call it starts runs to its
end. The window keeps each call's answers, not its LPs: once it has
closed, every LP is drawn again from (seed, call index) and every
answer is judged by the configuration's judge: `CHECK`, the name of
the number compared; `limit(config)`, its limit; `measure(problem,
answer, config)`, an answer's measures by name; `worst(measures)`, the
number compared of one answer. The harness knows nothing of the problem
type beyond the judge's name.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

from lpbench.trace import Trace, traced

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that nothing a run loads may have as its top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "highs_tpu")
# the numbers `judge` compares besides the judge's own `CHECK`, in order
OWN_CHECKS = ("not_optimal", "missing", "off_route")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the
    first dot), compared whole, is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def pool(member: dict) -> list:
    """The base seeds a member draws from: its `seeds`, or its `seed`."""
    return list(member["seeds"]) if "seeds" in member else [member["seed"]]


class Cell:
    """A workload of BENCHMARK.json with its files resolved by name."""

    def __init__(self, workload: dict, config: dict, traffic: dict,
                 end_to_end: list, per_layer: list):
        self.name = workload["name"]
        self.chips = workload["chips"]
        self.config = config
        self.traffic = traffic
        self.end_to_end = end_to_end  # metric entries of BENCHMARK.json
        self.per_layer = per_layer
        self.entry = importlib.import_module(
            f"lpbench.entries.{traffic['entry']}")
        self.generator = importlib.import_module(
            f"lpbench.generators.{config['generator']}")
        if "judge" not in config:
            raise KeyError(f"configuration {config['name']!r} names no "
                           "judge")
        self.judge = importlib.import_module(
            f"lpbench.judges.{config['judge']}")
        if self.judge.CHECK in OWN_CHECKS:
            raise ValueError(f"judge {config['judge']!r} names its check "
                             f"{self.judge.CHECK!r}, one of the harness's "
                             "own")

    def options(self) -> dict:
        """The options of the timed calls: the configuration's, then the
        traffic's."""
        return {**self.config["options"], **self.traffic.get("options", {})}

    def params(self, member: dict, seed: int) -> dict:
        """The generator parameters of `member` with the base seed
        `seed`."""
        own = {k: v for k, v in member.items() if k != "seeds"}
        return {**self.config["family"], **own, "seed": int(seed)}

    def members(self, part: dict) -> list:
        """The generator parameters of each member of a call of `part`
        (the traffic itself, or its warm-up), each at the first seed of
        its pool."""
        return [self.params(m, pool(m)[0]) for m in part["members"]]


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`)."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    (workload,) = found
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{workload['traffic']}.json")
    return Cell(workload, config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def load_metric(name: str, folder: pathlib.Path = HERE / "metrics"):
    """The reader of metric `name`: `<folder>/<name>.py`."""
    path = pathlib.Path(folder) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "lpbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bases:
    """A cell's base LPs, by their generator parameters, each made once
    and kept for the run."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.made = {}

    def get(self, params: dict):
        key = json.dumps(params, sort_keys=True)
        if key not in self.made:
            self.made[key] = self.cell.generator.generate(params)
        return self.made[key]

    def make_all(self) -> None:
        """Every base that the cell's traffic draws from."""
        for m in self.cell.traffic["members"]:
            for s in pool(m):
                self.get(self.cell.params(m, s))


def fresh_call(cell: Cell, bases: Bases, seed: int, index: int) -> list:
    """The LPs of call `index` of a run of `seed`, each with its
    generator parameters: every member's base in its pool's turn, made
    fresh, in an order drawn from the same stream."""
    # any whole number is a seed
    root = int(seed) % (1 << 64)
    turn = int(np.random.default_rng([root]).integers(1 << 30))
    rng = np.random.default_rng([root, int(index)])
    made = []
    for m in cell.traffic["members"]:
        seeds = pool(m)
        p = cell.params(m, seeds[(turn + index) % len(seeds)])
        made.append((cell.generator.fresh(bases.get(p), p, rng), p))
    order = rng.permutation(len(made))
    return [made[i] for i in order]


class Run:
    """What the metric readers read: the calls of the window, the set-up
    time and the trace (traced runs).

    Each call's record holds `index`, `seconds` (timed), `count` (LPs
    sent), `route`, `answers` (one a returned LP), `stats` (each LP's
    generator `stats`, in the call's order) and `api`: what the
    program's public API returned for the call, as the entry names it
    (the facade: `info`, `run_data`, `timer`; the batch: `results`)."""

    def __init__(self):
        self.calls = []
        self.setup_s = None
        self.build_s = 0.0
        self.timed_s = 0.0
        self.trace = None
        self.judged = []  # each answer's measures, once judged

    @property
    def lps(self) -> int:
        return sum(c["count"] for c in self.calls)

    def mean(self, fn):
        """The mean of fn(call) over the calls where it is not None, or
        None where it is None for every call."""
        vals = [v for v in map(fn, self.calls) if v is not None]
        return float(np.mean(vals)) if vals else None


def build_seconds() -> float:
    """The seconds this process spent building the program's kernels
    (its build records, by source)."""
    from highs_tpu_torch.ops import cuda_build
    return float(sum(sec for sec, _ in cuda_build.BUILD_INFO.values()))


def warm_up(cell: Cell, device, log) -> None:
    """One call of the traffic's warm-up: small members of the cell's
    family with options that force the cell's route; it must take it."""
    part = cell.traffic["warm_up"]
    lps = [cell.generator.generate(p) for p in cell.members(part)]
    options = {**cell.options(), **part.get("options", {})}
    handle = cell.entry.prepare(lps, options, device)
    t0 = time.perf_counter()
    cell.entry.call(handle)
    seconds = time.perf_counter() - t0
    rec = cell.entry.finish(handle)
    log(f"warm-up: {len(lps)} LP(s), {seconds:.3f} s, route {rec['route']}")
    want = cell.traffic.get("route")
    if want is not None and rec["route"] != want:
        raise RuntimeError(f"the warm-up took route {rec['route']!r}, the "
                           f"cell's is {want!r}")


def window(cell: Cell, run: Run, bases: Bases, seed: int, seconds: float,
           trace_on: bool, device, log) -> None:
    """Calls back to back until their timed total reaches `seconds`."""
    options = cell.options()
    run.trace = Trace() if trace_on else None
    index = 0
    while True:
        made = fresh_call(cell, bases, seed, index)
        lps = [lp for lp, _ in made]
        stats = [cell.generator.stats(lp, p) for lp, p in made]
        del made
        handle = cell.entry.prepare(lps, options, device)
        del lps
        with traced(run.trace, trace_on):
            t0 = time.perf_counter()
            cell.entry.call(handle)
            t1 = time.perf_counter()
        rec = cell.entry.finish(handle)
        del handle
        rec.update(index=index, seconds=t1 - t0, count=len(stats),
                   stats=stats)
        run.calls.append(rec)
        run.timed_s += t1 - t0
        log(f"call {index}: {t1 - t0:.4f} s, route {rec['route']}, "
            f"{json.dumps(cell.entry.summary(rec))}")
        index += 1
        if run.timed_s >= seconds:
            break


def judge(cell: Cell, run: Run, bases: Bases, seed: int, log) -> tuple:
    """Every answer of the window by the cell's judge, each problem
    drawn again from (seed, call index): (the numbers compared, the
    judge's first, each beside its limit; the count of problems that
    failed)."""
    limit = cell.judge.limit(cell.config)
    want_route = cell.traffic.get("route")
    worst = 0.0
    not_optimal = missing = off_route = failed = 0
    run.judged = []
    for rec in run.calls:
        made = fresh_call(cell, bases, seed, rec["index"])
        lps = [lp for lp, _ in made]
        answers = rec["answers"]
        bad_route = want_route is not None and rec["route"] != want_route
        off_route += int(bad_route)
        missing += max(0, len(lps) - len(answers))
        failed += max(0, len(lps) - len(answers))
        for (lp, p), ans in zip(made, answers):
            meas = cell.judge.measure(lp, ans, cell.config)
            run.judged.append({"call": rec["index"], "base": p["seed"],
                               "status": ans["status"], **meas})
            w = cell.judge.worst(meas)
            worst = max(worst, w)
            not_optimal += int(not ans["optimal"])
            ok = ans["optimal"] and w <= limit and not bad_route
            failed += int(not ok)
            log(f"call {rec['index']}: {ans['status']} "
                f"{cell.config['judge']} "
                + " ".join(f"{k} {v:.3e}" for k, v in meas.items())
                + f" objective {ans['objective']!r}")
    own = dict(zip(OWN_CHECKS, (not_optimal, missing, off_route)))
    checks = {cell.judge.CHECK: {"value": worst, "limit": limit},
              **{k: {"value": v, "limit": 0} for k, v in own.items()}}
    return checks, failed


def is_correct(checks: dict, failed: int) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values()) and \
        failed == 0


def read_metrics(run: Run, entries: list) -> dict:
    """The metrics of `entries` that their readers find in `run`."""
    out = {}
    for m in entries:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             device, started: float, log) -> dict:
    """One run of `cell`: set-up, the window, the judgement and the
    metrics, as the result object (without the device's name, which the
    caller adds). `started` is the process's start on the
    `time.perf_counter` clock."""
    import torch
    run = Run()
    bases = Bases(cell)
    bases.make_all()
    warm_up(cell, device, log)
    run.setup_s = time.perf_counter() - started
    run.build_s = build_seconds()
    log(f"set-up: {run.setup_s:.3f} s, of which the kernels' build "
        f"{run.build_s:.3f} s")
    window(cell, run, bases, seed, seconds, trace_on, device, log)
    if build_seconds() > run.build_s:
        log("a kernel was built inside the window")
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = judge(cell, run, bases, seed, log)
    metrics = read_metrics(run, cell.per_layer if trace_on
                           else cell.end_to_end)
    result = {"correct": is_correct(checks, failed),
              "attempted": run.lps, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "count": cell.chips, "memory_peak_bytes": int(peak),
                         "build_s": run.build_s}}
    if trace_on:
        result["device"].update(busy_s=run.trace.busy_ns * 1e-9,
                                window_s=run.trace.window_ns * 1e-9)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
