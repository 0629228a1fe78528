"""The port's named clocks as profiler spans (`utils/timer.py`).

With no profiler running, no solve enters a `record_function`. Under
`torch.profiler`, a facade PDLP solve (float32, so the refinement and its
host oracle run; the graph runner with the CPU's recorder, so captures
run), an IPM solve and a `solve_lp_batch` call emit every span of their
routes; each span agrees with its clock and lies inside its parent, and
the spans under "highs.solve" cover it. Presolve counts each rule's
stack entries. The benchmark's metrics that read the spans
(`lpbench/metrics/`) read them from a trace folded from such a profile.
"""
import collections
import math
import pathlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from highs_tpu_torch.options import HighsOptions  # noqa: E402
from highs_tpu_torch.utils.timer import HighsTimer, span  # noqa: E402
from lpbench import harness, trace  # noqa: E402
from lpbench.entries import facade  # noqa: E402
from lpbench.reference import Lp  # noqa: E402

# the tests run in parallel worker processes on shared cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
OPTIONS = {"pdlp": {"solver": "hipdlp", "tpu_dtype": "float32",
                    "pdlp_optimality_tolerance": 1e-7},
           "ipm": {"solver": "ipm", "run_crossover": "off"}}
# the spans each route opens (every one a clock but pass_model and the
# batch's), and the span each lies inside
ROUTE_SPANS = {
    "pdlp": ["run", "pass_model", "presolve", "presolve.setup",
             "presolve.singleton_row", "presolve.empty_col",
             "presolve.fixed_col", "presolve.probing", "presolve.build",
             "solve", "pdlp.setup", "pdlp.scale", "pdlp_round",
             "pdhg.power", "pdhg.block", "pdhg.capture", "pdlp.oracle",
             "pdlp.recover", "postsolve"],
    "ipm": ["run", "pass_model", "presolve", "presolve.setup",
            "presolve.build", "solve", "ipm_setup", "ipm.prepare",
            "ipm.start", "ipm_iterations", "ipm.recover", "postsolve"],
    "batch": ["batch.prepare", "batch.block", "pdhg.capture",
              "batch.recover"],
}
PARENT = {"presolve": "run", "solve": "run", "postsolve": "run",
          "pdlp.setup": "solve", "pdlp.scale": "pdlp.setup",
          "pdlp_round": "solve",
          "pdlp.oracle": "solve", "pdlp.recover": "solve",
          "pdhg.power": "pdlp_round", "pdhg.block": "pdlp_round",
          "pdhg.capture": "pdhg.block", "ipm_setup": "solve",
          "ipm.prepare": "ipm_setup", "ipm.start": "ipm_setup",
          "ipm_iterations": "solve", "ipm.recover": "solve",
          "batch.block": None}
SOLVE_CHILDREN = {"pdlp": ("pdlp.setup", "pdlp_round", "pdlp.oracle",
                           "pdlp.recover"),
                  "ipm": ("ipm_setup", "ipm_iterations", "ipm.recover")}
# the stack entry each presolve rule family pushes
RULE_TAG = {"empty_row": "empty_row", "singleton_row": "singleton_row",
            "fixed_col": "fixed_col", "empty_col": "empty_col",
            "redundant_row": "redundant_row",
            "doubleton_eq": "doubleton_eq", "duplicate_row": "duplicate_row",
            "duplicate_col": "dup_col", "sparsify": "sparsify",
            "dependent_eq": "redundant_row", "forcing_row": "forcing_row",
            "free_col_sub": "free_col_sub", "aggregator": "agg_sub",
            "dominated_col": "fixed_col", "probing": None}
NEW_METRICS = {"pdlp": ["pdlp_setup_s", "pdlp_oracle_s", "pdlp_recover_s",
                        "pdhg_block_ms", "idle_unattributed.solve"],
               "ipm": ["ipm_prepare_s", "ipm_start_s",
                       "idle_unattributed.solve"],
               "batch": ["batch_host_s"]}


def reducible_lp(m=120, n=120, seed=7) -> Lp:
    """A scattered LP (min c'x, Ax >= b, 0 <= x <= 10) with a singleton
    row, an empty column and a column fixed at 0 added."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=(n, 6))
    a = sp.csc_matrix((rng.standard_normal(n * 6),
                       (rows.ravel(), np.repeat(np.arange(n), 6))),
                      shape=(m, n))
    a.sum_duplicates()
    b = a @ rng.uniform(0, 1, n) - 0.1 * np.abs(rng.standard_normal(m))
    c = rng.uniform(0.1, 1.0, n)
    fixed = sp.csc_matrix(rng.standard_normal((m, 1)) *
                          (rng.uniform(size=(m, 1)) < 0.05))
    a = sp.hstack([a, sp.csc_matrix((m, 1)), fixed])
    single = sp.csr_matrix(([1.0], ([0], [0])), shape=(1, n + 2))
    a = sp.vstack([a, single]).tocsc()
    return Lp(a, np.append(b, 0.5), np.append(c, [1.0, 1.0]),
              np.append(np.full(n, 10.0), [10.0, 0.0]))


def batch_lps():
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    out = []
    for j in range(3):
        lp = reducible_lp(40 + 4 * j, 40 + 4 * j, j)
        m, n = lp.a.shape
        out.append(HighsLp(
            num_col=n, num_row=m, col_cost=lp.c, col_lower=np.zeros(n),
            col_upper=lp.upper, row_lower=lp.b,
            row_upper=np.full(m, np.inf),
            a_matrix=HighsSparseMatrix.from_scipy(lp.a), sense=1))
    return out


def graphs_on_the_cpu(monkeypatch):
    """The graph runner on the CPU: the recorder in place of a capture."""
    from highs_tpu_torch.solvers import capture
    from highs_tpu_torch.solvers.pdlp import graph
    monkeypatch.setattr(graph, "on_one_card", lambda *a: True)
    monkeypatch.setattr(capture, "cuda_graph", capture.eager_recorder)


def call(route):
    """One call of `route` through the benchmark's entry (the facade) or
    `solve_lp_batch` (the batch): (the call's function, its finish)."""
    if route == "batch":
        from highs_tpu_torch.solvers.capture import eager_recorder
        from highs_tpu_torch.solvers.pdlp.batch import solve_lp_batch
        lps, opts = batch_lps(), HighsOptions()
        opts.output_flag = False
        out = []

        def fn():
            out[:] = solve_lp_batch(lps, opts, device=CPU,
                                    capture=eager_recorder)

        def finish():
            return {"answers": [{"optimal": st.name == "kOptimal"}
                                for st, _, _ in out],
                    "route": "batch",
                    "api": {"results": [(st, i) for st, _, i in out]}}
        return fn, finish
    handle = facade.prepare([reducible_lp()], OPTIONS[route], CPU)
    return lambda: facade.call(handle), lambda: facade.finish(handle)


def profiled(route):
    """A call of `route` under `torch.profiler`: (its host events as
    (start, end, name), the call's record, the trace folded from the
    profile, as the benchmark folds it)."""
    from torch.profiler import ProfilerActivity, profile
    fn, finish = call(route)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    device, host, spans = trace.read_events(prof)
    t = trace.Trace()
    t.add(device, host, spans)
    return host, finish(), t


@pytest.fixture(scope="module")
def runs():
    """Each route's profiled call, made once for the module."""
    mp = pytest.MonkeyPatch()
    graphs_on_the_cpu(mp)
    try:
        yield {route: profiled(route) for route in ("pdlp", "ipm", "batch")}
    finally:
        mp.undo()


def by_name(host):
    out = collections.defaultdict(list)
    for s, e, name in host:
        if name.startswith("highs."):
            out[name[len("highs."):]].append((s, e))
    return out


@pytest.mark.parametrize("route", ["pdlp", "ipm", "batch"])
def test_no_record_function_without_a_profiler(monkeypatch, route):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            # the program's spans (the benchmark's entry opens its own)
            if self.name.startswith("highs."):
                entered.append(self.name)
            return super().__enter__()
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    fn, finish = call(route)
    fn()
    assert all(a["optimal"] for a in finish()["answers"])
    assert entered == []
    # the same class counts the spans while a profiler runs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span(None, "probe"):
            pass
    assert entered == ["highs.probe"]


@pytest.mark.parametrize("route", ["pdlp", "ipm", "batch"])
def test_every_span_of_the_route(runs, route):
    host, rec, _ = runs[route]
    names = by_name(host)
    missing = [n for n in ROUTE_SPANS[route] if n not in names]
    assert not missing, sorted(names)
    assert all(a["optimal"] for a in rec["answers"])
    assert rec["route"].startswith(route)
    if route == "pdlp":
        # the refinement ran: the oracle between rounds and in them
        assert rec["api"]["timer"].num_calls("pdlp_round") >= 2
        assert len(names["pdlp.oracle"]) >= 3


@pytest.mark.parametrize("route", ["pdlp", "ipm"])
def test_spans_agree_with_clocks_and_nest(runs, route):
    host, rec, _ = runs[route]
    timer = rec["api"]["timer"]
    names = by_name(host)
    for name, ivs in names.items():
        if name == "pass_model":
            continue
        total = sum(e - s for s, e in ivs) * 1e-9
        clock = timer.read(name)
        assert abs(total - clock) <= 0.02 * clock + 1e-3, (name, total,
                                                          clock)
    for name, parent in PARENT.items():
        for s, e in names.get(name, []):
            outer = names[parent] if parent else []
            assert parent is None or any(
                ps <= s and e <= pe for ps, pe in outer), (name, parent)
    for name, ivs in names.items():
        if name.startswith("presolve."):
            assert all(any(ps <= s and e <= pe
                           for ps, pe in names["presolve"])
                       for s, e in ivs), name


@pytest.mark.parametrize("route", ["pdlp", "ipm"])
def test_children_cover_the_solve(runs, route):
    host, rec, _ = runs[route]
    names = by_name(host)
    ((s0, e0),) = names["solve"]
    kids = [iv for name in SOLVE_CHILDREN[route] for iv in names[name]]
    assert trace.union_length(kids) >= 0.9 * (e0 - s0)
    assert rec["api"]["run_data"].solve_time == pytest.approx(
        (e0 - s0) * 1e-9, rel=0.02, abs=1e-3)


def test_ipm_setup_is_prepare_and_start(runs):
    timer = runs["ipm"][1]["api"]["timer"]
    parts = timer.read("ipm.prepare") + timer.read("ipm.start")
    assert parts <= timer.read("ipm_setup")
    assert parts >= 0.95 * timer.read("ipm_setup") - 1e-3
    assert timer.num_calls("ipm_iterations") == \
        runs["ipm"][1]["api"]["info"].ipm_iteration_count > 0


def test_presolve_counts_the_stack_by_rule():
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    from highs_tpu_torch.presolve.presolve import presolve_lp
    lp = reducible_lp()
    m, n = lp.a.shape
    model = HighsLp(num_col=n, num_row=m, col_cost=lp.c,
                    col_lower=np.zeros(n), col_upper=lp.upper,
                    row_lower=lp.b, row_upper=np.full(m, np.inf),
                    a_matrix=HighsSparseMatrix.from_scipy(lp.a), sense=1)
    opts = HighsOptions()
    opts._timer = timer = HighsTimer()
    result = presolve_lp(model, opts, "cpu")
    assert result.reduced
    tags = collections.Counter(entry[0] for entry in result.stack)
    counted = collections.Counter()
    for rule, tag in RULE_TAG.items():
        counted[tag] += timer.counter("presolve." + rule)
    del counted[None]
    assert +counted == tags
    for rule in ("singleton_row", "empty_col", "fixed_col"):
        assert timer.counter("presolve." + rule) >= 1
    passes = timer.num_calls("presolve.empty_row")
    assert passes >= 1
    assert all(timer.num_calls("presolve." + r) == passes
               for r in RULE_TAG)
    assert timer.num_calls("presolve.build") == 1
    # the option that logs them
    lines = []
    opts.presolve_rule_logging = True
    from highs_tpu_torch.presolve.presolve import log_rule_use
    log_rule_use(opts, lines.append)
    assert any(line.startswith("presolve.singleton_row") for line in lines)
    assert not any(line.startswith("run ") for line in lines)


def test_timer_counters_and_report():
    timer = HighsTimer()
    with timer.scope("a") as sc:
        sc.calls = 3
    timer.count("c")
    timer.count("c", 4)
    assert timer.num_calls("a") == 3 and timer.counter("c") == 5
    assert timer.counter("none") == 0
    report = timer.report()
    assert report[-2].split() == ["Counter", "Count"]
    assert report[-1].split() == ["c", "5"]
    timer.reset()
    assert timer.counter("c") == 0 and timer.num_calls("a") == 0


@pytest.mark.parametrize("route,metric", [
    (route, metric) for route, names in NEW_METRICS.items()
    for metric in names])
def test_metric_reads_the_profile(runs, route, metric):
    host, rec, t = runs[route]
    run = harness.Run()
    run.calls = [rec]
    run.trace = t
    value = harness.load_metric(metric).read(run)
    assert value is not None and math.isfinite(value) and value >= 0.0
    # a trace without the program's spans (a program that opens none)
    # reads nothing
    bare = trace.Trace()
    bare.add([], [(s, e, n) for s, e, n in host
                  if not n.startswith("highs.")], [])
    run.trace = bare
    assert harness.load_metric(metric).read(run) is None


def test_idle_unattributed_share():
    t = trace.Trace()
    t.host["highs.run"] = [100, 1]
    t.idle.update({"run": 10, "passModel": 5, "run: highs.solve": 5,
                   "run: highs.presolve": 4, "run: highs.pdlp_round": 3,
                   "run: highs.ipm_setup": 2, "run: highs.run": 1,
                   "run: highs.pdlp.setup": 30,
                   "run: highs.presolve.singleton_row": 10,
                   "run: aten::copy_": 30})
    run = harness.Run()
    run.trace = t
    share = harness.load_metric("idle_unattributed.solve").read(run)
    assert share == pytest.approx(30.0)


def test_a_span_that_did_not_run_counts_zero(runs):
    # a solve that needs no refinement opens no oracle: 0 s, where a
    # program that opens no span at all reads nothing
    _, rec, _ = runs["pdlp"]
    run = harness.Run()
    run.calls = [rec, rec]
    run.trace = trace.Trace()
    run.trace.host["highs.pdlp.setup"] = [3_000_000_000, 2]
    setup = harness.load_metric("pdlp_setup_s")
    oracle = harness.load_metric("pdlp_oracle_s")
    assert setup.read(run) == pytest.approx(1.5)
    assert oracle.read(run) == 0.0
    run.trace = trace.Trace()
    assert setup.read(run) is None and oracle.read(run) is None


def _toy_cover(seed: int):
    """A 12 x 24 set cover, three rows a column, integer costs 1..9:
    min c'x s.t. A x >= 1, x binary (its root enters separation)."""
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    rng = np.random.default_rng(seed)
    m, n = 12, 24
    rows = np.stack([rng.choice(m, size=3, replace=False) for _ in range(n)])
    a = sp.lil_matrix((m, n))
    a[rows.ravel(), np.repeat(np.arange(n), 3)] = 1.0
    for i in np.flatnonzero(np.asarray(a.sum(axis=1)).ravel() == 0):
        a[i, i % n] = 1.0
    a = a.tocsc()
    cost = rng.integers(1, 10, n).astype(np.float64)
    return HighsLp(num_col=n, num_row=m, col_cost=cost,
                   col_lower=np.zeros(n), col_upper=np.ones(n),
                   row_lower=np.ones(m), row_upper=np.full(m, np.inf),
                   a_matrix=HighsSparseMatrix.from_scipy(a), sense=1,
                   integrality=np.ones(n, dtype=np.uint8)), a, cost


def test_a_bare_scope_exit_closes_its_span():
    # `scope.__exit__()` with no arguments, as the MIP's separation
    # clock is closed, ends the span under a running profiler
    timer = HighsTimer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        scope = timer.scope("bare")
        scope.__enter__()
        scope.__exit__()
    assert timer.num_calls("bare") == 1
    assert any(e.name == "highs.bare" for e in prof.events())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mip_with_separation_is_optimal_under_the_profiler(seed):
    import highs_tpu_torch
    from scipy.optimize import Bounds, LinearConstraint, milp
    lp, a, cost = _toy_cover(seed)
    want = milp(cost, constraints=LinearConstraint(a, lb=1.0),
                integrality=np.ones(len(cost)), bounds=Bounds(0, 1)).fun
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    h.setOptionValue("mip_parallel_heuristics", False)
    h.passModel(lp)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        h.run()
    assert h.getModelStatus() == highs_tpu_torch.HighsModelStatus.kOptimal
    assert h.getObjectiveValue() == pytest.approx(want, abs=1e-6)
    assert h.getTimer().num_calls("mip::separation") >= 1
    assert any(e.name == "highs.mip::separation" for e in prof.events())
