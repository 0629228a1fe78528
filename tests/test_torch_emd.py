"""The Earth Mover's Distance with the L1 ground metric between DOTmark
WhiteNoise images (`lpbench/generators/emd_l1.py`), a min-cost flow on
the pixel grid, through the port on the CPU: held against scipy's HiGHS
and the plain certificate of `lpbench/flow_reference.py`, against the
closed form of W1 on a line, and the IPM's Newton route at 65,536 rows
read from the pattern alone."""
import pathlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import highs_tpu_torch  # noqa: E402
from highs_tpu_torch.constants import HighsModelStatus  # noqa: E402
from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix  # noqa: E402
from highs_tpu_torch.solvers.ipm import solver  # noqa: E402
from lpbench import flow_reference  # noqa: E402
from lpbench.generators import emd_l1  # noqa: E402

# the tests run in parallel worker processes on shared cores
torch.set_num_threads(1)

IPM_LDL = {"solver": "ipm", "tpu_ipm_newton": "ldl", "run_crossover": "off"}
# the spans of the Newton phases on the routes that assemble M on the host
PHASES = ("ipm.normal", "ipm.factor", "ipm.solve")


def model(lp: flow_reference.FlowLp) -> HighsLp:
    m, n = lp.a.shape
    return HighsLp(num_col=n, num_row=m, col_cost=lp.c.copy(),
                   col_lower=np.zeros(n), col_upper=np.full(n, np.inf),
                   row_lower=lp.b.copy(), row_upper=lp.b.copy(),
                   a_matrix=HighsSparseMatrix.from_scipy(lp.a.tocsc()),
                   sense=1)


def solve(lp: flow_reference.FlowLp, options: dict):
    """The facade's run on the CPU: (the facade, x, y, objective)."""
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    for key, val in options.items():
        h.setOptionValue(key, val)
    h.passModel(model(lp))
    h.run()
    assert h.getModelStatus() == HighsModelStatus.kOptimal
    sol = h.getSolution()
    return (h, np.asarray(sol.col_value), np.asarray(sol.row_dual),
            h.getObjectiveValue())


def scipy_optimum(lp: flow_reference.FlowLp) -> float:
    ref = linprog(lp.c, A_eq=lp.a, b_eq=lp.b, bounds=(0, None),
                  method="highs")
    assert ref.status == 0
    return float(ref.fun)


@pytest.mark.parametrize("res", [32, 64])
@pytest.mark.parametrize("route", ["ipm_ldl", "choose"])
def test_emd_matches_scipy_and_the_certificate(res, route):
    """A 32^2 and a 64^2 pair through the IPM's "ldl" route and through
    `choose` (which sends these sizes to the simplex): scipy's optimum
    within 1e-6 relative, the plain certificate within 1e-7."""
    lp = emd_l1.generate({"res": res, "seed": 1})
    assert lp.a.shape == (res * res, 4 * res * (res - 1))
    routes0 = dict(solver.ROUTES)
    h, x, y, obj = solve(lp, IPM_LDL if route == "ipm_ldl" else {})
    info = h.getInfo()
    if route == "ipm_ldl":
        assert info.ipm_iteration_count > 0
        assert solver.ROUTES["ldl"] == routes0["ldl"] + 1
    else:
        assert info.simplex_iteration_count > 0
        assert info.ipm_iteration_count <= 0
    want = scipy_optimum(lp)
    assert abs(obj - want) <= 1e-6 * abs(want)
    cert = flow_reference.certificate(lp, x, y, obj)
    assert flow_reference.worst(cert) <= 1e-7, cert


def test_strip_against_the_closed_form():
    """On a 1 x n image W1 is the mass that crosses each cut: the IPM's
    optimum matches the closed form."""
    rng = np.random.default_rng(11)
    mu, nu = rng.random((1, 300)), rng.random((1, 300))
    mu *= mu.size / mu.sum()
    nu *= nu.size / nu.sum()
    lp = emd_l1.emd_lp(mu, nu)
    h, x, y, obj = solve(lp, {"solver": "ipm", "run_crossover": "off"})
    assert h.getInfo().ipm_iteration_count > 0
    want = flow_reference.strip_w1(mu.ravel(), nu.ravel())
    assert abs(obj - want) <= 1e-6 * want
    assert flow_reference.worst(
        flow_reference.certificate(lp, x, y, obj)) <= 1e-7


def random_flow_pattern(m: int, arcs: int, seed: int = 0) -> sp.csr_matrix:
    """The node-arc matrix of `arcs` random arcs between `m` nodes."""
    rng = np.random.default_rng(seed)
    ends = rng.integers(0, m, (arcs, 2))
    ends = ends[ends[:, 0] != ends[:, 1]]
    k = len(ends)
    a = sp.csc_matrix((np.tile([1.0, -1.0], k), ends.ravel(),
                       np.arange(0, 2 * k + 1, 2)), shape=(m, k))
    return a.tocsr()


def test_route_at_65536_rows_from_the_pattern():
    """Up to the IPM gate's 80,000 rows `choose` keeps the "ldl" route
    where the factor of M stays within the route's budget: the 256^2
    grid flow does, a random flow network of as many nodes fills in and
    takes "cg"; past the gate "cg" takes every pattern; the option
    overrides."""
    grid = emd_l1.generate({"res": 256, "seed": 0}).a.tocsr()
    assert solver.LARGE_M_ROWS < grid.shape[0] == 65536
    assert solver.newton_route(grid) == "ldl"
    assert solver._ldl_analysis(grid) is not None
    scattered = random_flow_pattern(65536, 78643)
    assert solver.newton_route(scattered) == "cg"
    assert solver._ldl_analysis(scattered) is None
    big = emd_l1.emd_lp(np.ones((290, 290)), np.ones((290, 290))).a
    assert big.shape[0] > solver.IPM_MAX_ROWS
    assert solver.newton_route(big.tocsr()) == "cg"
    assert solver.newton_route(grid, "cg") == "cg"
    assert solver.newton_route(scattered, "ldl") == "ldl"


def fresh_banded_caches(monkeypatch):
    """The banded structures and the patterns found not banded, empty for
    this test alone."""
    monkeypatch.setattr(solver, "_BANDED_CACHE", {})
    monkeypatch.setattr(solver, "_BANDED_REJECT", set())


def no_band(monkeypatch):
    """Every pattern found not banded, as an unstructured one is."""
    monkeypatch.setattr(solver.BandedCholesky, "from_spd",
                        staticmethod(lambda *args, **kwargs: None))


def test_starting_point_factors_on_the_routes_analysis(monkeypatch):
    """Where the route's choice analysed M's pattern (from
    `LARGE_M_ROWS` rows, lowered here below a 64^2 flow's 4,096) and the
    pattern is not banded, the starting point's LDL' factors on that
    analysis: one symbolic analysis a solve, and the solve optimal on
    the "ldl" route."""
    monkeypatch.setattr(solver, "LARGE_M_ROWS", 4000)
    fresh_banded_caches(monkeypatch)
    no_band(monkeypatch)
    start0 = dict(solver.START_FACTORS)
    made = []

    class Counted(solver.SparseLdl):
        def __init__(self, *args, **kwargs):
            made.append(kwargs.get("numeric", True))
            super().__init__(*args, **kwargs)
    monkeypatch.setattr(solver, "SparseLdl", Counted)
    routes0 = solver.ROUTES["ldl"]
    lp = emd_l1.generate({"res": 64, "seed": 0})
    h, x, y, obj = solve(lp, {"solver": "ipm", "run_crossover": "off"})
    assert solver.ROUTES["ldl"] == routes0 + 1
    assert made == [False]
    assert {k: solver.START_FACTORS[k] - start0[k] for k in start0} == \
        {"banded_cuda": 0, "banded_cpu": 0, "ldl": 1}
    assert abs(obj - scipy_optimum(lp)) <= 1e-6 * abs(obj)


def ldl_run(lp):
    """A solve on the "ldl" route: (the facade, x, y, objective, the
    Newton factors by engine, the starting point's factors by engine,
    the banded factor's hand-offs), the counters as the solve grew
    them."""
    factors0 = dict(solver.SPARSE_FACTORS)
    start0 = dict(solver.START_FACTORS)
    handoffs0 = solver.BANDED_HANDOFFS["gate"]
    h, x, y, obj = solve(lp, {"solver": "ipm", "run_crossover": "off"})
    assert h.getInfo().ipm_iteration_count > 0
    return (h, x, y, obj,
            {k: v - factors0[k] for k, v in solver.SPARSE_FACTORS.items()},
            {k: v - start0[k] for k, v in solver.START_FACTORS.items()},
            solver.BANDED_HANDOFFS["gate"] - handoffs0)


def test_banded_factor_serves_every_newton_solve(monkeypatch):
    """A 64^2 flow on the "ldl" route with `LARGE_M_ROWS` lowered below
    its 4,096 rows: the starting point and every Newton factor on the
    banded f64 factor (here on the CPU), none on SuperLU, no hand-off by
    the Newton residual's gate; the iterations within one of the same
    LP's on SuperLU (the pattern taken for not banded), and the answer
    scipy's within 1e-6 with the certificate within 1e-7."""
    monkeypatch.setattr(solver, "LARGE_M_ROWS", 4000)
    fresh_banded_caches(monkeypatch)
    lp = emd_l1.generate({"res": 64, "seed": 0})
    h, x, y, obj, factors, start, handoffs = ldl_run(lp)
    iterations = h.getInfo().ipm_iteration_count
    assert factors == {**dict.fromkeys(factors, 0),
                       "banded_cpu": iterations}
    assert start == {"banded_cuda": 0, "banded_cpu": 1, "ldl": 0}
    assert handoffs == 0
    assert abs(obj - scipy_optimum(lp)) <= 1e-6 * abs(obj)
    cert = flow_reference.certificate(lp, x, y, obj)
    assert flow_reference.worst(cert) <= 1e-7, cert

    fresh_banded_caches(monkeypatch)
    no_band(monkeypatch)
    h, _, _, host_obj, factors, start, handoffs = ldl_run(lp)
    host_iterations = h.getInfo().ipm_iteration_count
    assert factors == {**dict.fromkeys(factors, 0),
                       "superlu": host_iterations}
    assert start == {"banded_cuda": 0, "banded_cpu": 0, "ldl": 1}
    assert abs(iterations - host_iterations) <= 1
    assert abs(obj - host_obj) <= 1e-8 * abs(host_obj)


def test_traced_solve_opens_the_phase_spans_and_counts_factors():
    """A traced 64^2 solve on the "ldl" route: the three Newton phases
    are spans inside `ipm_iterations`, "normal" and "factor" once an
    iteration and "solve" twice; the counter of factors by engine grows
    by one an iteration, on the native LDL' at this size."""
    from torch.profiler import ProfilerActivity, profile
    lp = emd_l1.generate({"res": 64, "seed": 0})
    factors0 = dict(solver.SPARSE_FACTORS)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        h, _, _, _ = solve(lp, IPM_LDL)
    finally:
        prof.stop()
    iterations = h.getInfo().ipm_iteration_count
    assert iterations > 0
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("highs."):
            spans.setdefault(ev.name()[len("highs."):], []).append(
                (ev.start_ns(), ev.end_ns()))
    counts = {p: len(spans.get(p, [])) for p in PHASES}
    assert counts == {"ipm.normal": iterations, "ipm.factor": iterations,
                      "ipm.solve": 2 * iterations}
    (outer,) = spans["ipm_iterations"]
    assert all(outer[0] <= s and e <= outer[1]
               for p in PHASES for s, e in spans[p])
    grew = {k: solver.SPARSE_FACTORS[k] - factors0[k] for k in factors0}
    assert grew == {**dict.fromkeys(grew, 0), "ldl": iterations}
