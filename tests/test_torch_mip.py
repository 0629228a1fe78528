"""The MIP through the port's facade, against the JAX package and scipy's
`milp`, on the CPU.

The instance-free cases of `tests/test_mip.py` (infeasible, knapsack,
SOS1, SOS2, the restart on heavy fixing, semi-variables) and seeded set
covering and facility location (`utils/gen_mip.py`) go through
`Highs(device="cpu").run()` and the JAX package's `Highs().run()`: the
same statuses, objectives within mip_rel_gap of each other and of
scipy's proven optimum, and incumbents that are feasible and integral
in the model's own data.  Parts of a MIP run are time-boxed and
threaded, so node counts are not compared; `mip_parallel_heuristics` is
off where a test needs a repeatable run."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.solvers import native_lib
from highs_tpu_torch.solvers.ipm import solver as ipm_solver
from highs_tpu_torch.solvers.mip import solver as mip_solver
from highs_tpu_torch.tools.mip_anchors import scipy_milp
from highs_tpu_torch.utils.gen_mip import (equality_knapsacks,
                                           facility_location, set_cover)

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

REL_GAP = 1e-4  # the default mip_rel_gap


def jax_lp(d):
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    return highs_tpu.HighsLp(
        num_col=d["num_col"], num_row=d["num_row"],
        col_cost=np.array(d["col_cost"], dtype=float),
        col_lower=np.array(d["col_lower"], dtype=float),
        col_upper=np.array(d["col_upper"], dtype=float),
        row_lower=np.array(d["row_lower"], dtype=float),
        row_upper=np.array(d["row_upper"], dtype=float),
        a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(a),
        sense=int(d.get("sense", 1)),
        integrality=np.array(d.get("integrality", np.zeros(0)),
                             dtype=np.uint8),
        sos=list(d.get("sos", [])))


def torch_lp(d):
    lp = lp_from_numpy(d)
    lp.sos = list(d.get("sos", []))
    return lp


def run(facade, d, **opts):
    if facade == "torch":
        h = highs_tpu_torch.Highs(device="cpu")
        h.passModel(torch_lp(d))
    else:
        h = highs_tpu.Highs()
        h.passModel(jax_lp(d))
    h.setOptionValue("output_flag", False)
    h.setOptionValue("mip_parallel_heuristics", False)
    for k, v in opts.items():
        h.setOptionValue(k, v)
    h.run()
    return h


def model_dict(a, cost, lo, up, rl, ru, integ, sense=1, sos=()):
    a = sp.csc_matrix(np.asarray(a, dtype=float))
    return dict(num_col=a.shape[1], num_row=a.shape[0],
                col_cost=np.asarray(cost, float),
                col_lower=np.asarray(lo, float),
                col_upper=np.asarray(up, float),
                row_lower=np.asarray(rl, float),
                row_upper=np.asarray(ru, float), a_start=a.indptr,
                a_index=a.indices, a_value=a.data,
                integrality=np.asarray(integ, dtype=np.uint8), sense=sense,
                sos=list(sos))


def check_incumbent(d, h, tol=1e-6):
    """The facade's point satisfies the model's rows, bounds and
    integrality in f64, from the model's data alone."""
    x = np.asarray(h.getSolution().col_value, dtype=float)
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    ax = a @ x
    assert np.all(ax >= d["row_lower"] - tol)
    assert np.all(ax <= d["row_upper"] + tol)
    assert np.all(x >= d["col_lower"] - tol)
    assert np.all(x <= d["col_upper"] + tol)
    is_int = np.asarray(d["integrality"]) == 1
    assert np.all(np.abs(x[is_int] - np.round(x[is_int])) <= tol)
    assert h.getInfo().max_integrality_violation <= tol


def both(d, **opts):
    """The port's and the JAX package's runs: the same status, and
    objectives within mip_rel_gap of each other."""
    got, want = run("torch", d, **opts), run("jax", d, **opts)
    assert got.getModelStatus().name == want.getModelStatus().name
    if got.getModelStatus().name == "kOptimal":
        go, wo = got.getObjectiveValue(), want.getObjectiveValue()
        assert abs(go - wo) <= REL_GAP * max(1.0, abs(wo))
        check_incumbent(d, got)
    return got, want


def test_infeasible():
    # 1.6 <= x + y <= 1.8 over binaries
    d = model_dict([[1.0, 1.0]], [1.0, 1.0], [0, 0], [1, 1], [1.6], [1.8],
                   [1, 1])
    got, _ = both(d)
    assert got.getModelStatus().name == "kInfeasible"


def test_knapsack():
    # max 8a + 11b + 6c + 4d s.t. 5a+7b+4c+3d <= 14, binary: 21
    d = model_dict([[5.0, 7.0, 4.0, 3.0]], [8.0, 11.0, 6.0, 4.0],
                   np.zeros(4), np.ones(4), [-np.inf], [14.0], np.ones(4),
                   sense=-1)
    got, _ = both(d)
    assert got.getModelStatus().name == "kOptimal"
    assert abs(got.getObjectiveValue() - 21.0) < 1e-6


def test_sos1():
    """max x1+x2+x3, x <= 1 each, SOS1: exactly one at 1."""
    d = model_dict(np.ones((1, 3)), [-1.0, -1.0, -1.0], np.zeros(3),
                   np.ones(3), [-np.inf], [10.0], [],
                   sos=[("S1", 0, [0, 1, 2], [1.0, 2.0, 3.0])])
    got, _ = both(d)
    x = np.asarray(got.getSolution().col_value)
    assert got.getModelStatus().name == "kOptimal"
    assert np.sum(np.abs(x) > 1e-6) <= 1
    assert abs(got.getObjectiveValue() + 1.0) < 1e-6


def test_sos2():
    """SOS2 over four members: at most two adjacent nonzeros; -3."""
    d = model_dict(np.ones((1, 4)), [-1.0, -2.0, -1.0, -2.0], np.zeros(4),
                   np.ones(4), [-np.inf], [10.0], [],
                   sos=[("S2", 0, [0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0])])
    got, _ = both(d)
    x = np.asarray(got.getSolution().col_value)
    nz = np.nonzero(np.abs(x) > 1e-6)[0]
    assert len(nz) <= 2 and (len(nz) < 2 or nz[1] == nz[0] + 1)
    assert abs(got.getObjectiveValue() + 3.0) < 1e-6


@pytest.mark.parametrize("restart", [True, False])
def test_restart_on_heavy_fixing(restart):
    """Singleton rows fix most binaries at the root: the same answer
    with and without the restart."""
    n = 10
    d = model_dict(np.eye(n), np.full(n, -1.0), np.zeros(n), np.ones(n),
                   np.full(n, -np.inf),
                   np.concatenate([np.zeros(n - 2), [1.5, 1.5]]),
                   np.ones(n))
    got, _ = both(d, mip_allow_restart=restart, presolve="off")
    assert got.getModelStatus().name == "kOptimal"
    assert abs(got.getObjectiveValue() + 2.0) < 1e-6


SEEDED = {
    "setcover_50x100": lambda: set_cover(50, 100, 0.05, seed=0),
    "setcover_100x200": lambda: set_cover(100, 200, 0.05, seed=1),
    "cfl_10x10": lambda: facility_location(10, 10, seed=0),
    "cfl_15x15": lambda: facility_location(15, 15, seed=1),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_mips_like_jax_and_scipy(name):
    d = SEEDED[name]()
    got, want = both(d)
    status, obj, _, _ = scipy_milp(d)
    assert status == 0 and got.getModelStatus().name == "kOptimal"
    assert abs(got.getObjectiveValue() - obj) <= REL_GAP * max(1.0,
                                                                abs(obj))
    info = got.getInfo()
    assert info.mip_node_count >= 1 and info.mip_gap <= REL_GAP
    assert info.mip_dual_bound <= got.getObjectiveValue() + 1e-6


def _semi_dict(semi_kind):
    """min 0.4 x + y s.t. x + y >= 2.5, x semi in {0} or [3, 10] (semi-
    integer: x integral there), 0 <= y <= 5."""
    return model_dict([[1.0, 1.0]], [0.4, 1.0], [3.0, 0.0], [10.0, 5.0],
                      [2.5], [np.inf], [semi_kind, 0])


@pytest.mark.parametrize("semi_kind", [2, 3])
def test_semi_variables_like_jax_and_scipy(semi_kind):
    """The semi-variable reformulation (binary indicator and two
    variable-bound rows) and its postsolve: the original columns and
    rows come back, with scipy's optimum."""
    d = _semi_dict(semi_kind)
    got, want = both(d)
    sol = got.getSolution()
    assert len(sol.col_value) == 2 and len(sol.row_value) == 1
    np.testing.assert_allclose(sol.row_value,
                               want.getSolution().row_value, atol=1e-9)
    status, obj, _, _ = scipy_milp(d)
    assert status == 0
    assert abs(got.getObjectiveValue() - obj) < 1e-6
    x = sol.col_value[0]
    assert abs(x) < 1e-9 or 3.0 - 1e-9 <= x <= 10.0 + 1e-9


def test_semi_variable_modification_sequence():
    """Solve, fix the semi column at 0, switch it to semi-integer and
    restore its bounds: each solve as the JAX facade's."""
    d = model_dict([[1.0, 1.0, 1.0]], [-1.0, -0.5, 0.3], [2.5, 0.0, 0.0],
                   [6.3, 4.0, 1.0], [-np.inf], [7.4], [2, 0, 1])
    hs = [run("torch", d), run("jax", d)]
    objs = [[h.getObjectiveValue() for h in hs]]
    for h, pkg in zip(hs, (highs_tpu_torch, highs_tpu)):
        h.changeColBounds(0, 0.0, 0.0)
        h.run()
    objs.append([h.getObjectiveValue() for h in hs])
    for h, pkg in zip(hs, (highs_tpu_torch, highs_tpu)):
        h.changeColIntegrality(0, pkg.HighsVarType.kSemiInteger)
        h.changeColBounds(0, 2.5, 6.3)
        h.run()
    objs.append([h.getObjectiveValue() for h in hs])
    for t, j in objs:
        assert abs(t - j) < 1e-6
    assert objs[0][0] < objs[2][0] < objs[1][0]


@pytest.mark.parametrize("option,value", [("tpu_mip_batch_nodes", 4),
                                          ("mip_search_simulate_concurrency",
                                           True),
                                          ("parallel", "on")])
def test_batched_node_lps_match_jax(option, value):
    # each option that turns the batched node LPs on: the same answer as
    # the JAX package (whose batch never runs a round, ROADMAP queue 3)
    # and as scipy, with a feasible integral incumbent
    d = set_cover(30, 60, 0.1, seed=2)
    got, _ = both(d, **{option: value})
    assert got.getModelStatus().name == "kOptimal"
    _, ref, _, _ = scipy_milp(d)
    assert abs(got.getObjectiveValue() - ref) <= REL_GAP * max(1.0, abs(ref))


def test_native_library_that_will_not_load_raises(monkeypatch, tmp_path):
    """A native library that neither loads nor builds raises out of
    `run()`: no Python propagator, separator or search takes over."""
    monkeypatch.setattr(native_lib, "_LOADED", {})
    monkeypatch.setattr(native_lib, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    h = highs_tpu_torch.Highs(device="cpu")
    h.passModel(torch_lp(set_cover(20, 40, 0.1, seed=2)))
    h.setOptionValue("output_flag", False)
    with pytest.raises(OSError):
        h.run()


def test_objective_bound_and_target():
    d = set_cover(60, 120, 0.05, seed=4)
    best = run("torch", d).getObjectiveValue()
    for opts, want in (({"objective_bound": best - 5.0}, "kObjectiveBound"),
                       ({"objective_target": best + 50.0},
                        "kObjectiveTarget")):
        got, jax = both(d, **opts)
        assert got.getModelStatus().name in (want, "kOptimal")


def test_mip_callbacks_fire_like_jax():
    """The MIP callbacks: every improving solution is reported, and an
    interrupt from kCallbackMipInterrupt stops the search."""
    d = facility_location(12, 12, seed=3)
    for pkg in (highs_tpu_torch, highs_tpu):
        seen = []

        def cb(kind, msg, data_out, data_in, user_data):
            seen.append(int(kind))
            if int(kind) == int(pkg.HighsCallbackType.kCallbackMipInterrupt):
                data_in.user_interrupt = True
        h = (pkg.Highs(device="cpu") if pkg is highs_tpu_torch
             else pkg.Highs())
        h.passModel(torch_lp(d) if pkg is highs_tpu_torch else jax_lp(d))
        h.setOptionValue("output_flag", False)
        h.setCallback(cb)
        for t in ("kCallbackMipImprovingSolution", "kCallbackMipInterrupt"):
            h.startCallback(getattr(pkg.HighsCallbackType, t))
        h.run()
        assert int(pkg.HighsCallbackType.kCallbackMipImprovingSolution) \
            in seen
        assert h.getModelStatus().name in ("kInterrupt", "kOptimal")


def test_node_lps_above_the_simplex_gate_run_in_the_ipm(monkeypatch):
    """With the simplex gate lowered, every node LP of a facility
    location goes to the IPM on the solver's device, as above 10,000 rows
    on the card: scipy's optimum, IPM solves counted on the CPU, and the
    MIP's time limit held."""
    monkeypatch.setattr(mip_solver, "SIMPLEX_MAX_ROWS", 50)
    d = facility_location(8, 8, seed=5)
    solves0 = dict(ipm_solver.SOLVES)
    h = run("torch", d, time_limit=60.0)
    status, obj, _, _ = scipy_milp(d)
    assert h.getModelStatus().name == "kOptimal"
    assert abs(h.getObjectiveValue() - obj) <= REL_GAP * max(1.0, abs(obj))
    check_incumbent(d, h)
    assert ipm_solver.SOLVES["cpu"] - solves0["cpu"] >= h.getInfo(
    ).mip_node_count
    assert h.getTimer().num_calls("mip::node_lp") >= 1


def test_ipm_node_lps_keep_the_time_limit(monkeypatch):
    monkeypatch.setattr(mip_solver, "SIMPLEX_MAX_ROWS", 50)
    d = facility_location(25, 25, seed=6)
    h = run("torch", d, time_limit=3.0)
    assert h.getRunTime() < 3.0 + 10.0
    assert h.getModelStatus().name in ("kTimeLimit", "kOptimal")


def test_central_rounding_runs_the_ipm_on_the_solver_device():
    """An equality-knapsack program has no incumbent after the root's
    roundings, so central rounding solves the analytic centre with the
    IPM on the facade's device (the CPU here, the card in
    chip_smoke.py)."""
    d = equality_knapsacks(4, 20, seed=0)
    solves0 = dict(ipm_solver.SOLVES)
    dense0 = dict(ipm_solver.DENSE_FACTORS)
    got, _ = both(d)
    assert got.getModelStatus().name == "kOptimal"
    assert ipm_solver.SOLVES["cpu"] - solves0["cpu"] >= 1
    assert ipm_solver.DENSE_FACTORS["cpu"] - dense0["cpu"] >= 1
    status, obj, _, _ = scipy_milp(d)
    assert abs(got.getObjectiveValue() - obj) < 1e-6


@pytest.mark.parametrize("error", ["AcceleratorError", "OutOfMemoryError"])
def test_a_device_error_in_central_rounding_passes_through(error,
                                                           monkeypatch):
    """Central rounding catches its own numerical failure only: a torch
    device error from its IPM solve reaches the caller of `run()`."""
    def failing(*args, **kwargs):
        raise getattr(torch, error)("device failure")
    monkeypatch.setattr(mip_solver, "solve_lp_ipm_native", failing)
    h = highs_tpu_torch.Highs(device="cpu")
    h.passModel(torch_lp(equality_knapsacks(4, 20, seed=0)))
    h.setOptionValue("output_flag", False)
    with pytest.raises(getattr(torch, error)):
        h.run()


def test_an_error_in_the_worker_thread_raises(monkeypatch):
    """An exception in the feasibility-jump worker thread of the native
    search is raised by `run()` once the thread is joined."""
    import threading
    real = mip_solver.feasibility_jump

    def failing_off_main(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            raise OSError("worker failure")
        return real(*args, **kwargs)
    monkeypatch.setattr(mip_solver, "feasibility_jump", failing_off_main)
    h = highs_tpu_torch.Highs(device="cpu")
    h.passModel(torch_lp(set_cover(100, 200, 0.05, seed=1)))
    h.setOptionValue("output_flag", False)
    with pytest.raises(OSError, match="worker failure"):
        h.run()
