"""The port's Highs facade against the JAX package's, on the CPU: the same
LP passed directly and read back from an MPS file the port writes gives
the same model status and objective; presolve reduces an LP the same
way in both packages."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.presolve.presolve import presolve_lp as jax_presolve
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.presolve.presolve import presolve_lp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

LP_FIELDS = ("num_col", "num_row", "col_cost", "col_lower", "col_upper",
             "row_lower", "row_upper", "offset")


def _lp_dict():
    """A seeded LP with a fixed column, a singleton row and an empty row,
    so that presolve has something to remove."""
    rng = np.random.default_rng(5)
    m, n = 120, 150
    a = sp.random(m, n, density=0.05, random_state=rng, format="lil")
    a[m - 1, :] = 0.0            # empty row
    a[m - 2, :] = 0.0
    a[m - 2, 3] = 2.0            # singleton row
    a = a.tocsc()
    r = a @ rng.uniform(0, 1, n)
    rl = r - np.abs(rng.standard_normal(m)) * 0.1
    ru = np.where(rng.uniform(size=m) < 0.2, r, np.inf)
    rl[m - 1], ru[m - 1] = -1.0, 1.0
    lo, up = np.zeros(n), np.full(n, 4.0)
    lo[7] = up[7] = 0.5          # fixed column
    return dict(num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1, n),
                col_lower=lo, col_upper=up, row_lower=rl, row_upper=ru,
                a_start=a.indptr, a_index=a.indices, a_value=a.data)


def _jax_lp(d):
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    return highs_tpu.HighsLp(
        num_col=d["num_col"], num_row=d["num_row"],
        col_cost=np.array(d["col_cost"]), col_lower=np.array(d["col_lower"]),
        col_upper=np.array(d["col_upper"]), row_lower=np.array(d["row_lower"]),
        row_upper=np.array(d["row_upper"]),
        a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(a), sense=1)


def _run(h, load):
    h.setOptionValue("output_flag", False)
    h.setOptionValue("solver", "hipdlp")
    assert int(load(h)) == 0
    h.run()
    return h.getModelStatus(), h.getObjectiveValue()


def _assert_same(port, jax):
    assert int(port[0]) == int(jax[0]) == \
        int(highs_tpu_torch.HighsModelStatus.kOptimal)
    assert abs(port[1] - jax[1]) <= 1e-6 * max(1.0, abs(jax[1]))


def test_pass_model_matches_jax():
    d = _lp_dict()
    port = _run(highs_tpu_torch.Highs(device="cpu"),
                lambda h: h.passModel(lp_from_numpy(d)))
    jax = _run(highs_tpu.Highs(), lambda h: h.passModel(_jax_lp(d)))
    _assert_same(port, jax)


def test_mps_written_by_port_matches_jax(tmp_path):
    d = _lp_dict()
    path = str(tmp_path / "seeded.mps")
    writer = highs_tpu_torch.Highs(device="cpu")
    writer.passModel(lp_from_numpy(d))
    assert int(writer.writeModel(path)) == 0
    port = _run(highs_tpu_torch.Highs(device="cpu"),
                lambda h: h.readModel(path))
    jax = _run(highs_tpu.Highs(), lambda h: h.readModel(path))
    _assert_same(port, jax)
    direct = _run(highs_tpu_torch.Highs(device="cpu"),
                  lambda h: h.passModel(lp_from_numpy(d)))
    _assert_same(port, direct)


def test_presolve_reduces_like_jax():
    d = _lp_dict()
    jres = jax_presolve(_jax_lp(d), JOptions())
    tres = presolve_lp(lp_from_numpy(d), HighsOptions())
    assert int(tres.status) == int(jres.status)
    assert tres.reduced and jres.reduced
    jl, tl = jres.reduced_lp, tres.reduced_lp
    assert tl.num_col < d["num_col"] and tl.num_row < d["num_row"]
    for name in LP_FIELDS:
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name),
                                      err_msg=name)
    assert (tl.a_matrix.to_scipy() != jl.a_matrix.to_scipy()).nnz == 0
    np.testing.assert_array_equal(tres.keep_rows, jres.keep_rows)
    np.testing.assert_array_equal(tres.keep_cols, jres.keep_cols)


def test_run_data_covers_the_last_run_only():
    h = highs_tpu_torch.Highs(device="cpu")
    _run(h, lambda hh: hh.passModel(lp_from_numpy(_lp_dict())))
    h.run()
    rd = h.getRunData()
    assert rd.valid
    assert h.getTimer().num_calls("run") == 1
    assert h.getTimer().num_calls("solve") == 1
    assert 0.0 < rd.solve_time <= h.getRunTime()
    assert rd.presolved_model_num_col < h.getLp().num_col
    assert h.getInfo().pdlp_iteration_count > 0


def test_not_yet_ported_models_raise(tmp_path):
    d = _lp_dict()
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    lp = lp_from_numpy(dict(d, integrality=np.ones(d["num_col"])))
    h.passModel(lp)
    with pytest.raises(NotImplementedError, match="MIP"):
        h.run()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        h.readModel(str(tmp_path / "model.lp"))
    h.passModel(lp_from_numpy(d))   # 'choose' on a small LP: simplex first
    with pytest.raises(NotImplementedError, match="not yet ported"):
        h.run()


def _highs_pair(lp_dict, **opts):
    """(port Highs on the CPU, JAX Highs) loaded with the same LP."""
    port, jax = highs_tpu_torch.Highs(device="cpu"), highs_tpu.Highs()
    for h in (port, jax):
        h.setOptionValue("output_flag", False)
        for k, v in opts.items():
            h.setOptionValue(k, v)
    port.passModel(lp_from_numpy(lp_dict))
    jax.passModel(_jax_lp(lp_dict))
    return port, jax


@pytest.mark.parametrize("solver", ["ipm", "ipx", "hipo"])
def test_ipm_solver_raises_where_crossover_would_run(solver):
    # the JAX package runs crossover after an optimal IPM solve of an LP
    # of at most 3,000 rows (run_crossover "on" by default): simplex,
    # ROADMAP queue 1 item 4
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    h.setOptionValue("solver", solver)
    h.passModel(lp_from_numpy(_lp_dict()))
    with pytest.raises(NotImplementedError, match="item 4"):
        h.run()


@pytest.mark.parametrize("solver", ["ipm", "ipx", "hipo"])
def test_ipm_solver_without_crossover_matches_jax(solver):
    port, jax = _highs_pair(_lp_dict(), solver=solver,
                            run_crossover="off")
    for h in (port, jax):
        h.run()
        assert int(h.getModelStatus()) == \
            int(highs_tpu_torch.HighsModelStatus.kOptimal)
    pi, ji = port.getInfo(), jax.getInfo()
    assert pi.pdlp_iteration_count == ji.pdlp_iteration_count == -1
    assert abs(pi.ipm_iteration_count - ji.ipm_iteration_count) <= 1
    assert abs(port.getObjectiveValue() - jax.getObjectiveValue()) <= \
        1e-8 * max(1.0, abs(jax.getObjectiveValue()))


def test_default_options_solve_the_gate_lp_like_jax():
    """The smallest kind of LP that the gates send to the IPM (more than
    1,500 rows and more than 120,000 nonzeros): `choose` with default
    options, dense route."""
    from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp
    a, b, c = gen_synth_lp(1600, 4000, per_col=31)
    assert a.nnz > 120_000
    d = dict(num_col=4000, num_row=1600, col_cost=c,
             col_lower=np.zeros(4000), col_upper=np.full(4000, 10.0),
             row_lower=b, row_upper=np.full(1600, np.inf),
             a_start=a.indptr, a_index=a.indices, a_value=a.data)
    port, jax = _highs_pair(d)
    for h in (port, jax):
        h.run()
    pi, ji = port.getInfo(), jax.getInfo()
    print(f"gate LP: port {port.getObjectiveValue()!r} in "
          f"{pi.ipm_iteration_count} IPM iterations, JAX "
          f"{jax.getObjectiveValue()!r} in {ji.ipm_iteration_count}")
    assert int(port.getModelStatus()) == int(jax.getModelStatus()) == \
        int(highs_tpu_torch.HighsModelStatus.kOptimal)
    assert pi.pdlp_iteration_count == ji.pdlp_iteration_count == -1
    assert pi.ipm_iteration_count > 0
    assert abs(pi.ipm_iteration_count - ji.ipm_iteration_count) <= 1
    assert abs(port.getObjectiveValue() - jax.getObjectiveValue()) <= \
        1e-8 * abs(jax.getObjectiveValue())


@pytest.mark.parametrize("verdict", ["kUnknown", "kInfeasible"])
def test_choose_after_an_inconclusive_ipm_like_jax(monkeypatch, verdict):
    """`choose` on an LP in the IPM's range: an inconclusive IPM goes to
    the classification, then (if that cannot decide) to PDLP, and the
    answer is PDLP's; no second IPM solve follows, in either package."""
    import highs_tpu.solvers.classify as jclassify
    import highs_tpu.solvers.ipm.wrapper as jipm
    import highs_tpu.solvers.pdlp.wrapper as jpdlp
    from highs_tpu.solvers.dispatch import solve_lp as jax_solve_lp
    from highs_tpu_torch.solvers import dispatch

    def stubs(pkg_status, calls):
        class Info:
            iterations = 5
            ipm_iterations = 5
            solve_time = 0.0

        class PdlpInfo:
            iterations = 7
            solve_time = 0.0

        def ipm(lp, options, log=None, x0=None, device=None):
            calls.append("ipm")
            return pkg_status.kUnknown, highs_tpu_torch.HighsSolution(), Info()

        def classify(lp, options, log=None, device=None):
            calls.append("classify")
            return getattr(pkg_status, verdict)

        def pdlp(lp, options, x0=None, y0=None, log_callback=None,
                 device=None, **kw):
            calls.append("pdlp")
            return (pkg_status.kIterationLimit,
                    highs_tpu_torch.HighsSolution(), PdlpInfo())
        return ipm, classify, pdlp

    # past the simplex gate (more than 20,000 rows), in the IPM's range
    m, n = 20_001, 5
    a = sp.random(m, n, density=0.3, random_state=0, format="csc")
    d = dict(num_col=n, num_row=m, col_cost=np.ones(n),
             col_lower=np.zeros(n), col_upper=np.ones(n),
             row_lower=np.full(m, -np.inf), row_upper=np.ones(m),
             a_start=a.indptr, a_index=a.indices, a_value=a.data)
    results = {}
    for name in ("port", "jax"):
        calls = []
        if name == "port":
            ipm, classify, pdlp = stubs(highs_tpu_torch.HighsModelStatus,
                                        calls)
            monkeypatch.setattr(dispatch, "solve_lp_ipm", ipm)
            monkeypatch.setattr(dispatch, "classify_inconclusive", classify)
            monkeypatch.setattr(dispatch, "solve_lp_pdlp", pdlp)
            st, _, info = dispatch.solve_lp(
                lp_from_numpy(d), HighsOptions(), presolve=False,
                device="cpu")
        else:
            ipm, classify, pdlp = stubs(highs_tpu.HighsModelStatus, calls)
            monkeypatch.setattr(jipm, "solve_lp_ipm", ipm)
            monkeypatch.setattr(jclassify, "classify_inconclusive", classify)
            monkeypatch.setattr(jpdlp, "solve_lp_pdlp", pdlp)
            st, _, info = jax_solve_lp(_jax_lp(d), JOptions(),
                                       presolve=False)
        results[name] = (calls, int(st), info.ipm_iteration_count,
                         info.pdlp_iteration_count)
    want_calls = ["ipm", "classify"] + (["pdlp"] if verdict == "kUnknown"
                                        else [])
    assert results["port"] == results["jax"]
    assert results["port"][0] == want_calls


def test_icrash_warm_start_matches_jax():
    """iCrash's point warm-starts PDLP through the facade, as in the JAX
    package: the same status and objective."""
    port, jax = _highs_pair(_lp_dict(), solver="hipdlp", icrash=True)
    for h in (port, jax):
        h.run()
    assert int(port.getModelStatus()) == int(jax.getModelStatus()) == \
        int(highs_tpu_torch.HighsModelStatus.kOptimal)
    assert abs(port.getObjectiveValue() - jax.getObjectiveValue()) <= \
        1e-6 * max(1.0, abs(jax.getObjectiveValue()))
    assert port.getTimer().num_calls("icrash") == 1
