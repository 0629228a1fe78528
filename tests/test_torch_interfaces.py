"""The port's remaining interfaces against the JAX package's, on the CPU:
the C-style API (`capi.py`), the modeling layer (`modeling.py`), the
command line (`cli.py`), the debug checks (`utils/debug.py`), matrix
images (`utils/matrix_pic.py`) and compensated arithmetic
(`utils/cdouble.py`).

The same script of C-API calls runs through both packages and gives the
same statuses, integers exactly and values within 1e-7 (1 + |value|)
(small LPs that both facades solve with the native simplex, a MIP and a
QP).  Each entry point defaults to CUDA and raises without a card; the
version functions build no facade, so they answer without one."""
import math

import numpy as np
import pytest
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu import capi as jax_capi
from highs_tpu import cli as jax_cli
from highs_tpu import modeling as jax_modeling
from highs_tpu.utils import cdouble as jax_cdouble
from highs_tpu.utils import debug as jax_debug
from highs_tpu_torch import capi, cli, modeling
from highs_tpu_torch.utils import cdouble, debug
from highs_tpu_torch.utils.gen_synth_lp import synth_lp

torch.set_num_threads(1)

VAL_TOL = 1e-7
INF = math.inf


def _same(got, want, where="result"):
    """Integers and strings equal, floats and arrays within VAL_TOL."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), \
            where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{k}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        g, w = np.asarray(got, float), np.asarray(want, float)
        assert g.shape == w.shape, where
        np.testing.assert_allclose(g, w, rtol=VAL_TOL, atol=VAL_TOL,
                                   err_msg=where)
    elif isinstance(want, float) or isinstance(got, float):
        if math.isnan(want):
            assert math.isnan(got), where
        else:
            assert abs(got - want) <= VAL_TOL * (1.0 + abs(want)), where
    else:
        assert got == want, where


def _capi_script(c, create):
    """A fixed sequence of C-API calls; returns every answer."""
    out = []
    h = create()
    out.append(c.Highs_setBoolOptionValue(h, "output_flag", False))
    # min -x - 2y s.t. x + y <= 4, x + 3y <= 6 (column-wise)
    out.append(c.Highs_passLp(
        h, 2, 2, 4, c.kHighsMatrixFormatColwise, c.kHighsObjSenseMinimize,
        0.5, [-1.0, -2.0], [0.0, 0.0], [INF, INF], [-INF, -INF], [4.0, 6.0],
        [0, 2], [0, 1, 0, 1], [1.0, 1.0, 1.0, 3.0]))
    out.append(c.Highs_run(h))
    out.append(c.Highs_getModelStatus(h))
    out.append(c.Highs_getObjectiveValue(h))
    out.append(c.Highs_getSolution(h))
    out.append(c.Highs_getBasis(h))
    out.append(c.Highs_getIntInfoValue(h, "simplex_iteration_count"))
    out.append(c.Highs_getDoubleInfoValue(h, "objective_function_value"))
    out.append(c.Highs_getIntInfoValue(h, "no_such_info"))
    # modify and re-solve
    out.append(c.Highs_changeColCost(h, 0, -3.0))
    out.append(c.Highs_changeColBounds(h, 1, 0.0, 1.5))
    out.append(c.Highs_changeRowBounds(h, 0, -INF, 5.0))
    out.append(c.Highs_changeCoeff(h, 1, 0, 2.0))
    out.append(c.Highs_changeObjectiveSense(h, c.kHighsObjSenseMinimize))
    out.append(c.Highs_run(h))
    out.append(c.Highs_getObjectiveValue(h))
    out.append(c.Highs_addCol(h, -1.0, 0.0, 2.0, 2, [0, 1], [1.0, 1.0]))
    out.append(c.Highs_addRow(h, -INF, 3.0, 2, [0, 2], [1.0, 1.0]))
    out.append((c.Highs_getNumCol(h), c.Highs_getNumRow(h),
                c.Highs_getNumNz(h)))
    out.append(c.Highs_run(h))
    out.append(c.Highs_getObjectiveValue(h))
    out.append(c.Highs_deleteRowsByRange(h, 2, 2))
    out.append(c.Highs_deleteColsBySet(h, 1, [2]))
    out.append(c.Highs_run(h))
    out.append(c.Highs_getObjectiveValue(h))
    out.append(c.Highs_getBasisSolve(h, [1.0, 2.0]))
    out.append(c.Highs_getBasisInverseRow(h, 0))
    # options
    out.append(c.Highs_setDoubleOptionValue(h, "time_limit", 10.0))
    out.append(c.Highs_getDoubleOptionValue(h, "time_limit"))
    out.append(c.Highs_setIntOptionValue(h, "random_seed", 7))
    out.append(c.Highs_getIntOptionValue(h, "random_seed"))
    out.append(c.Highs_setStringOptionValue(h, "presolve", "off"))
    out.append(c.Highs_getStringOptionValue(h, "presolve"))
    out.append(c.Highs_getBoolOptionValue(h, "output_flag"))
    out.append(c.Highs_setIntOptionValue(h, "nonexistent", 1))
    out.append(c.Highs_getOptionType(h, "mip_rel_gap"))
    # a MIP: max x + y s.t. x + y <= 7.5, integers in [0, 10]
    out.append(c.Highs_passMip(
        h, 2, 1, 2, c.kHighsMatrixFormatColwise, c.kHighsObjSenseMaximize,
        0.0, [1.0, 1.0], [0.0, 0.0], [10.0, 10.0], [-INF], [7.5], [0, 1],
        [0, 0], [1.0, 1.0], [c.kHighsVarTypeInteger] * 2))
    out.append(c.Highs_run(h))
    out.append(c.Highs_getModelStatus(h))
    out.append(c.Highs_getObjectiveValue(h))
    # malformed input
    out.append(c.Highs_passLp(
        h, 2, 1, 2, c.kHighsMatrixFormatColwise, 1, 0.0, [1.0], [0.0],
        [1.0], [0.0], [1.0], [0, 1], [0, 5], [1.0, 1.0]))
    c.Highs_destroy(h)
    # the one-shot calls
    lp_args = (2, 2, 4, c.kHighsMatrixFormatColwise, 1, 0.0, [-1.0, -2.0],
               [0.0, 0.0], [INF, INF], [-INF, -INF], [4.0, 6.0], [0, 2],
               [0, 1, 0, 1], [1.0, 1.0, 1.0, 3.0])
    return out, lp_args


def _one_shot(c, lp_args, **device):
    out = [c.Highs_lpCall(*lp_args, **device)]
    out.append(c.Highs_mipCall(*lp_args, [1, 0], **device))
    num_col, num_row, num_nz, a_format, sense, offset = lp_args[:6]
    out.append(c.Highs_qpCall(
        num_col, num_row, num_nz, 2, a_format, 1, sense, offset,
        *lp_args[6:], [0, 1], [0, 1], [2.0, 1.0], **device))
    return out


def test_c_api_matches_jax():
    got, lp_args = _capi_script(capi, lambda: capi.Highs_create("cpu"))
    want, _ = _capi_script(jax_capi, jax_capi.Highs_create)
    _same(got, want)
    _same(_one_shot(capi, lp_args, device="cpu"), _one_shot(jax_capi, lp_args))
    assert capi.Highs_version() == jax_capi.Highs_version()
    assert (capi.Highs_versionMajor(), capi.Highs_versionMinor(),
            capi.Highs_versionPatch()) == (
        jax_capi.Highs_versionMajor(), jax_capi.Highs_versionMinor(),
        jax_capi.Highs_versionPatch())


def test_c_api_versions_need_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert capi.Highs_version() == highs_tpu_torch.__version__
    assert capi.Highs_versionMajor() == 0
    assert capi.Highs_compilationDate() == "deprecated"
    assert capi.Highs_githash()
    with pytest.raises(RuntimeError, match="CUDA"):
        capi.Highs_create()


def _modeling_lp(pkg):
    h = pkg.Highs(device="cpu") if pkg is modeling else pkg.Highs()
    h.silent()
    x = h.addVariable(ub=8.0, name="x")
    y = h.addVariable(name="y")
    z = h.addIntegral(lb=0, ub=3)
    h.addConstr(x + 2 * y <= 14)
    h.addConstr(3 * x - y >= 0)
    h.addConstrs([x - y <= 2, y + z <= 5])
    return h, (x, y, z)


def test_modeling_layer_matches_jax():
    results = []
    for pkg in (modeling, jax_modeling):
        h, (x, y, z) = _modeling_lp(pkg)
        h.maximize(3 * x + 4 * y + pkg.qsum([z, z]))
        results.append((h.getModelStatus().name, h.getObjectiveValue(),
                        [h.val(v) for v in (x, y, z)],
                        list(h.allConstrValues()), h.numVariables(),
                        h.numConstrs()))
        e = 2 * x + 3 * y - x + 1.0
        assert (e.vals[x.index], e.vals[y.index], e.constant) == \
            (1.0, 3.0, 1.0)
    _same(results[0], results[1])


def test_modeling_start_and_join_solve():
    h, (x, y, z) = _modeling_lp(modeling)
    h.setObjective(3 * x + 4 * y, sense=highs_tpu_torch.ObjSense.kMaximize)
    thread = h.startSolve()
    assert h.joinSolve(thread) == highs_tpu_torch.HighsStatus.kOk
    assert h.getModelStatus().name == "kOptimal"
    done, status = h.wait()
    assert done and status == highs_tpu_torch.HighsStatus.kOk


@pytest.mark.parametrize("join", ["joinSolve", "wait"])
def test_modeling_error_comes_back_through_join(join, monkeypatch):
    h, (x, y, _) = _modeling_lp(modeling)
    h.setObjective(x + y)

    def broken():
        raise RuntimeError("CUDA error: device-side assert triggered")
    monkeypatch.setattr(h, "_optimize_model", broken)
    h.startSolve()
    with pytest.raises(RuntimeError, match="device-side assert"):
        getattr(h, join)()
    # reported once: the next join has nothing left to raise
    assert h.joinSolve() is None


def _write_models(tmp_path):
    """An LP from `gen_synth_lp` written as .mps and as .lp."""
    h = highs_tpu_torch.Highs(device="cpu")
    h.passModel(synth_lp(30, 45, per_col=4, seed=9))
    paths = [str(tmp_path / "m.mps"), str(tmp_path / "m.lp")]
    for p in paths:
        assert h.writeModel(p) == highs_tpu_torch.HighsStatus.kOk
    return paths


@pytest.mark.parametrize("suffix", ["mps", "lp"])
def test_cli_matches_jax(suffix, tmp_path, capsys):
    model = [p for p in _write_models(tmp_path) if p.endswith(suffix)][0]
    outs = {}
    for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                           ("jax", jax_cli.main, {})):
        sol = str(tmp_path / f"{name}.sol")
        rc = main([model, "--solution_file", sol, "--presolve=off"], **kw)
        printed = capsys.readouterr().out
        outs[name] = (rc, open(sol).read(), printed)
    assert outs["port"][0] == outs["jax"][0] == 0
    assert outs["port"][1] == outs["jax"][1]
    assert "Model status        : Optimal" in outs["port"][2]
    assert cli.main(["--version"], device="cpu") == 0
    assert cli.main([str(tmp_path / "none.mps")], device="cpu") == 1


def test_cli_module_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path / "m.mps")])
    assert cli.main(["--version"]) == 0


@pytest.mark.parametrize("level", [1, 2, 3])
def test_debug_level_matches_jax(level):
    lp = synth_lp(30, 45, per_col=4, seed=9)
    port = highs_tpu_torch.Highs(device="cpu")
    jax = highs_tpu.Highs()
    jax_lp = highs_tpu.HighsLp(
        num_col=lp.num_col, num_row=lp.num_row, col_cost=lp.col_cost,
        col_lower=lp.col_lower, col_upper=lp.col_upper,
        row_lower=lp.row_lower, row_upper=lp.row_upper,
        a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(
            lp.a_matrix.to_scipy()))
    for h, model in ((port, lp), (jax, jax_lp)):
        h.setOptionValue("output_flag", False)
        h.setOptionValue("highs_debug_level", level)
        h.passModel(model)
        assert int(h.run()) == 0
        assert h.getModelStatus().name == "kOptimal"
    found = []
    for mod, h in ((debug, port), (jax_debug, jax)):
        sol = h.getSolution()
        checks = [mod.debug_check_lp_solution(
            h.getLp(), sol, h.getBasis(), h.options,
            h.getModelStatus())]
        sol.col_value = np.asarray(sol.col_value) + 100.0  # corrupted
        checks.append(mod.debug_check_lp_solution(
            h.getLp(), sol, h.getBasis(), h.options,
            h.getModelStatus()))
        found.append(checks)
    assert found[0] == found[1]
    assert found[0][0] == [] and found[0][1] != []


def test_debug_layer_reports_its_own_failure():
    lp = synth_lp(10, 12, per_col=3, seed=1)
    h = highs_tpu_torch.Highs(device="cpu")
    h.setOptionValue("output_flag", False)
    h.setOptionValue("highs_debug_level", 1)
    h.passModel(lp)
    h.run()
    sol = h.getSolution()
    sol.col_value = np.zeros(3)  # the wrong length
    findings = debug.debug_check_lp_solution(
        lp, sol, None, h.options, h.getModelStatus())
    assert len(findings) == 1 and "checker itself failed" in findings[0]


@pytest.mark.parametrize("option", ["write_matrix_image",
                                    "write_hessian_image"])
def test_matrix_images_match_jax(option, tmp_path, monkeypatch):
    from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model
    model = mm_qp_model(1, 40, 25)
    lp = model.lp
    jax_model = highs_tpu.HighsModel(
        lp=highs_tpu.HighsLp(
            num_col=lp.num_col, num_row=lp.num_row, col_cost=lp.col_cost,
            col_lower=lp.col_lower, col_upper=lp.col_upper,
            row_lower=lp.row_lower, row_upper=lp.row_upper,
            a_matrix=highs_tpu.HighsSparseMatrix.from_scipy(
                lp.a_matrix.to_scipy())),
        hessian=highs_tpu.HighsHessian(
            dim=model.hessian.dim, format=model.hessian.format,
            start=model.hessian.start, index=model.hessian.index,
            value=model.hessian.value))
    images = []
    for name, h, m in (("port", highs_tpu_torch.Highs(device="cpu"), model),
                       ("jax", highs_tpu.Highs(), jax_model)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        h.setOptionValue("output_flag", False)
        h.setOptionValue(option, True)
        h.passModel(m)
        h.run()
        kind = "matrix" if option == "write_matrix_image" else "hessian"
        images.append((tmp_path / name / f"model_{kind}.pbm").read_bytes())
    assert images[0] == images[1]
    assert images[0].startswith(b"P1\n")


def test_cdouble_matches_jax():
    cases = []
    for mod in (cdouble, jax_cdouble):
        cd = mod.CDouble
        one_third = cd.from_float(1.0) / 3.0
        cases.append([
            float(cd.from_float(1e16) + 1.0 - 1e16),
            float(one_third * 3.0), float(one_third),
            float((cd.from_float(2.0) - 1e-20).floor()),
            float(cd.from_float(3.7).floor()),
            mod.comp_sum(np.array([1e16, 1.0, -1e16, 1.0])),
            mod.comp_dot(np.array([1e8, 1.0, -1e8]),
                         np.array([1e8, 1.0, 1e8]))])
    assert cases[0] == cases[1]
    assert cases[0][0] == 1.0 and cases[0][5] == 2.0 and cases[0][6] == 1.0
