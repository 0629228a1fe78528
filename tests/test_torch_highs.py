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
