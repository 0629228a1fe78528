"""The native simplex, its entry and crossover: the port against the JAX
package on the same LPs, on the CPU.

Both packages drive the same C++ (`native/`), so the bindings give the
same x, y, z, basis and iterations, bit for bit; the entries, crossover
and the facade give the same statuses, objectives, bases and iteration
counts.  Loading the port's bindings leaves every `native/` file as it
is."""
import hashlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu.callbacks import HighsCallback as JCallback
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.solvers.simplex import crossover as jcross
from highs_tpu.solvers.simplex import dual_native as jdual
from highs_tpu.solvers.simplex import native as jnative
from highs_tpu.solvers.simplex import wrapper as jwrap
from highs_tpu_torch.callbacks import HighsCallback
from highs_tpu_torch.constants import HighsCallbackType, HighsModelStatus
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.ipm.wrapper import solve_lp_ipm
from highs_tpu_torch.solvers.simplex import crossover as tcross
from highs_tpu_torch.solvers.simplex import dual_native as tdual
from highs_tpu_torch.solvers.simplex import native as tnative
from highs_tpu_torch.solvers.simplex import wrapper as twrap
from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp
from test_torch_highs import _jax_lp, _lp_dict

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _synth_dict(m, n=None, seed=3):
    n = n or m
    a, b, c = gen_synth_lp(m, n, seed=seed)
    return dict(num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
                col_upper=np.full(n, 10.0), row_lower=b,
                row_upper=np.full(m, np.inf), a_start=a.indptr,
                a_index=a.indices, a_value=a.data)


def _infeasible_dict():
    # rows 0 and 1 hold the same coefficients: a'x >= r0 + 1, a'x <= r0
    rng = np.random.default_rng(1)
    m, n = 60, 80
    a = sp.random(m, n, density=0.1, random_state=rng, format="lil")
    a[1, :] = a[0, :]
    a = a.tocsc()
    r = a @ rng.uniform(0, 1, n)
    rl, ru = r - 1, np.full(m, np.inf)
    rl[0], rl[1], ru[1] = r[0] + 1, -np.inf, r[0]
    return dict(num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1, n),
                col_lower=np.zeros(n), col_upper=np.full(n, 5.0),
                row_lower=rl, row_upper=ru, a_start=a.indptr,
                a_index=a.indices, a_value=a.data)


def _unbounded_dict():
    # column 0 costs -1, has no upper bound, and only helps its >= rows
    rng = np.random.default_rng(2)
    m, n = 60, 80
    a = abs(sp.random(m, n, density=0.1, random_state=rng, format="csc"))
    r = a @ rng.uniform(0, 1, n)
    c = rng.uniform(0.1, 1, n)
    c[0] = -1.0
    up = np.full(n, 5.0)
    up[0] = np.inf
    return dict(num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
                col_upper=up, row_lower=r - 0.5,
                row_upper=np.full(m, np.inf), a_start=a.indptr,
                a_index=a.indices, a_value=a.data)


def _tall_dict():
    # 12 x more rows than columns: simplex_dualize_strategy 0 dualizes
    rng = np.random.default_rng(4)
    m, n = 240, 20
    a = sp.random(m, n, density=0.3, random_state=rng, format="csc")
    r = a @ rng.uniform(0, 1, n)
    return dict(num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1, n),
                col_lower=np.zeros(n), col_upper=np.full(n, 5.0),
                row_lower=r - np.abs(rng.standard_normal(m)),
                row_upper=np.full(m, np.inf), a_start=a.indptr,
                a_index=a.indices, a_value=a.data)


def _equal_runs(got, want):
    """Two (result, x, y, z, basis, iters) tuples, bit for bit."""
    assert got[0] == want[0]
    for g, w in zip(got[1:5], want[1:5]):
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]


@pytest.mark.parametrize("engine", ["primal", "dual"])
def test_bindings_match_jax(engine):
    lp = lp_from_numpy(_synth_dict(150, 180))
    a = lp.a_matrix.to_scipy().tocsc()
    args = (lp.col_cost, lp.col_lower, lp.col_upper, lp.row_lower,
            lp.row_upper)
    if engine == "primal":
        got = tnative.simplex_solve(a, *args)
        want = jnative.simplex_solve(a, *args)
    else:
        got = tdual.dual_solve(a, a.tocsr(), *args)
        want = jdual.dual_solve(a, a.tocsr(), *args)
    assert got[0] == tnative.RESULT_OPTIMAL and got[5] > 0
    _equal_runs(got, want)
    # the Ruiz factors the entry scales the dual engine's LP by
    if engine == "primal":
        for g, w in zip(tnative._ruiz_scales(a * 1e3),
                        jnative._ruiz_scales(a * 1e3)):
            np.testing.assert_array_equal(g, w)


def _bases_equal(tb, jb):
    assert tb.valid and jb.valid
    assert [int(s) for s in tb.col_status] == [int(s) for s in jb.col_status]
    assert [int(s) for s in tb.row_status] == [int(s) for s in jb.row_status]


def _entry_pair(d, **opts):
    topts, jopts = HighsOptions(), JOptions()
    for o in (topts, jopts):
        for k, v in opts.items():
            setattr(o, k, v)
    tout = twrap.solve_lp_simplex(lp_from_numpy(d), topts, device="cpu")
    jout = jwrap.solve_lp_simplex(_jax_lp(d), jopts)
    return tout, jout


@pytest.mark.parametrize("make,status", [
    (lambda: _synth_dict(200), HighsModelStatus.kOptimal),
    (_infeasible_dict, HighsModelStatus.kInfeasible),
    (_unbounded_dict, HighsModelStatus.kUnbounded)])
def test_solve_lp_simplex_like_jax(make, status):
    (tst, tsol, tinfo), (jst, jsol, jinfo) = _entry_pair(make())
    assert int(tst) == int(jst) == int(status)
    assert tinfo.iterations == jinfo.iterations
    if status == HighsModelStatus.kOptimal:
        assert tinfo.iterations > 0
        assert tinfo.primal_obj == jinfo.primal_obj
        np.testing.assert_array_equal(tsol.col_value, jsol.col_value)
        np.testing.assert_array_equal(tsol.row_dual, jsol.row_dual)
        _bases_equal(tinfo.basis, jinfo.basis)


def test_warm_start_from_the_optimal_basis_takes_no_pivots():
    d = _synth_dict(200)
    (_, _, tinfo), (_, _, jinfo) = _entry_pair(d)
    for pkg, wrap, lp, basis in (
            ("port", twrap, lp_from_numpy(d), tinfo.basis),
            ("jax", jwrap, _jax_lp(d), jinfo.basis)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        opts = HighsOptions() if pkg == "port" else JOptions()
        st, sol, info = wrap.solve_lp_simplex(lp, opts, basis=basis, **kw)
        assert int(st) == int(HighsModelStatus.kOptimal)
        assert info.iterations == 0, pkg
        assert info.primal_obj == pytest.approx(tinfo.primal_obj, rel=1e-12)


@pytest.mark.parametrize("strategy", [0, 1])
def test_dualize_like_jax(strategy):
    (tst, tsol, tinfo), (jst, jsol, jinfo) = _entry_pair(
        _tall_dict(), simplex_dualize_strategy=strategy)
    assert int(tst) == int(jst) == int(HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    assert tinfo.primal_obj == jinfo.primal_obj
    np.testing.assert_array_equal(tsol.col_value, jsol.col_value)
    _bases_equal(tinfo.basis, jinfo.basis)


@pytest.mark.parametrize("interrupt", [True, False])
def test_simplex_interrupt_callback_chunks_like_jax(interrupt):
    # more than one 2,000-pivot chunk of the primal engine
    d = _synth_dict(700, seed=5)
    seen = {}
    results = {}
    for pkg, cb_cls in (("port", HighsCallback), ("jax", JCallback)):
        calls = []

        def user(kind, message, data_out, data_in, user_data,
                 calls=calls):
            calls.append((kind, data_out.simplex_iteration_count))
            data_in.user_interrupt = interrupt
        cbs = cb_cls()
        cbs.user_callback = user
        cbs.active[int(HighsCallbackType.kCallbackSimplexInterrupt)] = True
        if pkg == "port":
            opts = HighsOptions()
            opts._callbacks = cbs
            out = twrap.solve_lp_simplex(lp_from_numpy(d), opts,
                                         device="cpu")
        else:
            opts = JOptions()
            opts._callbacks = cbs
            out = jwrap.solve_lp_simplex(_jax_lp(d), opts)
        seen[pkg] = calls
        results[pkg] = (int(out[0]), out[2].iterations)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (int(HighsCallbackType.kCallbackSimplexInterrupt),
                               2000)
    assert results["port"] == results["jax"]
    if interrupt:
        assert results["port"] == (int(HighsModelStatus.kInterrupt), 2000)
    else:
        assert results["port"][0] == int(HighsModelStatus.kOptimal)
        assert results["port"][1] > 2000


def test_crossover_from_an_ipm_solution_like_jax():
    d = _synth_dict(180, 240, seed=6)
    lp = lp_from_numpy(d)
    st, ipm_sol, _ = solve_lp_ipm(lp, HighsOptions(), device="cpu")
    assert int(st) == int(HighsModelStatus.kOptimal)
    tst, tsol, tinfo = tcross.crossover_from_solution(lp, HighsOptions(),
                                                      ipm_sol)
    jst, jsol, jinfo = jcross.crossover_from_solution(_jax_lp(d), JOptions(),
                                                      ipm_sol)
    assert int(tst) == int(jst) == int(HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    np.testing.assert_array_equal(tsol.col_value, jsol.col_value)
    _bases_equal(tinfo.basis, jinfo.basis)
    for name in ("col_value", "row_value"):
        vals = np.asarray(getattr(ipm_sol, name))
        got = tcross._guess_statuses(vals, lp.col_lower if name ==
                                     "col_value" else lp.row_lower,
                                     lp.col_upper if name == "col_value"
                                     else lp.row_upper, 1e-6)
        want = jcross._guess_statuses(vals, lp.col_lower if name ==
                                      "col_value" else lp.row_lower,
                                      lp.col_upper if name == "col_value"
                                      else lp.row_upper, 1e-6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _facades(d, **opts):
    port, jax = highs_tpu_torch.Highs(device="cpu"), highs_tpu.Highs()
    for h in (port, jax):
        h.setOptionValue("output_flag", False)
        for k, v in opts.items():
            h.setOptionValue(k, v)
    port.passModel(lp_from_numpy(d))
    jax.passModel(_jax_lp(d))
    return port, jax


def test_choose_on_a_small_lp_runs_simplex_like_jax():
    port, jax = _facades(_lp_dict())
    for h in (port, jax):
        h.run()
    assert int(port.getModelStatus()) == int(jax.getModelStatus()) == \
        int(HighsModelStatus.kOptimal)
    pi, ji = port.getInfo(), jax.getInfo()
    assert pi.simplex_iteration_count == ji.simplex_iteration_count > 0
    assert pi.ipm_iteration_count == ji.ipm_iteration_count == -1
    assert pi.pdlp_iteration_count == ji.pdlp_iteration_count == -1
    assert port.getObjectiveValue() == pytest.approx(
        jax.getObjectiveValue(), rel=1e-12)
    _bases_equal(port.getBasis(), jax.getBasis())
    assert pi.basis_validity == ji.basis_validity == 1


def test_basis_and_solution_methods_like_jax():
    d = _synth_dict(150, seed=7)
    port, jax = _facades(d, solver="simplex")
    for h in (port, jax):
        h.run()
        assert h.getInfo().simplex_iteration_count > 0
    basis, solution = port.getBasis(), port.getSolution()
    # a re-run from the basis set back takes no pivots
    for h in (port, jax):
        h.setBasis(basis)
        h.run()
        assert int(h.getModelStatus()) == int(HighsModelStatus.kOptimal)
        assert h.getInfo().simplex_iteration_count == -1  # no pivots
        assert h.getInfo().pdlp_iteration_count == 0
    _bases_equal(port.getBasis(), jax.getBasis())
    # setBasis() with no argument clears it
    port.setBasis()
    assert not port.getBasis().valid
    # crossover from the solution set back: a valid basis, and the same
    # objective as the JAX facade's crossover from the same point
    for h in (port, jax):
        assert int(h.setSolution(solution)) == 0
        assert h.getSolution() is solution
        assert int(h.crossover(solution)) == 0
        assert int(h.getModelStatus()) == int(HighsModelStatus.kOptimal)
    _bases_equal(port.getBasis(), jax.getBasis())
    assert port.getObjectiveValue() == pytest.approx(
        jax.getObjectiveValue(), rel=1e-12)
    # on an infeasible LP crossover ends without a basis: an error, as
    # in the JAX package
    bad = _infeasible_dict()
    start = highs_tpu_torch.HighsSolution(
        value_valid=True, col_value=np.zeros(bad["num_col"]),
        row_value=np.zeros(0))
    port.passModel(lp_from_numpy(bad))
    jax.passModel(_jax_lp(bad))
    for h in (port, jax):
        assert int(h.crossover(start)) == int(highs_tpu.HighsStatus.kError)


def _native_digests():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "native").iterdir()) if p.is_file()}


def test_loading_the_bindings_leaves_native_files_unchanged():
    before = _native_digests()
    code = (
        "from highs_tpu_torch.solvers.simplex import native, dual_native\n"
        "from highs_tpu_torch.solvers.ipm import sparse_ldl\n"
        "from highs_tpu_torch.solvers import native_lib\n"
        "for mod in (native, dual_native, sparse_ldl):\n"
        "    mod.get_lib()\n"
        "print(sorted(native_lib._LOADED))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['hdual',", "'hipm',", "'hsimplex']"]
    assert _native_digests() == before
