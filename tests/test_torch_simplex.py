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
    """Every library of the port (the simplex, dual simplex, IPM and cut
    libraries) loads and binds its MIP entries too, and no `native/`
    file changes."""
    before = _native_digests()
    code = (
        "from highs_tpu_torch.solvers.simplex import native, dual_native\n"
        "from highs_tpu_torch.solvers.ipm import sparse_ldl\n"
        "from highs_tpu_torch.solvers.mip import native_cuts\n"
        "from highs_tpu_torch.solvers import native_lib\n"
        "for mod in (native, dual_native, sparse_ldl, native_cuts):\n"
        "    mod.get_lib()\n"
        "for f in ('hx_feasibility_jump', 'hx_bb_solve', 'hx_propagate'):\n"
        "    assert getattr(native.get_lib(), f).argtypes\n"
        "for f in ('hx_dual_create', 'hx_dual_solve_h', 'hx_mip_solve',\n"
        "          'hx_root_cuts'):\n"
        "    assert getattr(dual_native.get_lib(), f).argtypes\n"
        "for f in ('hx_mir_on_leq', 'hx_mir_batch', 'hx_integral_scale'):\n"
        "    assert getattr(native_cuts.get_lib(), f).argtypes\n"
        "print(sorted(native_lib._LOADED))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['hcuts',", "'hdual',", "'hipm',",
                                  "'hsimplex']"]
    assert _native_digests() == before


@pytest.mark.parametrize("module", [tnative, tdual])
def test_a_failed_load_raises(module, monkeypatch, tmp_path):
    """A library that neither loads nor builds raises from get_lib()."""
    from highs_tpu_torch.solvers import native_lib
    monkeypatch.setattr(native_lib, "_LOADED", {})
    monkeypatch.setattr(native_lib, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(OSError):
        module.get_lib()


def _mip_arrays():
    """A seeded facility location in the engines' scaled form."""
    from highs_tpu_torch.utils.gen_mip import facility_location
    d = facility_location(8, 8, seed=1)
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    return (a, a.tocsr(), d["col_cost"], d["col_lower"], d["col_upper"],
            d["row_lower"], d["row_upper"], d["integrality"] == 1)


def test_dual_engine_like_jax():
    """The persistent engine re-solves the same node boxes to the same
    x, y, z, basis and iterations as the JAX package's binding."""
    a, a_csr, c, lo, up, rl, ru, is_int = _mip_arrays()
    engines = [mod.DualEngine(a, a_csr, c, lo, up, rl, ru)
               for mod in (tdual, jdual)]
    rng = np.random.default_rng(0)
    basis = None
    for _ in range(6):
        lo2, up2 = lo.copy(), up.copy()
        fix = rng.choice(np.nonzero(is_int)[0], size=2, replace=False)
        up2[fix] = 0.0
        outs = []
        for eng in engines:
            eng.set_col_bounds(lo2, up2)
            if basis is not None:
                eng.set_basis(basis)
            outs.append(eng.solve())
        _equal_runs(*outs)
        basis = outs[0][4]
    for eng in engines:
        eng.close()


def test_mip_entries_like_jax():
    """`bb_solve` (hsimplex) and `mip_solve` (hdual, no callback, one
    engine) give the JAX package's results; `root_cuts` separates the
    same cuts from the same root point."""
    a, a_csr, c, lo, up, rl, ru, is_int = _mip_arrays()
    args = (a, a_csr, c, lo, up, rl, ru, is_int, None, np.inf, 0.0, 0.0,
            0.0, 0.0, -np.inf)
    for t, j in ((tnative.bb_solve, jnative.bb_solve),
                 (tdual.mip_solve, jdual.mip_solve)):
        got, want = t(*args), j(*args)
        assert got[0] == want[0] == 0 and got[1] and want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3:] == want[3:]
    st, x, y, z, basis, it = tnative.simplex_solve(a, c, lo, up, rl, ru)
    got = tdual.root_cuts(a, a_csr, c, lo, up, rl, ru, is_int,
                          basis_in=basis, x_at=x, max_cuts_round=1000,
                          time_budget=2.0)
    want = jdual.root_cuts(a, a_csr, c, lo, up, rl, ru, is_int,
                           basis_in=basis, x_at=x, max_rounds=1,
                           max_cuts_round=1000, separate_only=True,
                           time_budget=2.0)
    assert got[0] == want[0] == 0 and len(got[1]) == len(want[1]) > 0
    for (gc, gv, gr), (wc, wv, wr) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)
        assert gr == wr


def test_simplex_with_scales_like_jax():
    """`simplex_solve` on the Ruiz-scaled matrix the MIP passes maps the
    solution back as the JAX package does."""
    a, _, c, lo, up, rl, ru, _ = _mip_arrays()
    a = a @ sp.diags(np.linspace(1.0, 300.0, a.shape[1]))
    sc = tnative._ruiz_scales(a.tocsc())
    assert sc is not None
    scaled = (sp.diags(sc[0]) @ a @ sp.diags(sc[1])).tocsc()
    got = tnative.simplex_solve(a.tocsc(), c, lo, up, rl, ru, scales=sc,
                                scaled_matrix=scaled)
    want = jnative.simplex_solve(a.tocsc(), c, lo, up, rl, ru, scales=sc,
                                 scaled_matrix=scaled)
    assert got[0] == tnative.RESULT_OPTIMAL
    _equal_runs(got, want)
