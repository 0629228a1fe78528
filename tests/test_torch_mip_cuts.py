"""The MIP's cut layer: the port against the JAX package on the same
inputs, on the CPU.

Each case of `tests/test_cuts.py` and `tests/test_native_cuts.py` runs
in both packages: the separators the port's solver runs (c-MIR with its
native batch, Gomory, cliques, implied bounds, the pool and the diverse
selection) return the same cuts from the same LP point, column for
column and to 1e-12, and the port's cuts pass the original test's
validity checks.  The native c-MIR stays held against its Python oracle
(`_mir_on_leq_py`).  The JAX package's Python path, mod-k, network and
mixing separators have no counterpart in the port: its solver leaves
that separation to the native root round, so their cases run only
through the solver (`test_modk_solver_integration`)."""
import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.solvers.mip import cuts as JC
from highs_tpu.solvers.mip import implications as JI
from highs_tpu.solvers.mip import propagate as JP
from highs_tpu.solvers.mip import solver as JS
from highs_tpu.solvers.mip.native_cuts import VBounds as JVBounds
from highs_tpu.solvers.simplex import native as jnative
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.mip import cuts as TC
from highs_tpu_torch.solvers.mip import implications as TI
from highs_tpu_torch.solvers.mip import native_cuts as TN
from highs_tpu_torch.solvers.mip import propagate as TP
from highs_tpu_torch.solvers.mip import solver as TS
from highs_tpu_torch.solvers.mip.native_cuts import VBounds as TVBounds
from highs_tpu_torch.solvers.simplex import native as tnative

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

TOL = 1e-12


def same_cuts(got, want):
    """Two lists of cuts, column for column and to 1e-12."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.cols),
                                      np.asarray(w.cols))
        np.testing.assert_allclose(g.vals, w.vals, rtol=TOL, atol=TOL)
        assert g.rhs == pytest.approx(w.rhs, rel=TOL, abs=TOL)
        assert g.efficacy == pytest.approx(w.efficacy, rel=TOL, abs=TOL)


def dense(cut, n):
    row = np.zeros(n)
    row[cut.cols] = cut.vals
    return row


def ip_dict(c, a, rl, ru, lo, up):
    a = sp.csc_matrix(np.asarray(a, dtype=float))
    n = len(c)
    return dict(num_col=n, num_row=a.shape[0],
                col_cost=np.asarray(c, dtype=float),
                col_lower=np.asarray(lo, dtype=float),
                col_upper=np.asarray(up, dtype=float),
                row_lower=np.asarray(rl, dtype=float),
                row_upper=np.asarray(ru, dtype=float),
                a_start=a.indptr, a_index=a.indices, a_value=a.data,
                integrality=np.ones(n, dtype=np.uint8))


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
                             dtype=np.uint8))


def test_cut_pool_dedupe_and_eviction():
    for mod in (TC, JC):
        pool = mod.CutPool(4, age_limit=1, soft_limit=10)
        c1 = mod.Cut(np.array([0, 1], dtype=np.int32), np.array([1.0, 1.0]),
                     1.0)
        c2 = mod.Cut(np.array([0, 1], dtype=np.int32), np.array([1.0, 1.0]),
                     1.0)
        assert pool.add(c1)
        assert not pool.add(c2)  # duplicate
        pool.age_and_evict()     # age 1 -> kept
        assert len(pool.cuts) == 1
        pool.age_and_evict()     # age 2 > limit -> evicted
        assert len(pool.cuts) == 0


def test_pool_violated_selection():
    got = []
    for mod in (TC, JC):
        pool = mod.CutPool(3)
        pool.add(mod.Cut(np.array([0], dtype=np.int32), np.array([1.0]),
                         0.5))
        pool.add(mod.Cut(np.array([1], dtype=np.int32), np.array([1.0]),
                         2.0))
        got.append(pool.violated(np.array([1.0, 1.0, 0.0])))
    assert len(got[0]) == 1 and got[0][0].cols[0] == 0
    same_cuts(*got)
    # the pool's matrix form of the same cuts
    mats = [mod.CutPool(3).matrix(cuts) for mod, cuts in zip((TC, JC), got)]
    assert (mats[0][0] != mats[1][0]).nnz == 0
    np.testing.assert_array_equal(mats[0][1], mats[1][1])


def test_mir_separates_simple_knapsack():
    # 2x1 + 2x2 <= 3, x binary: MIR (delta=2) gives x1 + x2 <= 1
    a = sp.csr_matrix(np.array([[2.0, 2.0]]))
    x = np.array([0.75, 0.75])  # LP point violating x1+x2<=1
    args = (a, np.array([-np.inf]), np.array([3.0]), np.zeros(2),
            np.ones(2), x, np.array([True, True]))
    cuts = TC.separate_mir(*args)
    same_cuts(cuts, JC.separate_mir(*args))
    assert cuts, "expected a MIR cut"
    best = max(cuts, key=lambda c: c.efficacy)
    for pt, feas in [((0.75, 0.75), False), ((1, 0), True),
                     ((0, 1), True), ((0, 0), True)]:
        v = dense(best, 2) @ np.array(pt, dtype=float)
        assert (v <= best.rhs + 1e-9) == feas


def test_gomory_cuts_off_fractional_vertex():
    # max x1 + x2  s.t. 3x1 + 2x2 <= 6, x2 <= 1.5 (vertex (1, 1.5))
    a = sp.csc_matrix(np.array([[3.0, 2.0], [0.0, 1.0]]))
    lo, up = np.zeros(2), np.full(2, 10.0)
    rl, ru = np.full(2, -np.inf), np.array([6.0, 1.5])
    c = np.array([-1.0, -1.0])
    res, x, y, z, basis, iters = tnative.simplex_solve(a, c, lo, up, rl, ru)
    jres = jnative.simplex_solve(a, c, lo, up, rl, ru)
    assert res == 0 == jres[0]
    np.testing.assert_array_equal(basis, jres[4])
    args = (a, lo, up, rl, ru, basis, x, np.array([True, True]))
    cuts = TC.separate_gomory(*args)
    same_cuts(cuts, JC.separate_gomory(*args))
    assert cuts
    for cut in cuts:
        for x1, x2 in itertools.product(range(3), range(2)):
            if 3 * x1 + 2 * x2 <= 6 and x2 <= 1.5:
                assert dense(cut, 2) @ np.array([x1, x2], float) <= \
                    cut.rhs + 1e-7


def test_clique_extraction_and_separation():
    a = sp.csr_matrix(np.array([[1.0, 1.0, 1.0]]))
    args = (a, np.array([-np.inf]), np.array([1.0]), np.zeros(3),
            np.ones(3), np.array([True] * 3))
    tab, jtab = TC.CliqueTable(*args), JC.CliqueTable(*args)
    assert len(tab.cliques) == 1 == len(jtab.cliques)
    cuts = tab.separate(np.array([0.5, 0.5, 0.5]))
    same_cuts(cuts, jtab.separate(np.array([0.5, 0.5, 0.5])))
    assert cuts and cuts[0].rhs == 1.0


def test_mip_with_cuts_still_correct():
    # max 5x1+4x2 s.t. 6x1+4x2<=24, x1+2x2<=6: optimum (4, 0), 20
    d = ip_dict([-5.0, -4.0], [[6.0, 4.0], [1.0, 2.0]],
                [-np.inf, -np.inf], [24.0, 6.0], [0, 0], [10, 10])
    st, sol, info = TS.solve_mip(lp_from_numpy(d), HighsOptions(),
                                 device="cpu")
    jst, jsol, jinfo = JS.solve_mip(jax_lp(d), JOptions())
    assert st.name == jst.name == "kOptimal"
    assert info.primal_obj == pytest.approx(-20.0, abs=1e-6)
    assert info.primal_obj == pytest.approx(jinfo.primal_obj, abs=1e-9)
    np.testing.assert_array_equal(sol.col_value, jsol.col_value)


@pytest.mark.parametrize("facade", ["torch", "jax"])
def test_modk_solver_integration(facade):
    """The 5-cycle matching MIP, built through the facade's API."""
    pkg = highs_tpu_torch if facade == "torch" else highs_tpu
    h = pkg.Highs(device="cpu") if facade == "torch" else pkg.Highs()
    h.setOptionValue("output_flag", False)
    n = 5
    h.addVars(n, np.zeros(n), np.ones(n))
    for j in range(n):
        h.changeColIntegrality(j, 1)
        h.changeColCost(j, -1.0)
    for i in range(n):
        h.addRow(-np.inf, 1.0, 2, np.array([i, (i + 1) % n]),
                 np.array([1.0, 1.0]))
    h.run()
    assert h.getModelStatus().name == "kOptimal"
    assert abs(h.getObjectiveValue() - (-2.0)) < 1e-6


def test_implications_probing_and_implied_bound_cut():
    """Probing y=1 -> x1>=3 -> x2<=5 yields the cut x2 <= 8 - 3y."""
    a = sp.csr_matrix(np.array([[-2.5, 1.0, 0.0], [0.0, 1.0, 1.0]]))
    rl, ru = np.array([0.0, -np.inf]), np.array([np.inf, 8.0])
    is_int = np.array([True, True, False])
    lo, up = np.zeros(3), np.array([1.0, 8.0, 8.0])
    x = np.array([0.5, 1.25, 6.75])
    out = []
    for I, P in ((TI, TP), (JI, JP)):
        impl = I.Implications(P.Propagator(a, rl, ru, is_int))
        lo2, up2 = impl.probe([0], lo, up)
        out.append((impl, lo2, up2, impl.separate(x, lo2, up2)))
    (impl, lo2, up2, cuts), (jimpl, jlo2, jup2, jcuts) = out
    np.testing.assert_array_equal(lo2, jlo2)
    np.testing.assert_array_equal(up2, jup2)
    assert sorted(impl.store) == sorted(jimpl.store)
    for g, w in zip(impl.store[0], jimpl.store[0]):
        np.testing.assert_array_equal(g, w)
    same_cuts(cuts, jcuts)
    assert not impl.infeasible
    lo0, up0, lo1, up1 = impl.store[0]
    assert lo1[1] >= 3.0 - 1e-5 and up1[2] <= 5.0 + 1e-5
    assert cuts
    ok = False
    for c in cuts:
        row = dense(c, 3)
        for y in (0.0, 1.0):
            for x1 in range(9):
                if x1 >= 2.5 * y:
                    assert row @ np.array([y, x1, 8.0 - x1]) <= c.rhs + 1e-6
        ok |= bool(row @ x > c.rhs + 1e-6)
    assert ok, "at least one cut must be violated at the LP point"


def test_cmir_vub_substitution_fixed_charge():
    """x1 + x2 <= 8, x_i <= u_i y_i: VUB substitution separates the
    flow-cover point that plain bound substitution cannot."""
    u1, u2, b = 6.0, 5.0, 8.0
    a = sp.csr_matrix(np.array([[1.0, 1.0, 0.0, 0.0],
                                [1.0, 0.0, -u1, 0.0],
                                [0.0, 1.0, 0.0, -u2]]))
    x = np.array([6.0, 2.0, 1.0, 0.4])
    args = (a, np.full(3, -np.inf), np.array([b, 0.0, 0.0]), np.zeros(4),
            np.array([u1, u2, 1.0, 1.0]), x,
            np.array([False, False, True, True]))
    cuts = TC.separate_mir(*args)
    same_cuts(cuts, JC.separate_mir(*args))
    assert cuts, "VUB substitution must separate the flow point"
    best_viol = 0.0
    for c in cuts:
        row = dense(c, 4)
        best_viol = max(best_viol, (row @ x - c.rhs) /
                        np.linalg.norm(c.vals))
        for y1, y2 in itertools.product((0, 1), repeat=2):
            for x1 in np.linspace(0, u1 * y1, 7):
                for x2 in np.linspace(0, u2 * y2, 6):
                    if x1 + x2 <= b + 1e-9:
                        p = np.array([x1, x2, y1, y2])
                        assert row @ p <= c.rhs + 1e-6, (c, p)
    assert best_viol > 1e-3, "cut must actually cut off x*"


def test_clique_table_merging_and_extension():
    rows = [[0, 1, 2], [0, 3], [1, 3], [2, 3], [0, 1]]
    ri = [r for r, cols in enumerate(rows) for _ in cols]
    ci = [c for cols in rows for c in cols]
    a = sp.csr_matrix((np.ones(len(ci)), (ri, ci)), shape=(len(rows), 4))
    args = (a, np.full(len(rows), -np.inf), np.ones(len(rows)),
            np.zeros(4), np.ones(4), np.ones(4, dtype=bool))
    tab, jtab = TC.CliqueTable(*args), JC.CliqueTable(*args)
    assert len(tab.cliques) == len(jtab.cliques)
    for (c, r), (jc, jr) in zip(tab.cliques, jtab.cliques):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(r, jr)
    assert [0, 1] not in [sorted(c.tolist()) for c, _ in tab.cliques]
    x = np.array([0.45, 0.45, 0.45, 0.4])
    cuts = tab.separate(x)
    same_cuts(cuts, jtab.separate(x))
    best = max(cuts, key=lambda c: len(c.cols))
    assert set(best.cols.tolist()) == {0, 1, 2, 3} and best.rhs == 1.0



def _random_rows(seed):
    """A small mixed-integer row set with a point inside its bounds."""
    rng = np.random.default_rng(seed)
    m, n = 12, 16
    a = sp.random(m, n, density=0.35, random_state=rng,
                  data_rvs=lambda k: np.round(rng.normal(0, 3, k), 1))
    a = sp.csr_matrix(a)
    lo = np.zeros(n)
    up = np.where(rng.random(n) < 0.5, 1.0, rng.integers(2, 9, n))
    is_int = rng.random(n) < 0.6
    x = lo + rng.random(n) * (up - lo)
    act = a @ x
    rl = np.where(rng.random(m) < 0.4, act - rng.random(m), -np.inf)
    ru = np.where(np.isfinite(rl) & (rng.random(m) < 0.5), np.inf,
                  act + rng.random(m) * 0.1)
    return a, rl, ru, lo, up, x, is_int


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_separate_mir_like_jax_on_random_rows(seed):
    args = _random_rows(seed)
    cuts = TC.separate_mir(*args)
    same_cuts(cuts, JC.separate_mir(*args))
    assert cuts
    x = args[5]
    for c in cuts:
        assert c.efficacy > 0 and float(c.vals @ x[c.cols]) > c.rhs


@pytest.mark.parametrize("seed", [0, 1])
def test_gomory_like_jax_on_random_lps(seed):
    """Gomory cuts from the same optimal basis of a seeded LP."""
    a, rl, ru, lo, up, _x, is_int = _random_rows(seed)
    a = a.tocsc()
    c = -np.random.default_rng(seed + 10).random(a.shape[1])
    res, x, _y, _z, basis, _it = tnative.simplex_solve(a, c, lo, up, rl,
                                                       ru)
    jres = jnative.simplex_solve(a, c, lo, up, rl, ru)
    assert res == 0 == jres[0]
    np.testing.assert_array_equal(basis, jres[4])
    args = (a, lo, up, rl, ru, basis, x, is_int)
    cuts = TC.separate_gomory(*args)
    same_cuts(cuts, JC.separate_gomory(*args))
    assert cuts


@pytest.mark.parametrize("seed", [0, 1])
def test_select_diverse_cuts_like_jax(seed):
    """The same efficacy-ordered, parallelism-filtered picks."""
    picks = []
    for mod in (TC, JC):
        r = np.random.default_rng(seed)
        cuts = []
        for _ in range(60):
            cols = np.sort(r.choice(10, size=int(r.integers(1, 5)),
                                    replace=False)).astype(np.int32)
            cuts.append(mod.Cut(cols, np.round(r.normal(0, 1, len(cols)),
                                               1) + 0.05,
                                float(r.random()), float(r.random())))
        picks.append(mod.select_diverse_cuts(cuts, max_cuts=20,
                                             max_parallelism=0.8))
    same_cuts(*picks)
    assert 0 < len(picks[0]) <= 20

# --- the native c-MIR (tests/test_native_cuts.py) ------------------------

def _random_case(rng, vbounds):
    n = int(rng.integers(2, 25))
    is_int = rng.random(n) < 0.6
    lo = np.where(rng.random(n) < 0.8, np.round(rng.normal(0, 3, n)),
                  -np.inf)
    up = np.where(rng.random(n) < 0.8,
                  lo + np.abs(np.round(rng.normal(2, 3, n))) +
                  (rng.random(n) < 0.5), np.inf)
    bin_m = rng.random(n) < 0.3
    lo[bin_m], up[bin_m] = 0.0, 1.0
    x = np.where(np.isfinite(lo), lo, 0.0) + rng.random(n) * np.minimum(
        np.where(np.isfinite(up), up, 5.0) -
        np.where(np.isfinite(lo), lo, 0.0), 5.0)
    nnz = int(rng.integers(2, min(n, 12) + 1))
    cols = rng.choice(n, size=nnz, replace=False).astype(np.int64)
    vals = np.round(rng.normal(0, 2, nnz), 3)
    vals[vals == 0] = 1.0
    rhs = float(vals @ x[cols]) - rng.random() * 2 + 0.5
    vubs, vlbs = vbounds(), vbounds()
    for j in range(n):
        if is_int[j]:
            continue
        for _ in range(int(rng.integers(0, 3))):
            y = int(rng.integers(0, n))
            if not is_int[y]:
                continue
            c1 = float(np.round(rng.normal(0, 2), 2))
            c0 = float(np.round(rng.normal(0, 2), 2))
            (vubs if rng.random() < .5 else vlbs).setdefault(
                j, []).append((y, c1, c0))
    return cols, vals, rhs, x, lo, up, is_int, vubs, vlbs


def _cases(seed, count, vbounds):
    rng = np.random.default_rng(seed)
    return [_random_case(rng, vbounds) for _ in range(count)]


def _same_mir(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
        assert got[2] == pytest.approx(want[2], rel=TOL, abs=TOL)
        assert got[3] == pytest.approx(want[3], rel=TOL, abs=TOL)


@pytest.mark.parametrize("prefer_vbds", [False, True])
def test_native_mir_like_jax_and_its_oracle(prefer_vbds):
    """The port's native c-MIR gives the JAX package's cut on every
    case, and agrees with the Python oracle as the JAX test holds it
    (same noneness; the same cut on at least 90% of the produced
    ones)."""
    tcases = _cases(7, 400, TVBounds)
    jcases = _cases(7, 400, JVBounds)
    agree = produced = 0
    for tc, jc in zip(tcases, jcases):
        cols, vals, rhs, x, lo, up, is_int, vubs, vlbs = tc
        got = TN.mir_on_leq_native(cols, vals.copy(), rhs, x, lo, up,
                                   is_int.astype(np.int8), 1e-6,
                                   vubs=vubs, vlbs=vlbs,
                                   prefer_vbds=prefer_vbds)
        _same_mir(got, JC._mir_on_leq(
            jc[0], jc[1].copy(), *jc[2:7], 1e-6, vubs=jc[7], vlbs=jc[8],
            prefer_vbds=prefer_vbds))
        oracle = TC._mir_on_leq_py(cols, vals, rhs, x, lo, up, is_int,
                                   1e-6, vubs=vubs, vlbs=vlbs,
                                   prefer_vbds=prefer_vbds)
        assert (got is None) == (oracle is None)
        if got is None:
            continue
        produced += 1
        agree += bool(np.array_equal(got[0], oracle[0]) and
                      np.allclose(got[1], oracle[1], rtol=1e-9,
                                  atol=1e-12) and
                      np.isclose(got[2], oracle[2], rtol=1e-9, atol=1e-9))
    assert produced > 50 and agree / produced > 0.9, (agree, produced)


def test_native_mir_batch_like_jax():
    """One `hx_mir_batch` call over both sides of each row gives the JAX
    package's cuts, row for row."""
    from highs_tpu.solvers.mip import native_cuts as jn
    from highs_tpu_torch.solvers.mip import native_cuts as tn
    for tc in _cases(11, 150, TVBounds):
        cols, vals, rhs, x, lo, up, is_int, vubs, vlbs = tc
        trials = [(cols, vals, rhs), (cols, -vals, -rhs)]
        ii = is_int.astype(np.int8)
        got = tn.mir_batch_native(trials, x, lo, up, ii, 1e-6, vubs=vubs,
                                  vlbs=vlbs)
        want = jn.mir_batch_native(trials, x, lo, up, ii, 1e-6,
                                   vubs=JVBounds(vubs), vlbs=JVBounds(vlbs))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_mir(g, w)


def test_native_cuts_are_valid():
    rng = np.random.default_rng(11)
    checked = 0
    for _t in range(300):
        cols, vals, rhs, x, lo, up, is_int, vubs, vlbs = \
            _random_case(rng, TVBounds)
        got = TN.mir_on_leq_native(cols, vals, rhs, x, lo, up,
                                   is_int.astype(np.int8), 1e-6,
                                   vubs=vubs, vlbs=vlbs,
                                   prefer_vbds=bool(rng.random() < 0.5))
        if got is None:
            continue
        cc, cv, cr, eff = got
        assert eff > 0
        lo_s = np.where(np.isfinite(lo), lo, -8.0)
        up_s = np.where(np.isfinite(up), up, 8.0)
        for _ in range(200):
            p = lo_s + rng.random(len(lo)) * (up_s - lo_s)
            p[is_int] = np.round(p[is_int])
            p = np.clip(p, lo_s, up_s)
            if float(vals @ p[cols]) > rhs + 1e-9:
                continue
            if any(p[j] > c0 + c1 * p[y] + 1e-9
                   for j, lst in vubs.items() for (y, c1, c0) in lst):
                continue
            if any(p[j] < c0 + c1 * p[y] - 1e-9
                   for j, lst in vlbs.items() for (y, c1, c0) in lst):
                continue
            assert float(cv @ p[cc]) <= cr + 1e-6 * (1 + abs(cr))
        checked += 1
    assert checked > 50


def test_integral_scale_is_native_and_like_jax():
    from highs_tpu.utils import integers as jint
    from highs_tpu_torch.utils import integers as tint
    rng = np.random.default_rng(2)
    for _ in range(200):
        k = int(rng.integers(1, 8))
        vals = rng.integers(-40, 40, k) / rng.choice([1, 2, 3, 4, 7, 12], k)
        if rng.random() < 0.2:
            vals = vals + rng.normal(0, 1e-3, k)
        got = tint.integral_scale(vals)
        assert got == jint.integral_scale(vals)
        plain = tint._integral_scale_py(vals)
        assert (got is None) == (plain is None)
        if got is not None:
            assert got == pytest.approx(plain, rel=1e-9)
