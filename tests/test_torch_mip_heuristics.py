"""The MIP's primal heuristics, propagation and probing: the port against
the JAX package on the same inputs, on the CPU.

Each case of `tests/test_heuristics.py` that reads no instance runs in
both packages and must give the same point or bounds, bit for bit, and
pass the original test's checks.  Node propagation runs the native
worklist propagator in the port (no silent numpy fallback) and gives the
JAX Propagator's bounds exactly; so do root probing, coefficient
strengthening, the feasibility jump from the same seed and the
randomized rounding."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu.solvers.mip import feasibility_jump as jfj
from highs_tpu.solvers.mip import heuristics as jheur
from highs_tpu.solvers.mip import implications as jimp
from highs_tpu.solvers.mip import propagate as jprop
from highs_tpu_torch.solvers.mip import feasibility_jump as tfj
from highs_tpu_torch.solvers.mip import heuristics as theur
from highs_tpu_torch.solvers.mip import implications as timp
from highs_tpu_torch.solvers.mip import propagate as tprop
from highs_tpu_torch.solvers.simplex import native as tnative
from highs_tpu_torch.utils.gen_mip import facility_location, set_cover

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


def both(name, *args, **kwargs):
    """`heuristics.<name>` of the port and of the JAX package on the same
    inputs: the port's result, checked equal to the JAX package's."""
    got = getattr(theur, name)(*args, **kwargs)
    want = getattr(jheur, name)(*args, **kwargs)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    return got


def small_problem():
    # max x1 + x2 s.t. x1 + x2 <= 3.5, integers in [0, 3]
    a = sp.csc_matrix(np.array([[1.0, 1.0]]))
    return (a, np.array([-np.inf]), np.array([3.5]), np.zeros(2),
            np.full(2, 3.0), np.array([-1.0, -1.0]), np.array([True, True]))


def test_zi_round_integral_result():
    a, rl, ru, lo, up, cost, is_int = small_problem()
    x = both("zi_round", a, rl, ru, lo, up, cost, is_int,
             np.array([1.75, 1.75]))
    assert x is not None
    assert np.allclose(x, np.round(x)) and x.sum() <= 3.5 + 1e-6


def test_zi_round_gives_up_when_stuck():
    a = sp.csc_matrix(np.array([[1.0, 1.0]]))
    x = both("zi_round", a, np.array([1.5]), np.array([1.5]), np.zeros(2),
             np.ones(2), np.zeros(2), np.array([True, True]),
             np.array([0.75, 0.75]))
    assert x is None


def test_shifting_repairs_violation():
    a, rl, ru, lo, up, cost, is_int = small_problem()
    x = both("shifting", a, rl, ru, lo, up, cost, is_int,
             np.array([1.75, 1.75]))
    assert x is not None
    assert np.allclose(x[is_int], np.round(x[is_int]))
    assert (a @ x)[0] <= 3.5 + 1e-6


def test_shifting_with_continuous_var():
    a = sp.csc_matrix(np.array([[1.0, 1.0]]))
    x = both("shifting", a, np.array([-np.inf]), np.array([2.0]),
             np.zeros(2), np.array([3.0, 3.0]), np.array([-1.0, 0.0]),
             np.array([True, False]), np.array([1.6, 0.9]))
    assert x is not None
    assert abs(x[0] - round(x[0])) < 1e-9 and x[0] + x[1] <= 2.0 + 1e-6


def test_randomized_rounding_is_integral_and_deterministic():
    a = sp.csr_matrix(np.array([[1.0, 1.0]]))
    args = (a, np.zeros(2), np.full(2, 5.0), np.array([True, True]),
            np.array([1.3, 2.7]))
    x1 = both("randomized_rounding", *args, seed=7)
    x2 = both("randomized_rounding", *args, seed=7)
    assert np.array_equal(x1, x2)
    assert np.allclose(x1, np.round(x1))
    assert np.all(np.abs(x1 - args[-1]) <= 1.0)


def test_rins_bounds_fix_agreeing_vars():
    lo2, up2, nfx = both(
        "submip_bounds_rins", np.array([True, True, False]),
        np.array([2.0, 3.0, 0.7]), np.array([2.0, 2.4, 0.9]), np.zeros(3),
        np.full(3, 10.0))
    assert nfx == 1
    assert lo2[0] == up2[0] == 2.0
    assert lo2[1] == 0.0 and up2[1] == 10.0
    assert lo2[2] == 0.0 and up2[2] == 10.0


def test_rens_bounds_box():
    lo2, up2 = both("submip_bounds_rens", np.array([True, False]),
                    np.array([2.4, 1.7]), np.zeros(2), np.full(2, 10.0))
    assert lo2[0] == 2.0 and up2[0] == 3.0
    assert lo2[1] == 0.0 and up2[1] == 10.0


def test_root_redcost_bounds_like_jax():
    lo2, up2, nfx = both(
        "submip_bounds_root_redcost", np.array([True, True, False]),
        np.array([0.0, 3.0, 0.5]), np.array([2.0, 0.0, 0.0]),
        np.zeros(3), np.full(3, 5.0))
    assert nfx >= 1 and lo2[0] == up2[0] == 0.0


def test_redcost_fixing_tightens():
    lo2, up2, n = both(
        "redcost_fixing", np.array([4.0, -4.0, 0.0]),
        np.array([0.0, 5.0, 1.0]), 10.0, 12.0, np.zeros(3),
        np.full(3, 5.0), np.array([True, True, True]))
    assert n == 2
    assert up2[0] == 0.0 and lo2[1] == 5.0
    assert up2[2] == 5.0 and lo2[2] == 0.0


def test_redcost_fixing_no_gap_no_change():
    lo2, up2, n = both("redcost_fixing", np.array([4.0]), np.array([0.0]),
                       10.0, np.inf, np.zeros(1), np.full(1, 5.0),
                       np.array([True]))
    assert n == 0 and up2[0] == 5.0


def _seeded_mip(kind):
    d = (set_cover(40, 80, 0.08, seed=3) if kind == "setcover"
         else facility_location(8, 6, seed=2))
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"])).tocsr()
    return a, d


@pytest.mark.parametrize("kind", ["setcover", "cfl"])
def test_node_propagation_is_native_and_like_jax(kind, monkeypatch):
    """Node propagation calls hx_propagate (the port has no numpy
    fallback) and gives the JAX Propagator's bounds exactly, from the
    root box and from branched boxes, with and without incremental
    seeding."""
    a, d = _seeded_mip(kind)
    is_int = d["integrality"] == 1
    calls = []
    native = tnative.propagate_native

    def counted(*args, **kwargs):
        calls.append(1)
        return native(*args, **kwargs)
    monkeypatch.setattr(tnative, "propagate_native", counted)
    tp = tprop.Propagator(a, d["row_lower"], d["row_upper"], is_int)
    jp = jprop.Propagator(a, d["row_lower"], d["row_upper"], is_int)
    assert jp._native is not None  # the reference runs native too
    rng = np.random.default_rng(4)
    lo, up = d["col_lower"].copy(), d["col_upper"].copy()
    for step in range(12):
        seed = None
        if step:
            free = np.nonzero(is_int & (up > lo))[0]
            if not len(free):
                break
            j = int(rng.choice(free))
            lo, up = lo.copy(), up.copy()
            if rng.random() < 0.5:
                up[j] = lo[j]
            else:
                lo[j] = up[j]
            seed = np.array([j], dtype=np.int32) if step % 2 else None
        got = tp.propagate(lo, up, seed_cols=seed)
        want = jp.propagate(lo, up, seed_cols=seed)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        if not got[0]:
            break
        lo, up = got[1], got[2]
    assert len(calls) >= 2


def test_coefficient_strengthening_like_jax():
    a, d = _seeded_mip("cfl")
    is_int = d["integrality"] == 1
    # a big-M version of the linking rows: x_ij - 10 y_j <= 0
    a = a.tolil()
    nrow = a.shape[0]
    n_x = a.shape[1] - 6
    for r in range(nrow - n_x, nrow):
        cols = a.rows[r]
        a[r, cols[-1]] = -10.0
    a = a.tocsr()
    args = (a, d["row_lower"], d["row_upper"], d["col_lower"],
            d["col_upper"], is_int)
    got = tprop.strengthen_coefficients(*args)
    want = jprop.strengthen_coefficients(*args)
    assert got[3] == want[3] > 0
    assert (got[0] != want[0]).nnz == 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("kind", ["setcover", "cfl"])
def test_root_probing_like_jax(kind):
    """Probing every binary gives the same fixings, implication store
    and cover-clique rows in both packages."""
    a, d = _seeded_mip(kind)
    is_int = d["integrality"] == 1
    lo, up = d["col_lower"], d["col_upper"]
    out = []
    for prop, imp in ((tprop, timp), (jprop, jimp)):
        impl = imp.Implications(prop.Propagator(
            a, d["row_lower"], d["row_upper"], is_int))
        nl, nu = impl.probe(list(np.nonzero(is_int)[0]), lo, up,
                            max_probes=64)
        rows = impl.cover_clique_rows(nl, nu, is_int, d["col_cost"])
        out.append((impl, nl, nu, rows))
    (ti, tl, tu, trows), (ji, jl, ju, jrows) = out
    assert ti.infeasible == ji.infeasible
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tu, ju)
    assert sorted(ti.store) == sorted(ji.store)
    for k in ti.store:
        for g, w in zip(ti.store[k], ji.store[k]):
            np.testing.assert_array_equal(g, w)
    assert len(trows) == len(jrows)
    for g, w in zip(trows, jrows):
        np.testing.assert_array_equal(g.cols, w.cols)
        np.testing.assert_array_equal(g.vals, w.vals)
        assert g.rhs == w.rhs


@pytest.mark.parametrize("kind,seed", [("setcover", 0), ("setcover", 3),
                                       ("cfl", 1)])
def test_feasibility_jump_like_jax(kind, seed):
    """The native jump from the same start and seed gives the same
    feasible point (a move budget, not the clock, ends it here)."""
    a, d = _seeded_mip(kind)
    is_int = d["integrality"] == 1
    args = (a, d["row_lower"], d["row_upper"], d["col_lower"],
            d["col_upper"], d["col_cost"], is_int)
    kw = dict(x0=np.zeros(d["num_col"]), seed=seed, max_moves=20000,
              time_budget=60.0)
    got = tfj.feasibility_jump(*args, **kw)
    want = jfj.feasibility_jump(*args, **kw)
    assert got is not None
    np.testing.assert_array_equal(got, want)
    act = a @ got
    assert np.all(act >= d["row_lower"] - 1e-6)
    assert np.all(act <= d["row_upper"] + 1e-6)
    assert np.all(got[is_int] == np.round(got[is_int]))


def test_feasibility_jump_without_a_time_budget():
    """The default (infinite) time budget runs to the move budget; the
    JAX package's wrapper passes it to the native deadline as it is,
    which overflows and returns no point (ROADMAP queue 3)."""
    a, d = _seeded_mip("setcover")
    args = (a, d["row_lower"], d["row_upper"], d["col_lower"],
            d["col_upper"], d["col_cost"], d["integrality"] == 1)
    got = tfj.feasibility_jump(*args, x0=np.zeros(d["num_col"]),
                               max_moves=20000)
    assert got is not None and np.all(a @ got >= 1 - 1e-9)
    assert jfj.feasibility_jump(*args, x0=np.zeros(d["num_col"]),
                                max_moves=20000) is None
