"""Symmetry detection and its use in the MIP: the port against the JAX
package on the same models, on the CPU.

Each case of `tests/test_symmetry.py` runs in both packages: the
generators, orbits, symmetry-breaking pairs, orbitopes and their
fixings are equal, and the MIP solves give the same statuses and
objectives.  The JAX package switches symmetry off through an
environment variable (`HX_NO_SYM`) that the port does not read; both
packages switch it off here through the option `mip_detect_symmetry`."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu.presolve import symmetry as jsym
from highs_tpu_torch.presolve import symmetry as tsym

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

FACADES = ["torch", "jax"]


def _lp(pkg, d):
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    return pkg.HighsLp(
        num_col=d["num_col"], num_row=d["num_row"],
        col_cost=np.array(d["col_cost"], dtype=float),
        col_lower=np.array(d["col_lower"], dtype=float),
        col_upper=np.array(d["col_upper"], dtype=float),
        row_lower=np.array(d["row_lower"], dtype=float),
        row_upper=np.array(d["row_upper"], dtype=float),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(a), sense=1,
        integrality=np.array(d["integrality"], dtype=np.uint8))


def _dict(a, cost, lo, up, rl, ru, integ):
    a = sp.csc_matrix(a)
    return dict(num_col=a.shape[1], num_row=a.shape[0], col_cost=cost,
                col_lower=lo, col_upper=up, row_lower=rl, row_upper=ru,
                a_start=a.indptr, a_index=a.indices, a_value=a.data,
                integrality=integ)


def identical_items_knapsack(k=4):
    # max sum x_i, sum 2 x_i <= 2k-1, x binary: all items identical
    return _dict(np.full((1, k), 2.0), np.full(k, -1.0), np.zeros(k),
                 np.ones(k), np.array([-np.inf]), np.array([2.0 * k - 1.0]),
                 np.ones(k, dtype=np.uint8))


def identical_machines(jobs, machines, seed=3):
    """Assign jobs (weights 3..9) to identical machines, minimizing the
    makespan (the last column)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(3, 10, jobs).astype(float)
    ncol = jobs * machines + 1
    rows, cols, vals, rl, ru = [], [], [], [], []
    for j in range(jobs):
        for m in range(machines):
            rows.append(j)
            cols.append(j * machines + m)
            vals.append(1.0)
        rl.append(1.0)
        ru.append(1.0)
    for m in range(machines):
        r = jobs + m
        for j in range(jobs):
            rows.append(r)
            cols.append(j * machines + m)
            vals.append(w[j])
        rows.append(r)
        cols.append(ncol - 1)
        vals.append(-1.0)
        rl.append(-np.inf)
        ru.append(0.0)
    a = sp.csc_matrix((vals, (rows, cols)), shape=(jobs + machines, ncol))
    cost = np.zeros(ncol)
    cost[-1] = 1.0
    integ = np.ones(ncol, dtype=np.uint8)
    integ[-1] = 0
    up = np.ones(ncol)
    up[-1] = float(w.sum())
    return _dict(a, cost, np.zeros(ncol), up, np.array(rl), np.array(ru),
                 integ)


def solve(facade, d, **opts):
    if facade == "torch":
        h = highs_tpu_torch.Highs(device="cpu")
        h.passModel(_lp(highs_tpu_torch, d))
    else:
        h = highs_tpu.Highs()
        h.passModel(_lp(highs_tpu, d))
    h.setOptionValue("output_flag", False)
    for k, v in opts.items():
        h.setOptionValue(k, v)
    h.run()
    return h


def both_generators(d, **kw):
    got = tsym.detect_symmetry(_lp(highs_tpu_torch, d), **kw)
    want = jsym.detect_symmetry(_lp(highs_tpu, d), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def test_detects_identical_columns():
    d = identical_items_knapsack(4)
    gens = both_generators(d)
    assert gens, "identical columns must yield generators"
    orb = tsym.orbits(gens, 4)
    np.testing.assert_array_equal(orb, jsym.orbits(gens, 4))
    assert len(np.unique(orb)) < 4


def test_generators_are_verified_automorphisms():
    d = identical_items_knapsack(3)
    gens = both_generators(d)
    for g in gens:
        assert np.allclose(d["col_cost"], d["col_cost"][g])
        assert not np.array_equal(g, np.arange(3))


def test_no_symmetry_in_asymmetric_model():
    d = _dict(np.array([[1.0, 2.0, 3.0]]), np.array([1.0, 2.0, 3.0]),
              np.zeros(3), np.ones(3), np.array([-np.inf]),
              np.array([2.0]), np.ones(3, dtype=np.uint8))
    assert both_generators(d) == []


def test_symmetry_breaking_rows_shape():
    gens = both_generators(identical_items_knapsack(4))
    pairs = tsym.symmetry_breaking_rows(gens, 4)
    assert pairs == jsym.symmetry_breaking_rows(gens, 4)
    for j, k in pairs:
        assert j != k and 0 <= j < 4 and 0 <= k < 4


@pytest.mark.parametrize("facade", FACADES)
def test_mip_same_answer_with_symmetry_on_off(facade):
    objs = {}
    for flag in (True, False):
        h = solve(facade, identical_items_knapsack(5),
                  mip_detect_symmetry=flag, time_limit=60.0)
        assert h.getModelStatus().name == "kOptimal"
        objs[flag] = h.getObjectiveValue()
    assert abs(objs[True] - (-4.0)) < 1e-6
    assert abs(objs[True] - objs[False]) < 1e-6


@pytest.mark.parametrize("facade", FACADES)
def test_mip_symmetric_assignment(facade):
    """Two identical machines, three jobs: the same answer with and
    without symmetry handling."""
    a = np.zeros((5, 6))
    for j in range(3):
        a[j, 2 * j] = a[j, 2 * j + 1] = 1.0
    for m in range(2):
        for j in range(3):
            a[3 + m, 2 * j + m] = 1.0
    d = _dict(a, np.array([1.0, 1.0, 2.0, 2.0, 3.0, 3.0]), np.zeros(6),
              np.ones(6), np.array([1.0, 1.0, 1.0, -np.inf, -np.inf]),
              np.array([1.0, 1.0, 1.0, 2.0, 2.0]), np.ones(6, dtype=np.uint8))
    objs = {}
    for flag in (True, False):
        h = solve(facade, d, mip_detect_symmetry=flag)
        assert h.getModelStatus().name == "kOptimal"
        objs[flag] = h.getObjectiveValue()
    assert abs(objs[True] - objs[False]) < 1e-6
    assert abs(objs[True] - 6.0) < 1e-6


def test_orbital_branching_like_jax():
    """Orbital branching in the native search on an identical-machines
    makespan MIP: both packages reach the optimum 13 with symmetry on
    and off, and symmetry shrinks the port's tree (473 against 1,271
    nodes in both packages on an idle CPU; node counts are not compared
    across packages, since time-boxed heuristics shape the tree)."""
    d = identical_machines(9, 4)
    opts = dict(presolve="off", mip_rel_gap=0.0, threads=1,
                mip_parallel_heuristics=False)
    nodes = {}
    for flag in (True, False):
        got = solve("torch", d, mip_detect_symmetry=flag, **opts)
        want = solve("jax", d, mip_detect_symmetry=flag, **opts)
        assert got.getModelStatus().name == "kOptimal"
        assert abs(got.getObjectiveValue() - 13.0) < 1e-5
        assert abs(got.getObjectiveValue() -
                   want.getObjectiveValue()) < 1e-5
        nodes[flag] = got.getInfo().mip_node_count
    assert nodes[True] < nodes[False]


def test_packing_orbitope_detection_and_fixing():
    J, M = 4, 3
    ncol = J * M
    a = sp.csc_matrix((np.ones(ncol), (np.repeat(np.arange(J), M),
                                       np.arange(ncol))), shape=(J, ncol))
    d = _dict(a, np.zeros(ncol), np.zeros(ncol), np.ones(ncol), np.ones(J),
              np.ones(J), np.ones(ncol, dtype=np.uint8))
    g1, g2 = np.arange(ncol), np.arange(ncol)
    for j in range(J):
        g1[j * M + 0], g1[j * M + 1] = j * M + 1, j * M + 0
        g2[j * M + 1], g2[j * M + 2] = j * M + 2, j * M + 1
    orbs = tsym.detect_packing_orbitopes(_lp(highs_tpu_torch, d), [g1, g2])
    jorbs = jsym.detect_packing_orbitopes(_lp(highs_tpu, d), [g1, g2])
    assert [o.shape for o in orbs] == [(J, M)]
    for o, jo in zip(orbs, jorbs):
        np.testing.assert_array_equal(o, jo)
    fix = tsym.orbitope_fixings(orbs, ncol)
    assert fix == jsym.orbitope_fixings(jorbs, ncol)
    grid = orbs[0]
    assert set(fix) == {int(grid[0, 1]), int(grid[0, 2]), int(grid[1, 2])}


@pytest.mark.parametrize("facade", FACADES)
def test_orbitope_fixing_preserves_optimum(facade):
    d = identical_machines(10, 4)
    on = solve(facade, d, mip_rel_gap=0.0)
    off = solve(facade, d, mip_rel_gap=0.0, mip_detect_symmetry=False)
    assert abs(on.getInfo().objective_function_value -
               off.getInfo().objective_function_value) < 1e-6


@pytest.mark.parametrize("facade", FACADES)
def test_symmetric_mip_python_search_with_cut_aging(facade):
    """Symmetry-breaking rows join the relaxation without counting as
    cut rows; the Python search's cut aging must still work."""
    h = solve(facade, identical_items_knapsack(6),
              tpu_mip_native_search=False)
    assert h.getModelStatus().name == "kOptimal"
    assert abs(h.getInfo().objective_function_value - (-5.0)) < 1e-6
