"""Whole PDLP solves: the port's `solve_lp_pdlp` against the JAX
package's on the same seeded LPs.  Same status, objective to 1e-6
relative, iteration counts within 5% (both are printed)."""
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu.constants import HighsModelStatus as JStatus
from highs_tpu.models.lp import HighsLp as JLp
from highs_tpu.models.lp import HighsSparseMatrix as JMatrix
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.solvers.pdlp.wrapper import solve_lp_pdlp as jax_solve
from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.pdlp.wrapper import solve_lp_pdlp
from highs_tpu_torch.utils import gen_block_lp as port_gen

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import gen_block_lp as jax_gen  # noqa: E402

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


def _lp_dict(a, c, lo, up, rl, ru):
    a = sp.csc_matrix(a)
    return dict(num_col=a.shape[1], num_row=a.shape[0], col_cost=c,
                col_lower=lo, col_upper=up, row_lower=rl, row_upper=ru,
                a_start=a.indptr, a_index=a.indices, a_value=a.data)


def _jax_lp(d):
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    return JLp(num_col=d["num_col"], num_row=d["num_row"],
               col_cost=np.array(d["col_cost"], dtype=np.float64),
               col_lower=np.array(d["col_lower"], dtype=np.float64),
               col_upper=np.array(d["col_upper"], dtype=np.float64),
               row_lower=np.array(d["row_lower"], dtype=np.float64),
               row_upper=np.array(d["row_upper"], dtype=np.float64),
               a_matrix=JMatrix.from_scipy(a), sense=1)


def _block_lp():
    a, b, c = port_gen.gen_block_lp(nblocks=2)
    ja, jb, jc = jax_gen.gen_block_lp(nblocks=2)
    # the port's copy of the generator makes the JAX tool's LP
    assert (a != ja).nnz == 0
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(c, jc)
    n, m = a.shape[1], a.shape[0]
    return _lp_dict(a, c, np.zeros(n), np.full(n, 10.0), b,
                    np.full(m, np.inf))


def _sparse_lp():
    rng = np.random.default_rng(0)
    m, n = 300, 400
    a = sp.random(m, n, density=0.03, random_state=rng, format="csc")
    r = a @ rng.uniform(0, 1, n)
    rl = np.where(rng.uniform(size=m) < 0.3, r,
                  r - np.abs(rng.standard_normal(m)) * 0.1)
    ru = np.where(rng.uniform(size=m) < 0.3, r, np.inf)
    ru = np.where(rl == r, r, ru)
    return _lp_dict(a, rng.uniform(0.1, 1, n), np.zeros(n), np.full(n, 5.0),
                    rl, ru)


def _infeasible_lp():
    # rows 0 and 1 hold the same coefficients: a'x >= r0 + 1, a'x <= r0
    rng = np.random.default_rng(1)
    m, n = 60, 80
    a = sp.random(m, n, density=0.1, random_state=rng, format="lil")
    a[1, :] = a[0, :]
    a = a.tocsc()
    r = a @ rng.uniform(0, 1, n)
    rl, ru = r - 1, np.full(m, np.inf)
    rl[0], rl[1], ru[1] = r[0] + 1, -np.inf, r[0]
    return _lp_dict(a, rng.uniform(0.1, 1, n), np.zeros(n), np.full(n, 5.0),
                    rl, ru)


def _unbounded_lp():
    # column 0 costs -1, has no upper bound, and only helps its >= rows
    rng = np.random.default_rng(2)
    m, n = 60, 80
    a = abs(sp.random(m, n, density=0.1, random_state=rng, format="csc"))
    r = a @ rng.uniform(0, 1, n)
    c = rng.uniform(0.1, 1, n)
    c[0] = -1.0
    up = np.full(n, 5.0)
    up[0] = np.inf
    return _lp_dict(a, c, np.zeros(n), up, r - 0.5, np.full(m, np.inf))


def _solve_both(d, jax_format=None, run_jax=True, **opts):
    """(JAX run, port run), each (status, solution, info); the JAX run
    is None when run_jax is False."""
    jopts, topts = JOptions(), HighsOptions()
    for k, v in opts.items():
        setattr(jopts, k, v)
        setattr(topts, k, v)
    if jax_format is not None:
        jopts.tpu_matrix_format = jax_format
    jax_run = jax_solve(_jax_lp(d), jopts) if run_jax else None
    tst, tsol, tinfo = solve_lp_pdlp(lp_from_numpy(d), topts, device="cpu")
    jax_note = (f"JAX {JStatus(jax_run[0]).name} {jax_run[2].iterations} "
                f"iterations obj {jax_run[2].primal_obj!r}; " if run_jax
                else "")
    print(f"{opts}: {jax_note}port {HighsModelStatus(tst).name} "
          f"{tinfo.iterations} iterations obj {tinfo.primal_obj!r}")
    return jax_run, (tst, tsol, tinfo)


def _assert_agree(jax_run, port_run, iterations=True):
    (jst, jsol, jinfo), (tst, tsol, tinfo) = jax_run, port_run
    assert int(tst) == int(jst)
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-6 * max(1.0, abs(jinfo.primal_obj))
    if iterations:
        assert abs(tinfo.iterations - jinfo.iterations) <= \
            0.05 * jinfo.iterations


def test_block_lp_blockcsr_f64():
    d = _block_lp()
    jax_run, port_run = _solve_both(d, tpu_matrix_format="blockcsr",
                                    pdlp_optimality_tolerance=1e-6)
    assert int(port_run[0]) == int(HighsModelStatus.kOptimal)
    # the JAX package's f64 block-CSR step rounds the vectors it hands to
    # the product to f32 (its linop_dtype has no block-CSR case), which
    # costs it iterations; the port keeps f64, so its iteration count is
    # held against the JAX package's exact f64 operator on the same LP
    _assert_agree(jax_run, port_run, iterations=False)
    exact_run, _ = _solve_both(d, jax_format="dense",
                               tpu_matrix_format="blockcsr",
                               pdlp_optimality_tolerance=1e-6)
    _assert_agree(exact_run, port_run)


def test_block_lp_blockcsr_f32_refinement():
    d = _block_lp()
    jax_run, port_run = _solve_both(d, tpu_matrix_format="blockcsr",
                                    tpu_dtype="float32",
                                    pdlp_optimality_tolerance=1e-7)
    assert int(port_run[0]) == int(HighsModelStatus.kOptimal)
    _assert_agree(jax_run, port_run)
    # refinement ran: f32 alone floors near 1e-6, the result is at 1e-7
    assert port_run[2].rel_gap <= 1e-7


@pytest.mark.parametrize("fmt", ["ell", "dense"])
def test_sparse_lp(fmt):
    jax_run, port_run = _solve_both(_sparse_lp(), tpu_matrix_format=fmt,
                                    pdlp_optimality_tolerance=1e-6)
    assert int(port_run[0]) == int(HighsModelStatus.kOptimal)
    _assert_agree(jax_run, port_run)
    np.testing.assert_allclose(port_run[1].col_value, jax_run[1].col_value,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("make,status", [
    (_infeasible_lp, HighsModelStatus.kInfeasible),
    (_unbounded_lp, HighsModelStatus.kUnbounded)])
def test_infeasible_and_unbounded(make, status):
    jax_run, port_run = _solve_both(make(), tpu_matrix_format="dense",
                                    pdlp_optimality_tolerance=1e-6)
    assert int(port_run[0]) == int(status)
    assert int(jax_run[0]) == int(status)
    assert abs(port_run[2].iterations - jax_run[2].iterations) <= \
        0.05 * jax_run[2].iterations


def test_warm_start():
    d = _sparse_lp()
    jax_cold, _ = _solve_both(d, tpu_matrix_format="dense",
                              pdlp_optimality_tolerance=1e-4)
    x0, y0 = jax_cold[1].col_value, jax_cold[1].row_dual
    jopts, topts = JOptions(), HighsOptions()
    for o in (jopts, topts):
        o.tpu_matrix_format = "dense"
        o.pdlp_optimality_tolerance = 1e-6
    jst, _, jinfo = jax_solve(_jax_lp(d), jopts, x0=x0, y0=y0)
    tst, _, tinfo = solve_lp_pdlp(lp_from_numpy(d), topts, x0=x0, y0=y0,
                                  device="cpu")
    print(f"warm start: JAX {jinfo.iterations} iterations, port "
          f"{tinfo.iterations}")
    _assert_agree((jst, None, jinfo), (tst, None, tinfo))
    assert int(tst) == int(HighsModelStatus.kOptimal)


def test_bound_only_lp():
    d = _lp_dict(sp.csc_matrix((0, 3)), np.array([1.0, -2.0, 0.0]),
                 np.array([-1.0, 0.0, 2.0]), np.array([4.0, 3.0, 5.0]),
                 np.zeros(0), np.zeros(0))
    jax_run, port_run = _solve_both(d)
    _assert_agree(jax_run, port_run)
    np.testing.assert_array_equal(port_run[1].col_value, [-1.0, 3.0, 2.0])


@pytest.mark.parametrize("name,value,match", [
    ("solver", "pdlp", "not yet ported"),
    ("tpu_mesh_shape", "2", "not yet ported")])
def test_options_not_yet_ported_raise(name, value, match):
    opts = HighsOptions()
    setattr(opts, name, value)
    with pytest.raises(NotImplementedError, match=match):
        solve_lp_pdlp(lp_from_numpy(_sparse_lp()), opts, device="cpu")
