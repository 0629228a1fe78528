"""Whole PDLP solves in the formats ported in the second slice: the
port's `solve_lp_pdlp` against the JAX package's on `_sparse_lp`.

Each format gives the JAX package's status and objective (1e-6
relative) in the same format, the iteration count of the JAX package's
exact f64 `ell` run (within 5%), and the port's `ell` solution (1e-6,
in the natural order of rows and columns).  The iteration counts are
held against `ell` because the JAX package's f64 bucket-ELL, bucket-perm
and one-hot steps round to f32 (its `linop_dtype` answers float32 there,
ROADMAP queue 3); the port's stay f64.  The solves stop at 1e-4, where
every run takes seconds on the CPU."""
import numpy as np
import pytest
import torch

from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.pdlp.wrapper import solve_lp_pdlp
from test_torch_pdlp import _assert_agree, _solve_both, _sparse_lp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

TOL = 1e-4
FIELDS = ("col_value", "col_dual", "row_value", "row_dual")


@pytest.fixture(scope="module")
def ell_runs():
    """(JAX, port) runs of _sparse_lp in the exact f64 ELL format."""
    return _solve_both(_sparse_lp(), tpu_matrix_format="ell",
                       pdlp_optimality_tolerance=TOL)


@pytest.mark.parametrize("fmt", ["panelell", "bucketell", "bucketperm",
                                 "bcoo", "onehot"])
def test_sparse_lp_format(ell_runs, fmt):
    # bucketperm solves the problem permuted into bucket order and must
    # hand the solution back in the natural order
    jax_run, port_run = _solve_both(_sparse_lp(), tpu_matrix_format=fmt,
                                    pdlp_optimality_tolerance=TOL)
    assert int(port_run[0]) == int(HighsModelStatus.kOptimal)
    _assert_agree(jax_run, port_run, iterations=False)
    _assert_agree(ell_runs[0], port_run)
    ell_sol, sol = ell_runs[1][1], port_run[1]
    for field in FIELDS:
        np.testing.assert_allclose(getattr(sol, field),
                                   getattr(ell_sol, field), rtol=0,
                                   atol=1e-6, err_msg=field)


def test_onehot_f32_refines_to_f64_tolerance():
    # f32 one-hot products floor near 1e-6; the f64 host refinement
    # brings the returned solution to the 1e-7 asked for
    _, port_run = _solve_both(_sparse_lp(), tpu_matrix_format="onehot",
                              tpu_dtype="float32",
                              pdlp_optimality_tolerance=1e-7,
                              run_jax=False)
    status, _, info = port_run
    assert int(status) == int(HighsModelStatus.kOptimal)
    assert info.rel_gap <= 1e-7


def test_bucketperm_f32_warm_start_refines_in_permuted_space():
    # bucketperm permutes the problem, the warm start and the f64
    # refinement oracle into bucket order.  Warm-started at the exact
    # ell solution, its f32 round and refinement reach 1e-7 in a
    # fraction of a cold run's iterations (about 14,000 on this LP), and
    # the solution comes back in the natural order.  A warm start or an
    # oracle left in the natural order costs several times as many.
    d = _sparse_lp()
    _, (_, ell_sol, ell_info) = _solve_both(
        d, run_jax=False, tpu_matrix_format="ell",
        pdlp_optimality_tolerance=1e-7)
    assert ell_info.rel_gap <= 1e-7
    opts = HighsOptions()
    opts.tpu_matrix_format = "bucketperm"
    opts.tpu_dtype = "float32"
    opts.pdlp_optimality_tolerance = 1e-7
    opts.pdlp_iteration_limit = 6000  # per round, so a wrong oracle ends
    status, sol, info = solve_lp_pdlp(lp_from_numpy(d), opts,
                                      x0=ell_sol.col_value,
                                      y0=ell_sol.row_dual, device="cpu")
    print(f"bucketperm f32 warm start: {info.iterations} iterations, "
          f"rel_gap {info.rel_gap:.3e}")
    assert int(status) == int(HighsModelStatus.kOptimal)
    assert info.rel_gap <= 1e-7
    assert info.iterations <= 5000
    # both solutions lie within 1e-7 of the optimum: they agree to the
    # conditioning of this LP, far inside the unit scale of a misplaced
    # entry
    for field in FIELDS:
        np.testing.assert_allclose(getattr(sol, field),
                                   getattr(ell_sol, field), rtol=0,
                                   atol=1e-4, err_msg=field)
