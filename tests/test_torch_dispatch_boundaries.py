"""tests/test_lp_solve.py::test_dispatch_boundaries_solve_correctly
through the port's dispatch, on the CPU.

The same seeded LPs (seed 8, 1,499 and 1,501 equality rows, drawn in
that order) at the `choose` gates: each reaches the optimum of a forced
simplex solve.  The JAX facade's run of the same LPs is that test
itself, which the suite already runs; each of its four native simplex
solves takes about 50 s on a CPU core, so it is not run a second time
here.  The two sizes are cases of one test, in draw order.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.dispatch import solve_lp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


def _boundary_lps():
    """The LPs of the JAX test, drawn from one generator in its order."""
    rng = np.random.default_rng(8)
    lps = {}
    for m in (1499, 1501):
        n = m
        a = (sp.random(m, n, density=min(0.05, 20 / m),
                       random_state=rng, format="csc") +
             sp.identity(m) * 3.0).tocsc()
        b = a @ rng.uniform(0, 1, n)
        lps[m] = HighsLp(
            num_col=n, num_row=m, col_cost=rng.uniform(0.5, 1.5, n),
            col_lower=np.zeros(n), col_upper=np.full(n, 2.0),
            row_lower=np.asarray(b).ravel(),
            row_upper=np.asarray(b).ravel(),
            a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
    return lps


@pytest.mark.parametrize("m", [1499, 1501])
def test_dispatch_boundaries_solve_correctly(m):
    lp = _boundary_lps()[m]
    st, sol, info = solve_lp(lp, HighsOptions(), presolve=False,
                             device="cpu")
    assert st == HighsModelStatus.kOptimal, m
    obj = float(lp.col_cost @ sol.col_value)
    o = HighsOptions()
    o.solver = "simplex"
    st2, sol2, _ = solve_lp(lp, o, presolve=False, device="cpu")
    assert st2 == HighsModelStatus.kOptimal
    ref = float(lp.col_cost @ sol2.col_value)
    assert abs(obj - ref) <= 1e-5 * (1 + abs(ref)), m
