"""The facade entry of equality-form LPs with nonnegative columns (the
EMD flow): one LP a call, `passModel` on a new `highs_tpu_torch.Highs`
and `run()`, as a user drives the solver.

`prepare` is the client's work before the call (the model as the
facade's `HighsLp`: rows `b <= A x <= b`, columns `0 <= x < inf`; a new
`Highs` with the cell's options); `call` is what the window times;
`finish` reads what the program returned: the answer, the route the
solve took (from the program's counters, as `facade.py` reads them),
under `api` the objects of the public API whole, and under `factors`
the Newton factors of the call by engine and device with the banded
factor's precision-gate hand-offs (the IPM's `SPARSE_FACTORS` and
`BANDED_HANDOFFS`).

Those two counters are what the cell reports its factors from, so
`prepare` reads them before any call: a program without them stops
there, at the warm-up, and does not run a window it cannot report.
Whether a solve took the cell's route is the harness's check, from the
counters of `facade.py`.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from lpbench.entries import facade
from lpbench.trace import span


class Handle:
    def __init__(self, h, lp, before, factors):
        self.h = h
        self.lp = lp
        self.before = before
        self.factors = factors


# the program's counters that tell which route a solve took
counters = facade.counters


def factor_counts() -> dict:
    """The IPM's Newton factors by engine and device, and the banded
    factor's hand-offs ("handoffs")."""
    from highs_tpu_torch.solvers.ipm import solver
    return {**solver.SPARSE_FACTORS,
            "handoffs": solver.BANDED_HANDOFFS["gate"]}


def prepare(lps, options: dict, device) -> Handle:
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    (lp,) = lps
    m, n = lp.a.shape
    model = HighsLp(num_col=n, num_row=m, col_cost=lp.c.copy(),
                    col_lower=np.zeros(n), col_upper=np.full(n, np.inf),
                    row_lower=lp.b.copy(), row_upper=lp.b.copy(),
                    a_matrix=HighsSparseMatrix.from_scipy(
                        sp.csc_matrix(lp.a)), sense=1)
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("output_flag", False)
    for key, val in options.items():
        h.setOptionValue(key, val)
    return Handle(h, model, counters(), factor_counts())


def call(handle: Handle) -> None:
    with span("passModel"):
        handle.h.passModel(handle.lp)
    with span("run"):
        handle.h.run()
        if handle.h.device.type == "cuda":
            torch.cuda.synchronize()


def finish(handle: Handle) -> dict:
    """The call's answers (one), its route, the public API's objects
    and the call's Newton factors."""
    rec = facade.finish(handle)
    after = factor_counts()
    rec["factors"] = {k: after[k] - handle.factors[k] for k in after}
    return rec


def summary(rec: dict) -> dict:
    """A few of the call's numbers, for the run's log."""
    api = rec["api"]
    return {"presolve_s": api["run_data"].presolve_time,
            "solve_s": api["run_data"].solve_time,
            "ipm_setup_s": api["timer"].read("ipm_setup"),
            "ipm_iterations": api["info"].ipm_iteration_count,
            "factors": {k: v for k, v in rec["factors"].items() if v},
            "objective": rec["answers"][0]["objective"]}
