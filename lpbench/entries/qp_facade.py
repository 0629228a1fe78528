"""The QP facade entry: one convex QP a call, `passModel` of a
`HighsModel` (the LP part and the lower triangle of Q) on a new
`highs_tpu_torch.Highs` and `run()`, as a user drives the solver.

`prepare` is the client's work before the call (the model, a new
`Highs` with the cell's options); `call` is what the window times;
`finish` reads the answer (x, the row duals y, the column duals z, the
objective), the route the solve took and, under `api`, the objects of
the public API whole (`getInfo()`, `getRunData()`, `getTimer()`).

The route is "qp_ipm" where the dense QP IPM alone answered on the
call's device: its dense factors (`ipm_qp.DENSE_FACTORS`, two an
iteration) grew there by twice the QP iterations and on no other
device, and neither the classification LPs nor the active set ran
(the clock "qp.classify" has no call; the active set runs only after
them). Anything else reads "qp_other".
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from lpbench.trace import span


class Handle:
    def __init__(self, h, model, before):
        self.h = h
        self.model = model
        self.before = before


def counters() -> dict:
    """The program's count of dense QP IPM factors, by device type."""
    from highs_tpu_torch.solvers.qp import ipm_qp
    return dict(ipm_qp.DENSE_FACTORS)


def model_of(qp):
    """The QP as the facade's `HighsModel` (minimise), Q as its lower
    triangle, column by column."""
    from highs_tpu_torch.models.lp import (HighsHessian, HighsLp,
                                           HighsModel, HighsSparseMatrix)
    m, n = qp.a.shape
    lp = HighsLp(num_col=n, num_row=m, col_cost=qp.c.copy(),
                 col_lower=qp.col_lower.copy(),
                 col_upper=qp.col_upper.copy(),
                 row_lower=qp.row_lower.copy(),
                 row_upper=qp.row_upper.copy(),
                 a_matrix=HighsSparseMatrix.from_scipy(qp.a.tocsc()),
                 sense=1)
    low = sp.tril(qp.q, format="csc")
    low.sum_duplicates()
    low.sort_indices()
    hessian = HighsHessian(dim=n, start=low.indptr.astype(np.int64),
                           index=low.indices.astype(np.int64),
                           value=low.data.astype(np.float64))
    return HighsModel(lp=lp, hessian=hessian)


def prepare(qps, options: dict, device) -> Handle:
    import highs_tpu_torch
    (qp,) = qps
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("output_flag", False)
    for key, val in options.items():
        h.setOptionValue(key, val)
    return Handle(h, model_of(qp), counters())


def call(handle: Handle) -> None:
    with span("passModel"):
        handle.h.passModel(handle.model)
    with span("run"):
        handle.h.run()
        if handle.h.device.type == "cuda":
            torch.cuda.synchronize()


def route(before: dict, after: dict, device: str, iterations: int,
          classified: int) -> str:
    """"qp_ipm" where the QP IPM alone answered on `device`."""
    grew = {k: after[k] - before.get(k, 0) for k in after}
    alone = all(v == 0 for k, v in grew.items() if k != device)
    if iterations > 0 and grew.get(device) == 2 * iterations and alone \
            and classified == 0:
        return "qp_ipm"
    return "qp_other"


def finish(handle: Handle) -> dict:
    """The call's answer (one), its route and the public API's
    objects."""
    import highs_tpu_torch
    h = handle.h
    info = h.getInfo()
    sol = h.getSolution()
    timer = h.getTimer()
    ok = h.getModelStatus() == highs_tpu_torch.HighsModelStatus.kOptimal
    answer = {"optimal": bool(ok), "status": h.getModelStatus().name,
              "x": np.asarray(sol.col_value, dtype=np.float64).copy(),
              "y": np.asarray(sol.row_dual, dtype=np.float64).copy(),
              "z": np.asarray(sol.col_dual, dtype=np.float64).copy(),
              "objective": float(h.getObjectiveValue())}
    return {"answers": [answer],
            "route": route(handle.before, counters(), h.device.type,
                           info.qp_iteration_count,
                           timer.num_calls("qp.classify")),
            "api": {"info": info, "run_data": h.getRunData(),
                    "timer": timer}}


def summary(rec: dict) -> dict:
    """A few of the call's numbers, for the run's log."""
    api = rec["api"]
    return {"solve_s": api["run_data"].solve_time,
            "qp_setup_s": api["timer"].read("qp_setup"),
            "qp_iterations_s": api["timer"].read("qp_iterations"),
            "qp_iterations": api["info"].qp_iteration_count,
            "objective": rec["answers"][0]["objective"]}
