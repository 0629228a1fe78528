"""The facade entry: one LP a call, `passModel` on a new
`highs_tpu_torch.Highs` and `run()`, as a user drives the solver.

`prepare` is the client's work before the call (the model as the
facade's `HighsLp`, a new `Highs` with the cell's options); `call` is
what the window times; `finish` reads what the program returned: the
answer, the route the solve took (from the program's own counters), and
under `api` the objects of the public API whole (`getInfo()`,
`getRunData()`, `getTimer()`), so that a metric can read any count or
clock of them by its name.
"""
from __future__ import annotations

import numpy as np
import torch

from lpbench.trace import span


class Handle:
    def __init__(self, h, lp, before):
        self.h = h
        self.lp = lp
        self.before = before


def counters() -> dict:
    """The program's counters that tell which route a solve took."""
    from highs_tpu_torch.ops import block_csr, onehot_spmv
    from highs_tpu_torch.solvers.ipm import solver as ipm_solver
    from highs_tpu_torch.solvers.pdlp import graph
    return {"block_csr_spmv": block_csr.LAUNCHES,
            "onehot_spmv": onehot_spmv.LAUNCHES["onehot_spmv"],
            "graph_replays": graph.COUNTS.get("replays", 0),
            **{"ipm_" + k: v for k, v in ipm_solver.ROUTES.items()}}


def prepare(lps, options: dict, device) -> Handle:
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    (lp,) = lps
    m, n = lp.a.shape
    model = HighsLp(num_col=n, num_row=m, col_cost=lp.c.copy(),
                    col_lower=np.zeros(n), col_upper=lp.upper.copy(),
                    row_lower=lp.b.copy(), row_upper=np.full(m, np.inf),
                    a_matrix=HighsSparseMatrix.from_scipy(lp.a), sense=1)
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("output_flag", False)
    for key, val in options.items():
        h.setOptionValue(key, val)
    return Handle(h, model, counters())


def call(handle: Handle) -> None:
    with span("passModel"):
        handle.h.passModel(handle.lp)
    with span("run"):
        handle.h.run()
        if handle.h.device.type == "cuda":
            torch.cuda.synchronize()


def route(before: dict, after: dict, info) -> str:
    """The engine and the product kernel or Newton route a solve took."""
    grew = [k for k in after if after[k] > before[k]]
    if info.ipm_iteration_count > 0:
        return "ipm+" + "+".join(sorted(k[4:] for k in grew
                                        if k.startswith("ipm_")))
    if info.pdlp_iteration_count > 0:
        kernels = [k for k in ("block_csr_spmv", "onehot_spmv") if k in grew]
        graphs = ["graphs"] if "graph_replays" in grew else []
        return "+".join(["pdlp"] + kernels + graphs)
    if info.simplex_iteration_count > 0:
        return "simplex"
    return "none"


def finish(handle: Handle) -> dict:
    """The call's answers (one), its route and the public API's
    objects."""
    import highs_tpu_torch
    h = handle.h
    info = h.getInfo()
    sol = h.getSolution()
    ok = h.getModelStatus() == highs_tpu_torch.HighsModelStatus.kOptimal
    answer = {"optimal": bool(ok), "status": h.getModelStatus().name,
              "x": np.asarray(sol.col_value, dtype=np.float64).copy(),
              "y": np.asarray(sol.row_dual, dtype=np.float64).copy(),
              "objective": float(h.getObjectiveValue())}
    return {"answers": [answer],
            "route": route(handle.before, counters(), info),
            "api": {"info": info, "run_data": h.getRunData(),
                    "timer": h.getTimer()}}


def summary(rec: dict) -> dict:
    """A few of the call's numbers, for the run's log."""
    api = rec["api"]
    return {"presolve_s": api["run_data"].presolve_time,
            "solve_s": api["run_data"].solve_time,
            "pdlp_round_s": api["timer"].read("pdlp_round"),
            "pdlp_iterations": api["info"].pdlp_iteration_count,
            "ipm_setup_s": api["timer"].read("ipm_setup"),
            "ipm_iterations": api["info"].ipm_iteration_count,
            "gap": api["info"].primal_dual_objective_error}
