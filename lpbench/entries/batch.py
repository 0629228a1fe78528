"""The batch entry: many LPs a call through
`highs_tpu_torch.solvers.pdlp.batch.solve_lp_batch`, as a user runs a
sweep of small LPs.

`prepare` is the client's work before the call (each LP as the
facade's `HighsLp`, the options); `call` is what the window times;
`finish` reads each LP's answer and the route from the program's
counters, and keeps under `api` what `solve_lp_batch` returned for each
LP whole (its status and `PdlpRunInfo`), for the metrics to read.
"""
from __future__ import annotations

import numpy as np
import torch

from lpbench.trace import span


class Handle:
    def __init__(self, lps, options, device, before):
        self.lps = lps
        self.options = options
        self.device = device
        self.before = before
        self.results = None


def counters() -> dict:
    from highs_tpu_torch.ops import pdhg_step
    from highs_tpu_torch.solvers.pdlp import graph
    return {"graph_replays": graph.COUNTS.get("replays", 0),
            "pdhg_primal_step": pdhg_step.LAUNCHES["pdhg_primal_step"]}


def prepare(lps, options: dict, device) -> Handle:
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    from highs_tpu_torch.options import HighsOptions
    models = []
    for lp in lps:
        m, n = lp.a.shape
        models.append(HighsLp(
            num_col=n, num_row=m, col_cost=lp.c.copy(),
            col_lower=np.zeros(n), col_upper=lp.upper.copy(),
            row_lower=lp.b.copy(), row_upper=np.full(m, np.inf),
            a_matrix=HighsSparseMatrix.from_scipy(lp.a), sense=1))
    opts = HighsOptions()
    opts.output_flag = False
    for key, val in options.items():
        setattr(opts, key, val)
    return Handle(models, opts, device, counters())


def call(handle: Handle) -> None:
    from highs_tpu_torch.solvers.pdlp.batch import solve_lp_batch
    with span("batch_call"):
        handle.results = solve_lp_batch(handle.lps, handle.options,
                                        device=handle.device)
        if handle.device.type == "cuda":
            torch.cuda.synchronize()


def finish(handle: Handle) -> dict:
    """Each LP's answer, the call's route and the returned records."""
    answers = []
    for status, sol, info in handle.results:
        answers.append({
            "optimal": status.name == "kOptimal", "status": status.name,
            "x": np.asarray(sol.col_value, dtype=np.float64).copy(),
            "y": np.asarray(sol.row_dual, dtype=np.float64).copy(),
            "objective": float(info.primal_obj)})
    after = counters()
    grew = [k for k in after if after[k] > handle.before[k]]
    route = "+".join(["batch"] + (["graphs"] if "graph_replays" in grew
                                  else []) +
                     (["step_kernels"] if "pdhg_primal_step" in grew
                      else []))
    return {"answers": answers, "route": route,
            "api": {"results": [(status, info) for status, _, info
                                in handle.results]}}


def summary(rec: dict) -> dict:
    """The call's steps (the largest member's iterations), for the log."""
    its = [info.iterations for _, info in rec["api"]["results"]]
    return {"steps": max(its) if its else 0,
            "statuses": sorted({s.name for s, _ in rec["api"]["results"]})}
