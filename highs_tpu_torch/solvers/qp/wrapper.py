"""Convex QP solver entry.

The JAX package's `solvers/qp/wrapper.py`: the dense QP interior-point
solver (ipm_qp.py) on the caller's device, the active set (active_set.py,
solver "qpasm") on the host, and the classification LPs of
`classify_qp_inconclusive` where the IPM cannot conclude.  Unlike the
JAX package, a small QP is not moved to the CPU: it runs on the device
it is given.
"""
from __future__ import annotations

from ...constants import HighsModelStatus
from ...device import resolve_device
from ...models.lp import HighsModel
from ...models.solution import HighsSolution
from ...options import HighsOptions
from ...utils.timer import span
from ..classify import classify_qp_inconclusive
from .active_set import solve_qp_active_set
from .ipm_qp import solve_qp_ipm


def solve_qp(model: HighsModel, options: HighsOptions, log=None,
             device=None):
    """Solve a convex QP on `device` (default CUDA); returns (status,
    solution, info) with `info.iterations` the solver's count."""
    device = resolve_device(device)
    # "qpasm" selects the active-set method (reference: QUASS,
    # qpsolver/a_quass.cpp; solver option values HighsOptions.h:274-280)
    if options.solver == "qpasm":
        status, solution, info = solve_qp_active_set(
            model, options, log=log)
        if status in (HighsModelStatus.kOptimal,
                      HighsModelStatus.kInfeasible,
                      HighsModelStatus.kUnbounded,
                      HighsModelStatus.kTimeLimit):
            return status, solution, info
        if log is not None:
            log("QP active set inconclusive: falling back to IPM")
    status, solution, info = solve_qp_ipm(model, options, log=log,
                                          device=device)
    if status in (HighsModelStatus.kUnknown,
                  HighsModelStatus.kIterationLimit):
        with span(getattr(options, "_timer", None), "qp.classify"):
            verdict = classify_qp_inconclusive(model, options, log=log,
                                               device=device)
        if verdict in (HighsModelStatus.kInfeasible,
                       HighsModelStatus.kUnbounded):
            info.status = verdict
            return verdict, HighsSolution(), info
        # IPM stalled on a feasible QP: the active-set method is the
        # exact fallback at host-tractable sizes (reference analogue:
        # HiPO-QP falls back to QUASS via callSolveQp selection)
        if model.lp.num_col + model.lp.num_row <= 5000:
            st2, sol2, info2 = solve_qp_active_set(model, options,
                                                   log=log)
            if st2 in (HighsModelStatus.kOptimal,
                       HighsModelStatus.kInfeasible,
                       HighsModelStatus.kUnbounded):
                if log is not None:
                    log("QP IPM inconclusive: active-set fallback "
                        "succeeded")
                return st2, sol2, info2
    return status, solution, info
