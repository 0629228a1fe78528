"""Post-solve information record (lp_data/HighsInfo.h:92-131 behavior).

Field names match the reference so `Highs.getInfoValue(name)` accepts the
same names the reference documents.
"""
from __future__ import annotations

import dataclasses

from .constants import BasisValidity, SolutionStatus


@dataclasses.dataclass
class HighsInfo:
    valid: bool = False
    mip_node_count: int = -1
    simplex_iteration_count: int = -1
    ipm_iteration_count: int = -1
    crossover_iteration_count: int = -1
    pdlp_iteration_count: int = -1
    qp_iteration_count: int = -1
    primal_solution_status: int = int(SolutionStatus.kSolutionStatusNone)
    dual_solution_status: int = int(SolutionStatus.kSolutionStatusNone)
    basis_validity: int = int(BasisValidity.kBasisValidityInvalid)
    objective_function_value: float = 0.0
    mip_dual_bound: float = 0.0
    mip_gap: float = float("inf")
    max_integrality_violation: float = 0.0
    num_primal_infeasibilities: int = -1
    max_primal_infeasibility: float = float("inf")
    sum_primal_infeasibilities: float = float("inf")
    num_dual_infeasibilities: int = -1
    max_dual_infeasibility: float = float("inf")
    sum_dual_infeasibilities: float = float("inf")
    num_semi_infeasibilities: int = -1
    max_semi_infeasibility: float = float("inf")
    sum_semi_infeasibilities: float = float("inf")
    num_relative_primal_infeasibilities: int = -1
    max_relative_primal_infeasibility: float = float("inf")
    num_relative_dual_infeasibilities: int = -1
    max_relative_dual_infeasibility: float = float("inf")
    num_primal_residual_errors: int = -1
    max_primal_residual_error: float = float("inf")
    num_dual_residual_errors: int = -1
    max_dual_residual_error: float = float("inf")
    num_relative_primal_residual_errors: int = -1
    max_relative_primal_residual_error: float = float("inf")
    num_relative_dual_residual_errors: int = -1
    max_relative_dual_residual_error: float = float("inf")
    num_complementarity_violations: int = -1
    max_complementarity_violation: float = float("inf")
    primal_dual_objective_error: float = float("inf")
    primal_dual_integral: float = 0.0

    def invalidate(self):
        fresh = HighsInfo()
        for f in dataclasses.fields(fresh):
            setattr(self, f.name, getattr(fresh, f.name))

    def get(self, name: str):
        if not hasattr(self, name):
            raise KeyError(name)
        return getattr(self, name)
