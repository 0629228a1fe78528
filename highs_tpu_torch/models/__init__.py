from .lp import HighsLp, HighsModel, HighsHessian, HighsSparseMatrix
from .solution import (HighsSolution, HighsBasis, HighsObjectiveSolution,
                       HighsRay, HighsLinearObjective)

__all__ = [
    "HighsLp", "HighsModel", "HighsHessian", "HighsSparseMatrix",
    "HighsSolution", "HighsBasis", "HighsObjectiveSolution", "HighsRay",
    "HighsLinearObjective",
]
