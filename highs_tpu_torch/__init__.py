"""highs_tpu_torch — the PyTorch/CUDA port of highs_tpu.

Solves   min c'x  s.t.  L <= Ax <= U,  l <= x <= u   with the same public
surface as highs_tpu (the `Highs` facade, options under the same names,
statuses, info and solutions), on a torch device: CUDA by default, the
CPU when asked for by name.

This package imports torch, numpy and scipy, never jax or highs_tpu.
The LP path runs presolve, then the simplex, the interior-point solver
or the restarted PDHG, whose block-CSR and one-hot products run
hand-written CUDA kernels (csrc/); a convex QP (an LP with a Hessian)
runs the QP interior-point solver on the device.
"""

__version__ = "0.1.0"

from .constants import (HighsStatus, HighsModelStatus, ObjSense,
                        HighsVarType, HighsBasisStatus, MatrixFormat,
                        HessianFormat, SolutionStatus, BasisValidity,
                        SolutionStyle, HighsCallbackType, kHighsInf,
                        kHighsIInf)
from .options import HighsOptions
from .info import HighsInfo
from .models import (HighsLp, HighsModel, HighsHessian, HighsSparseMatrix,
                     HighsSolution, HighsBasis, HighsLinearObjective)
from .device import resolve_device
from .highs import Highs

__all__ = [
    "Highs", "HighsStatus", "HighsModelStatus", "ObjSense", "HighsVarType",
    "HighsBasisStatus", "MatrixFormat", "HessianFormat", "SolutionStatus",
    "BasisValidity", "SolutionStyle", "HighsCallbackType", "kHighsInf",
    "kHighsIInf", "HighsOptions", "HighsInfo", "HighsLp", "HighsModel",
    "HighsHessian", "HighsSparseMatrix", "HighsSolution", "HighsBasis",
    "HighsLinearObjective", "resolve_device",
]
