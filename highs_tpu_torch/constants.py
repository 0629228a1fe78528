"""Status/enum vocabulary for highs_tpu_torch.

Mirrors the public enum vocabulary of the reference HiGHS solver so that
users of the reference find the same names and integer values here
(reference: highs/lp_data/HConst.h, highs/lp_data/HighsStatus.h:15).
The implementation is brand new; only the *vocabulary*
(names, integer codes) is kept for API parity.
"""
from __future__ import annotations

import enum

kHighsInf = float("inf")
kHighsIInf = 2**31 - 1
kHighsTiny = 1e-14
kHighsZero = 1e-50
kHighsMacheps = 2.0**-52

kHighsOffString = "off"
kHighsChooseString = "choose"
kHighsOnString = "on"


class HighsStatus(enum.IntEnum):
    """Return status of API calls (HighsStatus.h:15)."""

    kError = -1
    kOk = 0
    kWarning = 1


class HighsModelStatus(enum.IntEnum):
    """Model status after a solve (HConst.h:201-230)."""

    kNotset = 0
    kLoadError = 1
    kModelError = 2
    kPresolveError = 3
    kSolveError = 4
    kPostsolveError = 5
    kModelEmpty = 6
    kOptimal = 7
    kInfeasible = 8
    kUnboundedOrInfeasible = 9
    kUnbounded = 10
    kObjectiveBound = 11
    kObjectiveTarget = 12
    kTimeLimit = 13
    kIterationLimit = 14
    kUnknown = 15
    kSolutionLimit = 16
    kInterrupt = 17
    kMemoryLimit = 18
    kHighsInterrupt = 19


_MODEL_STATUS_STRINGS = {
    HighsModelStatus.kNotset: "Not Set",
    HighsModelStatus.kLoadError: "Load error",
    HighsModelStatus.kModelError: "Model error",
    HighsModelStatus.kPresolveError: "Presolve error",
    HighsModelStatus.kSolveError: "Solve error",
    HighsModelStatus.kPostsolveError: "Postsolve error",
    HighsModelStatus.kModelEmpty: "Empty",
    HighsModelStatus.kOptimal: "Optimal",
    HighsModelStatus.kInfeasible: "Infeasible",
    HighsModelStatus.kUnboundedOrInfeasible: "Primal infeasible or unbounded",
    HighsModelStatus.kUnbounded: "Unbounded",
    HighsModelStatus.kObjectiveBound: "Bound on objective reached",
    HighsModelStatus.kObjectiveTarget: "Target for objective reached",
    HighsModelStatus.kTimeLimit: "Time limit reached",
    HighsModelStatus.kIterationLimit: "Iteration limit reached",
    HighsModelStatus.kUnknown: "Unknown",
    HighsModelStatus.kSolutionLimit: "Solution limit reached",
    HighsModelStatus.kInterrupt: "Interrupted by user",
    HighsModelStatus.kMemoryLimit: "Memory limit reached",
    HighsModelStatus.kHighsInterrupt: "Interrupted by HiGHS",
}


def model_status_to_string(status: HighsModelStatus) -> str:
    return _MODEL_STATUS_STRINGS.get(HighsModelStatus(status), "Unknown")


class ObjSense(enum.IntEnum):
    kMinimize = 1
    kMaximize = -1


class MatrixFormat(enum.IntEnum):
    kColwise = 1
    kRowwise = 2
    kRowwisePartitioned = 3


class HessianFormat(enum.IntEnum):
    kTriangular = 1
    kSquare = 2


class HighsVarType(enum.IntEnum):
    kContinuous = 0
    kInteger = 1
    kSemiContinuous = 2
    kSemiInteger = 3
    kImplicitInteger = 4


class SolutionStatus(enum.IntEnum):
    kSolutionStatusNone = 0
    kSolutionStatusInfeasible = 1
    kSolutionStatusFeasible = 2


class BasisValidity(enum.IntEnum):
    kBasisValidityInvalid = 0
    kBasisValidityValid = 1


class HighsBasisStatus(enum.IntEnum):
    """Basis status for columns and rows (HConst.h:249-259)."""

    kLower = 0
    kBasic = 1
    kUpper = 2
    kZero = 3
    kNonbasic = 4


class SolutionStyle(enum.IntEnum):
    kSolutionStyleOldRaw = -1
    kSolutionStyleRaw = 0
    kSolutionStylePretty = 1
    kSolutionStyleGlpsolRaw = 2
    kSolutionStyleGlpsolPretty = 3
    kSolutionStyleSparse = 4


class HighsPresolveStatus(enum.IntEnum):
    kNotPresolved = -1
    kNotReduced = 0
    kInfeasible = 1
    kUnboundedOrInfeasible = 2
    kReduced = 3
    kReducedToEmpty = 4
    kTimeout = 5
    kNullError = 6
    kOptionsError = 7
    kNotSet = 8
    kOutOfMemory = 9


class HighsCallbackType(enum.IntEnum):
    """Callback identifiers (HConst.h:233-245)."""

    kCallbackLogging = 0
    kCallbackSimplexInterrupt = 1
    kCallbackIpmInterrupt = 2
    kCallbackMipSolution = 3
    kCallbackMipImprovingSolution = 4
    kCallbackMipLogging = 5
    kCallbackMipInterrupt = 6
    kCallbackMipGetCutPool = 7
    kCallbackMipDefineLazyConstraints = 8
    kCallbackMipUserSolution = 9


class HighsLogType(enum.IntEnum):
    kInfo = 1
    kDetailed = 2
    kVerbose = 3
    kWarning = 4
    kError = 5


class PresolveRuleType(enum.IntEnum):
    """LP presolve rule identifiers (HConst.h:262-287)."""

    kEmptyRow = 0
    kSingletonRow = 1
    kRedundantRow = 2
    kEmptyCol = 3
    kFixedCol = 4
    kDominatedCol = 5
    kForcingRow = 6
    kForcingCol = 7
    kFreeColSubstitution = 8
    kDoubletonEquation = 9
    kDependentEquations = 10
    kDependentFreeCols = 11
    kAggregator = 12
    kParallelRowsAndCols = 13
    kSparsify = 14
    kProbing = 15
    kEnumeration = 16
    kDualFixing = 17
    kColStuffing = 18
    kInitialSweep = 19


kPresolveRuleFirstAllowOff = PresolveRuleType.kForcingRow


class IisStrategy(enum.IntEnum):
    kIisStrategyLight = 0
    kIisStrategyFromRay = 1
    kIisStrategyFromLp = 2
    kIisStrategyIrreducible = 4
    kIisStrategyColPriority = 8
    kIisStrategyRelaxation = 16


class IisBoundStatus(enum.IntEnum):
    kIisBoundStatusDropped = -1
    kIisBoundStatusNull = 0
    kIisBoundStatusFree = 1
    kIisBoundStatusLower = 2
    kIisBoundStatusUpper = 3
    kIisBoundStatusBoxed = 4


class HighsDebugLevel(enum.IntEnum):
    kNone = 0
    kCheap = 1
    kCostly = 2
    kExpensive = 3
