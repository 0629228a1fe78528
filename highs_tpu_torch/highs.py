"""The Highs orchestration class: the user-facing solver object.

Equivalent of the reference `class Highs` (highs/Highs.h:43,
lp_data/Highs.cpp): pass/read a model, set options, `run()`, query
solution / info / status.  `run()` solves an LP through presolve and the
LP dispatch, a convex QP through the QP solvers and a MIP through
presolve and branch-and-cut, on the torch device given to the
constructor (default CUDA); the simplex, crossover, the QP active set
and the MIP search run on the host.  The model-editing methods come
from `HighsModelApi` (model_api.py), ranging, IIS, basis solves and
multi-objective solves from `HighsAnalysisApi` (analysis_api.py).
"""
from __future__ import annotations

import copy
import math
import time
from typing import Any, Callable, Optional

import numpy as np

from .analysis_api import HighsAnalysisApi
from .callbacks import HighsCallback
from .constants import (BasisValidity, HighsModelStatus, HighsStatus,
                        HighsVarType, ObjSense, SolutionStatus,
                        model_status_to_string)
from .device import resolve_device
from .info import HighsInfo
from .io.logging import HighsLogger, HighsLogType
from .io.lp_format import read_lp, write_lp
from .io.mps import read_mps, write_mps
from .model_api import HighsModelApi
from .models.lp import HighsHessian, HighsLp, HighsModel
from .models.solution import HighsBasis, HighsSolution
from .options import HighsOptions
from .run_data import HighsRunData
from .utils.debug import debug_check_lp_solution
from .utils.kkt import compute_kkt, fill_info_from_kkt
from .utils.matrix_pic import write_matrix_pbm
from .utils.timer import HighsTimer, span


def githash() -> str:
    """The short hash of the checkout's HEAD, or "n/a"."""
    import os
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))).stdout.strip() or "n/a"
    except (OSError, subprocess.SubprocessError):
        return "n/a"


class Highs(HighsModelApi, HighsAnalysisApi):
    """User-facing solver object (API parity with the reference Highs)."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._model = HighsModel()
        self._options = HighsOptions()
        self._info = HighsInfo()
        self._run_data = HighsRunData()
        self._solution = HighsSolution()
        self._basis = HighsBasis()
        self._model_status = HighsModelStatus.kNotset
        self._log_callback: Optional[Callable[[int, str], None]] = None
        self._callbacks = HighsCallback()
        self._run_time = 0.0
        self._dual_ray: Optional[np.ndarray] = None
        self._primal_ray: Optional[np.ndarray] = None
        self._logger = HighsLogger(self._options)
        self._timer = HighsTimer()

    @property
    def device(self):
        return self._device

    # ------------------------------------------------------------------
    # Model loading
    # ------------------------------------------------------------------
    def readModel(self, filename: str) -> HighsStatus:
        try:
            if filename.endswith(".lp") or filename.endswith(".lp.gz"):
                self._model = read_lp(filename)
            else:
                self._model = read_mps(filename)
        except Exception as err:  # parse errors -> kError like the reference
            self._log(f"Error reading model file {filename}: {err}")
            return HighsStatus.kError
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def writeModel(self, filename: str) -> HighsStatus:
        if filename.endswith(".lp") or filename.endswith(".lp.gz"):
            return write_lp(self._model, filename)
        return write_mps(self._model, filename)

    def passModel(self, model) -> HighsStatus:
        # a span alone: run() resets the clocks
        with span(None, "pass_model"):
            if isinstance(model, HighsModel):
                self._model = model
            elif isinstance(model, HighsLp):
                self._model = HighsModel(lp=model)
            else:
                return HighsStatus.kError
            self._invalidate_solver_data()
        return HighsStatus.kOk

    def passHessian(self, hessian: HighsHessian) -> HighsStatus:
        if hessian.dim not in (0, self._model.lp.num_col):
            return HighsStatus.kError
        self._model.hessian = hessian
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def clearModel(self) -> HighsStatus:
        self._model = HighsModel()
        self._invalidate_solver_data()
        return HighsStatus.kOk

    clear = clearModel

    def clearSolver(self) -> HighsStatus:
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def _invalidate_solver_data(self):
        self._solution.clear()
        self._basis.clear()
        self._info.invalidate()
        self._model_status = HighsModelStatus.kNotset
        self._dual_ray = None
        self._primal_ray = None

    # ------------------------------------------------------------------
    # Options
    # ------------------------------------------------------------------
    def setOptionValue(self, name: str, value: Any) -> HighsStatus:
        status, _ = self._options.set(name, value)
        return status

    def getOptionValue(self, name: str):
        status, value = self._options.get(name)
        if status != HighsStatus.kOk:
            return None
        return value

    def resetOptions(self) -> HighsStatus:
        self._options.reset()
        return HighsStatus.kOk

    def readOptions(self, filename: str) -> HighsStatus:
        return self._options.read_options_file(filename)

    def writeOptions(self, filename: str,
                     report_only_deviations: bool = False) -> HighsStatus:
        self._options.write_options_file(filename, report_only_deviations)
        return HighsStatus.kOk

    @property
    def options(self) -> HighsOptions:
        return self._options

    # ------------------------------------------------------------------
    # Accessors
    # ------------------------------------------------------------------
    def getModel(self) -> HighsModel:
        return self._model

    def getLp(self) -> HighsLp:
        return self._model.lp

    def getNumCol(self) -> int:
        return self._model.lp.num_col

    def getNumRow(self) -> int:
        return self._model.lp.num_row

    def getNumNz(self) -> int:
        return self._model.lp.num_nz

    def getHessianNumNz(self) -> int:
        h = self._model.hessian
        return h.num_nz if h is not None else 0

    def getModelStatus(self) -> HighsModelStatus:
        return self._model_status

    def getScaledModelStatus(self) -> HighsModelStatus:
        # no separate scaled-model status (scaling is internal to each
        # solver): the model status
        return self._model_status

    def modelStatusToString(self, status) -> str:
        return model_status_to_string(status)

    def solutionStatusToString(self, status: int) -> str:
        return {0: "None", 1: "Infeasible", 2: "Feasible"}.get(
            int(status), "Unknown")

    def getSolution(self) -> HighsSolution:
        return self._solution

    def getBasis(self) -> HighsBasis:
        return self._basis

    def getInfo(self) -> HighsInfo:
        return self._info

    def getInfoValue(self, name: str):
        return self._info.get(name)

    def getObjectiveValue(self) -> float:
        return self._info.objective_function_value

    def getRunTime(self) -> float:
        return self._run_time

    def getObjectiveSense(self) -> ObjSense:
        return self._model.lp.sense

    def changeObjectiveSense(self, sense: ObjSense) -> HighsStatus:
        self._model.lp.sense = ObjSense(sense)
        return HighsStatus.kOk

    def changeObjectiveOffset(self, offset: float) -> HighsStatus:
        self._model.lp.offset = float(offset)
        return HighsStatus.kOk

    def version(self) -> str:
        from . import __version__
        return __version__

    def versionMajor(self) -> int:
        return int(self.version().split(".")[0])

    def versionMinor(self) -> int:
        return int(self.version().split(".")[1])

    def versionPatch(self) -> int:
        return int(self.version().split(".")[2])

    def compilationDate(self) -> str:
        return "deprecated"

    def githash(self) -> str:
        return githash()

    def getRunData(self) -> HighsRunData:
        """The post-run metric registry (reference Highs::getRunData)."""
        return self._run_data

    def getRunDataValue(self, name: str):
        """Value of one run-data record by name (reference
        Highs::getRunDataValue, Highs.h:421-429)."""
        return self._run_data.get(name)

    def getRunDataType(self, name: str):
        """Type of one run-data record (reference getRunDataType)."""
        return HighsRunData.type_of(name)

    def getTimer(self) -> HighsTimer:
        """The named-clock timer registry of the last run (reference
        HighsTimer)."""
        return self._timer

    def setLogCallback(self, callback) -> HighsStatus:
        self._log_callback = callback
        return HighsStatus.kOk

    def setCallback(self, callback, user_data=None) -> HighsStatus:
        """Register the user callback (reference Highs::setCallback)."""
        self._callbacks.user_callback = callback
        self._callbacks.user_callback_data = user_data
        return HighsStatus.kOk

    def startCallback(self, callback_type) -> HighsStatus:
        if self._callbacks.user_callback is None:
            return HighsStatus.kError
        self._callbacks.active[int(callback_type)] = True
        return HighsStatus.kOk

    def stopCallback(self, callback_type) -> HighsStatus:
        self._callbacks.active[int(callback_type)] = False
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # Warm start
    # ------------------------------------------------------------------
    def setSolution(self, solution: HighsSolution) -> HighsStatus:
        self._solution = solution
        return HighsStatus.kOk

    def setBasis(self, basis: Optional[HighsBasis] = None) -> HighsStatus:
        if basis is None:
            self._basis = HighsBasis()
        else:
            self._basis = basis
        return HighsStatus.kOk

    def setLogicalBasis(self) -> HighsStatus:
        """All-slack (logical) basis."""
        from .constants import HighsBasisStatus
        lp = self._model.lp
        b = HighsBasis(valid=True)
        b.col_status = [HighsBasisStatus.kLower] * lp.num_col
        b.row_status = [HighsBasisStatus.kBasic] * lp.num_row
        self._basis = b
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # Basis freeze/unfreeze (reference Highs::freezeBasis /
    # unfreezeBasis / frozenBasisAllDataClear, Highs.h:1574-1596): a
    # frozen id snapshots the basis, unfreeze restores it.
    # ------------------------------------------------------------------
    def freezeBasis(self):
        """Snapshot the current basis; returns (status, id)."""
        if not self._basis.valid:
            return HighsStatus.kError, -1
        store = getattr(self, "_frozen_bases", None)
        if store is None:
            store = {}
            self._frozen_bases = store
            self._frozen_next_id = 0
        fid = self._frozen_next_id
        self._frozen_next_id += 1
        store[fid] = copy.deepcopy(self._basis)
        return HighsStatus.kOk, fid

    def unfreezeBasis(self, frozen_basis_id: int) -> HighsStatus:
        """Restore (and release) a frozen basis by id."""
        store = getattr(self, "_frozen_bases", None)
        if not store or frozen_basis_id not in store:
            return HighsStatus.kError
        basis = store.pop(frozen_basis_id)
        lp = self._model.lp
        if len(basis.col_status) != lp.num_col or \
                len(basis.row_status) != lp.num_row:
            return HighsStatus.kError  # model changed shape since
        self._basis = basis
        return HighsStatus.kOk

    def frozenBasisAllDataClear(self) -> HighsStatus:
        """kOk when no frozen basis data remains (reference
        frozenBasisAllDataClear semantics)."""
        store = getattr(self, "_frozen_bases", None)
        return HighsStatus.kOk if not store else HighsStatus.kError

    def _log(self, msg: str, log_type=None):
        from .constants import HighsCallbackType as CbType
        if self._callbacks.callback_active(CbType.kCallbackLogging):
            self._callbacks.call(CbType.kCallbackLogging, msg + "\n")
        if not self._options.output_flag:
            return
        if self._log_callback is not None:
            self._logger.set_callback(self._log_callback)
            # callback replaces console output (reference user_callback
            # semantics in HighsIO.cpp)
            self._log_callback(int(log_type or HighsLogType.kInfo), msg)
            fh = self._logger._ensure_file()
            if fh is not None:
                fh.write(msg + "\n")
                fh.flush()
            return
        self._logger.log(log_type or HighsLogType.kInfo, msg)

    # ------------------------------------------------------------------
    # run()
    # ------------------------------------------------------------------
    def run(self) -> HighsStatus:
        # debug images (reference HighsMatrixPic, options
        # write_matrix_image / write_hessian_image)
        name = self._model.lp.model_name or "model"
        if self._options.write_matrix_image and self._model.lp.num_nz:
            write_matrix_pbm(self._model.lp.a_matrix.to_scipy(),
                             f"{name}_matrix.pbm")
        if self._options.write_hessian_image and \
                self._model.hessian is not None and \
                self._model.hessian.dim:
            write_matrix_pbm(self._model.hessian.to_scipy_full(),
                             f"{name}_hessian.pbm")
        t0 = time.perf_counter()
        # the run-data times cover this run only
        self._timer.reset()
        self._options._timer = self._timer
        self._options._callbacks = self._callbacks
        with self._timer.scope("run"):
            status = self._optimize_model()
        self._run_time = time.perf_counter() - t0
        self._fill_run_data()
        return status

    def _fill_run_data(self):
        """Populate the post-run metric registry (reference
        HighsRunData.h:29-47) from this run's phase clocks and the
        dispatch's presolved-model dimensions."""
        rd = self._run_data
        rd.invalidate()
        rd.valid = True
        rd.presolve_time = self._timer.read("presolve")
        rd.solve_time = self._timer.read("solve")
        rd.postsolve_time = self._timer.read("postsolve")
        lp = self._model.lp
        rd.presolved_model_num_col = int(getattr(
            self._info, "presolved_num_col", lp.num_col))
        rd.presolved_model_num_row = int(getattr(
            self._info, "presolved_num_row", lp.num_row))
        rd.presolved_model_num_nz = int(getattr(
            self._info, "presolved_num_nz", lp.a_matrix.num_nz))

    def _optimize_model(self) -> HighsStatus:
        lp = self._model.lp
        if lp.is_empty():
            self._model_status = HighsModelStatus.kModelEmpty
            self._solution = HighsSolution(
                value_valid=True, dual_valid=True)
            self._info.valid = True
            self._info.objective_function_value = lp.offset
            return HighsStatus.kOk

        if np.any(lp.col_lower > lp.col_upper) or (
                lp.num_row and np.any(lp.row_lower > lp.row_upper)):
            self._model_status = HighsModelStatus.kInfeasible
            self._info.valid = True
            return HighsStatus.kOk

        # NaN objective coefficients (reference behavior on nan0.mps:
        # the model solves and reports a NaN objective)
        if np.isnan(lp.col_cost).any():
            saved_cost = lp.col_cost
            lp.col_cost = np.where(np.isnan(saved_cost), 0.0, saved_cost)
            try:
                status = self._optimize_model()
            finally:
                lp.col_cost = saved_cost
            self._info.objective_function_value = math.nan
            return status

        if self._model.is_qp() and self._model.is_mip():
            self._log("MIQP is not supported")
            self._model_status = HighsModelStatus.kNotset
            return HighsStatus.kError

        if self._has_multi_objectives():
            return self._multiobjective_solve()

        if self._model.is_mip() and not self._options.solve_relaxation:
            return self._call_solve_mip()
        if self._model.is_qp():
            return self._call_solve_qp()
        return self._call_solve_lp()

    def _call_solve_lp(self) -> HighsStatus:
        lp = self._model.lp
        if self._model.is_mip():  # solve_relaxation
            lp = lp.copy()
            lp.integrality = np.zeros(0, dtype=np.uint8)

        from .solvers.dispatch import solve_lp
        status, solution, lp_info = solve_lp(
            lp, self._options, log=self._log,
            presolve=self._options.presolve != "off",
            basis=self._basis if self._basis.valid else None,
            warm_solution=(self._solution
                           if self._solution.value_valid else None),
            device=self._device)

        self._model_status = status
        self._solution = solution
        if lp_info.basis is not None:
            self._basis = lp_info.basis
        self._fill_info_lp(lp, lp_info)
        for name in ("presolved_num_col", "presolved_num_row",
                     "presolved_num_nz"):
            if hasattr(lp_info, name):  # set once the LP reached a solver
                setattr(self._info, name, getattr(lp_info, name))
        if self._options.highs_debug_level > 0:
            # the reference's HighsDebug layer: post-solve consistency
            # checks on the host, free when the level is 0
            debug_check_lp_solution(
                lp, self._solution,
                self._basis if self._basis.valid else None,
                self._options, status, log=self._log)
        return HighsStatus.kOk

    def _call_solve_qp(self) -> HighsStatus:
        from .solvers.qp.wrapper import solve_qp
        with self._timer.scope("solve"):
            status, solution, qp_info = solve_qp(
                self._model, self._options, log=self._log,
                device=self._device)
        self._model_status = status
        self._solution = solution
        self._fill_info_lp(self._model.lp, qp_info,
                           hessian=self._model.hessian)
        self._info.qp_iteration_count = qp_info.iterations
        return HighsStatus.kOk

    def _call_solve_mip(self) -> HighsStatus:
        from .presolve.presolve import (log_rule_use, postsolve_lp,
                                        presolve_lp)
        from .solvers.mip.solver import solve_mip
        lp_orig = self._model.lp
        lp = lp_orig
        # bounded semi variables reformulate to binary + variable-bound
        # rows (reference HPresolve; see presolve/semi.py) so the
        # standard MIP machinery applies
        semi_expand = None
        if lp.has_semi_variables():
            from .presolve.semi import reformulate_semi_variables
            semi_expand = reformulate_semi_variables(lp)
            if semi_expand is not None:
                lp = semi_expand.lp
        presolve_result = None
        # presolve has no SOS awareness: reductions could silently drop
        # or remap set members, so SOS models solve un-presolved
        if self._options.presolve != "off" and not getattr(lp, "sos",
                                                           None):
            presolve_result = presolve_lp(lp, self._options,
                                          self._device)
            log_rule_use(self._options, self._log)
            if presolve_result.status in (
                    HighsModelStatus.kInfeasible,
                    HighsModelStatus.kUnbounded,
                    HighsModelStatus.kUnboundedOrInfeasible):
                self._model_status = presolve_result.status
                self._info.valid = True
                return HighsStatus.kOk
            mip_lp = presolve_result.reduced_lp
        else:
            mip_lp = lp
        # the debug solution file lives in the ORIGINAL column space:
        # project it through presolve for the reduced-space tracer
        # (reference: HighsDebugSol is registered before presolve and
        # mapped through each reduction)
        self._options._mip_debug_x = None
        if self._options.mip_debug_solution_file and \
                presolve_result is not None and presolve_result.reduced:
            from .solvers.mip.debug_sol import DebugSolution
            dbg = DebugSolution.load(
                self._options.mip_debug_solution_file, lp, log=self._log)
            if dbg is not None:
                self._options._mip_debug_x = \
                    dbg.x[presolve_result.keep_cols]
        status, solution, mip_info = solve_mip(
            mip_lp, self._options, log=self._log,
            callbacks=self._callbacks, device=self._device)
        self._info.presolved_num_col = mip_lp.num_col
        self._info.presolved_num_row = mip_lp.num_row
        self._info.presolved_num_nz = mip_lp.a_matrix.num_nz
        if presolve_result is not None and presolve_result.reduced and \
                solution.value_valid:
            solution, _ = postsolve_lp(lp, presolve_result, solution)
        if semi_expand is not None and solution.value_valid:
            # strip the auxiliary binaries / variable-bound rows
            solution.col_value = solution.col_value[
                :semi_expand.n_orig_col]
            if len(solution.row_value):
                solution.row_value = solution.row_value[
                    :semi_expand.n_orig_row]
        self._model_status = status
        self._solution = solution
        self._fill_info_lp(lp_orig, mip_info)
        return HighsStatus.kOk

    def _fill_info_lp(self, lp: HighsLp, lp_info, hessian=None):
        self._info.invalidate()
        self._info.valid = True
        for attr in ("simplex_iteration_count", "ipm_iteration_count",
                     "crossover_iteration_count", "pdlp_iteration_count",
                     "qp_iteration_count", "mip_node_count",
                     "mip_dual_bound", "mip_gap"):
            if hasattr(lp_info, attr):
                setattr(self._info, attr, getattr(lp_info, attr))
        if self._solution.value_valid:
            rep = compute_kkt(
                lp, self._solution,
                self._options.primal_feasibility_tolerance,
                self._options.dual_feasibility_tolerance,
                self._options.primal_residual_tolerance,
                self._options.dual_residual_tolerance,
                hessian=hessian)
            fill_info_from_kkt(self._info, rep)
            self._info.objective_function_value = \
                rep.objective_function_value
            self._info.primal_solution_status = int(
                SolutionStatus.kSolutionStatusFeasible if rep.primal_feasible
                else SolutionStatus.kSolutionStatusInfeasible)
            if self._solution.dual_valid:
                self._info.dual_solution_status = int(
                    SolutionStatus.kSolutionStatusFeasible
                    if rep.dual_feasible
                    else SolutionStatus.kSolutionStatusInfeasible)
            if len(lp.integrality):
                integ = np.asarray(lp.integrality)
                is_int = (integ == int(HighsVarType.kInteger)) | (
                    integ == int(HighsVarType.kSemiInteger))
                if np.any(is_int):
                    frac = np.abs(self._solution.col_value[is_int] -
                                  np.round(self._solution.col_value[is_int]))
                    self._info.max_integrality_violation = float(
                        np.max(frac, initial=0.0))
        self._info.basis_validity = int(
            BasisValidity.kBasisValidityValid if self._basis.valid
            else BasisValidity.kBasisValidityInvalid)

    # ------------------------------------------------------------------
    # Crossover
    # ------------------------------------------------------------------
    def crossover(self, user_solution: HighsSolution) -> HighsStatus:
        """Convert a (near-optimal) solution into a vertex basis via the
        simplex cleanup on the host (reference Highs::crossover)."""
        from .solvers.simplex.crossover import crossover_from_solution
        status, solution, info = crossover_from_solution(
            self._model.lp, self._options, user_solution)
        if status != HighsModelStatus.kOptimal:
            return HighsStatus.kError
        self._model_status = status
        self._solution = solution
        if info.basis is not None:
            self._basis = info.basis
        self._fill_info_lp(self._model.lp, info)
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # Rays
    # ------------------------------------------------------------------
    def getDualRay(self):
        """Return (has_ray, ray): a Farkas certificate of primal
        infeasibility (reference Highs::getDualRay), from the elastic
        feasibility LP's optimal row duals (the IPM on the facade's
        device)."""
        if self._model_status != HighsModelStatus.kInfeasible:
            return False, None
        if self._dual_ray is not None:
            return True, self._dual_ray
        from .solvers.classify import build_primal_feasibility_lp
        from .solvers.ipm.wrapper import solve_lp_ipm
        feas_lp = build_primal_feasibility_lp(self._model.lp)
        st, sol, info = solve_lp_ipm(feas_lp, self._options,
                                     device=self._device)
        if st != HighsModelStatus.kOptimal or not sol.dual_valid:
            return False, None
        self._dual_ray = np.asarray(sol.row_dual, dtype=np.float64)
        return True, self._dual_ray

    def getPrimalRay(self):
        """Return (has_ray, ray): an unbounded primal direction
        (reference Highs::getPrimalRay), from the recession-cone LP."""
        if self._model_status != HighsModelStatus.kUnbounded:
            return False, None
        if self._primal_ray is not None:
            return True, self._primal_ray
        from .solvers.classify import build_qp_ray_lp
        from .solvers.ipm.wrapper import solve_lp_ipm
        ray_lp = build_qp_ray_lp(self._model)
        st, sol, info = solve_lp_ipm(ray_lp, self._options,
                                     device=self._device)
        if st != HighsModelStatus.kOptimal or not sol.value_valid or \
                info.primal_obj >= -1e-9:
            return False, None
        self._primal_ray = np.asarray(sol.col_value, dtype=np.float64)
        return True, self._primal_ray

    def getDualUnboundednessDirection(self):
        """The reference's name for the primal ray."""
        return self.getPrimalRay()

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------
    def reportSolvedStats(self):
        """Report solve statistics in the reference's format
        (Highs.cpp:5020-5061 reportSolvedLpQpStats)."""
        if not self._options.output_flag:
            return
        lp = self._model.lp
        if lp.model_name:
            self._log(f"Model name          : {lp.model_name}")
        self._log("Model status        : "
                  f"{model_status_to_string(self._model_status)}")
        info = self._info
        if info.valid:
            for label, count in (
                    ("Simplex   iterations", info.simplex_iteration_count),
                    ("IPM       iterations", info.ipm_iteration_count),
                    ("Crossover iterations", info.crossover_iteration_count),
                    ("PDLP      iterations", info.pdlp_iteration_count),
                    ("QP ASM    iterations", info.qp_iteration_count)):
                if count > 0:
                    self._log(f"{label}: {count}")
            if self._model.is_mip() and info.mip_node_count >= 0:
                self._log(f"MIP nodes           : {info.mip_node_count}")
                if math.isfinite(info.mip_gap):
                    self._log(f"MIP gap             : "
                              f"{100.0 * info.mip_gap:.4g}%")
            if self._solution.value_valid or \
                    self._model_status == HighsModelStatus.kModelEmpty:
                self._log("Objective value     : "
                          f"{info.objective_function_value:17.10e}")
        if self._solution.dual_valid and math.isfinite(
                info.primal_dual_objective_error):
            self._log("P-D objective error : "
                      f"{info.primal_dual_objective_error:17.10e}")
        if not self._options.timeless_log:
            self._log(f"HiGHS run time      : {self._run_time:13.2f}")

    def writeSolution(self, filename: str = "", style: int = 0
                      ) -> HighsStatus:
        from .io.solution_writer import write_solution
        return write_solution(self, filename, style)

    # ------------------------------------------------------------------
    # Standalone presolve / postsolve (reference Highs::presolve,
    # Highs::postsolve; C API Highs_presolve / Highs_getPresolvedLp)
    # ------------------------------------------------------------------
    def presolve(self) -> HighsStatus:
        """Run presolve only; the reduced model is available via
        getPresolvedLp()."""
        from .presolve.presolve import presolve_lp
        lp = self._model.lp
        if lp.is_empty():
            self._presolved_lp = lp.copy()
            self._presolve_stack = None
            self._model_status = HighsModelStatus.kModelEmpty
            return HighsStatus.kOk
        result = presolve_lp(lp, self._options, self._device)
        self._presolve_stack = result
        if result.status in (HighsModelStatus.kInfeasible,
                             HighsModelStatus.kUnbounded,
                             HighsModelStatus.kUnboundedOrInfeasible):
            self._model_status = result.status
            self._presolved_lp = None
            return HighsStatus.kOk
        self._presolved_lp = result.reduced_lp
        return HighsStatus.kOk

    def getPresolvedLp(self):
        return getattr(self, "_presolved_lp", None)

    def getPresolvedNumCol(self) -> int:
        lp = self.getPresolvedLp()
        return lp.num_col if lp is not None else -1

    def getPresolvedNumRow(self) -> int:
        lp = self.getPresolvedLp()
        return lp.num_row if lp is not None else -1

    def getPresolvedNumNz(self) -> int:
        lp = self.getPresolvedLp()
        return lp.num_nz if lp is not None else -1

    def postsolve(self, solution, basis=None) -> HighsStatus:
        """Map a solution of the presolved model back to the full model
        (reference Highs::postsolve)."""
        stack = getattr(self, "_presolve_stack", None)
        if stack is None:
            return HighsStatus.kError
        from .presolve.presolve import postsolve_lp
        full_solution, full_basis = postsolve_lp(
            self._model.lp, stack, solution, basis=basis)
        self._solution = full_solution
        if full_basis is not None:
            self._basis = full_basis
        self._fill_info_lp(self._model.lp, object())
        return HighsStatus.kOk
