"""The Highs orchestration class: the user-facing solver object.

Equivalent of the reference `class Highs` (highs/Highs.h:43,
lp_data/Highs.cpp): pass/read a model, set options, `run()`, query
solution / info / status.  `run()` solves an LP through presolve and the
LP dispatch on the torch device given to the constructor (default CUDA);
the simplex and crossover run on the host.  MIP and QP models, `.lp`
files and the model-editing and analysis methods of the JAX package's
facade are not ported yet.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Optional

import numpy as np

from .callbacks import HighsCallback
from .constants import (BasisValidity, HighsModelStatus, HighsStatus,
                        HighsVarType, SolutionStatus)
from .device import resolve_device
from .info import HighsInfo
from .io.logging import HighsLogger, HighsLogType
from .io.mps import read_mps, write_mps
from .models.lp import HighsLp, HighsModel
from .models.solution import HighsBasis, HighsSolution
from .options import HighsOptions
from .run_data import HighsRunData
from .utils.kkt import compute_kkt, fill_info_from_kkt
from .utils.timer import HighsTimer


class Highs:
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
        self._logger = HighsLogger(self._options)
        self._timer = HighsTimer()

    @property
    def device(self):
        return self._device

    # ------------------------------------------------------------------
    # Model loading
    # ------------------------------------------------------------------
    def readModel(self, filename: str) -> HighsStatus:
        if filename.endswith(".lp") or filename.endswith(".lp.gz"):
            raise NotImplementedError(
                "reading the .lp format is not yet ported "
                "(ROADMAP queue 1 item 8)")
        try:
            self._model = read_mps(filename)
        except Exception as err:  # parse errors -> kError like the reference
            self._log(f"Error reading model file {filename}: {err}")
            return HighsStatus.kError
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def writeModel(self, filename: str) -> HighsStatus:
        return write_mps(self._model, filename)

    def passModel(self, model) -> HighsStatus:
        if isinstance(model, HighsModel):
            self._model = model
        elif isinstance(model, HighsLp):
            self._model = HighsModel(lp=model)
        else:
            return HighsStatus.kError
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def _invalidate_solver_data(self):
        self._solution.clear()
        self._basis.clear()
        self._info.invalidate()
        self._model_status = HighsModelStatus.kNotset

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

    def getModelStatus(self) -> HighsModelStatus:
        return self._model_status

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

    def getRunData(self) -> HighsRunData:
        """The post-run metric registry (reference Highs::getRunData)."""
        return self._run_data

    def getTimer(self) -> HighsTimer:
        """The named-clock timer registry of the last run (reference
        HighsTimer)."""
        return self._timer

    def setLogCallback(self, callback) -> HighsStatus:
        self._log_callback = callback
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
        for name in ("write_matrix_image", "write_hessian_image"):
            if self._options.get(name)[1]:
                raise NotImplementedError(
                    f"option {name} is not yet ported "
                    "(ROADMAP queue 1 item 8)")
        t0 = time.perf_counter()
        # the run-data times cover this run only
        self._timer.reset()
        self._options._timer = self._timer
        self._options._callbacks = self._callbacks
        self._timer.start("run")
        try:
            status = self._optimize_model()
        finally:
            self._timer.stop("run")
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

        if self._model.is_mip() and not self._options.solve_relaxation:
            raise NotImplementedError(
                "MIP models are not yet ported (ROADMAP queue 1 item 7)")
        if self._model.is_qp():
            raise NotImplementedError(
                "QP models are not yet ported (ROADMAP queue 1 item 6)")
        return self._call_solve_lp()

    def _call_solve_lp(self) -> HighsStatus:
        lp = self._model.lp
        if self._model.is_mip():  # solve_relaxation
            lp = lp.copy()
            lp.integrality = np.zeros(0, dtype=np.uint8)
        if self._options.highs_debug_level > 0:
            raise NotImplementedError(
                "highs_debug_level > 0 is not yet ported "
                "(ROADMAP queue 1 item 8)")

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
        return HighsStatus.kOk

    def _fill_info_lp(self, lp: HighsLp, lp_info):
        self._info.invalidate()
        self._info.valid = True
        for attr in ("simplex_iteration_count", "ipm_iteration_count",
                     "crossover_iteration_count", "pdlp_iteration_count"):
            if hasattr(lp_info, attr):
                setattr(self._info, attr, getattr(lp_info, attr))
        if self._solution.value_valid:
            rep = compute_kkt(
                lp, self._solution,
                self._options.primal_feasibility_tolerance,
                self._options.dual_feasibility_tolerance,
                self._options.primal_residual_tolerance,
                self._options.dual_residual_tolerance)
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
