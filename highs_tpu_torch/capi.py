"""Flat C-style API.

Re-implements the reference C API surface (highs/interfaces/
highs_c_api.h: 174 flat `Highs_*` functions over an opaque handle) as
module-level functions over a Highs instance, so code written against
the reference's C/ctypes conventions ports mechanically:

    h = Highs_create()
    Highs_passLp(h, ...);  Highs_run(h)
    status, obj = Highs_getObjectiveValue(h), ...
    Highs_destroy(h)

Return conventions follow the reference: functions return a HighsInt
status (0 ok, -1 error, 1 warning); outputs are returned as values
(Python has no out-params).

The port's copy: `Highs_create(device=None)` and the one-shot
`Highs_lpCall`, `Highs_mipCall` and `Highs_qpCall` solve on CUDA unless
the caller names the CPU; the version functions build no facade.  A
malformed input gives kError; an error of the device is raised.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import __version__
from .constants import (HighsModelStatus, HighsStatus, HighsVarType,
                        MatrixFormat, ObjSense, kHighsInf)
from .highs import githash
from .modeling import Highs
from .models.lp import HighsHessian, HighsLp, HighsModel, \
    HighsSparseMatrix

kHighsStatusError = -1
kHighsStatusOk = 0
kHighsStatusWarning = 1

kHighsMatrixFormatColwise = 1
kHighsMatrixFormatRowwise = 2

kHighsObjSenseMinimize = 1
kHighsObjSenseMaximize = -1

kHighsVarTypeContinuous = 0
kHighsVarTypeInteger = 1
kHighsVarTypeSemiContinuous = 2
kHighsVarTypeSemiInteger = 3

kHighsInfinity = kHighsInf


def Highs_create(device=None) -> Highs:
    return Highs(device=device)


def Highs_destroy(h: Highs) -> None:
    h.clear()


def Highs_version() -> str:
    return __version__


def Highs_readModel(h: Highs, filename: str) -> int:
    return int(h.readModel(filename))


def Highs_writeModel(h: Highs, filename: str) -> int:
    return int(h.writeModel(filename))


def Highs_run(h: Highs) -> int:
    return int(h.run())


def Highs_clear(h: Highs) -> int:
    return int(h.clear())


def Highs_clearModel(h: Highs) -> int:
    return int(h.clearModel())


def Highs_clearSolver(h: Highs) -> int:
    return int(h.clearSolver())


def Highs_passLp(h: Highs, num_col: int, num_row: int, num_nz: int,
                 a_format: int, sense: int, offset: float,
                 col_cost, col_lower, col_upper, row_lower, row_upper,
                 a_start, a_index, a_value) -> int:
    import scipy.sparse as sp
    try:
        if a_format == kHighsMatrixFormatColwise:
            a = sp.csc_matrix(
                (np.asarray(a_value[:num_nz], dtype=np.float64),
                 np.asarray(a_index[:num_nz], dtype=np.int64),
                 np.asarray(list(a_start[:num_col]) + [num_nz],
                            dtype=np.int64)),
                shape=(num_row, num_col))
        else:
            a = sp.csr_matrix(
                (np.asarray(a_value[:num_nz], dtype=np.float64),
                 np.asarray(a_index[:num_nz], dtype=np.int64),
                 np.asarray(list(a_start[:num_row]) + [num_nz],
                            dtype=np.int64)),
                shape=(num_row, num_col)).tocsc()
        lp = HighsLp(
            num_col=num_col, num_row=num_row,
            col_cost=np.asarray(col_cost, dtype=np.float64),
            col_lower=np.asarray(col_lower, dtype=np.float64),
            col_upper=np.asarray(col_upper, dtype=np.float64),
            row_lower=np.asarray(row_lower, dtype=np.float64),
            row_upper=np.asarray(row_upper, dtype=np.float64),
            a_matrix=HighsSparseMatrix.from_scipy(a),
            sense=ObjSense(sense), offset=offset)
        return int(h.passModel(lp))
    except (ValueError, TypeError, IndexError):  # malformed input
        return kHighsStatusError


def Highs_passMip(h: Highs, num_col, num_row, num_nz, a_format, sense,
                  offset, col_cost, col_lower, col_upper, row_lower,
                  row_upper, a_start, a_index, a_value,
                  integrality) -> int:
    status = Highs_passLp(h, num_col, num_row, num_nz, a_format, sense,
                          offset, col_cost, col_lower, col_upper,
                          row_lower, row_upper, a_start, a_index,
                          a_value)
    if status != kHighsStatusOk:
        return status
    h.getLp().integrality = np.asarray(integrality, dtype=np.uint8)
    return kHighsStatusOk


def Highs_passHessian(h: Highs, dim: int, num_nz: int, q_format: int,
                      q_start, q_index, q_value) -> int:
    hessian = HighsHessian(
        dim=dim,
        start=np.asarray(list(q_start[:dim]) + [num_nz], dtype=np.int64),
        index=np.asarray(q_index[:num_nz], dtype=np.int64),
        value=np.asarray(q_value[:num_nz], dtype=np.float64))
    return int(h.passHessian(hessian))


# ---- solve results ---------------------------------------------------------

def Highs_getModelStatus(h: Highs) -> int:
    return int(h.getModelStatus())


def Highs_getObjectiveValue(h: Highs) -> float:
    return h.getObjectiveValue()


def Highs_getSolution(h: Highs):
    """Returns (status, col_value, col_dual, row_value, row_dual)."""
    sol = h.getSolution()
    return (kHighsStatusOk, np.asarray(sol.col_value),
            np.asarray(sol.col_dual), np.asarray(sol.row_value),
            np.asarray(sol.row_dual))


def Highs_getBasis(h: Highs):
    """Returns (status, col_status, row_status)."""
    basis = h.getBasis()
    if not basis.valid:
        return kHighsStatusError, None, None
    return (kHighsStatusOk,
            np.asarray([int(s) for s in basis.col_status]),
            np.asarray([int(s) for s in basis.row_status]))


def Highs_getNumCol(h: Highs) -> int:
    return h.getNumCol()


def Highs_getNumRow(h: Highs) -> int:
    return h.getNumRow()


def Highs_getNumNz(h: Highs) -> int:
    return h.getNumNz()


def Highs_getRunTime(h: Highs) -> float:
    return h.getRunTime()


# ---- options / info ---------------------------------------------------------

def Highs_setBoolOptionValue(h, name, value) -> int:
    return int(h.setOptionValue(name, bool(value)))


def Highs_setIntOptionValue(h, name, value) -> int:
    return int(h.setOptionValue(name, int(value)))


def Highs_setDoubleOptionValue(h, name, value) -> int:
    return int(h.setOptionValue(name, float(value)))


def Highs_setStringOptionValue(h, name, value) -> int:
    return int(h.setOptionValue(name, str(value)))


def _get_option(h, name):
    value = h.getOptionValue(name)
    return (kHighsStatusOk, value) if value is not None else \
        (kHighsStatusError, None)


Highs_getBoolOptionValue = _get_option
Highs_getIntOptionValue = _get_option
Highs_getDoubleOptionValue = _get_option
Highs_getStringOptionValue = _get_option


def Highs_resetOptions(h) -> int:
    return int(h.resetOptions())


def Highs_readOptions(h, filename) -> int:
    return int(h.readOptions(filename))


def Highs_writeOptions(h, filename) -> int:
    return int(h.writeOptions(filename))


def Highs_getIntInfoValue(h, name):
    try:
        return kHighsStatusOk, int(h.getInfoValue(name))
    except (KeyError, TypeError, ValueError):
        return kHighsStatusError, None


def Highs_getDoubleInfoValue(h, name):
    try:
        return kHighsStatusOk, float(h.getInfoValue(name))
    except (KeyError, TypeError, ValueError):
        return kHighsStatusError, None


def Highs_getInt64InfoValue(h, name):
    return Highs_getIntInfoValue(h, name)


# ---- model modification ------------------------------------------------------

def Highs_addCol(h, cost, lower, upper, num_new_nz, index, value) -> int:
    return int(h.addCol(cost, lower, upper, num_new_nz, index, value))


def Highs_addCols(h, num_new_col, costs, lower, upper, num_new_nz,
                  starts, index, value) -> int:
    return int(h.addCols(num_new_col, costs, lower, upper, num_new_nz,
                         starts, index, value))


def Highs_addRow(h, lower, upper, num_new_nz, index, value) -> int:
    return int(h.addRow(lower, upper, num_new_nz, index, value))


def Highs_addRows(h, num_new_row, lower, upper, num_new_nz, starts,
                  index, value) -> int:
    return int(h.addRows(num_new_row, lower, upper, num_new_nz, starts,
                         index, value))


def Highs_addVar(h, lower, upper) -> int:
    return int(h.addVar(lower, upper))


def Highs_changeColCost(h, col, cost) -> int:
    return int(h.changeColCost(col, cost))


def Highs_changeColBounds(h, col, lower, upper) -> int:
    return int(h.changeColBounds(col, lower, upper))


def Highs_changeRowBounds(h, row, lower, upper) -> int:
    return int(h.changeRowBounds(row, lower, upper))


def Highs_changeCoeff(h, row, col, value) -> int:
    return int(h.changeCoeff(row, col, value))


def Highs_changeColIntegrality(h, col, integrality) -> int:
    return int(h.changeColIntegrality(col, HighsVarType(integrality)))


def Highs_changeObjectiveSense(h, sense) -> int:
    return int(h.changeObjectiveSense(ObjSense(sense)))


def Highs_changeObjectiveOffset(h, offset) -> int:
    return int(h.changeObjectiveOffset(offset))


def Highs_deleteColsByRange(h, from_col, to_col) -> int:
    return int(h.deleteCols(from_col, to_col))


def Highs_deleteRowsByRange(h, from_row, to_row) -> int:
    return int(h.deleteRows(from_row, to_row))


def Highs_deleteColsBySet(h, num, idx_set) -> int:
    return int(h.deleteCols(num, idx_set))


def Highs_deleteRowsBySet(h, num, idx_set) -> int:
    return int(h.deleteRows(num, idx_set))


def Highs_passColName(h, col, name) -> int:
    return int(h.passColName(col, name))


def Highs_passRowName(h, row, name) -> int:
    return int(h.passRowName(row, name))


# ---- solution IO / extras ----------------------------------------------------

def Highs_writeSolution(h, filename) -> int:
    return int(h.writeSolution(filename, 0))


def Highs_writeSolutionPretty(h, filename) -> int:
    return int(h.writeSolution(filename, 1))


def Highs_crossover(h, num_col, num_row, col_value, col_dual,
                    row_dual) -> int:
    from .models.solution import HighsSolution
    sol = HighsSolution(
        value_valid=True, dual_valid=col_dual is not None,
        col_value=np.asarray(col_value, dtype=np.float64),
        col_dual=(np.asarray(col_dual, dtype=np.float64)
                  if col_dual is not None else np.zeros(num_col)),
        row_value=np.zeros(num_row),
        row_dual=(np.asarray(row_dual, dtype=np.float64)
                  if row_dual is not None else np.zeros(num_row)))
    return int(h.crossover(sol))


def Highs_getDualRay(h):
    has_ray, ray = h.getDualRay()
    return (kHighsStatusOk if has_ray else kHighsStatusError), ray


def Highs_getPrimalRay(h):
    has_ray, ray = h.getPrimalRay()
    return (kHighsStatusOk if has_ray else kHighsStatusError), ray


def Highs_setCallback(h, callback, user_data) -> int:
    return int(h.setCallback(callback, user_data))


def Highs_startCallback(h, callback_type) -> int:
    return int(h.startCallback(callback_type))


def Highs_stopCallback(h, callback_type) -> int:
    return int(h.stopCallback(callback_type))


# ---------------------------------------------------------------------------
# one-shot convenience solvers (reference Highs_lpCall/mipCall/qpCall)
# ---------------------------------------------------------------------------
def Highs_lpCall(num_col, num_row, num_nz, a_format, sense, offset,
                 col_cost, col_lower, col_upper, row_lower, row_upper,
                 a_start, a_index, a_value, device=None):
    """Solve an LP in one call; returns (status, col_value, col_dual,
    row_value, row_dual, model_status)."""
    h = Highs_create(device)
    st = Highs_passLp(h, num_col, num_row, num_nz, a_format, sense,
                      offset, col_cost, col_lower, col_upper, row_lower,
                      row_upper, a_start, a_index, a_value)
    if st != kHighsStatusOk:
        return st, None, None, None, None, 0
    h.setOptionValue("output_flag", False)
    st = Highs_run(h)
    sol = h.getSolution()
    return (st, sol.col_value, sol.col_dual, sol.row_value,
            sol.row_dual, int(h.getModelStatus()))


def Highs_mipCall(num_col, num_row, num_nz, a_format, sense, offset,
                  col_cost, col_lower, col_upper, row_lower, row_upper,
                  a_start, a_index, a_value, integrality, device=None):
    h = Highs_create(device)
    st = Highs_passMip(h, num_col, num_row, num_nz, a_format, sense,
                       offset, col_cost, col_lower, col_upper, row_lower,
                       row_upper, a_start, a_index, a_value, integrality)
    if st != kHighsStatusOk:
        return st, None, None, 0
    h.setOptionValue("output_flag", False)
    st = Highs_run(h)
    sol = h.getSolution()
    return st, sol.col_value, sol.row_value, int(h.getModelStatus())


def Highs_qpCall(num_col, num_row, num_nz, q_num_nz, a_format, q_format,
                 sense, offset, col_cost, col_lower, col_upper,
                 row_lower, row_upper, a_start, a_index, a_value,
                 q_start, q_index, q_value, device=None):
    h = Highs_create(device)
    st = Highs_passLp(h, num_col, num_row, num_nz, a_format, sense,
                      offset, col_cost, col_lower, col_upper, row_lower,
                      row_upper, a_start, a_index, a_value)
    if st != kHighsStatusOk:
        return st, None, None, None, None, 0
    st = Highs_passHessian(h, num_col, q_num_nz, q_format, q_start,
                           q_index, q_value)
    if st != kHighsStatusOk:
        return st, None, None, None, None, 0
    h.setOptionValue("output_flag", False)
    st = Highs_run(h)
    sol = h.getSolution()
    return (st, sol.col_value, sol.col_dual, sol.row_value,
            sol.row_dual, int(h.getModelStatus()))


# deprecated alias kept for ABI parity (reference Highs_call)
Highs_call = Highs_lpCall


def Highs_passModel(h, num_col, num_row, num_nz, q_num_nz, a_format,
                    q_format, sense, offset, col_cost, col_lower,
                    col_upper, row_lower, row_upper, a_start, a_index,
                    a_value, q_start, q_index, q_value,
                    integrality=None):
    st = Highs_passLp(h, num_col, num_row, num_nz, a_format, sense,
                      offset, col_cost, col_lower, col_upper, row_lower,
                      row_upper, a_start, a_index, a_value)
    if st != kHighsStatusOk:
        return st
    if integrality is not None and len(integrality):
        st = min(st, Highs_changeColsIntegralityByRange(
            h, 0, num_col - 1, integrality))
    if q_num_nz:
        st = min(st, Highs_passHessian(h, num_col, q_num_nz, q_format,
                                       q_start, q_index, q_value))
    return st


def Highs_passModelName(h, name) -> int:
    return int(h.passModelName(name))


# ---------------------------------------------------------------------------
# model mutation variants (by range / set / mask)
# ---------------------------------------------------------------------------
def Highs_addVars(h, num_new_var, lower, upper) -> int:
    return int(h.addVars(num_new_var, lower, upper))


def Highs_changeColsCostByRange(h, from_col, to_col, cost) -> int:
    return int(h.changeColsCostByRange(from_col, to_col, cost))


def Highs_changeColsCostBySet(h, num_set_entries, idx_set, cost) -> int:
    return int(h.changeColsCost(num_set_entries, idx_set, cost))


def Highs_changeColsCostByMask(h, mask, cost) -> int:
    return int(h.changeColsCostByMask(mask, cost))


def Highs_changeColsBoundsByRange(h, from_col, to_col, lower,
                                  upper) -> int:
    return int(h.changeColsBoundsByRange(from_col, to_col, lower, upper))


def Highs_changeColsBoundsBySet(h, num_set_entries, idx_set, lower,
                                upper) -> int:
    return int(h.changeColsBounds(num_set_entries, idx_set, lower,
                                  upper))


def Highs_changeColsBoundsByMask(h, mask, lower, upper) -> int:
    return int(h.changeColsBoundsByMask(mask, lower, upper))


def Highs_changeRowsBoundsByRange(h, from_row, to_row, lower,
                                  upper) -> int:
    return int(h.changeRowsBoundsByRange(from_row, to_row, lower, upper))


def Highs_changeRowsBoundsBySet(h, num_set_entries, idx_set, lower,
                                upper) -> int:
    return int(h.changeRowsBounds(num_set_entries, idx_set, lower,
                                  upper))


def Highs_changeRowsBoundsByMask(h, mask, lower, upper) -> int:
    return int(h.changeRowsBoundsByMask(mask, lower, upper))


def Highs_changeColsIntegralityByRange(h, from_col, to_col,
                                       integrality) -> int:
    return int(h.changeColsIntegralityByRange(from_col, to_col,
                                              integrality))


def Highs_changeColsIntegralityBySet(h, num_set_entries, idx_set,
                                     integrality) -> int:
    return int(h.changeColsIntegrality(num_set_entries, idx_set,
                                       integrality))


def Highs_changeColsIntegralityByMask(h, mask, integrality) -> int:
    return int(h.changeColsIntegralityByMask(mask, integrality))


def Highs_clearIntegrality(h) -> int:
    return int(h.clearIntegrality())


def Highs_deleteColsByMask(h, mask) -> int:
    return int(h.deleteCols(mask))


def Highs_deleteRowsByMask(h, mask) -> int:
    return int(h.deleteRows(mask))


def Highs_getColsByRange(h, from_col, to_col):
    return h.getColsByRange(from_col, to_col)


def Highs_getColsBySet(h, num_set_entries, idx_set):
    return h.getColsBySet(num_set_entries, idx_set)


def Highs_getColsByMask(h, mask):
    return h.getColsByMask(mask)


def Highs_getRowsByRange(h, from_row, to_row):
    return h.getRowsByRange(from_row, to_row)


def Highs_getRowsBySet(h, num_set_entries, idx_set):
    return h.getRowsBySet(num_set_entries, idx_set)


def Highs_getRowsByMask(h, mask):
    return h.getRowsByMask(mask)


def Highs_getColName(h, col):
    st, name = h.getColName(col)
    return int(st), name


def Highs_getRowName(h, row):
    st, name = h.getRowName(row)
    return int(st), name


def Highs_getColByName(h, name):
    st, col = h.getColByName(name)
    return int(st), col


def Highs_getRowByName(h, name):
    st, row = h.getRowByName(name)
    return int(st), row


def Highs_getColIntegrality(h, col):
    st, integ = h.getColIntegrality(col)
    return int(st), (int(integ) if integ is not None else -1)


def Highs_scaleCol(h, col, scale) -> int:
    return int(h.scaleCol(col, scale))


def Highs_scaleRow(h, row, scale) -> int:
    return int(h.scaleRow(row, scale))


def Highs_ensureColwise(h) -> int:
    return int(h.ensureColwise())


def Highs_ensureRowwise(h) -> int:
    return int(h.ensureRowwise())


# ---------------------------------------------------------------------------
# getters: model, objective, counts
# ---------------------------------------------------------------------------
def Highs_getNumCols(h) -> int:  # deprecated alias of getNumCol
    return h.getNumCol()


def Highs_getNumRows(h) -> int:
    return h.getNumRow()


def Highs_getObjectiveOffset(h):
    st, off = h.getObjectiveOffset()
    return int(st), off


def Highs_getObjectiveSense(h):
    return kHighsStatusOk, int(h.getObjectiveSense())


def Highs_getHessianNumNz(h) -> int:
    return h.getHessianNumNz()


def Highs_getLp(h):
    """Returns the incumbent LP data in flat arrays: (status, num_col,
    num_row, num_nz, sense, offset, col_cost, col_lower, col_upper,
    row_lower, row_upper, a_start, a_index, a_value, integrality)."""
    lp = h.getLp()
    a = lp.a_matrix.to_scipy().tocsc()
    return (kHighsStatusOk, lp.num_col, lp.num_row, a.nnz,
            int(lp.sense), lp.offset, lp.col_cost, lp.col_lower,
            lp.col_upper, lp.row_lower, lp.row_upper,
            a.indptr[:-1].astype(np.int64), a.indices.astype(np.int64),
            a.data, np.asarray(lp.integrality))


Highs_getModel = Highs_getLp


def Highs_getIterationCount(h) -> int:
    info = h.getInfo()
    return max(info.simplex_iteration_count, info.ipm_iteration_count,
               info.pdlp_iteration_count, 0)


def Highs_getSimplexIterationCount(h) -> int:
    return h.getInfo().simplex_iteration_count


def Highs_getScaledModelStatus(h) -> int:
    return int(h.getScaledModelStatus())


def Highs_getInfinity() -> float:
    return kHighsInfinity


def Highs_getSizeofHighsInt() -> int:
    return 8  # np.int64 indices


def Highs_getRunTime(h) -> float:
    return h.getRunTime()


# ---------------------------------------------------------------------------
# typed option / info access (reference get*OptionValue families)
# ---------------------------------------------------------------------------
def Highs_getBoolOptionValue(h, name):
    v = h.getOptionValue(name)
    if not isinstance(v, bool):
        return kHighsStatusError, False
    return kHighsStatusOk, v


def Highs_getIntOptionValue(h, name):
    v = h.getOptionValue(name)
    if not isinstance(v, int) or isinstance(v, bool):
        return kHighsStatusError, 0
    return kHighsStatusOk, v


def Highs_getDoubleOptionValue(h, name):
    v = h.getOptionValue(name)
    if not isinstance(v, float):
        return kHighsStatusError, 0.0
    return kHighsStatusOk, v


def Highs_getStringOptionValue(h, name):
    v = h.getOptionValue(name)
    if not isinstance(v, str):
        return kHighsStatusError, ""
    return kHighsStatusOk, v


def Highs_getBoolOptionValues(h, name):
    from .options import HighsOptions
    rec = HighsOptions.record(name)
    if rec is None or rec.type is not bool:
        return kHighsStatusError, False, False
    return kHighsStatusOk, h.getOptionValue(name), rec.default


def Highs_getIntOptionValues(h, name):
    from .options import HighsOptions
    rec = HighsOptions.record(name)
    if rec is None or rec.type is not int:
        return kHighsStatusError, 0, 0, 0, 0
    return (kHighsStatusOk, h.getOptionValue(name), rec.minimum,
            rec.maximum, rec.default)


def Highs_getDoubleOptionValues(h, name):
    from .options import HighsOptions
    rec = HighsOptions.record(name)
    if rec is None or rec.type is not float:
        return kHighsStatusError, 0.0, 0.0, 0.0, 0.0
    return (kHighsStatusOk, h.getOptionValue(name), rec.minimum,
            rec.maximum, rec.default)


def Highs_getStringOptionValues(h, name):
    from .options import HighsOptions
    rec = HighsOptions.record(name)
    if rec is None or rec.type is not str:
        return kHighsStatusError, "", ""
    return kHighsStatusOk, h.getOptionValue(name), rec.default


def Highs_getNumOptions(h) -> int:
    from .options import HighsOptions
    return len(HighsOptions.records())


def Highs_getOptionName(h, index):
    from .options import HighsOptions
    recs = HighsOptions.records()
    if not (0 <= index < len(recs)):
        return kHighsStatusError, ""
    return kHighsStatusOk, recs[index].name


def Highs_getOptionType(h, name):
    from .options import HighsOptions
    rec = HighsOptions.record(name)
    if rec is None:
        return kHighsStatusError, -1
    kind = {bool: 0, int: 1, float: 2, str: 3}[rec.type]
    return kHighsStatusOk, kind


def Highs_getInfoType(h, name):
    info = h.getInfo()
    try:
        v = info.get(name)
    except KeyError:
        return kHighsStatusError, -1
    if isinstance(v, int):
        return kHighsStatusOk, 1
    if isinstance(v, float):
        return kHighsStatusOk, 2
    return kHighsStatusError, -1


def Highs_resetHighsOptions(h) -> int:  # deprecated alias
    return int(h.resetOptions())


# legacy Highs_getHighs*/setHighs* aliases (deprecated in the reference,
# kept for ABI parity)
def Highs_setHighsOptionValue(h, name, value) -> int:
    return Highs_setOptionValue(h, name, value)


def Highs_setHighsBoolOptionValue(h, name, value) -> int:
    return Highs_setOptionValue(h, name, bool(value))


def Highs_setHighsIntOptionValue(h, name, value) -> int:
    return Highs_setOptionValue(h, name, int(value))


def Highs_setHighsDoubleOptionValue(h, name, value) -> int:
    return Highs_setOptionValue(h, name, float(value))


def Highs_setHighsStringOptionValue(h, name, value) -> int:
    return Highs_setOptionValue(h, name, str(value))


def Highs_getHighsBoolOptionValue(h, name):
    return Highs_getBoolOptionValue(h, name)


def Highs_getHighsIntOptionValue(h, name):
    return Highs_getIntOptionValue(h, name)


def Highs_getHighsDoubleOptionValue(h, name):
    return Highs_getDoubleOptionValue(h, name)


def Highs_getHighsStringOptionValue(h, name):
    return Highs_getStringOptionValue(h, name)


def Highs_getHighsOptionType(h, name):
    return Highs_getOptionType(h, name)


def Highs_getHighsIntInfoValue(h, name):
    return Highs_getIntInfoValue(h, name)


def Highs_getHighsDoubleInfoValue(h, name):
    return Highs_getDoubleInfoValue(h, name)


def Highs_getHighsRunTime(h) -> float:
    return h.getRunTime()


def Highs_getHighsInfinity() -> float:
    return kHighsInfinity


def Highs_setHighsLogfile(h, logfile=None) -> int:
    return kHighsStatusOk  # deprecated no-op (reference returns warning)


def Highs_setHighsOutput(h, output=None) -> int:
    return kHighsStatusOk  # deprecated no-op


def Highs_runQuiet(h) -> int:  # deprecated
    h.setOptionValue("output_flag", False)
    return kHighsStatusOk


# ---------------------------------------------------------------------------
# basis solves / reductions (reference Highs_getBasicVariables etc.)
# ---------------------------------------------------------------------------
def Highs_getBasicVariables(h):
    st, basic = h.getBasicVariables()
    return int(st), basic


def Highs_getBasisInverseRow(h, row):
    st, v = h.getBasisInverseRow(row)
    return int(st), v


def Highs_getBasisInverseCol(h, col):
    st, v = h.getBasisInverseCol(col)
    return int(st), v


def Highs_getBasisSolve(h, rhs):
    st, v = h.getBasisSolve(rhs)
    return int(st), v


def Highs_getBasisTransposeSolve(h, rhs):
    st, v = h.getBasisTransposeSolve(rhs)
    return int(st), v


def Highs_getReducedRow(h, row):
    st, v = h.getReducedRow(row)
    return int(st), v


def Highs_getReducedColumn(h, col):
    st, v = h.getReducedColumn(col)
    return int(st), v


def Highs_setBasis(h, col_status, row_status) -> int:
    from .constants import HighsBasisStatus
    from .models.solution import HighsBasis
    b = HighsBasis(valid=True)
    b.col_status = [HighsBasisStatus(int(s)) for s in col_status]
    b.row_status = [HighsBasisStatus(int(s)) for s in row_status]
    return int(h.setBasis(b))


def Highs_setLogicalBasis(h) -> int:
    return int(h.setLogicalBasis())


def Highs_setSolution(h, col_value, row_value=None, col_dual=None,
                      row_dual=None) -> int:
    from .models.solution import HighsSolution
    sol = HighsSolution(
        value_valid=col_value is not None,
        dual_valid=col_dual is not None,
        col_value=np.asarray(col_value, dtype=np.float64)
        if col_value is not None else np.zeros(0),
        row_value=np.asarray(row_value, dtype=np.float64)
        if row_value is not None else np.zeros(0),
        col_dual=np.asarray(col_dual, dtype=np.float64)
        if col_dual is not None else np.zeros(0),
        row_dual=np.asarray(row_dual, dtype=np.float64)
        if row_dual is not None else np.zeros(0))
    return int(h.setSolution(sol))


def Highs_setSparseSolution(h, num_entries, index, value) -> int:
    x = np.zeros(h.getNumCol())
    idx = np.asarray(index, dtype=np.int64)[:num_entries]
    x[idx] = np.asarray(value, dtype=np.float64)[:num_entries]
    return Highs_setSolution(h, x)


# ---------------------------------------------------------------------------
# presolve / postsolve / ranging / IIS / relaxation
# ---------------------------------------------------------------------------
def Highs_presolve(h) -> int:
    return int(h.presolve())


def Highs_postsolve(h, col_value, col_dual, row_dual) -> int:
    from .models.solution import HighsSolution
    sol = HighsSolution(
        value_valid=col_value is not None,
        dual_valid=col_dual is not None,
        col_value=np.asarray(col_value, dtype=np.float64)
        if col_value is not None else np.zeros(0),
        col_dual=np.asarray(col_dual, dtype=np.float64)
        if col_dual is not None else np.zeros(0),
        row_dual=np.asarray(row_dual, dtype=np.float64)
        if row_dual is not None else np.zeros(0))
    return int(h.postsolve(sol))


def Highs_getPresolvedLp(h):
    lp = h.getPresolvedLp()
    if lp is None:
        return kHighsStatusError, None
    return kHighsStatusOk, lp


Highs_getPresolvedModel = Highs_getPresolvedLp


def Highs_getPresolvedNumCol(h) -> int:
    return h.getPresolvedNumCol()


def Highs_getPresolvedNumRow(h) -> int:
    return h.getPresolvedNumRow()


def Highs_getPresolvedNumNz(h) -> int:
    return h.getPresolvedNumNz()


def Highs_getPresolvedColName(h, col):
    lp = h.getPresolvedLp()
    if lp is None or not (0 <= col < lp.num_col) or \
            len(lp.col_names) != lp.num_col:
        return kHighsStatusError, ""
    return kHighsStatusOk, lp.col_names[col]


def Highs_getPresolvedRowName(h, row):
    lp = h.getPresolvedLp()
    if lp is None or not (0 <= row < lp.num_row) or \
            len(lp.row_names) != lp.num_row:
        return kHighsStatusError, ""
    return kHighsStatusOk, lp.row_names[row]


def Highs_getRanging(h):
    """Returns (status, ranging) with the cost/bound ranging record."""
    st, ranging = h.getRanging()
    return int(st), ranging


def Highs_getIis(h):
    iis = h.getIis()
    return (kHighsStatusOk if iis.valid else kHighsStatusError), iis


def Highs_getIisLp(h):
    """LP restricted to the IIS rows/cols (reference Highs_getIisLp)."""
    iis = h.getIis()
    if not iis.valid:
        return kHighsStatusError, None
    lp = h.getLp()
    a = lp.a_matrix.to_scipy().tocsr()
    rows = list(iis.row_index)
    cols = (list(iis.col_index) if iis.col_index
            else list(range(lp.num_col)))
    sub = a[rows, :][:, cols].tocsc()
    from .models.lp import HighsLp, HighsSparseMatrix
    out = HighsLp(
        num_col=len(cols), num_row=len(rows),
        col_cost=lp.col_cost[cols], col_lower=lp.col_lower[cols],
        col_upper=lp.col_upper[cols], row_lower=lp.row_lower[rows],
        row_upper=lp.row_upper[rows],
        a_matrix=HighsSparseMatrix.from_scipy(sub),
        sense=lp.sense, offset=lp.offset)
    return kHighsStatusOk, out


def Highs_feasibilityRelaxation(h, global_lower_penalty,
                                global_upper_penalty,
                                global_rhs_penalty,
                                local_lower_penalty=None,
                                local_upper_penalty=None,
                                local_rhs_penalty=None) -> int:
    return int(h.feasibilityRelaxation(
        global_lower_penalty, global_upper_penalty, global_rhs_penalty,
        local_lower_penalty, local_upper_penalty, local_rhs_penalty))


def Highs_getDualUnboundednessDirection(h):
    st, ray = h.getDualUnboundednessDirection()
    return int(st), ray


# ---------------------------------------------------------------------------
# multi-objective (reference Highs_addLinearObjective etc.)
# ---------------------------------------------------------------------------
def Highs_addLinearObjective(h, weight, offset, coefficients, abs_tol,
                             rel_tol, priority) -> int:
    from .models.solution import HighsLinearObjective
    obj = HighsLinearObjective(
        weight=weight, offset=offset,
        coefficients=np.asarray(coefficients, dtype=np.float64),
        abs_tolerance=abs_tol, rel_tolerance=rel_tol,
        priority=priority)
    return int(h.addLinearObjective(obj))


def Highs_clearLinearObjectives(h) -> int:
    return int(h.clearLinearObjectives())


def Highs_passLinearObjectives(h, num_linear_objective, weight, offset,
                               coefficients, abs_tol, rel_tol,
                               priority) -> int:
    from .models.solution import HighsLinearObjective
    objs = []
    n = h.getNumCol()
    for k in range(num_linear_objective):
        objs.append(HighsLinearObjective(
            weight=weight[k], offset=offset[k],
            coefficients=np.asarray(coefficients[k * n:(k + 1) * n],
                                    dtype=np.float64),
            abs_tolerance=abs_tol[k], rel_tolerance=rel_tol[k],
            priority=priority[k]))
    return int(h.passLinearObjectives(objs))


# ---------------------------------------------------------------------------
# callback data access / versioning / runtime
# ---------------------------------------------------------------------------
def Highs_getCallbackDataOutItem(data_out, item_name):
    if hasattr(data_out, item_name):
        return kHighsStatusOk, getattr(data_out, item_name)
    return kHighsStatusError, None


def Highs_setCallbackSolution(h, num_entries, value) -> int:
    """Provide a (partial) user solution from a MIP callback
    (reference Highs_setCallbackSolution)."""
    return Highs_setSolution(
        h, np.asarray(value, dtype=np.float64)[:num_entries])


def Highs_setCallbackSparseSolution(h, num_entries, index, value) -> int:
    return Highs_setSparseSolution(h, num_entries, index, value)


def Highs_repairCallbackSolution(h) -> int:
    # the MIP solver repairs user solutions via round-and-repair when
    # they are injected; nothing further to do here
    return kHighsStatusOk


def Highs_versionMajor() -> int:
    return int(__version__.split(".")[0])


def Highs_versionMinor() -> int:
    return int(__version__.split(".")[1])


def Highs_versionPatch() -> int:
    return int(__version__.split(".")[2])


def Highs_compilationDate() -> str:
    return "deprecated"


def Highs_githash() -> str:
    return githash()


def Highs_releaseMemory(h) -> int:
    return kHighsStatusOk  # GC-managed


def Highs_resetGlobalScheduler(blocking) -> None:
    return None  # no global scheduler state to reset


def Highs_getFixedLp(h):
    """LP with all integrality dropped (reference Highs_getFixedLp
    returns the relaxation-fixed model)."""
    lp = h.getLp().copy()
    lp.integrality = np.zeros(0, dtype=np.uint8)
    return kHighsStatusOk, lp


def Highs_writeOptionsDeviations(h, filename) -> int:
    return int(h.writeOptions(filename, report_only_deviations=True))


def Highs_writePresolvedModel(h, filename) -> int:
    lp = h.getPresolvedLp()
    if lp is None:
        return kHighsStatusError
    from .io.mps import write_mps
    from .models.lp import HighsModel
    return int(write_mps(HighsModel(lp=lp), filename))


def Highs_zeroAllClocks(h) -> int:
    h.getTimer().reset()
    return kHighsStatusOk


def Highs_setOptionValue(h, name, value) -> int:
    """Untyped option setter (reference Highs_setOptionValue: parses the
    string value per the option's type)."""
    return int(h.setOptionValue(name, value))
