"""Model building / modification mixin for the Highs facade.

Re-implements the model-mutation API surface of the reference
(highs/Highs.h add/delete/change/get families, implemented in
lp_data/HighsInterface.cpp): incremental column/row addition, bound and
cost changes, coefficient edits, deletions by set/range/mask, and
queries.  Mutations invalidate solver data (the reference additionally
repairs the basis; the TPU solvers re-warm from the previous solution
instead).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from .constants import (HighsStatus, HighsVarType, MatrixFormat, ObjSense,
                        kHighsInf)
from .models.lp import HighsLp, HighsSparseMatrix


class HighsModelApi:
    """Mixin providing the model build/modify/query API (self must have
    _model and _invalidate_solver_data)."""

    # ------------------------------------------------------------------
    # additions
    # ------------------------------------------------------------------
    def addCol(self, cost: float, lower: float, upper: float,
               num_new_nz: int = 0,
               indices: Optional[Sequence[int]] = None,
               values: Optional[Sequence[float]] = None) -> HighsStatus:
        return self.addCols(1, [cost], [lower], [upper], num_new_nz,
                            [0, num_new_nz] if num_new_nz else [0, 0],
                            indices if indices is not None else [],
                            values if values is not None else [])

    def addVar(self, lower: float = 0.0,
               upper: float = kHighsInf) -> HighsStatus:
        return self.addCol(0.0, lower, upper)

    def addVars(self, num_vars: int, lower, upper) -> HighsStatus:
        return self.addCols(num_vars, np.zeros(num_vars), lower, upper,
                            0, np.zeros(num_vars + 1, dtype=int), [], [])

    def addCols(self, num_new_col: int, costs, lower, upper,
                num_new_nz: int, starts, indices, values) -> HighsStatus:
        lp = self._model.lp
        costs = np.asarray(costs, dtype=np.float64).ravel()
        lower = np.asarray(lower, dtype=np.float64).ravel()
        upper = np.asarray(upper, dtype=np.float64).ravel()
        if (len(costs) != num_new_col or len(lower) != num_new_col or
                len(upper) != num_new_col):
            return HighsStatus.kError
        a_old = lp.a_matrix.to_scipy().tocsc() if lp.num_col else \
            sp.csc_matrix((lp.num_row, 0))
        if num_new_nz:
            starts = np.asarray(starts, dtype=np.int64).ravel()
            if len(starts) == num_new_col:
                starts = np.concatenate([starts, [num_new_nz]])
            indices = np.asarray(indices, dtype=np.int64).ravel()
            values = np.asarray(values, dtype=np.float64).ravel()
            if np.any(indices >= lp.num_row) or np.any(indices < 0):
                return HighsStatus.kError
            a_new = sp.csc_matrix(
                (values[:num_new_nz], indices[:num_new_nz],
                 starts[:num_new_col + 1]),
                shape=(lp.num_row, num_new_col))
        else:
            a_new = sp.csc_matrix((lp.num_row, num_new_col))
        a = sp.hstack([a_old, a_new], format="csc") if lp.num_col else a_new
        lp.col_cost = np.concatenate([lp.col_cost, costs])
        lp.col_lower = np.concatenate([lp.col_lower, lower])
        lp.col_upper = np.concatenate([lp.col_upper, upper])
        if len(lp.integrality):
            lp.integrality = np.concatenate(
                [lp.integrality,
                 np.zeros(num_new_col, dtype=np.uint8)])
        if lp.col_names:
            lp.col_names += [f"c{lp.num_col + k}"
                             for k in range(num_new_col)]
        lp.num_col += num_new_col
        lp.a_matrix = HighsSparseMatrix.from_scipy(a)
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def addRow(self, lower: float, upper: float, num_new_nz: int = 0,
               indices: Optional[Sequence[int]] = None,
               values: Optional[Sequence[float]] = None) -> HighsStatus:
        return self.addRows(1, [lower], [upper], num_new_nz,
                            [0, num_new_nz] if num_new_nz else [0, 0],
                            indices if indices is not None else [],
                            values if values is not None else [])

    def addRows(self, num_new_row: int, lower, upper, num_new_nz: int,
                starts, indices, values) -> HighsStatus:
        lp = self._model.lp
        lower = np.asarray(lower, dtype=np.float64).ravel()
        upper = np.asarray(upper, dtype=np.float64).ravel()
        if len(lower) != num_new_row or len(upper) != num_new_row:
            return HighsStatus.kError
        a_old = lp.a_matrix.to_scipy().tocsr() if lp.num_row else \
            sp.csr_matrix((0, lp.num_col))
        if num_new_nz:
            starts = np.asarray(starts, dtype=np.int64).ravel()
            if len(starts) == num_new_row:
                starts = np.concatenate([starts, [num_new_nz]])
            indices = np.asarray(indices, dtype=np.int64).ravel()
            values = np.asarray(values, dtype=np.float64).ravel()
            if np.any(indices >= lp.num_col) or np.any(indices < 0):
                return HighsStatus.kError
            a_new = sp.csr_matrix(
                (values[:num_new_nz], indices[:num_new_nz],
                 starts[:num_new_row + 1]),
                shape=(num_new_row, lp.num_col))
        else:
            a_new = sp.csr_matrix((num_new_row, lp.num_col))
        a = sp.vstack([a_old, a_new], format="csr") if lp.num_row else a_new
        lp.row_lower = np.concatenate([lp.row_lower, lower])
        lp.row_upper = np.concatenate([lp.row_upper, upper])
        if lp.row_names:
            lp.row_names += [f"r{lp.num_row + k}"
                             for k in range(num_new_row)]
        lp.num_row += num_new_row
        lp.a_matrix = HighsSparseMatrix.from_scipy(a.tocsc())
        self._invalidate_solver_data()
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # changes
    # ------------------------------------------------------------------
    def changeColCost(self, col: int, cost: float) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= col < lp.num_col):
            return HighsStatus.kError
        lp.col_cost[col] = cost
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColsCost(self, num: int, cols, costs) -> HighsStatus:
        lp = self._model.lp
        cols = np.asarray(cols, dtype=np.int64)[:num]
        costs = np.asarray(costs, dtype=np.float64)[:num]
        if np.any(cols < 0) or np.any(cols >= lp.num_col):
            return HighsStatus.kError
        lp.col_cost[cols] = costs
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColBounds(self, col: int, lower: float,
                        upper: float) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= col < lp.num_col):
            return HighsStatus.kError
        lp.col_lower[col] = lower
        lp.col_upper[col] = upper
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColsBounds(self, num: int, cols, lower,
                         upper) -> HighsStatus:
        lp = self._model.lp
        cols = np.asarray(cols, dtype=np.int64)[:num]
        if np.any(cols < 0) or np.any(cols >= lp.num_col):
            return HighsStatus.kError
        lp.col_lower[cols] = np.asarray(lower, dtype=np.float64)[:num]
        lp.col_upper[cols] = np.asarray(upper, dtype=np.float64)[:num]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeRowBounds(self, row: int, lower: float,
                        upper: float) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= row < lp.num_row):
            return HighsStatus.kError
        lp.row_lower[row] = lower
        lp.row_upper[row] = upper
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeRowsBounds(self, num: int, rows, lower,
                         upper) -> HighsStatus:
        lp = self._model.lp
        rows = np.asarray(rows, dtype=np.int64)[:num]
        if np.any(rows < 0) or np.any(rows >= lp.num_row):
            return HighsStatus.kError
        lp.row_lower[rows] = np.asarray(lower, dtype=np.float64)[:num]
        lp.row_upper[rows] = np.asarray(upper, dtype=np.float64)[:num]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeCoeff(self, row: int, col: int,
                    value: float) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= row < lp.num_row and 0 <= col < lp.num_col):
            return HighsStatus.kError
        a = lp.a_matrix.to_scipy().tolil()
        a[row, col] = value
        lp.a_matrix = HighsSparseMatrix.from_scipy(a.tocsc())
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColIntegrality(self, col: int,
                             integrality: HighsVarType) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= col < lp.num_col):
            return HighsStatus.kError
        if len(lp.integrality) != lp.num_col:
            lp.integrality = np.zeros(lp.num_col, dtype=np.uint8)
        lp.integrality[col] = int(integrality)
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColsIntegrality(self, num: int, cols,
                              integrality) -> HighsStatus:
        lp = self._model.lp
        cols = np.asarray(cols, dtype=np.int64)[:num]
        if np.any(cols < 0) or np.any(cols >= lp.num_col):
            return HighsStatus.kError
        if len(lp.integrality) != lp.num_col:
            lp.integrality = np.zeros(lp.num_col, dtype=np.uint8)
        vals = np.asarray([int(v) for v in integrality][:num],
                          dtype=np.uint8)
        lp.integrality[cols] = vals
        self._invalidate_solver_data()
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # deletions
    # ------------------------------------------------------------------
    def deleteCols(self, *args) -> HighsStatus:
        lp = self._model.lp
        keep = self._keep_mask(args, lp.num_col)
        if keep is None:
            return HighsStatus.kError
        a = lp.a_matrix.to_scipy().tocsc()[:, keep]
        lp.col_cost = lp.col_cost[keep]
        lp.col_lower = lp.col_lower[keep]
        lp.col_upper = lp.col_upper[keep]
        if len(lp.integrality):
            lp.integrality = lp.integrality[keep]
        if lp.col_names:
            lp.col_names = [n for n, k in zip(lp.col_names, keep) if k]
        lp.num_col = int(np.sum(keep))
        lp.a_matrix = HighsSparseMatrix.from_scipy(a)
        self._invalidate_solver_data()
        return HighsStatus.kOk

    deleteVars = deleteCols

    def deleteRows(self, *args) -> HighsStatus:
        lp = self._model.lp
        keep = self._keep_mask(args, lp.num_row)
        if keep is None:
            return HighsStatus.kError
        a = lp.a_matrix.to_scipy().tocsr()[keep, :]
        lp.row_lower = lp.row_lower[keep]
        lp.row_upper = lp.row_upper[keep]
        if lp.row_names:
            lp.row_names = [n for n, k in zip(lp.row_names, keep) if k]
        lp.num_row = int(np.sum(keep))
        lp.a_matrix = HighsSparseMatrix.from_scipy(a.tocsc())
        self._invalidate_solver_data()
        return HighsStatus.kOk

    @staticmethod
    def _keep_mask(args, size) -> Optional[np.ndarray]:
        """Interpret (from,to) range / (num,set) / (mask,) arguments."""
        if len(args) == 2 and np.isscalar(args[0]) and \
                np.isscalar(args[1]) and not hasattr(args[1], "__len__"):
            frm, to = int(args[0]), int(args[1])
            if frm < 0 or to >= size or frm > to:
                return None
            keep = np.ones(size, dtype=bool)
            keep[frm:to + 1] = False
            return keep
        if len(args) == 2:
            num, idx_set = int(args[0]), np.asarray(args[1],
                                                   dtype=np.int64)
            idx_set = idx_set[:num]
            if np.any(idx_set < 0) or np.any(idx_set >= size):
                return None
            keep = np.ones(size, dtype=bool)
            keep[idx_set] = False
            return keep
        if len(args) == 1:
            mask = np.asarray(args[0]).astype(bool)
            if len(mask) != size:
                return None
            return ~mask
        return None

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def getCol(self, col: int):
        lp = self._model.lp
        if not (0 <= col < lp.num_col):
            return HighsStatus.kError, None, None, None, None
        return (HighsStatus.kOk, lp.col_cost[col], lp.col_lower[col],
                lp.col_upper[col],
                int(np.diff(lp.a_matrix.to_scipy().tocsc().indptr)[col]))

    def getRow(self, row: int):
        lp = self._model.lp
        if not (0 <= row < lp.num_row):
            return HighsStatus.kError, None, None, None
        a = lp.a_matrix.to_scipy().tocsr()
        return (HighsStatus.kOk, lp.row_lower[row], lp.row_upper[row],
                int(a.indptr[row + 1] - a.indptr[row]))

    def getCoeff(self, row: int, col: int):
        lp = self._model.lp
        if not (0 <= row < lp.num_row and 0 <= col < lp.num_col):
            return HighsStatus.kError, 0.0
        return HighsStatus.kOk, float(lp.a_matrix.to_scipy()[row, col])

    def getColIntegrality(self, col: int):
        lp = self._model.lp
        if not (0 <= col < lp.num_col):
            return HighsStatus.kError, None
        if len(lp.integrality) != lp.num_col:
            return HighsStatus.kOk, HighsVarType.kContinuous
        return HighsStatus.kOk, HighsVarType(int(lp.integrality[col]))

    # ------------------------------------------------------------------
    # names
    # ------------------------------------------------------------------
    def passColName(self, col: int, name: str) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= col < lp.num_col):
            return HighsStatus.kError
        if len(lp.col_names) != lp.num_col:
            lp.col_names = [f"c{j}" for j in range(lp.num_col)]
        lp.col_names[col] = name
        return HighsStatus.kOk

    def passRowName(self, row: int, name: str) -> HighsStatus:
        lp = self._model.lp
        if not (0 <= row < lp.num_row):
            return HighsStatus.kError
        if len(lp.row_names) != lp.num_row:
            lp.row_names = [f"r{i}" for i in range(lp.num_row)]
        lp.row_names[row] = name
        return HighsStatus.kOk

    def getColName(self, col: int):
        lp = self._model.lp
        if not (0 <= col < lp.num_col) or len(lp.col_names) != lp.num_col:
            return HighsStatus.kError, ""
        return HighsStatus.kOk, lp.col_names[col]

    def getRowName(self, row: int):
        lp = self._model.lp
        if not (0 <= row < lp.num_row) or len(lp.row_names) != lp.num_row:
            return HighsStatus.kError, ""
        return HighsStatus.kOk, lp.row_names[row]

    def getColByName(self, name: str):
        lp = self._model.lp
        try:
            return HighsStatus.kOk, lp.col_names.index(name)
        except ValueError:
            return HighsStatus.kError, -1

    def getRowByName(self, name: str):
        lp = self._model.lp
        try:
            return HighsStatus.kOk, lp.row_names.index(name)
        except ValueError:
            return HighsStatus.kError, -1

    # ------------------------------------------------------------------
    # by-range / by-set / by-mask getters and changers
    # (reference Highs.h getCols/getRows/changeCols* variants; the C API
    # exposes each addressing mode as its own Highs_* function)
    # ------------------------------------------------------------------
    @staticmethod
    def _select_idx(args, size) -> Optional[np.ndarray]:
        """Interpret (from,to) / (num,set) / (mask,) as an index array."""
        keep = HighsModelApi._keep_mask(args, size)
        if keep is None:
            return None
        return np.nonzero(~keep)[0]

    def getColsByRange(self, from_col: int, to_col: int):
        return self._get_cols(self._select_idx((from_col, to_col),
                                               self._model.lp.num_col))

    def getColsBySet(self, num: int, idx_set):
        return self._get_cols(self._select_idx((num, idx_set),
                                               self._model.lp.num_col))

    def getColsByMask(self, mask):
        return self._get_cols(self._select_idx((mask,),
                                               self._model.lp.num_col))

    def _get_cols(self, idx):
        lp = self._model.lp
        if idx is None:
            return (HighsStatus.kError, 0, np.zeros(0), np.zeros(0),
                    np.zeros(0), 0, np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.int64), np.zeros(0))
        a = lp.a_matrix.to_scipy().tocsc()[:, idx].tocsc()
        return (HighsStatus.kOk, len(idx), lp.col_cost[idx],
                lp.col_lower[idx], lp.col_upper[idx], a.nnz,
                a.indptr[:-1].astype(np.int64),
                a.indices.astype(np.int64), a.data)

    def getRowsByRange(self, from_row: int, to_row: int):
        return self._get_rows(self._select_idx((from_row, to_row),
                                               self._model.lp.num_row))

    def getRowsBySet(self, num: int, idx_set):
        return self._get_rows(self._select_idx((num, idx_set),
                                               self._model.lp.num_row))

    def getRowsByMask(self, mask):
        return self._get_rows(self._select_idx((mask,),
                                               self._model.lp.num_row))

    def _get_rows(self, idx):
        lp = self._model.lp
        if idx is None:
            return (HighsStatus.kError, 0, np.zeros(0), np.zeros(0), 0,
                    np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.int64), np.zeros(0))
        a = lp.a_matrix.to_scipy().tocsr()[idx, :].tocsr()
        return (HighsStatus.kOk, len(idx), lp.row_lower[idx],
                lp.row_upper[idx], a.nnz,
                a.indptr[:-1].astype(np.int64),
                a.indices.astype(np.int64), a.data)

    def _change_cols_cost_idx(self, idx, costs):
        if idx is None:
            return HighsStatus.kError
        lp = self._model.lp
        lp.col_cost[idx] = np.asarray(costs, dtype=np.float64)[:len(idx)]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColsCostByRange(self, from_col, to_col, costs):
        return self._change_cols_cost_idx(
            self._select_idx((from_col, to_col), self._model.lp.num_col),
            costs)

    def changeColsCostByMask(self, mask, costs):
        idx = self._select_idx((mask,), self._model.lp.num_col)
        if idx is None:
            return HighsStatus.kError
        lp = self._model.lp
        costs = np.asarray(costs, dtype=np.float64)
        lp.col_cost[idx] = costs[idx]  # mask form: full-length arrays
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def _change_cols_bounds_idx(self, idx, lower, upper, masked=False):
        if idx is None:
            return HighsStatus.kError
        lp = self._model.lp
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        if masked:
            lp.col_lower[idx] = lower[idx]
            lp.col_upper[idx] = upper[idx]
        else:
            lp.col_lower[idx] = lower[:len(idx)]
            lp.col_upper[idx] = upper[:len(idx)]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColsBoundsByRange(self, from_col, to_col, lower, upper):
        return self._change_cols_bounds_idx(
            self._select_idx((from_col, to_col), self._model.lp.num_col),
            lower, upper)

    def changeColsBoundsByMask(self, mask, lower, upper):
        return self._change_cols_bounds_idx(
            self._select_idx((mask,), self._model.lp.num_col),
            lower, upper, masked=True)

    def _change_rows_bounds_idx(self, idx, lower, upper, masked=False):
        if idx is None:
            return HighsStatus.kError
        lp = self._model.lp
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        if masked:
            lp.row_lower[idx] = lower[idx]
            lp.row_upper[idx] = upper[idx]
        else:
            lp.row_lower[idx] = lower[:len(idx)]
            lp.row_upper[idx] = upper[:len(idx)]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeRowsBoundsByRange(self, from_row, to_row, lower, upper):
        return self._change_rows_bounds_idx(
            self._select_idx((from_row, to_row), self._model.lp.num_row),
            lower, upper)

    def changeRowsBoundsByMask(self, mask, lower, upper):
        return self._change_rows_bounds_idx(
            self._select_idx((mask,), self._model.lp.num_row),
            lower, upper, masked=True)

    def _ensure_integrality_array(self):
        lp = self._model.lp
        if len(lp.integrality) != lp.num_col:
            lp.integrality = np.zeros(lp.num_col, dtype=np.uint8)
        return lp

    def changeColsIntegralityByRange(self, from_col, to_col,
                                     integrality):
        idx = self._select_idx((from_col, to_col),
                               self._model.lp.num_col)
        if idx is None:
            return HighsStatus.kError
        lp = self._ensure_integrality_array()
        lp.integrality[idx] = np.asarray(integrality,
                                         dtype=np.uint8)[:len(idx)]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def changeColsIntegralityByMask(self, mask, integrality):
        idx = self._select_idx((mask,), self._model.lp.num_col)
        if idx is None:
            return HighsStatus.kError
        lp = self._ensure_integrality_array()
        integrality = np.asarray(integrality, dtype=np.uint8)
        lp.integrality[idx] = integrality[idx]
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def clearIntegrality(self) -> HighsStatus:
        """Drop all integrality (reference Highs_clearIntegrality)."""
        self._model.lp.integrality = np.zeros(0, dtype=np.uint8)
        self._invalidate_solver_data()
        return HighsStatus.kOk

    # ------------------------------------------------------------------
    # scaling / matrix orientation / model name
    # ------------------------------------------------------------------
    def scaleCol(self, col: int, scale: float) -> HighsStatus:
        """Scale column: x_j' = x_j / scale (reference Highs::scaleCol:
        matrix entries *= scale, cost *= scale, bounds /= scale; negative
        scale swaps the bounds)."""
        lp = self._model.lp
        if not (0 <= col < lp.num_col) or scale == 0.0:
            return HighsStatus.kError
        a = lp.a_matrix.to_scipy().tocsc()
        a.data[a.indptr[col]:a.indptr[col + 1]] *= scale
        from .models.lp import HighsSparseMatrix
        lp.a_matrix = HighsSparseMatrix.from_scipy(a)
        lp.col_cost[col] *= scale
        lo, up = lp.col_lower[col] / scale, lp.col_upper[col] / scale
        lp.col_lower[col], lp.col_upper[col] = \
            (up, lo) if scale < 0 else (lo, up)
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def scaleRow(self, row: int, scale: float) -> HighsStatus:
        """Scale row: matrix row *= scale, bounds *= scale (swapped when
        negative)."""
        lp = self._model.lp
        if not (0 <= row < lp.num_row) or scale == 0.0:
            return HighsStatus.kError
        a = lp.a_matrix.to_scipy().tocsr()
        a.data[a.indptr[row]:a.indptr[row + 1]] *= scale
        from .models.lp import HighsSparseMatrix
        lp.a_matrix = HighsSparseMatrix.from_scipy(a.tocsc())
        lo, up = lp.row_lower[row] * scale, lp.row_upper[row] * scale
        lp.row_lower[row], lp.row_upper[row] = \
            (up, lo) if scale < 0 else (lo, up)
        self._invalidate_solver_data()
        return HighsStatus.kOk

    def ensureColwise(self) -> HighsStatus:
        from .constants import MatrixFormat
        self._model.lp.a_matrix.format = MatrixFormat.kColwise
        return HighsStatus.kOk

    def ensureRowwise(self) -> HighsStatus:
        from .constants import MatrixFormat
        self._model.lp.a_matrix.format = MatrixFormat.kRowwise
        return HighsStatus.kOk

    def passModelName(self, name: str) -> HighsStatus:
        self._model.lp.model_name = str(name)
        return HighsStatus.kOk

    def getObjectiveOffset(self):
        return HighsStatus.kOk, float(self._model.lp.offset)
