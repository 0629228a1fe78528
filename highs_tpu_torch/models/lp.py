"""Host-side model data layer.

Equivalent of the reference's lp_data/HighsLp.h, model/HighsModel.h and
util/HighsSparseMatrix (CSC/CSR constraint matrix): `HighsLp` holds the
incumbent model `min/max c'x + offset s.t. L <= Ax <= U, l <= x <= u`
with optional integrality, and `HighsModel` adds a positive semidefinite
Hessian for `+ 1/2 x'Qx`.

Host representation is numpy + scipy.sparse (the idiomatic Python
equivalent of the reference's hand-rolled CSC arrays); device
representations live in highs_tpu_torch.ops.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from ..constants import (HessianFormat, HighsVarType, MatrixFormat, ObjSense,
                         kHighsInf)


@dataclasses.dataclass
class HighsSparseMatrix:
    """CSC (kColwise) or CSR (kRowwise) sparse matrix of the constraints.

    Mirrors util/HighsSparseMatrix.h: start/index/value triplet arrays with
    explicit num_col/num_row, convertible between orientations.
    """

    format: MatrixFormat = MatrixFormat.kColwise
    num_col: int = 0
    num_row: int = 0
    start: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, dtype=np.int64))
    index: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    value: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.float64))

    @property
    def num_nz(self) -> int:
        return int(self.start[-1]) if len(self.start) else 0

    def is_colwise(self) -> bool:
        return self.format == MatrixFormat.kColwise

    def to_scipy(self) -> sp.spmatrix:
        if self.is_colwise():
            return sp.csc_matrix(
                (self.value, self.index, self.start),
                shape=(self.num_row, self.num_col))
        return sp.csr_matrix(
            (self.value, self.index, self.start),
            shape=(self.num_row, self.num_col))

    @staticmethod
    def from_scipy(mat: sp.spmatrix,
                   fmt: MatrixFormat = MatrixFormat.kColwise
                   ) -> "HighsSparseMatrix":
        m, n = mat.shape
        if fmt == MatrixFormat.kColwise:
            mat = sp.csc_matrix(mat)
        else:
            mat = sp.csr_matrix(mat)
        mat.sort_indices()
        return HighsSparseMatrix(
            format=fmt, num_col=n, num_row=m,
            start=mat.indptr.astype(np.int64),
            index=mat.indices.astype(np.int64),
            value=mat.data.astype(np.float64))

    def ensure_colwise(self):
        if not self.is_colwise():
            converted = HighsSparseMatrix.from_scipy(
                self.to_scipy(), MatrixFormat.kColwise)
            self.__dict__.update(converted.__dict__)

    def ensure_rowwise(self):
        if self.is_colwise():
            converted = HighsSparseMatrix.from_scipy(
                self.to_scipy(), MatrixFormat.kRowwise)
            self.__dict__.update(converted.__dict__)

    def product(self, x: np.ndarray) -> np.ndarray:
        """A @ x."""
        return self.to_scipy() @ x

    def product_transpose(self, y: np.ndarray) -> np.ndarray:
        """A' @ y."""
        return self.to_scipy().T @ y


@dataclasses.dataclass
class HighsLp:
    """The incumbent LP (lp_data/HighsLp.h behavior)."""

    num_col: int = 0
    num_row: int = 0
    col_cost: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    col_lower: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    col_upper: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    row_lower: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    row_upper: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    a_matrix: HighsSparseMatrix = dataclasses.field(
        default_factory=HighsSparseMatrix)
    sense: ObjSense = ObjSense.kMinimize
    offset: float = 0.0
    model_name: str = ""
    objective_name: str = ""
    col_names: List[str] = dataclasses.field(default_factory=list)
    row_names: List[str] = dataclasses.field(default_factory=list)
    integrality: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8))
    # SOS sets: (type "S1"/"S2", priority, member cols, weights)
    # (reference: SOS read by HMpsFF, branched on by the MIP solver)
    sos: List[tuple] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.col_cost = np.asarray(self.col_cost, dtype=np.float64)
        self.col_lower = np.asarray(self.col_lower, dtype=np.float64)
        self.col_upper = np.asarray(self.col_upper, dtype=np.float64)
        self.row_lower = np.asarray(self.row_lower, dtype=np.float64)
        self.row_upper = np.asarray(self.row_upper, dtype=np.float64)

    @property
    def num_nz(self) -> int:
        return self.a_matrix.num_nz

    def is_mip(self) -> bool:
        if len(self.sos) > 0:
            return True
        return (len(self.integrality) > 0 and
                bool(np.any(np.asarray(self.integrality) !=
                            int(HighsVarType.kContinuous))))

    def has_semi_variables(self) -> bool:
        if len(self.integrality) == 0:
            return False
        integ = np.asarray(self.integrality)
        return bool(np.any(
            (integ == int(HighsVarType.kSemiContinuous)) |
            (integ == int(HighsVarType.kSemiInteger))))

    def is_empty(self) -> bool:
        return self.num_col == 0 and self.num_row == 0

    def objective_value(self, x: np.ndarray) -> float:
        return float(self.sense) * 0 + float(
            np.dot(self.col_cost, x)) + self.offset

    def copy(self) -> "HighsLp":
        return HighsLp(
            num_col=self.num_col, num_row=self.num_row,
            col_cost=self.col_cost.copy(), col_lower=self.col_lower.copy(),
            col_upper=self.col_upper.copy(), row_lower=self.row_lower.copy(),
            row_upper=self.row_upper.copy(),
            a_matrix=HighsSparseMatrix(
                format=self.a_matrix.format,
                num_col=self.a_matrix.num_col,
                num_row=self.a_matrix.num_row,
                start=self.a_matrix.start.copy(),
                index=self.a_matrix.index.copy(),
                value=self.a_matrix.value.copy()),
            sense=self.sense, offset=self.offset,
            model_name=self.model_name, objective_name=self.objective_name,
            col_names=list(self.col_names), row_names=list(self.row_names),
            integrality=np.array(self.integrality, copy=True),
            sos=[(t, p, list(c), list(w)) for t, p, c, w in self.sos])


@dataclasses.dataclass
class HighsHessian:
    """Triangular/square Hessian Q for 1/2 x'Qx (model/HighsHessian.h)."""

    dim: int = 0
    format: HessianFormat = HessianFormat.kTriangular
    start: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, dtype=np.int64))
    index: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    value: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.float64))

    @property
    def num_nz(self) -> int:
        return int(self.start[-1]) if len(self.start) else 0

    def to_scipy_full(self) -> sp.spmatrix:
        """Return the full (square, symmetric) Q as scipy CSC."""
        if self.dim == 0:
            return sp.csc_matrix((0, 0))
        q = sp.csc_matrix((self.value, self.index, self.start),
                          shape=(self.dim, self.dim))
        if self.format == HessianFormat.kTriangular:
            # stored lower triangle: symmetrize without double-counting diag
            d = sp.diags(q.diagonal())
            q = q + q.T - d
        return q

    def quad_value(self, x: np.ndarray) -> float:
        if self.dim == 0:
            return 0.0
        q = self.to_scipy_full()
        return float(0.5 * x @ (q @ x))


@dataclasses.dataclass
class HighsModel:
    """LP + Hessian (model/HighsModel.h)."""

    lp: HighsLp = dataclasses.field(default_factory=HighsLp)
    hessian: HighsHessian = dataclasses.field(default_factory=HighsHessian)

    def is_qp(self) -> bool:
        return self.hessian.dim > 0 and self.hessian.num_nz > 0

    def is_mip(self) -> bool:
        return self.lp.is_mip()

    def objective_value(self, x: np.ndarray) -> float:
        obj = float(np.dot(self.lp.col_cost, x)) + self.lp.offset
        if self.is_qp():
            obj += self.hessian.quad_value(x)
        return obj
