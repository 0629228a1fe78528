"""Solution / basis containers (lp_data/HStruct.h behavior)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..constants import (BasisValidity, HighsBasisStatus, SolutionStatus)


@dataclasses.dataclass
class HighsSolution:
    value_valid: bool = False
    dual_valid: bool = False
    col_value: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    col_dual: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    row_value: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    row_dual: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    def invalidate(self):
        self.value_valid = False
        self.dual_valid = False

    def clear(self):
        self.invalidate()
        self.col_value = np.zeros(0)
        self.col_dual = np.zeros(0)
        self.row_value = np.zeros(0)
        self.row_dual = np.zeros(0)


@dataclasses.dataclass
class HighsBasis:
    valid: bool = False
    alien: bool = False
    useful: bool = False
    was_alien: bool = False
    debug_id: int = -1
    debug_update_count: int = -1
    debug_origin_name: str = ""
    col_status: List[HighsBasisStatus] = dataclasses.field(
        default_factory=list)
    row_status: List[HighsBasisStatus] = dataclasses.field(
        default_factory=list)

    def invalidate(self):
        self.valid = False
        self.useful = False

    def clear(self):
        self.invalidate()
        self.col_status = []
        self.row_status = []


@dataclasses.dataclass
class HighsObjectiveSolution:
    objective: float = 0.0
    col_value: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))


@dataclasses.dataclass
class HighsRay:
    """A primal or dual unboundedness ray."""
    valid: bool = False
    value: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))


@dataclasses.dataclass
class HighsLinearObjective:
    """One of several linear objectives (HStruct.h:158-167)."""
    weight: float = 0.0
    offset: float = 0.0
    coefficients: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    abs_tolerance: float = -1.0
    rel_tolerance: float = -1.0
    priority: int = 0
