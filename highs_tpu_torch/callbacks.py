"""User callback system.

Re-implements the reference callback machinery (lp_data/HighsCallback.h,
HighsCallbackStruct.h, callback types HConst.h:233-245): a single user
callback function receives (callback_type, message, data_out, data_in,
user_data); solvers invoke it at defined points and honor
data_in.user_interrupt.  Types are enabled with start_callback /
stop_callback, like the reference's Highs::startCallback.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np

from .constants import HighsCallbackType


@dataclasses.dataclass
class HighsCallbackDataOut:
    """Mirror of HighsCallbackDataOut (HighsCallbackStruct.h)."""
    log_type: int = -1
    running_time: float = -1.0
    simplex_iteration_count: int = -1
    ipm_iteration_count: int = -1
    pdlp_iteration_count: int = -1
    objective_function_value: float = float("inf")
    mip_node_count: int = -1
    mip_total_lp_iterations: int = -1
    mip_primal_bound: float = float("inf")
    mip_dual_bound: float = -float("inf")
    mip_gap: float = -1.0
    mip_solution: Optional[np.ndarray] = None
    cutpool_num_col: int = 0
    cutpool_num_cut: int = 0
    cutpool_start: Optional[np.ndarray] = None
    cutpool_index: Optional[np.ndarray] = None
    cutpool_value: Optional[np.ndarray] = None
    cutpool_lower: Optional[np.ndarray] = None
    cutpool_upper: Optional[np.ndarray] = None
    objective_bound: float = float("inf")
    external_solution_query_origin: int = 0


@dataclasses.dataclass
class HighsCallbackDataIn:
    """Mirror of HighsCallbackDataIn."""
    user_interrupt: bool = False
    user_has_solution: bool = False
    user_solution: Optional[np.ndarray] = None


class HighsCallback:
    """Callback registry + dispatcher held by the Highs facade."""

    def __init__(self):
        self.user_callback: Optional[Callable] = None
        self.user_callback_data: Any = None
        self.active = [False] * (max(int(t) for t in HighsCallbackType)
                                 + 1)
        self.data_out = HighsCallbackDataOut()
        self.data_in = HighsCallbackDataIn()

    def clear(self):
        self.__init__()

    def callback_active(self, callback_type: HighsCallbackType) -> bool:
        return (self.user_callback is not None and
                self.active[int(callback_type)])

    def call(self, callback_type: HighsCallbackType,
             message: str = "") -> bool:
        """Invoke the user callback; returns True if the user requested
        an interrupt."""
        if not self.callback_active(callback_type):
            return False
        self.data_in.user_interrupt = False
        self.user_callback(int(callback_type), message, self.data_out,
                           self.data_in, self.user_callback_data)
        return bool(self.data_in.user_interrupt)
