"""Post-run metric registry (reference lp_data/HighsRunData.h:29-47).

`HighsRunData` collects the quantities that describe the LAST `run()`
rather than the solution itself (the `HighsInfo` role): presolved model
dimensions, the simplex clean-up effort after postsolve, and the
per-phase wall-clock split.  Values are accessible as attributes, by
name through `get`, and through the typed record census (`records()`),
mirroring the reference's `getRunDataValue` / `getRunDataType` surface.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


# (name, python type, description) — names and descriptions match the
# reference's initRecords (HighsRunData.h:149-187)
_RUN_DATA_RECORDS: List[Tuple[str, type, str]] = [
    ("presolved_model_num_col", int,
     "Number of columns in presolved model"),
    ("presolved_model_num_row", int,
     "Number of rows in presolved model"),
    ("presolved_model_num_nz", int,
     "Number of nonzeros in presolved model"),
    ("num_simplex_iterations_after_postsolve", int,
     "Number of simplex iterations after postsolve"),
    ("presolve_time", float, "Presolve time"),
    ("solve_time", float, "Solve time"),
    ("postsolve_time", float, "Postsolve time"),
]


@dataclasses.dataclass
class HighsRunData:
    valid: bool = False
    presolved_model_num_col: int = 0
    presolved_model_num_row: int = 0
    presolved_model_num_nz: int = 0
    num_simplex_iterations_after_postsolve: int = 0
    presolve_time: float = 0.0
    solve_time: float = 0.0
    postsolve_time: float = 0.0

    def invalidate(self):
        fresh = HighsRunData()
        for f in dataclasses.fields(fresh):
            setattr(self, f.name, getattr(fresh, f.name))

    def get(self, name: str):
        """Value lookup by record name (reference getRunDataValue)."""
        for rec_name, _, _ in _RUN_DATA_RECORDS:
            if rec_name == name:
                return getattr(self, name)
        raise KeyError(name)

    @staticmethod
    def type_of(name: str) -> type:
        """Record type lookup (reference getRunDataType)."""
        for rec_name, rec_type, _ in _RUN_DATA_RECORDS:
            if rec_name == name:
                return rec_type
        raise KeyError(name)

    @staticmethod
    def records() -> List[Tuple[str, type, str]]:
        """The typed record census: (name, type, description)."""
        return list(_RUN_DATA_RECORDS)
