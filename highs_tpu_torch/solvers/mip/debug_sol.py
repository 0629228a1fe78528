"""MIP debug-solution tracer.

Re-implements the dev tool HighsDebugSol (highs/mip/HighsDebugSol.cpp,
option mip_debug_solution_file): load a known feasible solution and
track it through presolve/cuts/propagation — any operation that cuts it
off is reported immediately, localizing cut/propagation bugs."""
from __future__ import annotations

from typing import Optional

import numpy as np


class DebugSolution:
    def __init__(self, x: np.ndarray, log=None):
        self.x = np.asarray(x, dtype=np.float64)
        self.log = log
        self.active = True

    @staticmethod
    def load(filename: str, lp, log=None) -> Optional["DebugSolution"]:
        """Accepts either raw solution-writer output (name value lines
        under '# Primal solution values') or plain 'name value' pairs."""
        try:
            values = {}
            plain = []
            with open(filename) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2:
                        try:
                            plain.append(float(parts[1]))
                            values[parts[0]] = float(parts[1])
                        except ValueError:
                            continue
                    elif len(parts) == 1:
                        try:
                            plain.append(float(parts[0]))
                        except ValueError:
                            continue
            x = None
            names = list(lp.col_names) if len(lp.col_names) == \
                lp.num_col else []
            if names and all(nm in values for nm in names):
                x = np.array([values[nm] for nm in names])
            elif len(plain) >= lp.num_col:
                x = np.array(plain[:lp.num_col])
            if x is None:
                return None
            dbg = DebugSolution(x, log=log)
            return dbg
        except OSError:
            return None

    def _report(self, what: str):
        if self.log is not None:
            self.log(f"WARNING: MIP debug solution violated by {what}")
        self.active = False

    def check_bounds(self, lo, up, what: str, feastol=1e-6) -> bool:
        """True if the debug solution remains inside [lo, up]."""
        if not self.active:
            return True
        if np.any(self.x < lo - feastol) or np.any(self.x > up + feastol):
            self._report(what)
            return False
        return True

    def in_box(self, lo, up, feastol=1e-6) -> bool:
        """Whether the debug solution lies inside a node's box (no
        report: pruning such a node by BOUND is legal, by infeasibility
        is not)."""
        return self.active and bool(
            np.all(self.x >= lo - feastol) and
            np.all(self.x <= up + feastol))

    def check_cut(self, coefs: np.ndarray, rhs: float, what: str,
                  feastol=1e-6) -> bool:
        """True if the cut  coefs'x <= rhs  keeps the debug solution."""
        if not self.active:
            return True
        act = float(coefs @ self.x)
        if act > rhs + feastol * (1.0 + abs(rhs)):
            self._report(f"{what} (activity {act:.6g} > rhs {rhs:.6g})")
            return False
        return True
