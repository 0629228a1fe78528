"""Pythonic modeling layer.

Re-implements the behavior of the reference highspy modeling interface
(highspy/highspy/highs.py: highs_var, highs_cons,
highs_linear_expression with operator overloading, addVariable(s) /
addConstr(s) / qsum, value/dual accessors, async solve) on top of the
port's Highs facade, on its device (`Highs(device=None)`: CUDA unless
the caller names the CPU).  An error raised by a solve started with
`startSolve` comes back from `joinSolve` and `wait`.

    h = Highs()
    x = h.addVariable()
    y = h.addVariable()
    h.addConstr(x + 2 * y <= 14)
    h.addConstr(3 * x - y >= 0)
    h.maximize(3 * x + 4 * y)
"""
from __future__ import annotations

import itertools
import numbers
import threading
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

from .constants import (HighsModelStatus, HighsStatus, HighsVarType,
                        ObjSense, kHighsInf)
from .highs import Highs as _Highs


class highs_var:
    """A variable handle (reference: highspy highs_var)."""

    __slots__ = ("index", "highs")

    def __init__(self, index: int, highs):
        self.index = index
        self.highs = highs

    @property
    def name(self) -> str:
        st, name = self.highs.getColName(self.index)
        return name if st == HighsStatus.kOk else f"__v{self.index}"

    @name.setter
    def name(self, value: str):
        self.highs.passColName(self.index, value)

    def __repr__(self):
        return f"highs_var({self.index})"

    # arithmetic builds expressions
    def __neg__(self):
        return highs_linear_expression(self) * -1.0

    def __add__(self, other):
        return highs_linear_expression(self) + other

    def __radd__(self, other):
        return highs_linear_expression(self) + other

    def __sub__(self, other):
        return highs_linear_expression(self) - other

    def __rsub__(self, other):
        return (-highs_linear_expression(self)) + other

    def __mul__(self, coef):
        return highs_linear_expression(self) * coef

    __rmul__ = __mul__

    def __truediv__(self, coef):
        return highs_linear_expression(self) * (1.0 / coef)

    def __le__(self, other):
        return highs_linear_expression(self) <= other

    def __ge__(self, other):
        return highs_linear_expression(self) >= other

    def __eq__(self, other):
        return highs_linear_expression(self) == other

    def __hash__(self):
        return hash(("highs_var", self.index))


class highs_cons:
    """A constraint handle (reference: highspy highs_cons)."""

    __slots__ = ("index", "highs")

    def __init__(self, index: int, highs):
        self.index = index
        self.highs = highs

    @property
    def name(self) -> str:
        st, name = self.highs.getRowName(self.index)
        return name if st == HighsStatus.kOk else f"__c{self.index}"

    @name.setter
    def name(self, value: str):
        self.highs.passRowName(self.index, value)

    def expr(self):
        return self.highs.getExpr(self)

    def __repr__(self):
        return f"highs_cons({self.index})"


class highs_linear_expression:
    """Mutable-free linear expression with optional bounds.

    Comparison operators attach bounds: `e <= 4`, `e == 2`,
    `2 <= e <= 4` (chained bounds combine).
    """

    __slots__ = ("vals", "constant", "bounds")

    def __init__(self, other=None):
        self.vals: Dict[int, float] = {}
        self.constant: float = 0.0
        self.bounds = None  # (lo, up) once a comparison was applied
        if other is None:
            return
        if isinstance(other, highs_var):
            self.vals[other.index] = 1.0
        elif isinstance(other, highs_linear_expression):
            self.vals = dict(other.vals)
            self.constant = other.constant
            self.bounds = other.bounds
        elif isinstance(other, numbers.Real):
            self.constant = float(other)
        else:
            raise TypeError(f"cannot build expression from {other!r}")

    def copy(self):
        return highs_linear_expression(self)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        result = self.copy()
        if isinstance(other, highs_var):
            result.vals[other.index] = result.vals.get(other.index,
                                                      0.0) + 1.0
        elif isinstance(other, highs_linear_expression):
            for k, v in other.vals.items():
                result.vals[k] = result.vals.get(k, 0.0) + v
            result.constant += other.constant
        elif isinstance(other, numbers.Real):
            result.constant += float(other)
        else:
            return NotImplemented
        return result

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, highs_var):
            other = highs_linear_expression(other)
        if isinstance(other, highs_linear_expression):
            return self + (other * -1.0)
        if isinstance(other, numbers.Real):
            return self + (-float(other))
        return NotImplemented

    def __rsub__(self, other):
        return (self * -1.0) + other

    def __neg__(self):
        return self * -1.0

    def __mul__(self, coef):
        if not isinstance(coef, numbers.Real):
            return NotImplemented
        result = self.copy()
        result.vals = {k: v * float(coef) for k, v in result.vals.items()}
        result.constant *= float(coef)
        return result

    __rmul__ = __mul__

    def __truediv__(self, coef):
        return self * (1.0 / coef)

    # -- comparisons create bounded expressions ----------------------------
    def _with_bounds(self, lo, up):
        result = self.copy()
        if result.bounds is not None:
            old_lo, old_up = result.bounds
            lo = max(old_lo, lo)
            up = min(old_up, up)
        result.bounds = (lo, up)
        return result

    def __le__(self, other):
        if isinstance(other, numbers.Real):
            return self._with_bounds(-kHighsInf, float(other))
        if isinstance(other, (highs_var, highs_linear_expression)):
            diff = self - other
            return diff._with_bounds(-kHighsInf, 0.0)
        return NotImplemented

    def __ge__(self, other):
        if isinstance(other, numbers.Real):
            return self._with_bounds(float(other), kHighsInf)
        if isinstance(other, (highs_var, highs_linear_expression)):
            diff = self - other
            return diff._with_bounds(0.0, kHighsInf)
        return NotImplemented

    def __eq__(self, other):
        if isinstance(other, numbers.Real):
            return self._with_bounds(float(other), float(other))
        if isinstance(other, (highs_var, highs_linear_expression)):
            diff = self - other
            return diff._with_bounds(0.0, 0.0)
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __repr__(self):
        terms = " + ".join(f"{v}*v{k}" for k, v in self.vals.items())
        s = f"{terms or '0'}"
        if self.constant:
            s += f" + {self.constant}"
        if self.bounds is not None:
            s = f"{self.bounds[0]} <= {s} <= {self.bounds[1]}"
        return s


def qsum(items, start=None) -> highs_linear_expression:
    """Fast sum of variables/expressions (reference: highspy qsum)."""
    result = highs_linear_expression(start)
    vals = result.vals
    for item in items:
        if isinstance(item, highs_var):
            vals[item.index] = vals.get(item.index, 0.0) + 1.0
        elif isinstance(item, highs_linear_expression):
            for k, v in item.vals.items():
                vals[k] = vals.get(k, 0.0) + v
            result.constant += item.constant
        elif isinstance(item, numbers.Real):
            result.constant += float(item)
        else:
            raise TypeError(f"cannot sum {item!r}")
    return result


class Highs(_Highs):
    """Highs facade + the pythonic modeling interface."""

    def __init__(self, device=None):
        super().__init__(device=device)
        self._solver_thread: Optional[threading.Thread] = None
        self._solve_status: Optional[HighsStatus] = None
        self._solve_error: Optional[BaseException] = None

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.clear()
        return False

    def silent(self, turn_off_output: bool = True):
        self.setOptionValue("output_flag", not turn_off_output)

    def inf(self) -> float:
        return kHighsInf

    # -- variables ----------------------------------------------------------
    def addVariable(self, lb: float = 0.0, ub: float = kHighsInf,
                    obj: float = 0.0,
                    type: HighsVarType = HighsVarType.kContinuous,
                    name: Optional[str] = None) -> highs_var:
        idx = self.getNumCol()
        self.addCol(obj, lb, ub)
        if type != HighsVarType.kContinuous:
            self.changeColIntegrality(idx, type)
        if name is not None:
            self.passColName(idx, name)
        return highs_var(idx, self)

    def addVariables(self, *nvars, **kwargs):
        """addVariables(n) or addVariables(n1, n2, ...) -> dict keyed by
        tuples; supports lb/ub/obj/type/name_prefix kwargs."""
        lb = kwargs.get("lb", 0.0)
        ub = kwargs.get("ub", kHighsInf)
        obj = kwargs.get("obj", 0.0)
        vtype = kwargs.get("type", HighsVarType.kContinuous)
        name_prefix = kwargs.get("name_prefix", None)
        if len(nvars) == 1 and isinstance(nvars[0], numbers.Integral):
            count = int(nvars[0])
            out = [self.addVariable(lb, ub, obj, vtype) for _ in
                   range(count)]
            if name_prefix:
                for i, v in enumerate(out):
                    v.name = f"{name_prefix}{i}"
            return np.asarray(out, dtype=object)
        if len(nvars) >= 1 and all(isinstance(d, numbers.Integral)
                                   for d in nvars):
            keys = list(itertools.product(*(range(int(d))
                                            for d in nvars)))
            return {k: self.addVariable(lb, ub, obj, vtype)
                    for k in keys}
        # iterable of keys
        if len(nvars) == 1:
            keys = list(nvars[0])
            return {k: self.addVariable(lb, ub, obj, vtype)
                    for k in keys}
        raise TypeError("unsupported addVariables arguments")

    def addBinary(self, obj: float = 0.0,
                  name: Optional[str] = None) -> highs_var:
        return self.addVariable(0.0, 1.0, obj, HighsVarType.kInteger,
                                name)

    def addIntegral(self, lb: float = 0.0, ub: float = kHighsInf,
                    obj: float = 0.0,
                    name: Optional[str] = None) -> highs_var:
        return self.addVariable(lb, ub, obj, HighsVarType.kInteger, name)

    def addBinaries(self, *nvars, **kwargs):
        kwargs.setdefault("lb", 0.0)
        kwargs["ub"] = 1.0
        kwargs["type"] = HighsVarType.kInteger
        return self.addVariables(*nvars, **kwargs)

    def addIntegrals(self, *nvars, **kwargs):
        kwargs["type"] = HighsVarType.kInteger
        return self.addVariables(*nvars, **kwargs)

    def deleteVariable(self, var: Union[int, highs_var]):
        idx = var.index if isinstance(var, highs_var) else int(var)
        self.deleteCols(idx, idx)

    def getVariables(self) -> List[highs_var]:
        return [highs_var(i, self) for i in range(self.getNumCol())]

    def numVariables(self) -> int:
        return self.getNumCol()

    def numConstrs(self) -> int:
        return self.getNumRow()

    def setInteger(self, var):
        for v in np.atleast_1d(np.asarray(var, dtype=object)).ravel():
            idx = v.index if isinstance(v, highs_var) else int(v)
            self.changeColIntegrality(idx, HighsVarType.kInteger)

    def setContinuous(self, var):
        for v in np.atleast_1d(np.asarray(var, dtype=object)).ravel():
            idx = v.index if isinstance(v, highs_var) else int(v)
            self.changeColIntegrality(idx, HighsVarType.kContinuous)

    # -- constraints ---------------------------------------------------------
    def addConstr(self, expr: highs_linear_expression,
                  name: Optional[str] = None) -> highs_cons:
        if not isinstance(expr, highs_linear_expression) or \
                expr.bounds is None:
            raise TypeError("addConstr needs a bounded expression "
                            "(use <=, >=, ==)")
        lo, up = expr.bounds
        lo = lo - expr.constant if lo != -kHighsInf else lo
        up = up - expr.constant if up != kHighsInf else up
        idx = self.getNumRow()
        items = [(k, v) for k, v in expr.vals.items() if v != 0.0]
        self.addRow(lo, up, len(items),
                    [k for k, _ in items], [v for _, v in items])
        if name is not None:
            self.passRowName(idx, name)
        return highs_cons(idx, self)

    def addConstrs(self, exprs, name_prefix: Optional[str] = None):
        if isinstance(exprs, (list, tuple)):
            iterable = exprs
        else:
            iterable = list(exprs)
        out = [self.addConstr(e) for e in iterable]
        if name_prefix:
            for i, c in enumerate(out):
                c.name = f"{name_prefix}{i}"
        return out

    def removeConstr(self, cons: Union[int, highs_cons]):
        idx = cons.index if isinstance(cons, highs_cons) else int(cons)
        self.deleteRows(idx, idx)

    def chgCoeff(self, cons, var, val: float):
        ci = cons.index if isinstance(cons, highs_cons) else int(cons)
        vi = var.index if isinstance(var, highs_var) else int(var)
        self.changeCoeff(ci, vi, val)

    def getConstrs(self) -> List[highs_cons]:
        return [highs_cons(i, self) for i in range(self.getNumRow())]

    def getExpr(self, cons: Union[int, highs_cons]
                ) -> highs_linear_expression:
        idx = cons.index if isinstance(cons, highs_cons) else int(cons)
        lp = self.getLp()
        a = lp.a_matrix.to_scipy().tocsr()
        expr = highs_linear_expression()
        for k in range(a.indptr[idx], a.indptr[idx + 1]):
            expr.vals[int(a.indices[k])] = float(a.data[k])
        expr.bounds = (lp.row_lower[idx], lp.row_upper[idx])
        return expr

    # -- objective -----------------------------------------------------------
    def setObjective(self, obj=None, sense: Optional[ObjSense] = None):
        if obj is not None:
            if isinstance(obj, highs_var):
                obj = highs_linear_expression(obj)
            if obj.bounds is not None:
                raise TypeError("objective cannot be a bounded "
                                "expression")
            lp = self.getLp()
            cost = np.zeros(lp.num_col)
            for k, v in obj.vals.items():
                cost[k] = v
            lp.col_cost = cost
            self.changeObjectiveOffset(obj.constant)
        if sense is not None:
            self.changeObjectiveSense(sense)
        return HighsStatus.kOk

    def setMinimize(self):
        self.changeObjectiveSense(ObjSense.kMinimize)

    def setMaximize(self):
        self.changeObjectiveSense(ObjSense.kMaximize)

    def minimize(self, obj=None):
        self.setObjective(obj, ObjSense.kMinimize)
        return self.solve()

    def maximize(self, obj=None):
        self.setObjective(obj, ObjSense.kMaximize)
        return self.solve()

    # -- solving -------------------------------------------------------------
    def solve(self):
        return self.run()

    optimize = solve

    def startSolve(self) -> threading.Thread:
        if self.is_solver_running():
            raise RuntimeError("solver already running")
        self._solve_status = None
        self._solve_error = None
        self._solver_thread = threading.Thread(target=self.__solve)
        self._solver_thread.start()
        return self._solver_thread

    def __solve(self):
        try:
            self._solve_status = self.run()
        except BaseException as err:  # handed to joinSolve / wait
            self._solve_error = err

    def _raise_solve_error(self):
        err, self._solve_error = self._solve_error, None
        if err is not None:
            raise err

    def is_solver_running(self) -> bool:
        return (self._solver_thread is not None and
                self._solver_thread.is_alive())

    def joinSolve(self, solver_thread=None, interrupt_limit: int = 5):
        thread = solver_thread or self._solver_thread
        if thread is not None:
            thread.join()
        self._raise_solve_error()
        return self._solve_status

    def wait(self, timeout: float = -1.0):
        thread = self._solver_thread
        if thread is None:
            return True, self._solve_status
        thread.join(timeout if timeout >= 0 else None)
        done = not thread.is_alive()
        if done:
            self._raise_solve_error()
        return done, (self._solve_status if done else None)

    # -- value / dual accessors ---------------------------------------------
    def _value_of(self, item, values, row_values):
        if isinstance(item, highs_var):
            return float(values[item.index])
        if isinstance(item, highs_cons):
            return float(row_values[item.index])
        if isinstance(item, highs_linear_expression):
            total = item.constant + sum(
                v * values[k] for k, v in item.vals.items())
            if item.bounds is not None:
                lo, up = item.bounds
                return bool(lo - 1e-9 <= total <= up + 1e-9)
            return float(total)
        if isinstance(item, numbers.Integral):
            return float(values[int(item)])
        raise TypeError(f"cannot evaluate {item!r}")

    def _map_over(self, var, values, row_values):
        if isinstance(var, dict):
            return {k: self._map_over(v, values, row_values)
                    for k, v in var.items()}
        if isinstance(var, (list, tuple, np.ndarray)):
            return np.asarray([self._map_over(v, values, row_values)
                               for v in np.asarray(var,
                                                   dtype=object).ravel()])
        return self._value_of(var, values, row_values)

    def val(self, var):
        sol = self.getSolution()
        return self._map_over(var, sol.col_value, sol.row_value)

    vals = val

    def variableValue(self, var):
        return self.val(var)

    variableValues = variableValue

    def allVariableValues(self):
        return list(self.getSolution().col_value)

    def variableDual(self, var):
        sol = self.getSolution()
        return self._map_over(var, sol.col_dual, sol.row_dual)

    variableDuals = variableDual

    def allVariableDuals(self):
        return list(self.getSolution().col_dual)

    def constrValue(self, con):
        sol = self.getSolution()
        if isinstance(con, numbers.Integral):
            return float(sol.row_value[int(con)])
        return self._map_over(con, sol.col_value, sol.row_value)

    constrValues = constrValue

    def allConstrValues(self):
        return list(self.getSolution().row_value)

    def constrDual(self, con):
        sol = self.getSolution()
        if isinstance(con, numbers.Integral):
            return float(sol.row_dual[int(con)])
        if isinstance(con, highs_cons):
            return float(sol.row_dual[con.index])
        return self._map_over(con, sol.col_dual, sol.row_dual)

    constrDuals = constrDual

    def allConstrDuals(self):
        return list(self.getSolution().row_dual)

    def variableName(self, var):
        idx = var.index if isinstance(var, highs_var) else int(var)
        st, name = self.getColName(idx)
        return name

    def variableNames(self, idxs):
        if isinstance(idxs, dict):
            return {k: self.variableName(v) for k, v in idxs.items()}
        return [self.variableName(v) for v in idxs]

    def allVariableNames(self):
        lp = self.getLp()
        return list(lp.col_names) if lp.col_names else [
            f"c{j}" for j in range(lp.num_col)]

    def expr(self, other=None) -> highs_linear_expression:
        return highs_linear_expression(other)
