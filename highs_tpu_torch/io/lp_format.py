"""CPLEX LP-format reader/writer.

Re-implements the observable behavior of the reference LP reader
(highs/io/FilereaderLp.cpp + extern filereaderlp/reader.cpp): sections
minimize/maximize, subject to (st / s.t. / such that), bounds, general /
integer, binary, semi-continuous, sos, end; "\\" comments; keywords may
appear mid-line (the token stream is parsed, not lines); objective may
carry a quadratic term "[ ... ]/2"; constraints may be two-sided
("-2 <= expr <= 5").  Quadratic constraints raise (unsupported, like the
reference's QCQP rejection).
"""
from __future__ import annotations

import gzip
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..constants import (HessianFormat, HighsStatus, HighsVarType,
                         ObjSense, kHighsInf)
from ..models.lp import HighsHessian, HighsLp, HighsModel, HighsSparseMatrix


class LpParseError(Exception):
    pass


# "semi-continuous" is one token (the section keyword `write_lp` writes),
# and so is a number with a signed exponent ("1.5e-05"); the JAX
# package's tokenizer splits both, reading columns named "-" and
# "continuous" after a "semi" section keyword, and one named "1.5e"
_TOKEN_RE = re.compile(
    r"(?i:semi-continuous)(?![A-Za-z0-9_])|"
    r"<=|>=|=<|=>|[<>=:\[\]\*\^\+\-/]|"
    r"(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?|"
    r"[A-Za-z_!\"#$%&(),;?@'`{}~.][A-Za-z0-9_!\"#$%&(),;?@'`{}~.]*")

_NUM_RE = re.compile(r"^[0-9.]")

_SECTION_STARTS = {
    "minimize": "obj_min", "minimise": "obj_min", "min": "obj_min",
    "maximize": "obj_max", "maximise": "obj_max", "max": "obj_max",
    "st": "st", "s.t.": "st", "st.": "st",
    "bounds": "bounds", "bound": "bounds",
    "general": "general", "generals": "general", "gen": "general",
    "integer": "general", "integers": "general", "int": "general",
    "binary": "binary", "binaries": "binary", "bin": "binary",
    "semi-continuous": "semi", "semi": "semi", "semis": "semi",
    "sos": "sos", "sos1": "sos", "sos2": "sos",
    "end": "end", "free": None,  # "free" is only a keyword inside bounds
}


def _tokenize(text: str) -> List[str]:
    lines = []
    for line in text.splitlines():
        # "\" starts a comment
        idx = line.find("\\")
        if idx >= 0:
            line = line[:idx]
        lines.append(line)
    return _TOKEN_RE.findall("\n".join(lines))


def _is_num(tok: str) -> bool:
    if tok is None:
        return False
    if _NUM_RE.match(tok):
        try:
            float(tok)
            return True
        except ValueError:
            return False
    return False


def _num(tok: str) -> float:
    return float(tok)


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.pos = 0

    def peek(self, ahead=0) -> Optional[str]:
        i = self.pos + ahead
        return self.toks[i] if i < len(self.toks) else None

    def next(self) -> Optional[str]:
        t = self.peek()
        self.pos += 1
        return t

    def at_section_keyword(self) -> Optional[str]:
        """Return the normalized section name starting at pos, or None."""
        t = self.peek()
        if t is None:
            return "end"
        # a keyword followed by ':' is an entity NAME, not a section
        # (reference: check/instances/1451.lp names a constraint "end",
        # TestFilereader.cpp "keywords as constraint names")
        if self.peek(1) == ":":
            return None
        tl = t.lower()
        if tl in ("subject", "such"):
            t2 = self.peek(1)
            if t2 is not None and t2.lower() in ("to", "that"):
                return "st2"  # two tokens
            return None
        if tl == "s" and self.peek(1) == "." and \
                (self.peek(2) or "").lower() == "t" and self.peek(3) == ".":
            return "st4"
        sec = _SECTION_STARTS.get(tl)
        if tl == "free":
            return None
        if tl == "semi-continuous":
            return "semi"
        return sec

    def consume_section_keyword(self, kind: str):
        if kind == "st2":
            self.pos += 2
        elif kind == "st4":
            self.pos += 4
        else:
            self.pos += 1


def read_lp(path: str) -> HighsModel:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    tokens = _tokenize(text)
    if not tokens:
        raise LpParseError("empty LP file")
    p = _Parser(tokens)

    sense = ObjSense.kMinimize
    offset = 0.0
    col_names: List[str] = []
    colname2idx: Dict[str, int] = {}
    col_cost: List[float] = []
    col_lower: List[float] = []
    col_upper: List[float] = []
    col_integrality: List[int] = []
    explicit_bound: List[bool] = []

    row_names: List[str] = []
    row_lower: List[float] = []
    row_upper: List[float] = []
    entries: List[Tuple[int, int, float]] = []  # (row, col, value)
    q_terms: Dict[Tuple[int, int], float] = {}

    def get_col(name: str) -> int:
        idx = colname2idx.get(name)
        if idx is None:
            idx = len(col_names)
            colname2idx[name] = idx
            col_names.append(name)
            col_cost.append(0.0)
            col_lower.append(0.0)
            col_upper.append(kHighsInf)
            col_integrality.append(int(HighsVarType.kContinuous))
            explicit_bound.append(False)
        return idx

    def parse_quad(divide_allowed=True) -> Dict[Tuple[int, int], float]:
        """Parse '[ ... ]' (after the opening '[' was consumed)."""
        terms: Dict[Tuple[int, int], float] = {}
        sign = 1.0
        while True:
            t = p.peek()
            if t is None:
                raise LpParseError("unterminated quadratic bracket")
            if t == "]":
                p.next()
                break
            if t == "+":
                p.next()
                sign = 1.0
                continue
            if t == "-":
                p.next()
                sign = -1.0
                continue
            coef = 1.0
            if _is_num(t):
                coef = _num(p.next())
                t = p.peek()
            if t is None or _is_num(t) or t in "+-]":
                raise LpParseError(f"bad quadratic term near {t!r}")
            v1 = get_col(p.next())
            nxt = p.peek()
            if nxt == "*":
                p.next()
                v2 = get_col(p.next())
            elif nxt == "^":
                p.next()
                exp = p.next()
                if exp != "2":
                    raise LpParseError("only ^2 supported")
                v2 = v1
            else:
                raise LpParseError("quadratic term missing * or ^2")
            key = (max(v1, v2), min(v1, v2))
            terms[key] = terms.get(key, 0.0) + sign * coef
            sign = 1.0
        divisor = 1.0
        if divide_allowed and p.peek() == "/":
            p.next()
            divisor = _num(p.next())
        if divisor != 1.0:
            terms = {k: v / divisor for k, v in terms.items()}
        return terms

    def parse_expr(allow_quad: bool, into_obj: bool):
        """Parse a linear (+ optional quadratic) expression until an
        operator / section keyword.  Returns (lin_terms, const, quad)."""
        nonlocal offset
        lin: Dict[int, float] = {}
        const = 0.0
        quad: Dict[Tuple[int, int], float] = {}
        sign = 1.0
        pending_coef: Optional[float] = None
        while True:
            t = p.peek()
            if t is None:
                break
            if t in ("<=", ">=", "=", "<", ">", "=<", "=>"):
                break
            kw = p.at_section_keyword()
            if kw is not None:
                # a pending number before a keyword is a constant term
                break
            if t in ("+", "-"):
                p.next()
                if pending_coef is not None:
                    # a number followed by a sign is a constant term (the
                    # objective offset `write_lp` writes before a
                    # quadratic bracket; the JAX package's reader makes
                    # it the bracket's factor)
                    const += sign * pending_coef
                    pending_coef = None
                sign = 1.0 if t == "+" else -1.0
                continue
            if t == "[":
                p.next()
                q = parse_quad()
                factor = sign * (pending_coef if pending_coef is not None
                                 else 1.0)
                for k, v in q.items():
                    quad[k] = quad.get(k, 0.0) + factor * v
                sign = 1.0
                pending_coef = None
                continue
            if _is_num(t):
                val = _num(p.next())
                if pending_coef is not None:
                    # two numbers in a row: previous was a constant
                    const += sign * pending_coef
                    sign = 1.0
                pending_coef = val
                continue
            if t == ":":
                raise LpParseError("unexpected ':'")
            # a variable name
            name = p.next()
            j = get_col(name)
            coef = sign * (pending_coef if pending_coef is not None else 1.0)
            lin[j] = lin.get(j, 0.0) + coef
            sign = 1.0
            pending_coef = None
        if pending_coef is not None:
            const += sign * pending_coef
        return lin, const, quad

    # ---- objective section -----------------------------------------------
    kw = p.at_section_keyword()
    if kw not in ("obj_min", "obj_max"):
        # reference behavior (vendored filereaderlp on 1448.lp /
        # garbage.lp): content with no recognizable LP structure loads
        # as an EMPTY model rather than a read error
        return HighsModel(lp=HighsLp())
    sense = (ObjSense.kMinimize if kw == "obj_min" else ObjSense.kMaximize)
    p.consume_section_keyword(kw)

    # optional objective name "obj:"
    if p.peek(1) == ":" and not _is_num(p.peek() or "1"):
        obj_name = p.next()
        p.next()
    else:
        obj_name = "obj"

    lin, const, quad = parse_expr(allow_quad=True, into_obj=True)
    for j, v in lin.items():
        col_cost[j] += v
    offset += const
    for (i, j), v in quad.items():
        # objective = c'x + 1/2 x'Qx: with bracket content C and obj +=
        # C (already divided when "/2" present): x'Qx = 2*C
        q_terms[(i, j)] = q_terms.get((i, j), 0.0) + (
            2.0 * v if i == j else v)

    # ---- subject to -------------------------------------------------------
    kw = p.at_section_keyword()
    if kw in ("st", "st2", "st4"):
        p.consume_section_keyword(kw)
        while True:
            kw = p.at_section_keyword()
            if kw is not None and kw not in (None,):
                break
            if p.peek() is None:
                break
            # optional row label
            row_name = None
            if p.peek(1) == ":":
                row_name = p.next()
                p.next()
            lhs_bound = None
            # a left-hand bound, signed or not ("-1 <= x + y <= 1", as
            # `write_lp` writes a two-sided row; the JAX package's reader
            # takes only an unsigned one and splits such a row in two)
            n_sign = 1 if p.peek() in ("+", "-") else 0
            if _is_num(p.peek(n_sign) or "") and p.peek(n_sign + 1) in (
                    "<=", "<", "=<", ">=", ">", "=>"):
                lhs_sign = -1.0 if n_sign and p.next() == "-" else 1.0
                lhs_bound = lhs_sign * _num(p.next())
                lhs_op = p.next()
            lin, const, quadc = parse_expr(allow_quad=True, into_obj=False)
            if quadc:
                raise LpParseError("quadratic constraints not supported")
            op = p.next()
            if op not in ("<=", ">=", "=", "<", ">", "=<", "=>"):
                raise LpParseError(f"expected comparison, got {op!r}")
            if not _is_num(p.peek() or ""):
                # +/- then number
                s2 = 1.0
                while p.peek() in ("+", "-"):
                    if p.next() == "-":
                        s2 = -s2
                rhs = s2 * _num(p.next())
            else:
                rhs = _num(p.next())
            # constants inside constraint expressions are DROPPED to
            # match the reference (filereaderlp keeps only the
            # objective offset; FilereaderLp.cpp:67 ToDo + the 1451.lp
            # test expects  x - 1 >= 2  to behave as  x >= 2)
            lo, up = -kHighsInf, kHighsInf
            if op in ("<=", "<", "=<"):
                up = rhs
            elif op in (">=", ">", "=>"):
                lo = rhs
            else:
                lo = up = rhs
            if lhs_bound is not None:
                if lhs_op in ("<=", "<", "=<"):
                    lo = lhs_bound
                else:
                    up = lhs_bound
            # possible trailing second bound: "expr >= l <= u"? (rare)
            i = len(row_names)
            row_names.append(row_name or f"r{i}")
            row_lower.append(lo)
            row_upper.append(up)
            for j, v in lin.items():
                if v != 0.0:
                    entries.append((i, j, v))

    # ---- remaining sections ----------------------------------------------
    while True:
        kw = p.at_section_keyword()
        if kw == "end" or p.peek() is None:
            break
        if kw == "bounds":
            p.consume_section_keyword(kw)
            while True:
                kw2 = p.at_section_keyword()
                if kw2 is not None:
                    break
                t = p.peek()
                if t is None:
                    break
                # forms: [num op] name [op num] | name free | name = num
                lhs_val = None
                sign = 1.0
                while p.peek() in ("+", "-"):
                    if p.next() == "-":
                        sign = -sign
                if _is_num(p.peek() or "") or (
                        p.peek() or "").lower() in ("inf", "infinity"):
                    tok = p.next()
                    lhs_val = sign * (kHighsInf if tok.lower().startswith(
                        "inf") else _num(tok))
                    op1 = p.next()
                    name = p.next()
                    j = get_col(name)
                    if op1 in ("<=", "<", "=<"):
                        col_lower[j] = lhs_val
                    elif op1 in (">=", ">", "=>"):
                        col_upper[j] = lhs_val
                    else:
                        col_lower[j] = col_upper[j] = lhs_val
                    explicit_bound[j] = True
                    # optional second op
                    if p.peek() in ("<=", "<", "=<", ">=", ">", "=>"):
                        op2 = p.next()
                        sign2 = 1.0
                        while p.peek() in ("+", "-"):
                            if p.next() == "-":
                                sign2 = -sign2
                        tok2 = p.next()
                        val2 = sign2 * (kHighsInf
                                        if tok2.lower().startswith("inf")
                                        else _num(tok2))
                        if op2 in ("<=", "<", "=<"):
                            col_upper[j] = val2
                        else:
                            col_lower[j] = val2
                    continue
                name = p.next()
                j = get_col(name)
                nxt = p.peek()
                if nxt is not None and nxt.lower() == "free":
                    p.next()
                    col_lower[j] = -kHighsInf
                    col_upper[j] = kHighsInf
                    explicit_bound[j] = True
                    continue
                if nxt in ("<=", "<", "=<", ">=", ">", "=>", "="):
                    op1 = p.next()
                    sign2 = 1.0
                    while p.peek() in ("+", "-"):
                        if p.next() == "-":
                            sign2 = -sign2
                    tok2 = p.next()
                    val = sign2 * (kHighsInf if tok2.lower().startswith(
                        "inf") else _num(tok2))
                    if op1 in ("<=", "<", "=<"):
                        col_upper[j] = val
                        if val < 0 and not explicit_bound[j] and \
                                col_lower[j] == 0.0:
                            col_lower[j] = -kHighsInf
                    elif op1 in (">=", ">", "=>"):
                        col_lower[j] = val
                    else:
                        col_lower[j] = col_upper[j] = val
                    explicit_bound[j] = True
                    continue
                raise LpParseError(f"bad bounds entry near {name!r}")
            continue
        if kw == "general":
            p.consume_section_keyword(kw)
            while p.at_section_keyword() is None and p.peek() is not None:
                j = get_col(p.next())
                col_integrality[j] = int(HighsVarType.kInteger)
            continue
        if kw == "binary":
            p.consume_section_keyword(kw)
            while p.at_section_keyword() is None and p.peek() is not None:
                j = get_col(p.next())
                col_integrality[j] = int(HighsVarType.kInteger)
                if not explicit_bound[j]:
                    col_lower[j] = 0.0
                    col_upper[j] = 1.0
            continue
        if kw == "semi":
            p.consume_section_keyword(kw)
            # possible "-continuous" continuation already folded by
            # tokenizer ("semi-continuous" is one token)
            while p.at_section_keyword() is None and p.peek() is not None:
                j = get_col(p.next())
                if col_integrality[j] == int(HighsVarType.kInteger):
                    col_integrality[j] = int(HighsVarType.kSemiInteger)
                else:
                    col_integrality[j] = int(
                        HighsVarType.kSemiContinuous)
            continue
        if kw == "sos":
            p.consume_section_keyword(kw)
            while p.at_section_keyword() is None and p.peek() is not None:
                p.next()  # SOS entries are recorded but not yet used
            continue
        if kw in ("obj_min", "obj_max", "st", "st2", "st4"):
            raise LpParseError(f"unexpected section {kw}")
        # unknown token outside any section
        raise LpParseError(f"unexpected token {p.peek()!r}")

    num_col = len(col_names)
    num_row = len(row_names)
    if entries:
        rows, cols, vals = zip(*entries)
        a = sp.coo_matrix((vals, (rows, cols)),
                          shape=(num_row, num_col)).tocsc()
    else:
        a = sp.csc_matrix((num_row, num_col))

    lp = HighsLp(
        num_col=num_col, num_row=num_row,
        col_cost=np.array(col_cost), col_lower=np.array(col_lower),
        col_upper=np.array(col_upper),
        row_lower=np.array(row_lower), row_upper=np.array(row_upper),
        a_matrix=HighsSparseMatrix.from_scipy(a),
        sense=sense, offset=offset,
        objective_name=obj_name,
        col_names=col_names, row_names=row_names,
        integrality=(np.array(col_integrality, dtype=np.uint8)
                     if any(v != 0 for v in col_integrality)
                     else np.zeros(0, dtype=np.uint8)))

    hessian = HighsHessian()
    if q_terms:
        keys = sorted(q_terms.keys(), key=lambda k: (k[1], k[0]))
        rows_q = [k[0] for k in keys]
        cols_q = [k[1] for k in keys]
        vals_q = [q_terms[k] for k in keys]
        qm = sp.coo_matrix((vals_q, (rows_q, cols_q)),
                           shape=(num_col, num_col)).tocsc()
        hessian = HighsHessian(
            dim=num_col, format=HessianFormat.kTriangular,
            start=qm.indptr.astype(np.int64),
            index=qm.indices.astype(np.int64),
            value=qm.data.astype(np.float64))
    return HighsModel(lp=lp, hessian=hessian)


def write_lp(model: HighsModel, path: str) -> HighsStatus:
    lp = model.lp
    col_names = (lp.col_names if len(lp.col_names) == lp.num_col
                 else [f"x{j}" for j in range(lp.num_col)])
    row_names = (lp.row_names if len(lp.row_names) == lp.num_row
                 else [f"r{i}" for i in range(lp.num_row)])
    out = ["\\ File written by highs_tpu .lp writer"]
    out.append("max" if lp.sense == ObjSense.kMaximize else "min")
    terms = [f"obj:"]
    for j in range(lp.num_col):
        if lp.col_cost[j] != 0.0:
            terms.append(f"{lp.col_cost[j]:+.12g} {col_names[j]}")
    if lp.offset:
        terms.append(f"{lp.offset:+.12g}")
    if model.is_qp():
        h = model.hessian
        qterms = []
        for j in range(h.dim):
            for k in range(h.start[j], h.start[j + 1]):
                i = h.index[k]
                v = h.value[k] * (1.0 if i == j else 2.0)
                if i == j:
                    qterms.append(f"{v:+.12g} {col_names[j]}^2")
                else:
                    qterms.append(
                        f"{v:+.12g} {col_names[i]} * {col_names[j]}")
        terms.append("+ [ " + " ".join(qterms) + " ]/2")
    out.append(" " + " ".join(terms))
    out.append("st")
    a = lp.a_matrix.to_scipy().tocsr()
    for i in range(lp.num_row):
        row_terms = []
        for k in range(a.indptr[i], a.indptr[i + 1]):
            row_terms.append(f"{a.data[k]:+.12g} {col_names[a.indices[k]]}")
        expr = " ".join(row_terms) if row_terms else "0 " + (
            col_names[0] if lp.num_col else "x0")
        lo, up = lp.row_lower[i], lp.row_upper[i]
        name = row_names[i]
        if lo == up:
            out.append(f" {name}: {expr} = {lo:.12g}")
        elif lo != -kHighsInf and up != kHighsInf:
            out.append(f" {name}: {lo:.12g} <= {expr} <= {up:.12g}")
        elif up != kHighsInf:
            out.append(f" {name}: {expr} <= {up:.12g}")
        elif lo != -kHighsInf:
            out.append(f" {name}: {expr} >= {lo:.12g}")
        else:
            out.append(f" {name}: {expr} >= -1e30")
    out.append("bounds")
    integ = np.asarray(lp.integrality)
    for j in range(lp.num_col):
        lo, up = lp.col_lower[j], lp.col_upper[j]
        name = col_names[j]
        if lo == -kHighsInf and up == kHighsInf:
            out.append(f" {name} free")
        elif lo == up:
            out.append(f" {name} = {lo:.12g}")
        else:
            lo_s = "-inf" if lo == -kHighsInf else f"{lo:.12g}"
            up_s = "+inf" if up == kHighsInf else f"{up:.12g}"
            out.append(f" {lo_s} <= {name} <= {up_s}")
    gen = [col_names[j] for j in range(lp.num_col)
           if len(integ) and integ[j] == int(HighsVarType.kInteger)]
    if gen:
        out.append("general")
        out.append(" " + " ".join(gen))
    semis = [col_names[j] for j in range(lp.num_col)
             if len(integ) and integ[j] in (
                 int(HighsVarType.kSemiContinuous),
                 int(HighsVarType.kSemiInteger))]
    if semis:
        out.append("semi-continuous")
        out.append(" " + " ".join(semis))
    out.append("end")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("\n".join(out) + "\n")
    return HighsStatus.kOk
