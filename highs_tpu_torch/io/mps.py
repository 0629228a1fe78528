"""Free-format MPS reader/writer.

Re-implements the observable behavior of the reference free-format MPS
parser (highs/io/HMpsFF.cpp): sections NAME / OBJSENSE / ROWS / COLUMNS
(with 'MARKER' INTORG/INTEND) / RHS / RANGES / BOUNDS / SOS /
QUADOBJ / QMATRIX / QSECTION / ENDATA, gzip transparency, the classic MPS
conventions:

- first N row is the objective; later N rows are ignored (free rows are
  deleted, matching the reference's default keep_n_rows = -1);
- an RHS entry on the objective row sets objective offset = -value
  (HMpsFF.cpp:1081);
- marker-integer columns default to binary [0, 1] unless a BOUNDS entry
  mentions them (HMpsFF.cpp:327-333, HMpsFF.h:130);
- RANGES: L-row -> [u - |r|, u]; G-row -> [l, l + |r|]; E-row with r > 0 ->
  [l, l + r], r < 0 -> [u - |r|, u] (HMpsFF.cpp:1554-1563);
- QMATRIX/QCMATRIX hold all of Q, QUADOBJ/QSECTION the lower triangle
  (off-diagonals implicitly mirrored); objective is c'x + 1/2 x'Qx.
"""
from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np
import scipy.sparse as sp

from ..constants import (HessianFormat, HighsStatus, HighsVarType,
                         MatrixFormat, ObjSense, kHighsInf)
from ..models.lp import (HighsHessian, HighsLp, HighsModel, HighsSparseMatrix)

_SECTION_KEYS = {
    "NAME", "OBJSENSE", "OBJSENSEMAX", "OBJSENSEMIN", "ROWS", "COLUMNS",
    "RHS", "RANGES", "BOUNDS", "SOS", "ENDATA", "QMATRIX", "QUADOBJ",
    "QSECTION", "QCMATRIX", "CSECTION", "DELAYEDROWS", "MODELCUTS",
    "INDICATORS", "SETS", "GENCONS", "PWLOBJ", "OBJECTS",
}


class MpsParseError(Exception):
    pass


def _open(path: str) -> TextIO:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _tokens(line: str) -> List[str]:
    toks = line.split()
    # Inline comments: a token starting with '$' ends the data on the
    # line (fixed-MPS comment field).  '*' is NOT an inline comment
    # marker — only full-line comments start with '*' (reference
    # HMpsFF.cpp:223 has remove_trailing_comments=false, and row names
    # like '*OBJ*' occur in the wild, e.g. check/instances/sctest.mps).
    # Stray trailing '*...' words are instead dropped per-section as
    # unknown row names, matching the reference's ignored-row warnings.
    out = []
    for t in toks:
        if t.startswith("$"):
            break
        out.append(t)
    return out


def _parse_value(tok: str, allow_nan: bool = False) -> float:
    try:
        v = float(tok)
    except ValueError:
        # Fortran-style exponents like 1.0D+2
        try:
            v = float(tok.replace("D", "E").replace("d", "e"))
        except ValueError:
            raise MpsParseError(f"cannot parse value {tok!r}")
    if math.isnan(v) and not allow_nan:
        # reference: NaN in RHS/RANGES/BOUNDS fails the load (nan2.mps)
        raise MpsParseError(f"NaN value {tok!r}")
    return v


_FIXED_SPANS = ((1, 3), (4, 12), (14, 22), (24, 36), (39, 47),
                (49, 61))
_NAME_MANGLE = "\x01"


def _fixed_to_free_lines(lines):
    """Re-tokenize classic fixed-column MPS (reference HMPSIO.cpp
    field positions 2-3 / 5-12 / 15-22 / 25-36 / 40-47 / 50-61) into
    free-format tokens.  Names containing spaces survive as single
    tokens via a sentinel mangle that read_mps strips afterwards."""
    out = []
    for raw in lines:
        line = raw.rstrip("\n")
        if not line or line[0] in "*$":
            out.append(raw)
            continue
        if line[0] not in " \t":
            out.append(raw)  # section header
            continue
        fields = []
        for k, (a, b) in enumerate(_FIXED_SPANS):
            if len(line) <= a:
                break
            end = len(line) if k == len(_FIXED_SPANS) - 1 else b
            tok = line[a:end].strip()
            if tok:
                fields.append(tok.replace(" ", _NAME_MANGLE))
        out.append(" " + " ".join(fields) + "\n" if fields else "\n")
    return out


def read_mps(path: str, fixed: bool = False) -> HighsModel:
    """Parse a (possibly gzipped) MPS file into a HighsModel.

    Free format by default; ``fixed=True`` re-tokenizes by the classic
    fixed column positions (reference HMPSIO.cpp) so names with
    embedded spaces parse.  A free-format parse error falls back to
    the fixed reader automatically (reference Filereader behavior)."""
    if not fixed:
        try:
            return _read_mps_any(path, fixed=False)
        except MpsParseError:
            return _read_mps_any(path, fixed=True)
    return _read_mps_any(path, fixed=True)


def _read_mps_any(path: str, fixed: bool) -> HighsModel:
    model_name = ""
    objective_name = ""
    sense = ObjSense.kMinimize

    row_names: List[str] = []
    row_lower: List[float] = []
    row_upper: List[float] = []
    # -1 = objective row, -2 = ignored free row
    rowname2idx: Dict[str, int] = {}
    row_type: List[str] = []

    col_names: List[str] = []
    colname2idx: Dict[str, int] = {}
    col_cost: List[float] = []
    col_lower: List[float] = []
    col_upper: List[float] = []
    col_integrality: List[int] = []
    col_binary: List[bool] = []
    has_lower: List[bool] = []
    has_upper: List[bool] = []

    entries: List[Tuple[int, int, float]] = []  # (col, row, value)
    nan_rows: set = set()  # rows neutralized by a NaN coefficient
    obj_offset = 0.0

    q_entries: List[Tuple[int, int, float]] = []

    sos: List[Tuple[str, int, List[int], List[float]]] = []

    def get_col(name: str, allow_new=True) -> int:
        idx = colname2idx.get(name)
        if idx is None:
            if not allow_new:
                return -1
            idx = len(col_names)
            colname2idx[name] = idx
            col_names.append(name)
            col_cost.append(0.0)
            col_lower.append(0.0)
            col_upper.append(kHighsInf)
            col_integrality.append(int(HighsVarType.kContinuous))
            col_binary.append(False)
            has_lower.append(False)
            has_upper.append(False)
        return idx

    f = _open(path)
    try:
        lines = f.readlines()
    finally:
        f.close()
    if fixed:
        lines = _fixed_to_free_lines(lines)

    section = None
    section_arg = None  # e.g. QCMATRIX row name
    integral_cols = False
    i_line = 0
    n_lines = len(lines)

    while i_line < n_lines:
        raw = lines[i_line]
        i_line += 1
        if not raw.strip():
            continue
        if raw[0] in "*$":
            continue
        is_section_line = not raw[0].isspace()
        toks = _tokens(raw)
        if not toks:
            continue

        if is_section_line:
            key = toks[0].upper()
            if key == "NAME":
                model_name = toks[1] if len(toks) > 1 else ""
                section = None
                continue
            if key == "OBJSENSE":
                if len(toks) > 1:
                    sense = (ObjSense.kMaximize
                             if toks[1].upper().startswith("MAX")
                             else ObjSense.kMinimize)
                    section = None
                else:
                    section = "OBJSENSE"
                continue
            if key in ("MAXIMIZE", "MAX", "MAXIMIZ"):
                sense = ObjSense.kMaximize
                section = None
                continue
            if key in ("MINIMIZE", "MIN", "MINIMIZ"):
                sense = ObjSense.kMinimize
                section = None
                continue
            if key == "ENDATA":
                break
            if key in _SECTION_KEYS:
                section = key
                section_arg = toks[1] if len(toks) > 1 else None
                integral_cols = False
                continue
            raise MpsParseError(f"unknown MPS section {key!r}")

        if section == "OBJSENSE":
            word = toks[0].upper()
            sense = (ObjSense.kMaximize if word.startswith("MAX")
                     else ObjSense.kMinimize)
            continue

        if section == "ROWS":
            rtype = toks[0].upper()
            if len(toks) < 2:
                raise MpsParseError(f"ROWS line missing name: {raw!r}")
            name = toks[1]
            if rtype == "N":
                if not objective_name:
                    objective_name = name
                    rowname2idx[name] = -1
                else:
                    rowname2idx[name] = -2  # ignored free row
                continue
            idx = len(row_names)
            if name in rowname2idx:
                raise MpsParseError(f"duplicate row name {name!r}")
            rowname2idx[name] = idx
            row_names.append(name)
            row_type.append(rtype)
            if rtype == "E":
                row_lower.append(0.0)
                row_upper.append(0.0)
            elif rtype == "G":
                row_lower.append(0.0)
                row_upper.append(kHighsInf)
            elif rtype == "L":
                row_lower.append(-kHighsInf)
                row_upper.append(0.0)
            else:
                raise MpsParseError(f"unknown row type {rtype!r}")
            continue

        if section == "COLUMNS":
            if len(toks) >= 3 and toks[1] == "'MARKER'":
                marker = toks[2]
            elif len(toks) >= 2 and toks[0] == "'MARKER'":
                marker = toks[-1]
            else:
                marker = None
            if marker is not None or "'MARKER'" in toks:
                m_up = raw.upper()
                if "INTORG" in m_up:
                    integral_cols = True
                elif "INTEND" in m_up:
                    integral_cols = False
                else:
                    raise MpsParseError(f"bad marker line {raw!r}")
                continue
            colname = toks[0]
            colidx = colname2idx.get(colname)
            if colidx is None:
                colidx = get_col(colname)
                if integral_cols:
                    col_integrality[colidx] = int(HighsVarType.kInteger)
                    col_binary[colidx] = True
            pairs = toks[1:]
            if len(pairs) % 2 != 0:
                # tolerate a stray trailing token that is not a row name
                # (the reference ignores undefined row names with a
                # warning; '*...' pseudo-comments land here)
                if pairs and pairs[-1] not in rowname2idx:
                    pairs = pairs[:-1]
                else:
                    raise MpsParseError(f"odd COLUMNS entries in {raw!r}")
            for j in range(0, len(pairs), 2):
                rname, vtok = pairs[j], pairs[j + 1]
                # COLUMNS tolerates NaN (reference nan0/nan1.mps): a
                # NaN objective coefficient is kept (the objective
                # evaluates to NaN); a NaN constraint coefficient
                # neutralizes its row (NaN poisons every activity
                # comparison in the reference, so the row never binds)
                value = _parse_value(vtok, allow_nan=True)
                ridx = rowname2idx.get(rname)
                if ridx is None:
                    continue  # undefined row: ignored with warning upstream
                if ridx == -1:
                    col_cost[colidx] += value
                elif ridx >= 0 and math.isnan(value):
                    nan_rows.add(ridx)
                elif ridx >= 0 and value != 0.0:
                    entries.append((colidx, ridx, value))
            continue

        if section == "RHS":
            # first token is the (ignored) rhs vector name unless it is a
            # row name (SIF files may omit it)
            pairs = toks
            if pairs and pairs[0] not in rowname2idx:
                pairs = pairs[1:]
            if len(pairs) % 2 != 0:
                if pairs and pairs[-1] not in rowname2idx:
                    pairs = pairs[:-1]
                else:
                    raise MpsParseError(f"odd RHS entries in {raw!r}")
            for j in range(0, len(pairs), 2):
                rname, vtok = pairs[j], pairs[j + 1]
                value = _parse_value(vtok)
                ridx = rowname2idx.get(rname)
                if ridx is None:
                    continue
                if ridx == -1:
                    obj_offset = -value
                    continue
                if ridx == -2:
                    continue
                rtype = row_type[ridx]
                if rtype == "E":
                    row_lower[ridx] = value
                    row_upper[ridx] = value
                elif rtype == "G":
                    row_lower[ridx] = value
                elif rtype == "L":
                    row_upper[ridx] = value
            continue

        if section == "RANGES":
            pairs = toks
            if pairs and pairs[0] not in rowname2idx:
                pairs = pairs[1:]
            if len(pairs) % 2 != 0:
                if pairs and pairs[-1] not in rowname2idx:
                    pairs = pairs[:-1]
                else:
                    raise MpsParseError(f"odd RANGES entries in {raw!r}")
            for j in range(0, len(pairs), 2):
                rname, vtok = pairs[j], pairs[j + 1]
                value = _parse_value(vtok)
                ridx = rowname2idx.get(rname)
                if ridx is None or ridx < 0:
                    continue
                rtype = row_type[ridx]
                if (rtype == "E" and value < 0) or rtype == "L":
                    row_lower[ridx] = row_upper[ridx] - abs(value)
                elif (rtype == "E" and value > 0) or rtype == "G":
                    row_upper[ridx] = row_lower[ridx] + abs(value)
            continue

        if section == "BOUNDS":
            btype = toks[0].upper()
            rest = toks[1:]
            if not rest:
                raise MpsParseError(f"BOUNDS line too short: {raw!r}")
            # bound-set name is optional (SIF); detect by column lookup
            if rest[0] in colname2idx or len(rest) == 1:
                cname = rest[0]
                vtoks = rest[1:]
            else:
                cname = rest[1] if len(rest) > 1 else rest[0]
                vtoks = rest[2:]
            colidx = get_col(cname)
            value = _parse_value(vtoks[0]) if vtoks else None

            if btype == "UP":
                col_upper[colidx] = value
                has_upper[colidx] = True
                # classic MPS quirk: negative upper bound with default
                # lower of zero frees the lower bound
                if value is not None and value < 0 and not has_lower[colidx]:
                    col_lower[colidx] = -kHighsInf
                col_binary[colidx] = False
            elif btype == "LO":
                col_lower[colidx] = value
                has_lower[colidx] = True
                col_binary[colidx] = False
            elif btype == "FX":
                col_lower[colidx] = value
                col_upper[colidx] = value
                has_lower[colidx] = True
                has_upper[colidx] = True
                col_binary[colidx] = False
            elif btype == "FR":
                col_lower[colidx] = -kHighsInf
                col_upper[colidx] = kHighsInf
                has_lower[colidx] = True
                has_upper[colidx] = True
                col_binary[colidx] = False
            elif btype == "MI":
                col_lower[colidx] = -kHighsInf
                has_lower[colidx] = True
                col_binary[colidx] = False
            elif btype == "PL":
                col_upper[colidx] = kHighsInf
                has_upper[colidx] = True
                col_binary[colidx] = False
            elif btype == "BV":
                col_integrality[colidx] = int(HighsVarType.kInteger)
                col_lower[colidx] = 0.0
                col_upper[colidx] = 1.0
                has_lower[colidx] = True
                has_upper[colidx] = True
                col_binary[colidx] = False
            elif btype == "LI":
                col_integrality[colidx] = int(HighsVarType.kInteger)
                col_lower[colidx] = value
                has_lower[colidx] = True
                col_binary[colidx] = False
            elif btype == "UI":
                col_integrality[colidx] = int(HighsVarType.kInteger)
                col_upper[colidx] = value
                has_upper[colidx] = True
                col_binary[colidx] = False
            elif btype == "SC":
                col_integrality[colidx] = int(HighsVarType.kSemiContinuous)
                col_upper[colidx] = value
                has_upper[colidx] = True
                col_binary[colidx] = False
            elif btype == "SI":
                col_integrality[colidx] = int(HighsVarType.kSemiInteger)
                col_upper[colidx] = value
                has_upper[colidx] = True
                col_binary[colidx] = False
            else:
                raise MpsParseError(f"unknown bound type {btype!r}")
            continue

        if section in ("QMATRIX", "QUADOBJ"):
            if len(toks) < 3:
                raise MpsParseError(f"bad Q entry {raw!r}")
            c1 = get_col(toks[0], allow_new=False)
            c2 = get_col(toks[1], allow_new=False)
            if c1 < 0 or c2 < 0:
                raise MpsParseError(f"Q entry references unknown column "
                                    f"{raw!r}")
            value = _parse_value(toks[2])
            if value != 0.0:
                # unify as FULL-matrix records (reference
                # HMpsFF::parseQuadMatrix): triangular sections mirror
                # their off-diagonals, so mixed QUADOBJ+QMATRIX files
                # accumulate into one Hessian
                q_entries.append((c1, c2, value))
                if section == "QUADOBJ" and c1 != c2:
                    q_entries.append((c2, c1, value))
            continue

        if section in ("QSECTION", "QCMATRIX", "CSECTION"):
            # row-quadratic / cone sections are not yet supported; the
            # objective QSECTION is when its argument names the objective
            if section == "QSECTION" and (
                    section_arg is None or section_arg == objective_name):
                c1 = get_col(toks[0], allow_new=False)
                c2 = get_col(toks[1], allow_new=False)
                value = _parse_value(toks[2])
                if c1 >= 0 and c2 >= 0 and value != 0.0:
                    q_entries.append((c1, c2, value))
                    if c1 != c2:  # triangular section: mirror
                        q_entries.append((c2, c1, value))
                continue
            raise MpsParseError(
                f"section {section} (row quadratic / cone) not supported")

        if section == "SOS" or section == "SETS":
            # store SOS metadata; entries: "S1"/"S2" setname, then member
            # lines "colname weight"
            if toks[0].upper() in ("S1", "S2"):
                sos.append((toks[0].upper(),
                            len(sos), [], []))
            else:
                if not sos:
                    raise MpsParseError("SOS member before set header")
                cidx = get_col(toks[0], allow_new=False)
                if cidx >= 0 and len(toks) > 1:
                    sos[-1][2].append(cidx)
                    sos[-1][3].append(_parse_value(toks[1]))
            continue

        if section in ("DELAYEDROWS", "MODELCUTS", "INDICATORS", "GENCONS",
                       "PWLOBJ", "OBJECTS"):
            raise MpsParseError(f"section {section} not supported")

        if section is None:
            raise MpsParseError(f"data line outside any section: {raw!r}")

    # binary-by-default marker integers
    for cidx in range(len(col_names)):
        if col_binary[cidx]:
            col_lower[cidx] = 0.0
            col_upper[cidx] = 1.0

    num_col = len(col_names)
    num_row = len(row_names)

    # rows poisoned by a NaN coefficient never bind (see COLUMNS above)
    for ridx in nan_rows:
        row_lower[ridx] = -kHighsInf
        row_upper[ridx] = kHighsInf

    if entries:
        cols, rows, vals = zip(*entries)
        # duplicate (col,row) pairs: reference keeps the first and ignores
        # duplicates (HMpsFF.cpp COLUMNS handling)
        seen = {}
        keep_c, keep_r, keep_v = [], [], []
        for c, r, v in entries:
            if (c, r) in seen:
                continue
            seen[(c, r)] = True
            keep_c.append(c)
            keep_r.append(r)
            keep_v.append(v)
        a = sp.coo_matrix((keep_v, (keep_r, keep_c)),
                          shape=(num_row, num_col)).tocsc()
        a.sort_indices()
    else:
        a = sp.csc_matrix((num_row, num_col))

    lp = HighsLp(
        num_col=num_col, num_row=num_row,
        col_cost=np.array(col_cost, dtype=np.float64),
        col_lower=np.array(col_lower, dtype=np.float64),
        col_upper=np.array(col_upper, dtype=np.float64),
        row_lower=np.array(row_lower, dtype=np.float64),
        row_upper=np.array(row_upper, dtype=np.float64),
        a_matrix=HighsSparseMatrix.from_scipy(a),
        sense=sense, offset=obj_offset,
        model_name=model_name, objective_name=objective_name,
        col_names=col_names, row_names=row_names,
        integrality=(np.array(col_integrality, dtype=np.uint8)
                     if any(v != 0 for v in col_integrality)
                     else np.zeros(0, dtype=np.uint8)),
        sos=[s for s in sos if s[2]],
    )

    hessian = HighsHessian()
    if q_entries:
        # build lower-triangular CSC of Q (objective term 1/2 x'Qx)
        # q_entries hold FULL-matrix records (triangular sections were
        # mirrored at parse time): fold to the lower triangle, halving
        # off-diagonals since both (i,j) and (j,i) are present
        tri: Dict[Tuple[int, int], float] = {}
        for c1, c2, v in q_entries:
            i, j = (c1, c2) if c1 >= c2 else (c2, c1)
            key = (i, j)
            tri[key] = tri.get(key, 0.0) + (v if i == j else 0.5 * v)
        rows_q = [k[0] for k in tri]
        cols_q = [k[1] for k in tri]
        vals_q = [tri[k] for k in tri]
        qm = sp.coo_matrix((vals_q, (rows_q, cols_q)),
                           shape=(num_col, num_col)).tocsc()
        qm.sort_indices()
        hessian = HighsHessian(
            dim=num_col, format=HessianFormat.kTriangular,
            start=qm.indptr.astype(np.int64),
            index=qm.indices.astype(np.int64),
            value=qm.data.astype(np.float64))

    model = HighsModel(lp=lp, hessian=hessian)
    if fixed:
        # strip the fixed-mode name mangle (spaces inside names)
        lp.model_name = lp.model_name.replace(_NAME_MANGLE, " ")
        lp.col_names = [nm.replace(_NAME_MANGLE, " ")
                        for nm in lp.col_names]
        lp.row_names = [nm.replace(_NAME_MANGLE, " ")
                        for nm in lp.row_names]
    return model


def _fmt(v: float) -> str:
    v = float(v)
    return repr(v) if v not in (kHighsInf, -kHighsInf) else (
        "1e30" if v > 0 else "-1e30")


def write_mps(model: HighsModel, path: str) -> HighsStatus:
    """Write a model as free-format MPS (reader-compatible round trip)."""
    lp = model.lp
    col_names = (lp.col_names if len(lp.col_names) == lp.num_col
                 else [f"C{j}" for j in range(lp.num_col)])
    row_names = (lp.row_names if len(lp.row_names) == lp.num_row
                 else [f"R{i}" for i in range(lp.num_row)])
    obj_name = lp.objective_name or "Obj"

    lines = [f"NAME        {lp.model_name}"]
    if lp.sense == ObjSense.kMaximize:
        lines.append("OBJSENSE")
        lines.append("    MAX")
    lines.append("ROWS")
    lines.append(f" N  {obj_name}")
    row_kind = []
    for i in range(lp.num_row):
        lo, up = lp.row_lower[i], lp.row_upper[i]
        if lo == up:
            kind = "E"
        elif up == kHighsInf and lo != -kHighsInf:
            kind = "G"
        elif lo == -kHighsInf and up != kHighsInf:
            kind = "L"
        elif lo == -kHighsInf and up == kHighsInf:
            kind = "N"  # free row: keep as extra N row
        else:
            kind = "L"  # ranged: L row + RANGES entry
        row_kind.append(kind)
        lines.append(f" {kind}  {row_names[i]}")
    lines.append("COLUMNS")
    a = lp.a_matrix.to_scipy().tocsc()
    integ = np.asarray(lp.integrality)
    in_int = False
    marker_count = 0
    for j in range(lp.num_col):
        is_int = (len(integ) > 0 and
                  integ[j] in (int(HighsVarType.kInteger),
                               int(HighsVarType.kSemiInteger)))
        if is_int and not in_int:
            lines.append(f"    MARKER{marker_count:04d}  'MARKER'"
                         "                 'INTORG'")
            marker_count += 1
            in_int = True
        elif not is_int and in_int:
            lines.append(f"    MARKER{marker_count:04d}  'MARKER'"
                         "                 'INTEND'")
            marker_count += 1
            in_int = False
        if lp.col_cost[j] != 0.0:
            lines.append(f"    {col_names[j]}  {obj_name}  "
                         f"{_fmt(lp.col_cost[j])}")
        start, end = a.indptr[j], a.indptr[j + 1]
        for k in range(start, end):
            lines.append(f"    {col_names[j]}  {row_names[a.indices[k]]}  "
                         f"{_fmt(a.data[k])}")
    if in_int:
        lines.append(f"    MARKER{marker_count:04d}  'MARKER'"
                     "                 'INTEND'")
    lines.append("RHS")
    if lp.offset != 0.0:
        lines.append(f"    RHS  {obj_name}  {_fmt(-lp.offset)}")
    for i in range(lp.num_row):
        kind = row_kind[i]
        if kind == "E" or kind == "G":
            v = lp.row_lower[i]
        elif kind == "L":
            v = lp.row_upper[i]
        else:
            continue
        if v != 0.0:
            lines.append(f"    RHS  {row_names[i]}  {_fmt(v)}")
    # RANGES for two-sided rows
    ranged = [i for i in range(lp.num_row)
              if row_kind[i] == "L" and lp.row_lower[i] != -kHighsInf]
    if ranged:
        lines.append("RANGES")
        for i in ranged:
            lines.append(f"    RNG  {row_names[i]}  "
                         f"{_fmt(lp.row_upper[i] - lp.row_lower[i])}")
    lines.append("BOUNDS")
    for j in range(lp.num_col):
        lo, up = lp.col_lower[j], lp.col_upper[j]
        name = col_names[j]
        is_semi = (len(integ) > 0 and
                   integ[j] in (int(HighsVarType.kSemiContinuous),
                                int(HighsVarType.kSemiInteger)))
        if is_semi:
            kind = ("SI" if integ[j] == int(HighsVarType.kSemiInteger)
                    else "SC")
            lines.append(f" {kind} BND  {name}  {_fmt(up)}")
            if lo != 0.0:
                lines.append(f" LO BND  {name}  {_fmt(lo)}")
            continue
        if lo == up:
            lines.append(f" FX BND  {name}  {_fmt(lo)}")
            continue
        if lo == -kHighsInf and up == kHighsInf:
            lines.append(f" FR BND  {name}")
            continue
        if lo == -kHighsInf:
            lines.append(f" MI BND  {name}")
        elif lo != 0.0:
            lines.append(f" LO BND  {name}  {_fmt(lo)}")
        if up != kHighsInf:
            lines.append(f" UP BND  {name}  {_fmt(up)}")
    if model.is_qp():
        lines.append("QUADOBJ")
        h = model.hessian
        for j in range(h.dim):
            for k in range(h.start[j], h.start[j + 1]):
                lines.append(f"    {col_names[h.index[k]]}  {col_names[j]}  "
                             f"{_fmt(h.value[k])}")
    if getattr(lp, "sos", None):
        lines.append("SOS")
        for si, (typ, _pri, scols, sweights) in enumerate(lp.sos):
            lines.append(f" {typ} SOS{si + 1}")
            for cj, wj in zip(scols, sweights):
                lines.append(f"    {col_names[cj]}  {_fmt(wj)}")
    lines.append("ENDATA")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return HighsStatus.kOk
