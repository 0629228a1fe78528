"""Solution writers (reference: HighsModelUtils.cpp writeSolutionFile,
writeGlpsolSolution; solution styles HConst.h:157-165: kOldRaw -1,
kRaw 0, kPretty 1, kGlpsolRaw 2, kGlpsolPretty 3, kSparse 4)."""
from __future__ import annotations

import sys

import numpy as np

from ..constants import (HighsBasisStatus, HighsModelStatus, HighsStatus,
                         SolutionStyle, model_status_to_string)


def _names(lp):
    col_names = (lp.col_names if len(lp.col_names) == lp.num_col
                 else [f"C{j}" for j in range(lp.num_col)])
    row_names = (lp.row_names if len(lp.row_names) == lp.num_row
                 else [f"R{i}" for i in range(lp.num_row)])
    return col_names, row_names


def _raw_lines(highs, sparse: bool = False):
    lp = highs.getLp()
    sol = highs.getSolution()
    info = highs.getInfo()
    status = highs.getModelStatus()
    col_names, row_names = _names(lp)
    lines = [f"Model status: {model_status_to_string(status)}", ""]
    lines.append("# Primal solution values")
    if not sol.value_valid:
        lines.append("None")
    else:
        lines.append("Feasible" if info.num_primal_infeasibilities == 0
                     else "Infeasible")
        lines.append(f"Objective {info.objective_function_value:.15g}")
        if sparse:
            nz = [j for j in range(lp.num_col)
                  if abs(sol.col_value[j]) > 1e-13]
            lines.append(f"# Columns {len(nz)}")
            for j in nz:
                lines.append(f"{col_names[j]} {sol.col_value[j]:.15g} "
                             f"{j}")
        else:
            lines.append(f"# Columns {lp.num_col}")
            for j in range(lp.num_col):
                lines.append(f"{col_names[j]} {sol.col_value[j]:.15g}")
            lines.append(f"# Rows {lp.num_row}")
            for i in range(lp.num_row):
                lines.append(f"{row_names[i]} {sol.row_value[i]:.15g}")
    if sparse:
        return lines
    lines.append("")
    lines.append("# Dual solution values")
    if not sol.dual_valid:
        lines.append("None")
    else:
        lines.append("Feasible" if info.num_dual_infeasibilities == 0
                     else "Infeasible")
        lines.append(f"# Columns {lp.num_col}")
        for j in range(lp.num_col):
            lines.append(f"{col_names[j]} {sol.col_dual[j]:.15g}")
        lines.append(f"# Rows {lp.num_row}")
        for i in range(lp.num_row):
            lines.append(f"{row_names[i]} {sol.row_dual[i]:.15g}")
    # basis section (reference raw style appends basis validity/statuses)
    basis = highs.getBasis()
    lines.append("")
    lines.append("# Basis")
    if not basis.valid:
        lines.append("HiGHS basis file")
        lines.append("None")
    else:
        lines.append("HiGHS basis file")
        lines.append("Valid")
        lines.append("# Columns " + " ".join(
            str(int(s)) for s in basis.col_status))
        lines.append("# Rows " + " ".join(
            str(int(s)) for s in basis.row_status))
    return lines


_BASIS_CH = {0: "LB", 1: "BS", 2: "UB", 3: "FR", 4: "NB"}


def _pretty_lines(highs):
    lp = highs.getLp()
    sol = highs.getSolution()
    info = highs.getInfo()
    status = highs.getModelStatus()
    basis = highs.getBasis()
    col_names, row_names = _names(lp)
    lines = ["Columns"]
    hdr = (f"{'Index':>9} {'Status':>8} {'Lower':>12} {'Upper':>12} "
           f"{'Primal':>14} {'Dual':>14}  Name")
    lines.append(hdr)
    for j in range(lp.num_col):
        st = (_BASIS_CH.get(int(basis.col_status[j]), "??")
              if basis.valid else "")
        primal = sol.col_value[j] if sol.value_valid else 0.0
        dual = sol.col_dual[j] if sol.dual_valid else 0.0
        lines.append(f"{j:>9} {st:>8} {lp.col_lower[j]:>12.6g} "
                     f"{lp.col_upper[j]:>12.6g} {primal:>14.6g} "
                     f"{dual:>14.6g}  {col_names[j]}")
    lines.append("Rows")
    lines.append(hdr)
    for i in range(lp.num_row):
        st = (_BASIS_CH.get(int(basis.row_status[i]), "??")
              if basis.valid else "")
        primal = sol.row_value[i] if sol.value_valid else 0.0
        dual = sol.row_dual[i] if sol.dual_valid else 0.0
        lines.append(f"{i:>9} {st:>8} {lp.row_lower[i]:>12.6g} "
                     f"{lp.row_upper[i]:>12.6g} {primal:>14.6g} "
                     f"{dual:>14.6g}  {row_names[i]}")
    lines.append("")
    lines.append(f"Model status: {model_status_to_string(status)}")
    lines.append("")
    lines.append(
        f"Objective value: {info.objective_function_value:.15g}")
    return lines


def _glpsol_status_char(basis_valid, st, lower, upper):
    if not basis_valid:
        return "*"
    st = int(st)
    if st == 1:
        return "B"
    if st == 0:
        return "NL"
    if st == 2:
        return "NU"
    if st == 3:
        return "NF"
    return "NS"


def _glpsol_lines(highs, pretty: bool):
    """GLPK glpsol-compatible solution print (reference
    writeGlpsolSolution: used by the GLPK ecosystem's tooling)."""
    lp = highs.getLp()
    sol = highs.getSolution()
    info = highs.getInfo()
    status = highs.getModelStatus()
    basis = highs.getBasis()
    col_names, row_names = _names(lp)
    is_mip = bool(len(lp.integrality))
    n_lines = []
    stat_str = {
        HighsModelStatus.kOptimal: "OPTIMAL",
        HighsModelStatus.kInfeasible: ("INFEASIBLE (FINAL)"
                                       if is_mip else
                                       "PROBLEM HAS NO PRIMAL FEASIBLE "
                                       "SOLUTION"),
        HighsModelStatus.kUnbounded: "UNBOUNDED",
    }.get(status, "UNDEFINED")
    if is_mip:
        stat_str = {"OPTIMAL": "INTEGER OPTIMAL",
                    "UNDEFINED": "INTEGER UNDEFINED"}.get(
                        stat_str, stat_str)
    n_lines.append(f"{'Problem:':<12}{lp.model_name}")
    n_lines.append(f"{'Rows:':<12}{lp.num_row}")
    n_lines.append(f"{'Columns:':<12}{lp.num_col}"
                   + (f" ({int(np.sum(np.asarray(lp.integrality) > 0))}"
                      " integer)" if is_mip else ""))
    n_lines.append(f"{'Non-zeros:':<12}{lp.num_nz}")
    n_lines.append(f"{'Status:':<12}{stat_str}")
    n_lines.append(f"{'Objective:':<12}obj = "
                   f"{info.objective_function_value:.10g} "
                   f"({'MINimum' if int(lp.sense) == 1 else 'MAXimum'})")
    n_lines.append("")
    if pretty:
        n_lines.append(f"{'No.':>6} {'Row name':<12} {'St':>4} "
                       f"{'Activity':>13} {'Lower bound':>13} "
                       f"{'Upper bound':>13} {'Marginal':>13}")
        n_lines.append("------ ------------   -- ------------- "
                       "------------- ------------- -------------")
        for i in range(lp.num_row):
            act = sol.row_value[i] if sol.value_valid else 0.0
            dual = sol.row_dual[i] if sol.dual_valid else 0.0
            st = _glpsol_status_char(
                basis.valid, basis.row_status[i] if basis.valid else 0,
                lp.row_lower[i], lp.row_upper[i])
            lob = ("" if not np.isfinite(lp.row_lower[i])
                   else f"{lp.row_lower[i]:>13.6g}")
            upb = ("" if not np.isfinite(lp.row_upper[i])
                   else f"{lp.row_upper[i]:>13.6g}")
            n_lines.append(f"{i + 1:>6} {row_names[i]:<12} {st:>4} "
                           f"{act:>13.6g} {lob:>13} {upb:>13} "
                           f"{dual:>13.6g}")
        n_lines.append("")
        n_lines.append(f"{'No.':>6} {'Column name':<12} {'St':>4} "
                       f"{'Activity':>13} {'Lower bound':>13} "
                       f"{'Upper bound':>13} {'Marginal':>13}")
        n_lines.append("------ ------------   -- ------------- "
                       "------------- ------------- -------------")
        for j in range(lp.num_col):
            act = sol.col_value[j] if sol.value_valid else 0.0
            dual = sol.col_dual[j] if sol.dual_valid else 0.0
            st = _glpsol_status_char(
                basis.valid, basis.col_status[j] if basis.valid else 0,
                lp.col_lower[j], lp.col_upper[j])
            lob = ("" if not np.isfinite(lp.col_lower[j])
                   else f"{lp.col_lower[j]:>13.6g}")
            upb = ("" if not np.isfinite(lp.col_upper[j])
                   else f"{lp.col_upper[j]:>13.6g}")
            n_lines.append(f"{j + 1:>6} {col_names[j]:<12} {st:>4} "
                           f"{act:>13.6g} {lob:>13} {upb:>13} "
                           f"{dual:>13.6g}")
    else:
        # glpsol raw: counts line then one value line per row/col
        n_lines.append(f"s {'mip' if is_mip else 'bas'} {lp.num_row} "
                       f"{lp.num_col} "
                       f"{'o' if status == HighsModelStatus.kOptimal else 'u'}"
                       f" {info.objective_function_value:.12g}")
        for i in range(lp.num_row):
            act = sol.row_value[i] if sol.value_valid else 0.0
            dual = sol.row_dual[i] if sol.dual_valid else 0.0
            n_lines.append(f"i {i + 1} {act:.12g} {dual:.12g}")
        for j in range(lp.num_col):
            act = sol.col_value[j] if sol.value_valid else 0.0
            dual = sol.col_dual[j] if sol.dual_valid else 0.0
            n_lines.append(f"j {j + 1} {act:.12g} {dual:.12g}")
    n_lines.append("")
    n_lines.append("End of output")
    return n_lines


def write_solution(highs, filename: str = "", style: int = 0) -> HighsStatus:
    style = int(style)
    if style == int(SolutionStyle.kSolutionStylePretty):
        lines = _pretty_lines(highs)
    elif style == int(SolutionStyle.kSolutionStyleSparse):
        lines = _raw_lines(highs, sparse=True)
    elif style == int(SolutionStyle.kSolutionStyleGlpsolRaw):
        lines = _glpsol_lines(highs, pretty=False)
    elif style == int(SolutionStyle.kSolutionStyleGlpsolPretty):
        lines = _glpsol_lines(highs, pretty=True)
    else:  # kRaw / kOldRaw
        lines = _raw_lines(highs)

    text = "\n".join(lines) + "\n"
    if filename in ("", "-"):
        sys.stdout.write(text)
    else:
        with open(filename, "w") as f:
            f.write(text)
    return HighsStatus.kOk
