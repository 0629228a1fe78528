"""Command-line interface.

Equivalent of the reference CLI (app/RunHighs.cpp:42-139 +
app/HighsRuntimeOptions.h): reads a model, applies command-line /
options-file options, solves, and reports with the reference's exact
output format (Highs.cpp:5020-5061 reportSolvedLpQpStats), so scripts
and the reference's instance-test expectations
("Model status        : Optimal", "Objective value     : %17.10e")
work unchanged.

    python3 -m highs_tpu_torch model.mps [--solution_file out.sol]

solves on CUDA.  `main(argv, device=None)` takes the device as a Python
argument, so a caller can run it on the CPU; the command line has no
device flag, as the JAX package's has none.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import __version__
from .constants import HighsStatus
from .highs import Highs


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="highs_tpu_torch",
        description="LP/QP/MIP solver on PyTorch and CUDA with the "
                    "capabilities of HiGHS")
    parser.add_argument("model_file", nargs="?",
                        help="File of model to solve")
    parser.add_argument("--options_file", help="File containing HiGHS "
                        "options")
    parser.add_argument("--read_solution_file",
                        help="File of solution to read")
    parser.add_argument("--read_basis_file", help="File of basis to read")
    parser.add_argument("--write_model_file", help="File for writing out "
                        "the model")
    parser.add_argument("--solution_file", help="File for writing out "
                        "the solution")
    parser.add_argument("--write_basis_file", help="File for writing out "
                        "the basis")
    parser.add_argument("--presolve", help="Set presolve option to: "
                        '"choose" (default), "on" or "off"')
    parser.add_argument("--solver", help="Set solver option")
    parser.add_argument("--parallel", help="Set parallel option")
    parser.add_argument("--run_crossover", help="Set run_crossover "
                        "option")
    parser.add_argument("--time_limit", type=float,
                        help="Run time limit (seconds)")
    parser.add_argument("--random_seed", type=int, help="Seed to "
                        "initialize random number generation")
    parser.add_argument("--ranging", help="Compute cost, bound, RHS "
                        "ranging: on | off")
    parser.add_argument("--version", "-v", action="store_true",
                        help="Print version")
    return parser


def main(argv: Optional[List[str]] = None, device=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    # accept arbitrary --option=value pairs for any registered option
    parser = build_arg_parser()
    known, unknown = parser.parse_known_args(argv)

    if known.version:
        print(f"highs_tpu_torch version {__version__}")
        return 0

    h = Highs(device=device)

    if known.options_file:
        if h.readOptions(known.options_file) == HighsStatus.kError:
            print(f"Error loading options file {known.options_file}")
            return 1

    for name in ("presolve", "solver", "parallel", "run_crossover",
                 "time_limit", "random_seed", "ranging",
                 "solution_file", "write_model_file", "write_basis_file",
                 "read_solution_file", "read_basis_file"):
        value = getattr(known, name, None)
        if value is not None:
            h.setOptionValue(name, value)

    extra = []
    for tok in unknown:
        if tok.startswith("--") and "=" in tok:
            name, _, value = tok[2:].partition("=")
            if h.setOptionValue(name, value) != HighsStatus.kOk:
                print(f"Unknown or invalid option {name}={value}")
                return 1
        else:
            extra.append(tok)
    if extra:
        print(f"Unrecognized arguments: {' '.join(extra)}")
        return 1

    if not known.model_file:
        print("ERROR: no model file specified")
        parser.print_usage()
        return 1

    if h.readModel(known.model_file) != HighsStatus.kOk:
        print(f"Error loading file {known.model_file}")
        return 1

    h.run()
    h.reportSolvedStats()

    if h.getOptionValue("write_model_file"):
        h.writeModel(h.getOptionValue("write_model_file"))
    if h.getOptionValue("solution_file"):
        h.writeSolution(h.getOptionValue("solution_file"),
                        h.getOptionValue("write_solution_style"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
