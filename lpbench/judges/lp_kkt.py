"""The LP's judge: the f64 KKT check of `lpbench/reference.py`.

An answer is judged by its relative primal residual, dual residual and
gap, worked out again from the generated LP; the number compared is the
largest of the three over the window's answers, against the KKT
tolerance that the configuration states.
"""
from __future__ import annotations

import math

from lpbench import reference

CHECK = "kkt_worst"


def limit(config: dict) -> float:
    """The configuration's KKT tolerance."""
    return float(config["kkt_tolerance"])


def measure(problem: reference.Lp, answer: dict, config: dict) -> dict:
    """The answer's three relative measures (`inf` where the answer has
    the wrong shape or a NaN)."""
    out = reference.kkt(problem, answer["x"], answer["y"],
                        answer["objective"])
    # `reference.kkt` takes the larger of two gaps with `max`, which
    # passes over a NaN objective when c'x's gap is finite
    if not math.isfinite(float(answer["objective"])):
        out["rel_gap"] = math.inf
    return out


# the largest of an answer's measures
worst = reference.worst
