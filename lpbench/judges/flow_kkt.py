"""The equality-form LP's judge: the f64 certificate of
`lpbench/flow_reference.py`.

An answer is judged by its relative primal residual (rows and signs),
its dual residual (negative reduced costs) and its gap, worked out
again from the generated LP; the number compared is the largest of the
three over the window's answers, against the KKT tolerance that the
configuration states.
"""
from __future__ import annotations

from lpbench import flow_reference

CHECK = "kkt_worst"


def limit(config: dict) -> float:
    """The configuration's KKT tolerance."""
    return float(config["kkt_tolerance"])


def measure(problem: flow_reference.FlowLp, answer: dict,
            config: dict) -> dict:
    """The answer's three relative measures (`inf` where the answer has
    the wrong shape, lacks a part, or holds a NaN, its objective too)."""
    if any(k not in answer for k in ("x", "y", "objective")):
        return flow_reference.certificate(problem, [], [], float("nan"))
    return flow_reference.certificate(problem, answer["x"], answer["y"],
                                      answer["objective"])


# the largest of an answer's measures
worst = flow_reference.worst
