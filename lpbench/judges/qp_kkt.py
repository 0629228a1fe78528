"""The convex QP's judge: the f64 certificate of `lpbench/qp_reference.py`.

An answer is judged by its relative primal infeasibility,
stationarity, dual sign and gap, worked out again from the generated
QP; the number compared is the largest of the four over the window's
answers, against the KKT tolerance that the configuration states.
"""
from __future__ import annotations

from lpbench import qp_reference

CHECK = "qp_kkt_worst"


def limit(config: dict) -> float:
    """The configuration's KKT tolerance."""
    return float(config["kkt_tolerance"])


def measure(problem: qp_reference.Qp, answer: dict, config: dict) -> dict:
    """The answer's four relative measures (`inf` where the answer has
    the wrong shape, lacks a part, or holds a NaN, its objective too)."""
    if any(k not in answer for k in ("x", "y", "z", "objective")):
        return qp_reference.certificate(problem, [], [], [], float("nan"))
    return qp_reference.certificate(problem, answer["x"], answer["y"],
                                    answer["z"], answer["objective"])


# the largest of an answer's measures
worst = qp_reference.worst
