"""ipm_card_factors: of the Newton factors of the window's calls on the
routes that assemble M on the host, the share, in %, that ran on the
card and served the Newton solves (the banded f32 Cholesky, the dense
Cholesky of "dense_m"), from the program's counter of factors by engine
and device (each call's `factors`, `entries/flow_facade.py`). A banded
factor that fails its precision gate ("handoffs") serves no solve: the
host factors that iteration again, and it counts among neither. None
where the program has no such counter or made no such factor."""

CARD = ("banded_cuda", "dense_cuda")


def read(run):
    card = total = 0
    for c in run.calls:
        factors = dict(c.get("factors") or {})
        # a call runs on one device: its hand-offs are its banded factors'
        handoffs = factors.pop("handoffs", 0)
        card += sum(factors.get(k, 0) for k in CARD)
        if factors.get("banded_cuda", 0):
            card -= handoffs
        total += sum(factors.values()) - handoffs
    return 100.0 * card / total if total > 0 else None
