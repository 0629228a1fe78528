"""The MIP's batched node-LP rounds as replays (`solvers/mip/batch_nodes.py`
with `solvers/capture.py`), on the CPU.

A card captures each round's starting point and step as CUDA graphs over
static buffers; here the evaluator takes `capture.eager_recorder`, which
replays by running the captured work again and copying its outputs, and
is held against the evaluator that runs op by op:
- bit for bit, lane by lane, over three rounds at two round sizes (the
  second round of size 4 replays the graphs the first captured), one of
  them with a lane whose step breaks (a singular normal matrix with the
  regularization at 0: the lane's mu is NaN and the revert writes its
  previous state back into the buffers);
- with `COUNTS` and `ipm/solver.py`'s `DENSE_FACTORS` true under replay
  (one batched factor a step);
- through a whole MIP, whose evaluator is rebuilt when node cuts add rows:
  the old evaluator's graphs are freed first, and the last evaluator's
  when the search ends;
- against the JAX package's evaluator run one node at a time, with the
  tolerance of `test_torch_batch_nodes.py`."""
import functools

import numpy as np
import pytest
import torch

import test_torch_batch_nodes
from highs_tpu_torch.solvers import capture
from highs_tpu_torch.solvers.ipm import solver as ipm_solver
from highs_tpu_torch.solvers.mip import batch_nodes
from highs_tpu_torch.solvers.mip.batch_nodes import BatchNodeEvaluator
from highs_tpu_torch.utils.gen_mip import equality_knapsacks
from test_torch_batch_nodes import node_boxes, relaxation
from test_torch_mip import run

torch.set_num_threads(1)

# (round size K, seed of its node boxes); the third round breaks a lane
ROUNDS = [(4, 1), (2, 2), (4, 3)]
BROKEN_ROUND, BROKEN_LANE = 2, 2


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.int64)


def _run_rounds(ev, lpt):
    """ROUNDS through `ev`: per round its results and a copy of its
    buffers (state, previous state, regularizations, metrics)."""
    out = []
    for i, (K, seed) in enumerate(ROUNDS):
        los, ups = node_boxes(lpt.num_col, K, seed)
        if i == BROKEN_ROUND:
            # every column but the first fixed: K Theta K' has rank 1
            # over the four equality rows, singular once the
            # regularization is 0
            los[BROKEN_LANE] = ups[BROKEN_LANE] = 0.0
            ups[BROKEN_LANE, 0] = 1.0
            ev._regs = np.zeros(2)
        results = ev.evaluate(los, ups)
        r = ev._rounds[K]
        out.append((results, [t.clone() for t in
                              (*r.state, *r.prev, r.regs, r.metrics)]))
    return out


def _evaluator(capture_step):
    lpt, _ = relaxation(equality_knapsacks(4, 20, 0))
    return BatchNodeEvaluator(lpt, device="cpu", capture=capture_step), lpt


def test_recorded_rounds_equal_op_by_op_bit_for_bit():
    runs = []
    for capture_step in (None, capture.eager_recorder):
        ev, lpt = _evaluator(capture_step)
        runs.append(_run_rounds(ev, lpt))
    for (want, want_bufs), (got, got_bufs) in zip(*runs):
        assert len(got) == len(want)
        for (conv, bound, x), (w_conv, w_bound, w_x) in zip(got, want):
            assert conv == w_conv
            assert np.float64(bound).tobytes() == \
                np.float64(w_bound).tobytes()
            if w_x is None:
                assert x is None
            else:
                assert x.tobytes() == w_x.tobytes()
        for g, w in zip(got_bufs, want_bufs):
            assert torch.equal(_bits(g), _bits(w))
    # the broken lane: its last step's mu is NaN, and the revert left
    # the previous (finite) state in the buffers; it reports nothing
    results, bufs = runs[1][BROKEN_ROUND]
    state, metrics = bufs[:6], bufs[-1]
    assert torch.isnan(metrics[2, BROKEN_LANE])
    assert all(torch.isfinite(t[BROKEN_LANE]).all() for t in state)
    assert results[BROKEN_LANE] == (False, -np.inf, None)
    assert sum(r[0] for r in results) == len(results) - 1


def test_counts_hold_under_replay():
    deltas = []
    for capture_step in (None, capture.eager_recorder):
        ev, lpt = _evaluator(capture_step)
        counts0 = dict(batch_nodes.COUNTS)
        factors0 = dict(ipm_solver.DENSE_FACTORS)
        _run_rounds(ev, lpt)
        deltas.append(({k: batch_nodes.COUNTS[k] - counts0[k]
                        for k in counts0},
                       {k: ipm_solver.DENSE_FACTORS[k] - factors0[k]
                        for k in factors0}))
    (eager, eager_factors), (graphed, graphed_factors) = deltas
    for key in ("rounds", "lanes", "converged", "iterations", "cpu"):
        assert graphed[key] == eager[key]
    assert eager["rounds"] == len(ROUNDS)
    assert eager["lanes"] == sum(K for K, _ in ROUNDS)
    assert eager["cpu"] == eager["iterations"] > 0
    assert eager["captures"] == eager["replays"] == 0
    # a start and a step graph for each of the two round sizes; one
    # replay a round's start and one an iteration
    assert graphed["captures"] == 4
    assert graphed["replays"] == graphed["rounds"] + graphed["iterations"]
    # one batched factor a step, counted at every replay
    assert graphed_factors == eager_factors == \
        {"cuda": 0, "cpu": eager["iterations"]}


def test_rebuilt_and_last_evaluators_free_their_graphs(monkeypatch):
    events = []

    class Recorded(BatchNodeEvaluator):
        def __init__(self, relax_lp, *args, **kwargs):
            super().__init__(relax_lp, *args,
                             capture=capture.eager_recorder, **kwargs)
            events.append(("build", self, relax_lp.num_row))

        def close(self):
            graphs = sum(len(r.graphs) for r in self._rounds.values())
            events.append(("close", self, graphs))
            super().close()
    monkeypatch.setattr(batch_nodes, "BatchNodeEvaluator", Recorded)
    # node cuts at the 200th node add rows, so the evaluator is rebuilt
    h = run("torch", equality_knapsacks(3, 18, 2), tpu_mip_batch_nodes=4,
            mip_max_nodes=210)
    assert h.getInfo().mip_node_count == 210
    builds = [e for e in events if e[0] == "build"]
    assert len(builds) == 2 and builds[1][2] > builds[0][2]
    # each evaluator is closed, holding graphs, before the next is built
    # and the last when the search ends
    assert [e[0] for e in events] == ["build", "close"] * 2
    for (_, built, _), (_, closed, graphs) in zip(events[::2], events[1::2]):
        assert closed is built and graphs > 0
        assert built._rounds == {}


@pytest.mark.parametrize("name", sorted(test_torch_batch_nodes.INSTANCES))
def test_recorded_lanes_match_reference_node_by_node(name, monkeypatch):
    monkeypatch.setattr(test_torch_batch_nodes, "BatchNodeEvaluator",
                        functools.partial(BatchNodeEvaluator,
                                          capture=capture.eager_recorder))
    replays = batch_nodes.COUNTS["replays"]
    test_torch_batch_nodes.test_lanes_match_reference_node_by_node(name)
    assert batch_nodes.COUNTS["replays"] > replays
