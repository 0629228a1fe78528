"""Batched MIP node LPs (`solvers/mip/batch_nodes.py`) against the JAX
package's evaluator and the native simplex, on the CPU.

The JAX evaluator builds the slack upper bounds of a round with one row
instead of K, so it raises for every round of K >= 2 nodes; it answers a
single node (K = 1) correctly.  The port's lanes of one K-node round are
held against the JAX evaluator run on each node alone:
- the same `converged` flag;
- dual bounds within 1e-9 relative (torch's f64 arithmetic against
  XLA's: the same algorithm in a different order of operations);
- x within 1e-7 (1 + |x|) where the node LP's optimum is a point (the
  knapsacks).  Set cover's costs tie (integers in 1..100), so its node
  LPs have optimal faces and two IPMs stop at different points of them
  (1.5e-5 apart along two columns of cost 4 at seed 3): there x is held
  to optimality, feasible in the node's box and rows to 1e-7 and with
  c'x within 1e-9 relative of the reference's.
Each certified dual bound is at most the node LP's optimum from the
port's native dual simplex, and whole MIPs under each option that turns
the batch on reach scipy's optimum through batched rounds."""
import numpy as np
import pytest
import torch

import highs_tpu_torch
from highs_tpu.solvers.mip.batch_nodes import \
    BatchNodeEvaluator as JaxEvaluator
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.mip import batch_nodes
from highs_tpu_torch.solvers.mip.batch_nodes import BatchNodeEvaluator
from highs_tpu_torch.solvers.simplex.wrapper import solve_lp_simplex
from highs_tpu_torch.tools.mip_anchors import scipy_milp
from highs_tpu_torch.utils.gen_mip import equality_knapsacks, set_cover
from test_torch_mip import jax_lp, run, torch_lp

torch.set_num_threads(1)

INSTANCES = {
    "knapsacks": lambda: equality_knapsacks(4, 20, 0),
    "setcover": lambda: set_cover(40, 80, 0.1, seed=3),
}
# whether the instance's node LPs have a unique optimum (see above)
UNIQUE_X = {"knapsacks": True, "setcover": False}


def relaxation(d):
    """The model's LP relaxation for both packages."""
    d = dict(d, integrality=np.zeros(d["num_col"], dtype=np.uint8))
    return torch_lp(d), jax_lp(d)


def node_boxes(n, k, seed):
    """K node boxes over n binaries: three columns fixed in each."""
    rng = np.random.default_rng(seed)
    los, ups = np.zeros((k, n)), np.ones((k, n))
    for lane in range(k):
        js = rng.choice(n, 3, replace=False)
        v = rng.integers(0, 2, 3)
        los[lane, js] = v
        ups[lane, js] = v
    return los, ups


def test_reference_fields_raise_and_port_fields_match_lane_by_lane():
    lpt, lpj = relaxation(equality_knapsacks(4, 20, 0))
    los, ups = node_boxes(lpt.num_col, 4, seed=0)
    jax_ev = JaxEvaluator(lpj)
    with pytest.raises(ValueError):
        jax_ev._problem_fields(los[:2], ups[:2])
    port = BatchNodeEvaluator(lpt, device="cpu")._problem_fields(los, ups)
    for lane in range(4):
        ref = jax_ev._problem_fields(los[lane:lane + 1], ups[lane:lane + 1])
        for got, want in zip(port, ref):
            assert got.shape[0] == 4
            np.testing.assert_array_equal(got[lane], want[0])


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_lanes_match_reference_node_by_node(name):
    lpt, lpj = relaxation(INSTANCES[name]())
    los, ups = node_boxes(lpt.num_col, 4, seed=1)
    got = BatchNodeEvaluator(lpt, device="cpu").evaluate(los, ups)
    jax_ev = JaxEvaluator(lpj)
    assert len(got) == 4
    for lane, (conv, bound, x) in enumerate(got):
        want_conv, want_bound, want_x = jax_ev.evaluate(
            los[lane:lane + 1], ups[lane:lane + 1])[0]
        assert conv == want_conv
        if np.isfinite(want_bound):
            assert abs(bound - want_bound) <= 1e-9 * max(1.0,
                                                         abs(want_bound))
        else:
            assert bound == want_bound
        if want_x is None:
            assert x is None
        elif UNIQUE_X[name]:
            np.testing.assert_allclose(x, want_x, rtol=1e-7, atol=1e-7)
        else:
            obj, want_obj = lpt.col_cost @ x, lpt.col_cost @ want_x
            assert abs(obj - want_obj) <= 1e-9 * (1.0 + abs(want_obj))
            ax = lpt.a_matrix.to_scipy() @ x
            assert np.all(ax >= lpt.row_lower - 1e-7)
            assert np.all(ax <= lpt.row_upper + 1e-7)
            assert np.all(x >= los[lane] - 1e-7)
            assert np.all(x <= ups[lane] + 1e-7)
    assert any(lane[0] for lane in got)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_certified_bounds_below_simplex_optimum(name):
    lpt, _ = relaxation(INSTANCES[name]())
    los, ups = node_boxes(lpt.num_col, 6, seed=2)
    got = BatchNodeEvaluator(lpt, device="cpu").evaluate(los, ups)
    certified = 0
    for lane, (conv, bound, x) in enumerate(got):
        node = lpt.copy()
        node.col_lower, node.col_upper = los[lane], ups[lane]
        status, sol, _ = solve_lp_simplex(node, HighsOptions(),
                                          device="cpu")
        if status.name == "kInfeasible":
            continue  # every bound holds for an empty node
        assert status.name == "kOptimal"
        opt = float(node.col_cost @ sol.col_value)
        if np.isfinite(bound):
            certified += 1
            assert bound <= opt + 1e-6 * (1.0 + abs(opt))
        if conv:
            assert abs(float(node.col_cost @ x) - opt) <= \
                1e-6 * (1.0 + abs(opt))
    assert certified > 0


@pytest.mark.parametrize("option,value", [("tpu_mip_batch_nodes", 4),
                                          ("mip_search_simulate_concurrency",
                                           True),
                                          ("parallel", "on")])
def test_batched_mip_matches_jax_and_scipy(option, value):
    # a market-split instance that branches for about a hundred nodes
    d = equality_knapsacks(3, 16, 1)
    rounds = batch_nodes.COUNTS["rounds"]
    got = run("torch", d, **{option: value})
    assert batch_nodes.COUNTS["rounds"] > rounds
    want = run("jax", d, **{option: value})
    _, ref, _, _ = scipy_milp(d)
    assert got.getModelStatus().name == "kOptimal"
    assert abs(got.getObjectiveValue() - want.getObjectiveValue()) <= 1e-6
    assert abs(got.getObjectiveValue() - ref) <= 1e-6


def _model_facade(d):
    h = highs_tpu_torch.Highs(device="cpu")
    h.passModel(torch_lp(d))
    h.setOptionValue("output_flag", False)
    h.setOptionValue("mip_parallel_heuristics", False)
    h.setOptionValue("tpu_mip_batch_nodes", 4)
    return h


def test_device_error_in_the_step_leaves_run(monkeypatch):
    def broken_step(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(batch_nodes, "ipm_step", broken_step)
    h = _model_facade(equality_knapsacks(3, 16, 1))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        h.run()


def test_lane_linalg_error_sends_the_round_to_the_exact_engine(monkeypatch):
    def failing_step(*args, **kwargs):
        raise torch.linalg.LinAlgError("lane factor failed")
    monkeypatch.setattr(batch_nodes, "ipm_step", failing_step)
    d = equality_knapsacks(3, 16, 1)
    before = dict(batch_nodes.COUNTS)
    h = _model_facade(d)
    h.run()
    assert batch_nodes.COUNTS["rounds"] > before["rounds"]
    assert batch_nodes.COUNTS["converged"] == before["converged"]
    _, ref, _, _ = scipy_milp(d)
    assert h.getModelStatus().name == "kOptimal"
    assert abs(h.getObjectiveValue() - ref) <= 1e-6


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lpt, _ = relaxation(equality_knapsacks(3, 8, 0))
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchNodeEvaluator(lpt)
