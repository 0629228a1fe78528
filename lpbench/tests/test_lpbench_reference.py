"""The frozen generators against the port's, fresh instances, and the
reference's judgement of a right and a perturbed answer."""
import numpy as np
import pytest
import scipy.optimize

from lpbench import harness, reference
from lpbench.generators import block_lp, synth_lp


def test_frozen_block_generator_equals_the_ports():
    from highs_tpu_torch.utils.gen_block_lp import gen_block_lp
    for nblocks in (3, 8):
        a, b, c = gen_block_lp(nblocks=nblocks, seed=2024)
        lp = block_lp.generate({"nblocks": nblocks, "block": 128,
                                "seed": 2024, "upper": 10.0})
        assert (lp.a != a).nnz == 0 and lp.a.format == a.format
        np.testing.assert_array_equal(lp.b, b)
        np.testing.assert_array_equal(lp.c, c)


@pytest.mark.parametrize("shape", [(300, 300), (200, 1600), (1000, 700)])
def test_frozen_synth_generator_equals_the_ports(shape):
    from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp
    m, n = shape
    a, b, c = gen_synth_lp(m, n, seed=42)
    lp = synth_lp.generate({"m": m, "n": n, "per_col": 10, "seed": 42,
                            "upper": 10.0})
    assert (lp.a != a).nnz == 0
    np.testing.assert_array_equal(lp.b, b)
    np.testing.assert_array_equal(lp.c, c)


def solve_plain(lp):
    """x, y and the optimum of lp by SciPy's HiGHS (y >= 0 on A x >= b)."""
    res = scipy.optimize.linprog(lp.c, A_ub=-lp.a, b_ub=-lp.b,
                                 bounds=list(zip(np.zeros(len(lp.c)),
                                                 lp.upper)),
                                 method="highs")
    assert res.status == 0
    return res.x, -res.ineqlin.marginals, res.fun


def test_reference_accepts_the_optimum_and_rejects_perturbed_answers():
    lp = synth_lp.generate({"m": 120, "n": 150, "per_col": 10, "seed": 5,
                            "upper": 10.0})
    x, y, obj = solve_plain(lp)
    assert reference.worst(reference.kkt(lp, x, y, obj)) < 1e-9
    x_bad = x.copy()
    x_bad[np.argmax(np.abs(lp.a).sum(axis=0))] += 1e-3
    bad = [(x_bad, y, obj), (x, y * (1 + 1e-5), obj), (x, y, obj + 1e-3),
           (x, np.maximum(y, 0) - 1e-4, obj), (x[:-1], y, obj),
           (np.full_like(x, np.nan), y, obj)]
    for xb, yb, ob in bad:
        assert reference.worst(reference.kkt(lp, xb, yb, ob)) > 1e-7


@pytest.mark.parametrize("gen,params", [
    (block_lp, {"nblocks": 3, "block": 128, "seed": 11, "upper": 10.0}),
    (synth_lp, {"m": 150, "n": 180, "per_col": 10, "seed": 11,
                "upper": 10.0})])
def test_fresh_instance_is_new_data_with_the_same_optimum(gen, params):
    base = gen.generate(params)
    one = gen.fresh(base, params, np.random.default_rng([7, 0]))
    two = gen.fresh(base, params, np.random.default_rng([7, 1]))
    again = gen.fresh(base, params, np.random.default_rng([7, 0]))
    assert (one.a != again.a).nnz == 0
    assert (one.a != two.a).nnz > 0 and (one.a != base.a).nnz > 0
    assert gen.stats(one, params) == gen.stats(base, params)
    _, _, f0 = solve_plain(base)
    _, _, f1 = solve_plain(one)
    assert f1 == pytest.approx(f0, rel=1e-9)


def test_block_fresh_keeps_every_tile_in_place():
    params = {"nblocks": 4, "block": 128, "seed": 3, "upper": 10.0}
    base = block_lp.generate(params)
    one = block_lp.fresh(base, params, np.random.default_rng([1, 2]))
    tiles = lambda a: {(i // 128, j // 128) for i, j in zip(*a.nonzero())}
    assert tiles(one.a) == tiles(base.a)
    assert one.a.nnz == base.a.nnz == 10 * 128 * 128


def test_calls_are_drawn_from_seed_and_index():
    cell = harness.load_cell("synth_lp.batch16")
    cell.traffic["members"] = [{"m": 60 + j, "n": 60 + j, "seed": j}
                               for j in range(4)]
    bases = harness.Bases(cell)
    params = cell.members(cell.traffic)
    big = 2 ** 31 + 977
    first = [lp for lp, _ in harness.fresh_call(cell, bases, big, 0)]
    assert [lp.a.shape for lp in first] != [bases.get(p).a.shape
                                            for p in params] or \
        any((x.a != bases.get(p).a).nnz for x, p in zip(first, params))
    same = [lp for lp, _ in harness.fresh_call(cell, bases, big, 0)]
    assert all((x.a != y.a).nnz == 0 for x, y in zip(first, same))
    other = [lp for lp, _ in harness.fresh_call(cell, bases, big, 1)]
    assert any(x.a.shape != y.a.shape or (x.a != y.a).nnz
               for x, y in zip(first, other))
    assert sorted(lp.a.shape for lp in first) == \
        sorted(bases.get(p).a.shape for p in params)


def test_every_run_draws_its_pool_in_turn():
    cell = harness.load_cell("synth_lp.solve50k")
    cell.traffic["members"] = [{"m": 40, "n": 40, "seeds": [5, 6, 7]}]
    bases = harness.Bases(cell)
    bases.make_all()
    assert len(bases.made) == 3

    def drawn(seed, calls):
        return [p["seed"] for i in range(calls)
                for _, p in harness.fresh_call(cell, bases, seed, i)]
    one, two = drawn(2 ** 33 + 1, 6), drawn(17, 6)
    # each run takes the pool in turn from a start drawn from its seed:
    # every three calls the whole pool, whatever the seed
    for run in (one, two):
        assert sorted(run[:3]) == sorted(run[3:]) == [5, 6, 7]
        assert run[:3] == run[3:]
    assert drawn(2 ** 33 + 1, 6) == one
    assert len({tuple(drawn(s, 3)) for s in range(20)}) == 3
    # the same base in two calls reaches the solver as new data
    lp0, _ = harness.fresh_call(cell, bases, 17, 0)[0]
    lp3, _ = harness.fresh_call(cell, bases, 17, 3)[0]
    assert (lp0.a != lp3.a).nnz > 0


@pytest.mark.parametrize("name", ["synth_lp.solve50k", "block_lp.solve64k"])
def test_reference_gap_is_the_ports_own(tiny_cell, name):
    # the reference works the gap out again in the original space; for
    # PDLP it equals the gap the port's own stopping test measured
    # (`getInfo().primal_dual_objective_error`), which stops at the
    # tolerance: a reading above the limit is the port's, not noise of
    # the reference
    import torch
    cell = tiny_cell(name)
    bases = harness.Bases(cell)
    run = harness.Run()
    harness.window(cell, run, bases, 2 ** 31 + 3, 0.0, False,
                   torch.device("cpu"), lambda msg: None)
    harness.judge(cell, run, bases, 2 ** 31 + 3, lambda msg: None)
    (rec,) = run.calls
    (judged,) = run.judged
    port = rec["api"]["info"].primal_dual_objective_error
    assert judged["rel_gap"] == pytest.approx(port, rel=1e-6, abs=1e-15)
    assert judged["rel_gap"] <= cell.config["kkt_tolerance"]
