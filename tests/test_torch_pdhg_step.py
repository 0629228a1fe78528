"""The PDHG step's two kernels and the graph block runner.

- `ops/pdhg_step.py`: the plain chains `primal_step_plain` and
  `dual_step_plain`, composed with the two products into a step, against
  the JAX package's `_halpern_step` and `_avg_pdhg_step` on the same
  inputs (f64: 1e-12, f32: 1e-6, relative to the largest entry).
- `solvers/pdlp/graph.py`: `solve_pdhg` through the block runner with the
  eager recorder (each replay runs the captured function again and
  copies its outputs into the first call's, as a graph refreshes its
  static outputs) equal bit for bit to the plain loop, and the launch
  counters multiplied by the replays.
- `launch_geometry`: every element covered once by the vector body and
  the scalar tail, in one wave at the PDLP widths; the wrappers refuse a
  vector that does not start on a 16-byte boundary.
- On a card: the kernels against the plain chains (bit for bit) at the
  PDLP widths and off the vector grid, the offset view refused, and
  captured windows against the eager ones (the `cuda_device` fixture
  skips these elsewhere).
"""
import inspect
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from highs_tpu.ops import linops as jlin
from highs_tpu.solvers.pdlp import pdhg as jp
from highs_tpu_torch.convert import (linop_from_numpy,
                                     pdhg_batch_problem_from_numpy,
                                     pdhg_batch_state_from_numpy,
                                     pdhg_problem_from_numpy,
                                     pdhg_state_from_numpy,
                                     restart_ctl_from_numpy)
from highs_tpu_torch.ops import block_csr, pdhg_step
from highs_tpu_torch.ops.linops import DenseMatrix
from highs_tpu_torch.parallel import dryrun, shard_ops
from highs_tpu_torch.parallel.dryrun import dryrun_multichip
from highs_tpu_torch.parallel.mesh import make_mesh
from highs_tpu_torch.solvers.capture import eager_recorder, read_counts
from highs_tpu_torch.solvers.pdlp import batch, graph
from highs_tpu_torch.solvers.pdlp import pdhg as tp
from highs_tpu_torch.tools import step_bench, step_turns

torch.set_num_threads(1)

M, N, NEQ = 48, 80, 12
TOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _arrays(seed, infinite, with_y_lo, dtype=np.float64, m=M, n=N):
    """A standard-form problem K x >= b (NEQ equality rows) with mixed
    bounds, as numpy arrays; infinite bounds as +-inf or as the huge
    finite values the PDLP wrapper puts in their place."""
    rng = np.random.default_rng(seed)
    k = sp.random(m, n, density=0.1, random_state=rng, format="csr")
    b = k @ rng.uniform(0.0, 1.0, n)
    b[NEQ:] -= np.abs(rng.standard_normal(m - NEQ)) * 0.1
    c = rng.uniform(-0.5, 1.0, n)
    lo_fin = (rng.uniform(size=n) < 0.8).astype(np.float64)
    up_fin = (rng.uniform(size=n) < 0.6).astype(np.float64)
    big = np.inf if infinite else np.finfo(dtype).max / 4
    arrays = dict(
        b=b, c=c, lo=np.where(lo_fin > 0, 0.0, -big),
        up=np.where(up_fin > 0, rng.uniform(1.0, 5.0, n), big),
        is_eq=(np.arange(m) < NEQ).astype(np.float64),
        lo_fin=lo_fin, up_fin=up_fin,
        inv_row_scale=rng.uniform(0.5, 2.0, m),
        inv_col_scale=rng.uniform(0.5, 2.0, n),
        norm_b=np.asarray(np.linalg.norm(b)),
        norm_c=np.asarray(np.linalg.norm(c)))
    if with_y_lo:
        arrays["y_lo"] = np.where(arrays["is_eq"] > 0, 0.0,
                                  -rng.uniform(0.0, 0.5, m))
    return k, {name: v.astype(dtype) for name, v in arrays.items()}


def _problems(fmt, seed=0, infinite=False, with_y_lo=False,
              dtype=np.float64):
    k, arrays = _arrays(seed, infinite, with_y_lo, dtype)
    jop = jlin.from_scipy(k, fmt=fmt, dtype=jnp.dtype(dtype))
    jprob = jp.PdhgProblem(k_op=jop, **{
        name: jnp.asarray(v) for name, v in arrays.items()})
    top = linop_from_numpy({f: np.asarray(getattr(jop, f))
                            for f in jop._fields}, device="cpu")
    tprob = pdhg_problem_from_numpy(dict(arrays, k_op=top), device="cpu")
    return jprob, tprob


def _state_arrays(lo, up, is_eq, rmv, k, seed=1, dtype=np.float64):
    """A PDHG state as numpy arrays: iterates inside the bounds and the
    dual cone, K'y from `rmv`."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    up = np.asarray(up, np.float64)
    is_eq = np.asarray(is_eq) > 0

    def xs():
        return np.clip(rng.standard_normal(lo.shape[0]), lo, up)

    def ys():
        y = rng.standard_normal(is_eq.shape[0])
        return np.where(is_eq, y, np.abs(y))
    y = ys().astype(dtype)
    s = dict(x=xs(), y=y, x_pd=xs(), y_pd=ys(), x_anchor=xs(),
             y_anchor=ys(), aty=rmv(y), eta=np.asarray(0.4),
             omega=np.asarray(0.7))
    s = {name: np.asarray(v).astype(dtype) for name, v in s.items()}
    s["k"] = np.asarray(k, np.int32)
    return s


def _states(jprob, k, seed=1, dtype=np.float64):
    s = _state_arrays(jprob.lo, jprob.up, jprob.is_eq,
                      lambda y: np.asarray(jprob.k_op.rmv(jnp.asarray(y))),
                      k, seed, dtype)
    jstate = jp.PdhgState(**{name: jnp.asarray(v) for name, v in s.items()})
    return jstate, pdhg_state_from_numpy(s, device="cpu")


def _port_step(prob, state, gamma, mode):
    """One step from the plain chains and the operator's products, as
    `pdhg._pdhg_step` composes them."""
    x_pd, x_r, x_out = pdhg_step.primal_step_plain(
        state.x, prob.c, state.aty, prob.lo, prob.up, state.x_anchor,
        state.eta, state.omega, state.k, gamma, mode)
    y_pd, y_out, k_next = pdhg_step.dual_step_plain(
        state.y, prob.b, prob.k_op.mv(x_r), prob.is_eq, prob.y_lo,
        state.y_anchor, state.eta, state.omega, state.k, gamma, mode)
    if mode == "halpern":
        return state._replace(x=x_out, y=y_out, x_pd=x_pd, y_pd=y_pd,
                              aty=prob.k_op.rmv(y_out), k=k_next)
    return state._replace(x=x_pd, y=y_pd, x_pd=x_pd, y_pd=y_pd,
                          x_anchor=x_out, y_anchor=y_out,
                          aty=prob.k_op.rmv(y_pd), k=k_next)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [0, 37])
@pytest.mark.parametrize("infinite", [False, True])
@pytest.mark.parametrize("with_y_lo", [False, True])
@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("mode,gamma", [("halpern", 1.0), ("halpern", 0.9),
                                        ("average", 1.0)])
def test_plain_step_equals_jax(mode, gamma, fmt, with_y_lo, infinite, k,
                               dtype):
    jprob, tprob = _problems(fmt, infinite=infinite, with_y_lo=with_y_lo,
                             dtype=dtype)
    jstate, tstate = _states(jprob, k, dtype=dtype)
    got = _port_step(tprob, tstate, gamma, mode)
    want = (jp._halpern_step(jprob, jstate, gamma) if mode == "halpern"
            else jp._avg_pdhg_step(jprob, jstate))
    for name in jp.PdhgState._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        scale = max(float(np.max(np.abs(w.astype(np.float64)))), 1e-300)
        err = float(np.max(np.abs(g.astype(np.float64) -
                                  w.astype(np.float64))))
        assert err <= TOL[dtype] * scale, (name, err, scale)


def test_wrappers_take_the_plain_chains_on_the_cpu():
    _, tprob = _problems("dense", seed=2, with_y_lo=True)
    jstate, tstate = _states(_problems("dense", seed=2)[0], 5, seed=3)
    args = (tstate.x, tprob.c, tstate.aty, tprob.lo, tprob.up,
            tstate.x_anchor, tstate.eta, tstate.omega, tstate.k, 0.9)
    before = dict(pdhg_step.LAUNCHES)
    for mode in pdhg_step.MODES:
        for got, want in zip(pdhg_step.primal_step(*args, mode),
                             pdhg_step.primal_step_plain(*args, mode)):
            assert torch.equal(got, want)
        dargs = (tstate.y, tprob.b, tstate.y_pd, tprob.is_eq, tprob.y_lo,
                 tstate.y_anchor, tstate.eta, tstate.omega, tstate.k, 0.9,
                 mode)
        for got, want in zip(pdhg_step.dual_step(*dargs),
                             pdhg_step.dual_step_plain(*dargs)):
            assert torch.equal(got, want)
    assert pdhg_step.LAUNCHES == before


def test_wrappers_check_their_inputs():
    x = torch.zeros(4, dtype=torch.float64)
    s = torch.tensor(1.0, dtype=torch.float64)
    k = torch.tensor(0, dtype=torch.int32)
    ok = (x, x, x, x, x, x, s, s, k, 1.0)
    with pytest.raises(ValueError, match="mode"):
        pdhg_step.primal_step(*ok, "fast")
    with pytest.raises(ValueError, match="shape"):
        pdhg_step.primal_step(x, torch.zeros(5, dtype=torch.float64),
                              *ok[2:], "halpern")
    with pytest.raises(TypeError):
        pdhg_step.primal_step(*ok[:6], s.float(), s, k, 1.0, "halpern")
    with pytest.raises(TypeError, match="int32"):
        pdhg_step.dual_step(x, x, x, x, None, x, s, s, k.long(), 1.0,
                            "average")
    with pytest.raises(TypeError, match="float32 or float64"):
        pdhg_step.dual_step(*(x.half(),) * 4, None, x.half(), s, s, k, 1.0,
                            "average")


def _covered(g, n, itemsize):
    """How often a launch of geometry g touches each index of range(n),
    by the kernels' index arithmetic: thread t takes the 16-byte vectors
    t + j * grid * threads (j < per_thread) below g.vectors, and threads
    below g.tail the element g.vectors * width + t."""
    width = 16 // itemsize
    stride = g.grid * g.threads
    t = np.arange(stride)
    touched = [g.vectors * width + t[t < g.tail]]
    for j in range(g.per_thread):
        v = t + j * stride
        v = v[v < g.vectors]
        touched += [v * width + e for e in range(width)]
    # an index at or past n lengthens the count, and fails the comparison
    return np.bincount(np.concatenate(touched), minlength=n)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 127, 128, 50176, 65536, 65537])
def test_launch_geometry_covers_each_element_once(n, itemsize):
    sms = 132  # the H100's
    g = pdhg_step.launch_geometry(n, itemsize, sms)
    assert np.array_equal(_covered(g, n, itemsize), np.ones(n, np.int64))
    assert g.grid <= sms  # one wave: at most one block an SM
    assert g.threads % 32 == 0 and 32 <= g.threads <= pdhg_step.MAX_THREADS
    assert g.per_thread in (1, 2)
    assert g.tail < 16 // itemsize <= g.threads


@pytest.mark.parametrize("n,itemsize,sms", [(2_000_003, 4, 132),
                                            (1_000_001, 8, 132),
                                            (65536, 4, 1), (50177, 8, 7)])
def test_launch_geometry_beyond_one_wave(n, itemsize, sms):
    """A body of more than two vectors a thread in blocks of MAX_THREADS
    on every SM takes more blocks, each element still once."""
    g = pdhg_step.launch_geometry(n, itemsize, sms)
    assert np.array_equal(_covered(g, n, itemsize), np.ones(n, np.int64))
    assert g.grid > sms and g.per_thread == 2
    assert g.threads == pdhg_step.MAX_THREADS


def test_launch_geometry_refuses_other_item_sizes():
    with pytest.raises(ValueError, match="item size"):
        pdhg_step.launch_geometry(64, 2, 132)


def test_step_bench_records_on_the_cpu():
    """`step_kernel_records` without times at widths off the vector grid:
    on the CPU the wrappers take the plain chains, so every record is
    equal, and the records cover both kernels in every variant."""
    records = step_bench.step_kernel_records(
        torch.device("cpu"), {"odd": 67, "grid": 64}, timed=False)
    assert all(r["ok"] and r["equal_bits"] for r in records)
    # per width, dtype and mode: primal once, dual with and without y_lo
    assert len(records) == 2 * 2 * 2 * 3
    assert {(r["name"], r["y_lo"]) for r in records} == {
        ("pdhg_primal_step", False), ("pdhg_dual_step", False),
        ("pdhg_dual_step", True)}


def test_step_turns_summary_reads_both_trees():
    """A run with the profile's kernel groups (`by_kernel`) and one from
    a tree whose profile has only its top kernels give the same groups."""
    kernels = {"primal_kernel<float>": {"device_ms_per_step": 0.002},
               "dual_kernel<float>": {"device_ms_per_step": 0.0015},
               "onehot_spmv_kernel": {"device_ms_per_step": 0.011}}
    from highs_tpu_torch.tools.profile_block64k import kernel_groups
    cell = dict(wall_ms_per_step=0.02, device_ms_per_step=0.019,
                device_busy_share=0.95, top_kernels=kernels)
    new = dict(cell, by_kernel=kernel_groups(kernels, 0.019))
    rec = dict(name="pdhg_dual_step", path="synth50k", dtype="float32",
               mode="halpern", y_lo=False, bound_ms=0.0004, ms=0.003,
               call_ms=0.01, plain_ms=0.03)
    out = step_turns.summary([
        ("parent", {"cells": {"synth50k": cell}, "kernels": [rec]}),
        ("change", {"cells": {"synth50k": new}, "kernels": [rec]})])
    parent, change = (out["cells"]["synth50k"][t] for t in ("parent",
                                                           "change"))
    assert parent == change
    assert parent["pdhg_primal_step"] == [0.002]
    assert parent["product"] == [0.011]
    assert parent["rest"] == [pytest.approx(0.019 - 0.0145)]
    key = "pdhg_dual_step synth50k float32 halpern"
    assert out["kernels"][key]["parent ms"] == [0.003]
    assert out["kernels"][key]["change plain_ms"] == [0.03]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper does with
    a CUDA tensor, on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrappers_raise_on_a_cuda_tensor_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    x = torch.zeros(4, dtype=torch.float64).as_subclass(_OnCard)
    s = torch.tensor(1.0, dtype=torch.float64).as_subclass(_OnCard)
    k = torch.tensor(0, dtype=torch.int32).as_subclass(_OnCard)
    before = dict(pdhg_step.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        pdhg_step.primal_step(x, x, x, x, x, x, s, s, k, 1.0, "halpern")
    with pytest.raises(RuntimeError, match="nvcc"):
        pdhg_step.dual_step(x, x, x, x, None, x, s, s, k, 1.0, "average")
    assert pdhg_step.LAUNCHES == before


def test_wrappers_refuse_a_vector_off_16_bytes():
    """On a card every vector must start on a 16-byte boundary; a view
    offset by one element is refused before any library is loaded."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")

    def on_card(t):
        return t.as_subclass(_OnCard)
    x = on_card(torch.zeros(4, dtype=torch.float64))
    off = on_card(torch.zeros(5, dtype=torch.float64)[1:])
    s = on_card(torch.tensor(1.0, dtype=torch.float64))
    k = on_card(torch.tensor(0, dtype=torch.int32))
    before = dict(pdhg_step.LAUNCHES)
    for args in ((off, x, x, x, x, x), (x, x, x, x, x, off)):
        with pytest.raises(ValueError, match="16-byte"):
            pdhg_step.primal_step(*args, s, s, k, 1.0, "halpern")
    for y, y_lo in ((off, None), (x, off)):
        with pytest.raises(ValueError, match="16-byte"):
            pdhg_step.dual_step(y, x, x, x, y_lo, x, s, s, k, 1.0,
                                "average")
    assert pdhg_step.LAUNCHES == before


# --- the block runner --------------------------------------------------

def _solve_problem(seed=11):
    _, tprob = _problems("dense", seed=seed)
    return tprob


def _solve_both(tmp_path, settings, prob=None):
    """solve_pdhg as the plain loop and through the runner with the
    eager recorder; a checkpoint file in `settings` is copied so that
    both runs resume from the same one."""
    prob = _solve_problem() if prob is None else prob
    out = []
    for name, capture in (("plain", None), ("graph", eager_recorder)):
        s = dict(settings)
        if s.get("checkpoint_file"):
            path = str(tmp_path / f"{name}.npz")
            shutil.copy(s["checkpoint_file"], path)
            s["checkpoint_file"] = path
        graph.COUNTS.clear()
        out.append((tp.solve_pdhg(prob, N, M, tp.PdhgSettings(**s),
                                  capture=capture), dict(graph.COUNTS)))
    return out


def _assert_same(plain, graphed):
    assert graphed.status == plain.status
    assert graphed.iterations == plain.iterations
    assert graphed.restarts == plain.restarts
    for name in ("x", "y", "z"):
        assert np.array_equal(getattr(graphed, name), getattr(plain, name)), \
            name
    assert graphed.primal_obj == plain.primal_obj
    assert graphed.dual_res == plain.dual_res


RUNNER_CASES = {
    "halpern_device_restarts": dict(),
    "host_restarts": dict(device_restarts=False),
    "average": dict(mode="average"),
    "adaptive_step": dict(step_size_strategy="adaptive"),
    "average_adaptive": dict(mode="average",
                             step_size_strategy="adaptive"),
    "bf16_exit": dict(step_dtype="bfloat16", step_dtype_switch_tol=0.05),
    # full-size blocks of 2,560 steps in chunks of 50: 51 chunks and a
    # remainder of 10, each its own graph
    "uneven_chunks": dict(device_restarts=False, check_interval=50,
                          ramp_start=24),
}


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_equals_plain_loop(tmp_path, case):
    settings = dict(eps_optimal=1e-6, iteration_limit=3000,
                    **RUNNER_CASES[case])
    (plain, plain_counts), (graphed, counts) = _solve_both(tmp_path,
                                                           settings)
    _assert_same(plain, graphed)
    assert plain_counts == {}  # the plain loop replays nothing
    assert counts["metrics"] >= 2 and counts["replays"] > counts["metrics"]
    if case == "bf16_exit":
        # the bf16 window and the full-precision one after the exit
        assert counts["captures"] == 3
    if case == "uneven_chunks":
        assert counts["captures"] == 3 and plain.iterations % 2560 == 0


def _tiny_problem(m, n, seed):
    """A tiny equality LP, on whose few directions the block's movement
    and K-interaction are close, so that the adaptive step size moves."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.5, 1.5, (m, n))
    b = k @ rng.uniform(0.0, 1.0, n)
    c = rng.uniform(0.1, 1.0, n)
    arrays = dict(b=b, c=c, lo=np.zeros(n), up=np.full(n, 5.0),
                  is_eq=np.ones(m), lo_fin=np.ones(n), up_fin=np.ones(n),
                  inv_row_scale=np.ones(m), inv_col_scale=np.ones(n),
                  norm_b=np.asarray(np.linalg.norm(b)),
                  norm_c=np.asarray(np.linalg.norm(c)))
    return pdhg_problem_from_numpy(
        dict(arrays, k_op=DenseMatrix(torch.as_tensor(k))), device="cpu")


@pytest.mark.parametrize("mode", ["halpern", "average"])
@pytest.mark.parametrize("m,n,seed", [(1, 2, 2), (2, 3, 2)])
def test_runner_keeps_the_previous_iterates(m, n, seed, mode):
    """The adaptive step size compares the iterate with the one the
    previous block ended at: that one must survive the replays."""
    prob = _tiny_problem(m, n, seed)
    settings = tp.PdhgSettings(eps_optimal=1e-8, iteration_limit=3000,
                               step_size_strategy="adaptive", mode=mode)
    plain = tp.solve_pdhg(prob, n, m, settings)
    graphed = tp.solve_pdhg(prob, n, m, settings,
                            capture=eager_recorder)
    _assert_same(plain, graphed)


def test_runner_resumes_a_checkpoint(tmp_path):
    first = str(tmp_path / "first.npz")
    tp.solve_pdhg(_solve_problem(), N, M, tp.PdhgSettings(
        eps_optimal=1e-6, iteration_limit=200, checkpoint_file=first,
        checkpoint_interval=1))
    saved = int(np.load(first)["total_iters"])
    assert saved >= 200
    for mode in ("halpern", "average"):
        (plain, _), (graphed, _) = _solve_both(tmp_path, dict(
            eps_optimal=1e-6, iteration_limit=3000, checkpoint_file=first,
            checkpoint_interval=1, mode=mode))
        _assert_same(plain, graphed)
        assert plain.iterations > saved


class _CountingDense(DenseMatrix):
    """A dense operator that counts each product as a block-CSR launch,
    as a kernel's wrapper does on a card."""

    def mv(self, x):
        block_csr.LAUNCHES += 1
        return super().mv(x)

    def rmv(self, y):
        block_csr.LAUNCHES += 1
        return super().rmv(y)


def _counting_step_kernels(monkeypatch):
    """The step wrappers count a launch per call, as on a card."""
    primal, dual = pdhg_step.primal_step, pdhg_step.dual_step

    def counted(fn, name):
        def run(*args):
            pdhg_step.LAUNCHES[name] += 1
            return fn(*args)
        return run
    monkeypatch.setattr(pdhg_step, "primal_step",
                        counted(primal, "pdhg_primal_step"))
    monkeypatch.setattr(pdhg_step, "dual_step",
                        counted(dual, "pdhg_dual_step"))


@pytest.mark.parametrize("mode", ["halpern", "average"])
def test_launch_counts_follow_the_replays(tmp_path, monkeypatch, mode):
    _counting_step_kernels(monkeypatch)
    prob = _solve_problem()
    prob = prob._replace(k_op=_CountingDense(prob.k_op.a))
    counts = []
    for capture in (None, eager_recorder):
        start = read_counts()
        res = tp.solve_pdhg(prob, N, M, tp.PdhgSettings(
            eps_optimal=1e-6, iteration_limit=2000, mode=mode),
            capture=capture)
        end = read_counts()
        counts.append({k: end[k] - start[k] for k in end})
    plain, graphed = counts
    assert graphed == plain
    # two step launches and at least two products per iteration
    assert plain["pdhg_primal_step"] == plain["pdhg_dual_step"] == \
        res.iterations
    assert plain["block_csr_spmv"] >= 2 * res.iterations


def test_runner_counts_each_replay_once(monkeypatch):
    """Three window replays add three times one window's launches; the
    capture's own run adds nothing."""
    _counting_step_kernels(monkeypatch)
    jprob, _ = _problems("dense", seed=4)
    _, state = _states(jprob, 0, seed=5)
    prob = _solve_problem(seed=4)
    ctl = restart_ctl_from_numpy(dict(
        fpe_init=np.asarray(np.inf), fpe_last=np.asarray(np.inf),
        fresh=np.asarray(True), total_k=np.asarray(0, np.int32),
        n_restarts=np.asarray(0, np.int32)), device="cpu")
    theta = torch.tensor(0.0, dtype=torch.float64)
    runner = graph.GraphBlocks(prob, 40, eager_recorder)
    start = read_counts()
    st, c, metrics = runner.windows(state, ctl, 3, 1.0, 40, theta, None)
    end = read_counts()
    assert end["pdhg_primal_step"] - start["pdhg_primal_step"] == 3 * 40
    assert end["pdhg_dual_step"] - start["pdhg_dual_step"] == 3 * 40
    # and the same state, restart control and metrics as the plain block
    ws, wc, wm = tp.pdhg_block_windows(prob, state, ctl, 3, 1.0, 40, theta)
    for got, want in zip((*st, *c, *metrics), (*ws, *wc, *wm)):
        assert torch.equal(got, want)
    runner.close()
    assert runner.graphs == {}


def test_shard_reductions_follow_the_replays():
    """K split by rows over two views of the CPU (`solve_pdhg`'s mesh):
    the runner's sums of partials equal the plain loop's, and so does
    the solve."""
    prob = _solve_problem(seed=6)
    mesh = make_mesh((2,), devices=[torch.device("cpu")] * 2)
    runs = []
    for capture in (None, eager_recorder):
        before = shard_ops.REDUCTIONS
        res = tp.solve_pdhg(prob, N, M, tp.PdhgSettings(
            eps_optimal=1e-6, iteration_limit=1000), mesh=mesh,
            capture=capture)
        runs.append((res, shard_ops.REDUCTIONS - before))
    (plain, red_plain), (graphed, red_graph) = runs
    _assert_same(plain, graphed)
    assert red_graph == red_plain >= plain.iterations


def test_vmapped_callers_take_the_plain_chains(monkeypatch):
    """Under `torch.func.vmap` (the batch, the multi-device dry run) a
    step reaches the step operators, whose vmap rule makes one batched
    call: on the CPU the plain chains run there on the (b, n) rows,
    never on a batched tensor (on a card the rule launches the kernels),
    and neither caller names a plain chain itself."""
    seen = []

    def watching(fn):
        def run(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and
                   torch._C._functorch.is_batchedtensor(a) for a in args):
                raise AssertionError("a plain chain under vmap")
            seen.append(args[0].dim())
            return fn(*args, **kwargs)
        return run
    monkeypatch.setattr(pdhg_step, "primal_step_plain",
                        watching(pdhg_step.primal_step_plain))
    monkeypatch.setattr(pdhg_step, "dual_step_plain",
                        watching(pdhg_step.dual_step_plain))
    dryrun_multichip(2, devices=[torch.device("cpu")] * 2)
    # its vmapped layout's steps come as rows (its others are unbatched)
    assert 2 in seen
    seen.clear()
    probs, states = [], []
    for i in range(2):
        k, arrays = _arrays(20 + i, False, False)
        probs.append(dict(arrays, a=k.toarray()))
        states.append(_state_arrays(arrays["lo"], arrays["up"],
                                    arrays["is_eq"], lambda y: k.T @ y, 0,
                                    30 + i))
    ctl = dict(fpe_init=np.full(2, np.inf), fpe_last=np.full(2, np.inf),
               fresh=np.ones(2, bool), total_k=np.zeros(2, np.int32),
               n_restarts=np.zeros(2, np.int32))
    _, tc, _ = batch.batched_pdhg_windows(
        pdhg_batch_problem_from_numpy(probs, device="cpu"),
        pdhg_batch_state_from_numpy(states, device="cpu"),
        restart_ctl_from_numpy(ctl, device="cpu"), 2, 1.0, 10,
        torch.tensor(0.0, dtype=torch.float64))
    assert tc.total_k.tolist() == [20, 20]
    # one call a half-step, on the batch's rows
    assert seen and set(seen) == {2}
    for module in (batch, dryrun, tp):
        source = inspect.getsource(module)
        assert "primal_step_plain" not in source
        assert "dual_step_plain" not in source


def test_graphs_only_on_one_card():
    """The CPU runs the plain loop; the graph rule needs a CUDA loop."""
    prob = _solve_problem()
    assert not graph.on_one_card(prob, torch.device("cpu"))
    graph.COUNTS.clear()
    tp.solve_pdhg(prob, N, M, tp.PdhgSettings(eps_optimal=1e-4))
    assert dict(graph.COUNTS) == {}


# --- on a card ----------------------------------------------------------

def _card_problem(device, seed, dtype=np.float64, infinite=False,
                  with_y_lo=False):
    """The problem and a state on the card, from numpy alone."""
    k, arrays = _arrays(seed, infinite, with_y_lo, dtype)
    kd = k.toarray().astype(dtype)
    prob = pdhg_problem_from_numpy(dict(
        arrays, k_op=DenseMatrix(torch.as_tensor(kd, device=device))),
        device=device)
    state = pdhg_state_from_numpy(_state_arrays(
        arrays["lo"], arrays["up"], arrays["is_eq"], lambda y: kd.T @ y, 37,
        seed + 1, dtype), device=device)
    return prob, state


@pytest.mark.parametrize("with_y_lo", [False, True])
@pytest.mark.parametrize("mode", ["halpern", "average"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernels_equal_plain_on_card(cuda_device, dtype, mode, with_y_lo):
    p, s = _card_problem(cuda_device, 7, dtype, True, with_y_lo)
    for gamma in (1.0, 0.9):
        args = (s.x, p.c, s.aty, p.lo, p.up, s.x_anchor, s.eta, s.omega,
                s.k, gamma, mode)
        got = pdhg_step.primal_step(*args)
        want = pdhg_step.primal_step_plain(*args)
        dargs = (s.y, p.b, s.y_pd, p.is_eq, p.y_lo, s.y_anchor, s.eta,
                 s.omega, s.k, gamma, mode)
        got += pdhg_step.dual_step(*dargs)
        want += pdhg_step.dual_step_plain(*dargs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _bits(t):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


@pytest.mark.parametrize("n", [1, 3, 5, 127, 65537])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_equal_plain_at_odd_widths_on_card(cuda_device, dtype, n):
    """Widths off the 16-byte grid: the scalar tail and the vector body
    together, bit for bit."""
    rng = np.random.default_rng(n)

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=cuda_device)
    lo = np.where(rng.uniform(size=n) < 0.8, 0.0, -np.inf)
    up = np.where(rng.uniform(size=n) < 0.6, rng.uniform(1, 5, n), np.inf)
    vec = rng.standard_normal
    eta, omega, k = t(0.0123), t(1.7), t(37, torch.int32)
    for mode in pdhg_step.MODES:
        p_args = (t(np.clip(vec(n), lo, up)), t(vec(n)), t(vec(n)), t(lo),
                  t(up), t(vec(n)), eta, omega, k, 0.9, mode)
        got = pdhg_step.primal_step(*p_args)
        want = pdhg_step.primal_step_plain(*p_args)
        for y_lo in (None, t(-rng.uniform(0, 0.5, n))):
            d_args = (t(vec(n)), t(vec(n)), t(vec(n)),
                      t((rng.uniform(size=n) < 0.25).astype(np.float64)),
                      y_lo, t(vec(n)), eta, omega, k, 0.9, mode)
            got += pdhg_step.dual_step(*d_args)
            want += pdhg_step.dual_step_plain(*d_args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


def test_offset_view_refused_on_card(cuda_device):
    x = torch.zeros(65, dtype=torch.float64, device=cuda_device)
    s = torch.tensor(1.0, dtype=torch.float64, device=cuda_device)
    k = torch.tensor(0, dtype=torch.int32, device=cuda_device)
    a = x[:64]
    before = dict(pdhg_step.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        pdhg_step.primal_step(x[1:], a, a, a, a, a, s, s, k, 1.0, "halpern")
    with pytest.raises(ValueError, match="16-byte"):
        pdhg_step.dual_step(x[1:], a, a, a, None, a, s, s, k, 1.0,
                            "halpern")
    assert pdhg_step.LAUNCHES == before


@pytest.mark.parametrize("mode", ["halpern", "average"])
def test_graph_window_at_odd_widths_on_card(cuda_device, mode):
    """One captured 40-step window (or average chunk) at widths off the
    16-byte grid, the step kernels' scalar tails included, against the
    eager steps bit for bit."""
    k, arrays = _arrays(13, False, True, m=47, n=83)
    kd = k.toarray()
    prob = pdhg_problem_from_numpy(dict(
        arrays, k_op=DenseMatrix(torch.as_tensor(kd, device=cuda_device))),
        device=cuda_device)
    state = pdhg_state_from_numpy(_state_arrays(
        arrays["lo"], arrays["up"], arrays["is_eq"], lambda y: kd.T @ y, 0,
        14), device=cuda_device)
    runner = graph.GraphBlocks(prob, 40)
    if mode == "halpern":
        ctl = restart_ctl_from_numpy(dict(
            fpe_init=np.asarray(np.inf), fpe_last=np.asarray(np.inf),
            fresh=np.asarray(True), total_k=np.asarray(0, np.int32),
            n_restarts=np.asarray(0, np.int32)), device=cuda_device)
        theta = torch.tensor(0.5, dtype=torch.float64, device=cuda_device)
        got = runner.windows(state, ctl, 1, 1.0, 40, theta, None)
        want = tp.pdhg_block_windows(prob, state, ctl, 1, 1.0, 40, theta)
    else:
        got = runner.block_avg(state, 40, None)
        want = tp.pdhg_block_avg(prob, state, 40, None)
    torch.cuda.synchronize()
    flat = [t for part in got for t in (part if isinstance(part, tuple)
                                        else (part,))]
    flat_want = [t for part in want for t in (part if isinstance(
        part, tuple) else (part,))]
    assert len(flat) == len(flat_want)
    for g, w in zip(flat, flat_want):
        assert torch.equal(_bits(g), _bits(w))
    runner.close()


def test_graph_window_equals_eager_on_card(cuda_device, monkeypatch):
    prob, state = _card_problem(cuda_device, 9)
    state = state._replace(k=torch.zeros_like(state.k))
    ctl = restart_ctl_from_numpy(dict(
        fpe_init=np.asarray(np.inf), fpe_last=np.asarray(np.inf),
        fresh=np.asarray(True), total_k=np.asarray(0, np.int32),
        n_restarts=np.asarray(0, np.int32)), device=cuda_device)
    theta = torch.tensor(0.5, dtype=torch.float64, device=cuda_device)
    runner = graph.GraphBlocks(prob, 40)
    got = runner.windows(state, ctl, 4, 1.0, 40, theta, None)
    want = tp.pdhg_block_windows(prob, state, ctl, 4, 1.0, 40, theta)
    monkeypatch.setattr(pdhg_step, "primal_step", pdhg_step.primal_step_plain)
    monkeypatch.setattr(pdhg_step, "dual_step", pdhg_step.dual_step_plain)
    plain = tp.pdhg_block_windows(prob, state, ctl, 4, 1.0, 40, theta)
    torch.cuda.synchronize()
    for g, w, p in zip((*got[0], *got[1], *got[2]),
                       (*want[0], *want[1], *want[2]),
                       (*plain[0], *plain[1], *plain[2])):
        assert torch.equal(g, w) and torch.equal(w, p)
    runner.close()
