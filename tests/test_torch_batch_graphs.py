"""The batched LP solve on the step kernels and the graph runner.

- `ops/pdhg_step.py`: the step operators under `torch.func.vmap` (their
  vmap rule: one batched call, the plain chains on the CPU) against the
  vmapped plain chains bit for bit, at 1, 3 and 16 instances, f32 and
  f64, both modes, with frozen lanes (eta = 0), with unbatched inputs
  and a vmap dimension other than 0; a vmapped step against the JAX
  package's `jax.vmap` of `_halpern_step` and `_avg_pdhg_step` (f64,
  1e-12 relative to the largest entry); `launch_geometry` covering b x n
  exactly, no 16-byte word across two instances.
- `solvers/pdlp/batch.py`: the batch's runner with the eager recorder
  (each replay reruns the captured function and copies into its first
  outputs) against the windows op by op, bit for bit, across a freeze,
  with the graph and launch counters of the replays; `solve_lp_batch`
  through the recorder against op by op.
- On a card (the `cuda_device` fixture skips these elsewhere): the
  batched kernels against the vmapped plain chains, and a captured batch
  window against the eager one.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from highs_tpu.ops.linops import DenseMatrix as JDense
from highs_tpu.solvers.pdlp import pdhg as jp
from highs_tpu_torch.convert import (pdhg_batch_problem_from_numpy,
                                     pdhg_batch_state_from_numpy,
                                     restart_ctl_from_numpy)
from highs_tpu_torch.ops import pdhg_step
from highs_tpu_torch.ops.linops import DenseMatrix
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.capture import eager_recorder, read_counts
from highs_tpu_torch.solvers.pdlp import batch, graph
from highs_tpu_torch.solvers.pdlp import pdhg as tp
from highs_tpu_torch.tools import step_bench
from highs_tpu_torch.utils.gen_synth_lp import synth_lp

torch.set_num_threads(1)

M, N = 32, 48
RTOL = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _instances(b, seed=0):
    """b dense problems of one shape and a mid-run state each, as numpy
    arrays; every third lane from the second frozen (eta = 0)."""
    rng = np.random.default_rng(seed)
    probs, states = [], []
    for i in range(b):
        k = rng.standard_normal((M, N)) * (rng.uniform(size=(M, N)) < 0.2)
        big = np.finfo(np.float64).max / 4
        up_fin = (rng.uniform(size=N) < 0.7).astype(float)
        p = dict(a=k, b=k @ rng.uniform(0, 1, N), c=rng.uniform(-0.5, 1, N),
                 lo=np.where(rng.uniform(size=N) < 0.8, 0.0, -big),
                 up=np.where(up_fin > 0, 5.0, big),
                 is_eq=(np.arange(M) < 8).astype(float),
                 lo_fin=np.ones(N), up_fin=up_fin,
                 inv_row_scale=rng.uniform(0.5, 2.0, M),
                 inv_col_scale=rng.uniform(0.5, 2.0, N))
        p["norm_b"] = np.linalg.norm(p["b"])
        p["norm_c"] = np.linalg.norm(p["c"])
        y = np.abs(rng.standard_normal(M))
        x = np.clip(rng.standard_normal(N), p["lo"], p["up"])
        s = dict(x=x, y=y, x_pd=x, y_pd=y, x_anchor=x * 0.5,
                 y_anchor=y * 0.5, aty=k.T @ y, k=np.int32(3 + 7 * i),
                 eta=0.0 if i % 3 == 1 else 0.9 / np.linalg.norm(k, 2),
                 omega=0.5 + i)
        probs.append(p)
        states.append(s)
    return probs, states


def _ctl(b):
    return dict(fpe_init=np.full(b, np.inf), fpe_last=np.full(b, np.inf),
                fresh=np.ones(b, bool), total_k=np.zeros(b, np.int32),
                n_restarts=np.zeros(b, np.int32))


def _bits(t):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


# --- the step operators under vmap ---------------------------------------

@pytest.mark.parametrize("width", step_bench.BATCH_WIDTHS)
@pytest.mark.parametrize("b", step_bench.BATCHES)
def test_vmapped_operators_equal_vmapped_plain_chains(b, width):
    """f32 and f64, both modes, with and without y_lo, frozen lanes: the
    records `chip_smoke.py` holds the kernels to on a card."""
    records = step_bench.batched_step_records(
        torch.device("cpu"), (b,), (width,), timed=None)
    assert len(records) == 2 * 2 * 3
    assert all(r["ok"] and r["equal_bits"] for r in records)
    assert all(r["frozen"] == len(range(1, b, 3)) for r in records)
    # the plain chains on the CPU launch nothing
    assert {r["launches"] for r in records} == {0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", pdhg_step.MODES)
def test_vmap_rule_takes_any_in_dims(mode, dtype):
    """Unbatched inputs (a shared c and lo, a shared eta) broadcast to the
    batch, and inputs batched at dimension 1, reach the operators as the
    vmapped plain chains see them; one operator call a half."""
    v = step_bench.batch_inputs(3, 64, dtype, True, "cpu", seed=5)
    p_args = (v["x"].t().contiguous(), v["c"][0], v["aty"], v["lo"][0],
              v["up"], v["x_anchor"], v["eta"][0], v["omega"], v["k"])
    p_dims = (1, None, 0, None, 0, 0, None, 0, 0)
    d_args = (v["y"], v["b"], v["ax_r"].t().contiguous(), v["is_eq"][0],
              v["y_lo"], v["y_anchor"], v["eta"], v["omega"][0], v["k"])
    d_dims = (0, 0, 1, None, 0, 0, 0, None, 0)
    seen = []

    def count(fn):
        def run(*args, **kwargs):
            seen.append(args[0].shape)
            return fn(*args, **kwargs)
        return run
    for kernel, plain, args, dims in (
            (pdhg_step.primal_step, pdhg_step.primal_step_plain, p_args,
             p_dims),
            (pdhg_step.dual_step, pdhg_step.dual_step_plain, d_args,
             d_dims)):
        got = torch.func.vmap(lambda *a: kernel(*a, 0.9, mode),
                              in_dims=dims)(*args)
        want = torch.func.vmap(lambda *a: plain(*a, 0.9, mode),
                               in_dims=dims)(*args)
        _same(got, want)
    # the rule calls the operator once, on (3, 64) rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdhg_step, "primal_step_plain",
                   count(pdhg_step.primal_step_plain))
        torch.func.vmap(lambda *a: pdhg_step.primal_step(*a, 0.9, mode),
                        in_dims=p_dims)(*p_args)
    assert seen == [torch.Size([3, 64])]


@pytest.mark.parametrize("mode,gamma", [("halpern", 1.0), ("halpern", 0.9),
                                        ("average", 1.0)])
def test_vmapped_step_like_jax(mode, gamma):
    """A vmapped step of the port (operators and products) against the
    JAX package's `jax.vmap` of the same step, f64."""
    probs, states = _instances(3, seed=1)
    tprob = pdhg_batch_problem_from_numpy(probs, device="cpu")
    tstate = pdhg_batch_state_from_numpy(states, device="cpu")
    jprob = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jp.PdhgProblem(k_op=JDense(jnp.asarray(p["a"])), **{
            f: jnp.asarray(p[f]) for f in jp.PdhgProblem._fields
            if f not in ("k_op", "y_lo")}) for p in probs])
    jstate = jp.PdhgState(**{f: jnp.asarray(np.stack([s[f] for s in states]))
                             for f in jp.PdhgState._fields})
    vecs = {f: getattr(tprob, f) for f in batch._VECTORS}

    def one(a, vecs, state):
        prob = tp.PdhgProblem(k_op=DenseMatrix(a), **vecs)
        return (tp._halpern_step(prob, state, gamma) if mode == "halpern"
                else tp._avg_pdhg_step(prob, state))
    got = torch.func.vmap(one)(tprob.k_op.a, vecs, tstate)
    want = jax.vmap(lambda p, s: jp._halpern_step(p, s, gamma)
                    if mode == "halpern" else jp._avg_pdhg_step(p, s))(
        jprob, jstate)
    for name in jp.PdhgState._fields:
        g = getattr(got, name).numpy().astype(np.float64)
        w = np.asarray(getattr(want, name)).astype(np.float64)
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert np.max(np.abs(g - w)) <= RTOL * scale, name


def _covered(g, b, n, itemsize):
    """How often a launch of geometry g touches each index of the flat
    (b, n) rows, by the kernels' index arithmetic (block row y on
    instance y, its threads as in a single launch), and whether any
    16-byte word spans two instances."""
    width = 16 // itemsize
    stride = g.grid * g.threads
    t = np.arange(stride)
    touched, crossing = [], False
    for y in range(b):
        base = y * n
        touched.append(base + g.vectors * width + t[t < g.tail])
        for j in range(g.per_thread):
            v = t + j * stride
            v = v[v < g.vectors]
            first, last = base + v * width, base + v * width + width - 1
            crossing |= bool(np.any(first // n != last // n))
            touched += [first + e for e in range(width)]
    return np.bincount(np.concatenate(touched), minlength=b * n), crossing


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,n", [(1, 128), (1, 2048), (3, 128), (3, 2048),
                                 (16, 128), (16, 2048), (1, 65537),
                                 (16, 4), (300, 128)])
def test_launch_geometry_covers_a_batch(b, n, itemsize):
    sms = 132  # the H100's
    g = pdhg_step.launch_geometry(n, itemsize, sms, b)
    counts, crossing = _covered(g, b, n, itemsize)
    assert np.array_equal(counts, np.ones(b * n, np.int64))
    assert not crossing
    assert g.batch == b
    assert g.threads % 32 == 0 and 32 <= g.threads <= pdhg_step.MAX_THREADS
    # no block of an instance without a vector of its own
    assert (g.grid - 1) * g.threads * g.per_thread < max(g.vectors, 1)
    if b <= 16 and n <= 2048:
        assert g.grid * b <= sms  # one wave at the batch phase's sizes
    if b == 1:  # the single-instance launch as it was
        assert g == pdhg_step.launch_geometry(n, itemsize, sms)


def test_launch_geometry_refuses_a_batch_off_the_grid():
    with pytest.raises(ValueError, match="16-byte grid"):
        pdhg_step.launch_geometry(5, 8, 132, 3)
    with pytest.raises(ValueError, match="batch"):
        pdhg_step.launch_geometry(128, 8, 132, pdhg_step.MAX_BATCH + 1)
    with pytest.raises(ValueError, match="batch"):
        pdhg_step.launch_geometry(128, 8, 132, 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_operators_refuse_a_batch_they_cannot_take():
    """On a card a batch's rows must be whole 16-byte words, and the
    scalars must have the batch's shape; refused before any library is
    loaded, with no launch counted."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")

    def on_card(t):
        return t.as_subclass(_OnCard)
    x = on_card(torch.zeros(3, 5, dtype=torch.float64))
    s = on_card(torch.ones(3, dtype=torch.float64))
    k = on_card(torch.zeros(3, dtype=torch.int32))
    before = dict(pdhg_step.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        pdhg_step.primal_step(x, x, x, x, x, x, s, s, k, 1.0, "halpern")
    with pytest.raises(ValueError, match="16-byte"):
        pdhg_step.dual_step(x, x, x, x, None, x, s, s, k, 1.0, "average")
    cpu = torch.zeros(3, 4, dtype=torch.float64)
    with pytest.raises(TypeError, match="shape"):
        pdhg_step.primal_step(cpu, cpu, cpu, cpu, cpu, cpu,
                              torch.tensor(1.0, dtype=torch.float64),
                              torch.ones(3, dtype=torch.float64),
                              torch.zeros(3, dtype=torch.int32), 1.0,
                              "halpern")
    with pytest.raises(TypeError, match="int32"):
        pdhg_step.dual_step(cpu, cpu, cpu, cpu, None, cpu,
                            torch.ones(3, dtype=torch.float64),
                            torch.ones(3, dtype=torch.float64),
                            torch.zeros((), dtype=torch.int32), 1.0,
                            "halpern")
    assert pdhg_step.LAUNCHES == before


def test_no_plain_argument_and_no_plain_chain_by_name():
    for fn in (tp._pdhg_step, tp._halpern_step, tp._halpern_step_fpe,
               tp.restart_window, tp.pdhg_block_windows, tp.halpern_steps,
               tp.pdhg_block):
        assert "plain" not in inspect.signature(fn).parameters, fn
    for module in (batch, graph, tp):
        source = inspect.getsource(module)
        assert "step_plain" not in source, module


# --- the batch's runner ---------------------------------------------------

def _counting_step_operators(monkeypatch):
    """Each step wrapper call counts a launch, as a batched launch counts
    one on a card."""
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


def _two_blocks(runner, start, frozen, n_windows, interval):
    """Two blocks with the lanes `frozen` between them, as
    `solve_lp_batch` freezes a finished instance: every tensor the
    blocks returned, cloned."""
    state, ctl, out = start[0], start[1], []
    theta = torch.zeros((), dtype=state.x.dtype, device=state.x.device)
    for _ in range(2):
        state, ctl, metrics = runner.windows(state, ctl, n_windows, 1.0,
                                             interval, theta, None)
        out += [t.clone() for part in (state, ctl, metrics) for t in part]
        state = batch.freeze_instances(state, frozen)
    return out


def test_batch_runner_equals_windows_op_by_op(monkeypatch):
    _counting_step_operators(monkeypatch)
    probs, states = _instances(4, seed=3)
    for s in states:
        s["k"] = np.int32(0)
        s["eta"] = 0.9 / np.linalg.norm(probs[0]["a"], 2)
    problem = pdhg_batch_problem_from_numpy(probs, device="cpu")
    start = (pdhg_batch_state_from_numpy(states, device="cpu"),
             restart_ctl_from_numpy(_ctl(4), device="cpu"))
    frozen = torch.tensor([False, True, False, True])
    interval, n_windows = 10, 3

    runner = batch.batch_runner(problem, interval, eager_recorder)
    assert isinstance(runner, graph.GraphBlocks)
    graph.COUNTS.clear()
    before = read_counts()
    got = _two_blocks(runner, start, frozen, n_windows, interval)
    after = read_counts()
    runner.close()
    assert dict(graph.COUNTS) == {"captures": 2, "replays": 8, "window": 6,
                                  "metrics": 2}
    # one (batched) launch of each half a step, replays included
    for name in pdhg_step.LAUNCHES:
        assert after[name] - before[name] == 2 * n_windows * interval

    eager = batch.batch_runner(problem, interval)
    assert isinstance(eager, graph.EagerBlocks)
    _same(got, _two_blocks(eager, start, frozen, n_windows, interval))
    # the second block ran with the frozen lanes' step size at 0
    eta = got[len(got) // 2 + tp.PdhgState._fields.index("eta")]
    assert torch.all(eta[frozen] == 0) and torch.all(eta[~frozen] > 0)


def test_solve_lp_batch_through_the_recorder():
    """`solve_lp_batch` with its blocks replayed (the eager recorder)
    gives what op by op gives, bit for bit: every block a replay of the
    window graph and one of the metrics graph."""
    lps = [synth_lp(m=m, n=m, seed=i) for i, m in enumerate((100, 110, 120))]
    runs = []
    for capture in (None, eager_recorder):
        graph.COUNTS.clear()
        blocks = []
        res = batch.solve_lp_batch(lps, HighsOptions(), log=blocks.append,
                                   device="cpu", capture=capture)
        runs.append((res, dict(graph.COUNTS), len(blocks)))
    (plain, plain_counts, _), (graphed, counts, n_blocks) = runs
    assert plain_counts == {}
    assert counts["metrics"] == n_blocks and counts["window"] >= n_blocks
    for (st_p, sol_p, info_p), (st_g, sol_g, info_g) in zip(plain, graphed):
        assert st_p == st_g
        assert (info_p.iterations, info_p.restarts, info_p.primal_obj) == \
            (info_g.iterations, info_g.restarts, info_g.primal_obj)
        for name in ("col_value", "row_dual", "col_dual"):
            assert np.array_equal(getattr(sol_p, name), getattr(sol_g, name))


# --- on a card -------------------------------------------------------------

def test_batched_kernels_equal_vmapped_plain_on_card(cuda_device):
    records = step_bench.batched_step_records(cuda_device, timed=None)
    assert all(r["ok"] and r["launches"] == 1 for r in records)


def test_batch_window_graph_equals_eager_on_card(cuda_device):
    probs, states = _instances(16, seed=4)
    for s in states:
        s["k"] = np.int32(0)
    problem = pdhg_batch_problem_from_numpy(probs, device=cuda_device)
    start = (pdhg_batch_state_from_numpy(states, device=cuda_device),
             restart_ctl_from_numpy(_ctl(16), device=cuda_device))
    frozen = torch.zeros(16, dtype=torch.bool, device=cuda_device)
    frozen[::5] = True
    runner = batch.batch_runner(problem, 40)
    assert isinstance(runner, graph.GraphBlocks)
    got = _two_blocks(runner, start, frozen, 2, 40)
    runner.close()
    want = _two_blocks(graph.EagerBlocks(problem, batch.batched_window,
                                         batch.batched_metrics),
                       start, frozen, 2, 40)
    torch.cuda.synchronize()
    _same(got, want)
