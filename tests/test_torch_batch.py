"""Batched PDLP (`solve_lp_batch`): the port against the JAX package's
vmapped batch on the same instances, on the CPU in f64.

The batched pieces agree to 1e-10 relative; whole batches take the same
iterations per instance, with objectives within 1e-8.  A batch agrees
with single solves to the tolerance of tests/test_batch.py, and an
instance does not feel its neighbours: an LP scaled by 1e3 takes the
same iterations and iterates in a batch as alone."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from highs_tpu.models.lp import HighsLp as JLp
from highs_tpu.models.lp import HighsSparseMatrix as JMatrix
from highs_tpu.ops.linops import DenseMatrix as JDense
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.solvers.pdlp import batch as jb
from highs_tpu.solvers.pdlp import pdhg as jp
from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.convert import (pdhg_batch_problem_from_numpy,
                                     pdhg_batch_state_from_numpy,
                                     restart_ctl_from_numpy)
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.pdlp import batch as tb
from highs_tpu_torch.solvers.pdlp.wrapper import solve_lp_pdlp
from highs_tpu_torch.utils.gen_synth_lp import synth_lp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

RTOL = 1e-10
B, M, N = 3, 96, 128


def _close(got, want, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    # an infinite entry (a restart's reset fpe) must match exactly
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    got, want = got[fin], want[fin]
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= RTOL * scale, (what, err, scale)


def _instances(seed=0):
    """B problems of one padded shape, the second scaled by 1e3, and a
    mid-run state for each."""
    rng = np.random.default_rng(seed)
    probs, states = [], []
    for i in range(B):
        k = rng.standard_normal((M, N)) * (rng.uniform(size=(M, N)) < 0.1)
        scale = 1e3 if i == 1 else 1.0
        b = k @ rng.uniform(0, 1, N) * scale
        c = rng.uniform(0.1, 1.0, N) * scale
        big = np.finfo(np.float64).max / 4
        up_fin = (rng.uniform(size=N) < 0.7).astype(float)
        p = dict(a=k, b=b, c=c, lo=np.zeros(N),
                 up=np.where(up_fin > 0, 5.0, big),
                 is_eq=(np.arange(M) < 20).astype(float),
                 lo_fin=np.ones(N), up_fin=up_fin,
                 inv_row_scale=rng.uniform(0.5, 2.0, M),
                 inv_col_scale=rng.uniform(0.5, 2.0, N),
                 norm_b=np.linalg.norm(b), norm_c=np.linalg.norm(c))
        y = np.abs(rng.standard_normal(M))
        x = np.clip(rng.standard_normal(N), p["lo"], p["up"])
        s = dict(x=x, y=y, x_pd=np.clip(x + 0.1, p["lo"], p["up"]),
                 y_pd=y * 0.9, x_anchor=x * 0.5, y_anchor=y * 0.5,
                 aty=k.T @ y, k=np.int32(3 + i),
                 eta=0.9 / np.linalg.norm(k, 2), omega=0.5 + i)
        probs.append(p)
        states.append(s)
    return probs, states


def _jax_batch(probs, states):
    jprob = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jp.PdhgProblem(k_op=JDense(jnp.asarray(p["a"])), **{
            f: jnp.asarray(p[f]) for f in jp.PdhgProblem._fields
            if f not in ("k_op", "y_lo")}) for p in probs])
    jstate = jp.PdhgState(**{f: jnp.asarray(np.stack([s[f] for s in states]))
                             for f in jp.PdhgState._fields})
    return jprob, jstate


def _compare_states(tstate, jstate):
    for name in jp.PdhgState._fields:
        _close(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
               name)


CTL = dict(fpe_init=np.full(B, np.inf), fpe_last=np.full(B, np.inf),
           fresh=np.ones(B, bool), total_k=np.zeros(B, np.int32),
           n_restarts=np.zeros(B, np.int32))


@pytest.mark.parametrize("n_windows", [1, 5])
def test_batched_windows_like_jax(n_windows):
    probs, states = _instances()
    jprob, jstate = _jax_batch(probs, states)
    tprob = pdhg_batch_problem_from_numpy(probs, device="cpu")
    tstate = pdhg_batch_state_from_numpy(states, device="cpu")
    jctl = jp.RestartCtl(**{k: jnp.asarray(v) for k, v in CTL.items()})
    tctl = restart_ctl_from_numpy(CTL, device="cpu")
    js, jc, jm = jb.batched_pdhg_windows(jprob, jstate, jctl, n_windows,
                                         1.0, 10, jnp.asarray(0.0))
    ts, tc, tm = tb.batched_pdhg_windows(
        tprob, tstate, tctl, n_windows, 1.0, 10,
        torch.tensor(0.0, dtype=torch.float64))
    _compare_states(ts, js)
    for name in jp.RestartCtl._fields:
        _close(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), name)
    for name in jp.PdhgMetrics._fields:
        _close(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), name)
    assert tc.n_restarts.tolist() == np.asarray(jc.n_restarts).tolist()


def test_batched_restart_and_freeze_like_jax():
    probs, states = _instances(seed=1)
    _, jstate = _jax_batch(probs, states)
    tstate = pdhg_batch_state_from_numpy(states, device="cpu")
    flags = np.array([True, False, True])
    omegas = np.array([1.5, 2.5, 3.5])
    _compare_states(
        tb.batched_restart(tstate, torch.as_tensor(flags),
                           torch.as_tensor(omegas)),
        jb.batched_restart(jstate, jnp.asarray(flags), jnp.asarray(omegas)))
    frozen = np.array([False, True, True])
    _compare_states(tb.freeze_instances(tstate, torch.as_tensor(frozen)),
                    jb.freeze_instances(jstate, jnp.asarray(frozen)))


def _jax_lp(lp):
    return JLp(num_col=lp.num_col, num_row=lp.num_row,
               col_cost=lp.col_cost.copy(), col_lower=lp.col_lower.copy(),
               col_upper=lp.col_upper.copy(), row_lower=lp.row_lower.copy(),
               row_upper=lp.row_upper.copy(),
               a_matrix=JMatrix.from_scipy(lp.a_matrix.to_scipy()), sense=1)


def _synth_lps(sizes, scaled=None):
    lps = []
    for i, m in enumerate(sizes):
        lp = synth_lp(m=m, n=m, seed=i)
        if i == scaled:
            lp.col_cost = lp.col_cost * 1e3
            lp.row_lower = lp.row_lower * 1e3
            lp.col_upper = lp.col_upper * 1e3
        lps.append(lp)
    return lps


def test_solve_lp_batch_like_jax():
    lps = _synth_lps([256, 288, 320, 384])
    jres = jb.solve_lp_batch([_jax_lp(lp) for lp in lps], JOptions())
    tres = tb.solve_lp_batch(lps, HighsOptions(), device="cpu")
    for (jst, jsol, jinfo), (tst, tsol, tinfo) in zip(jres, tres):
        print(f"{jst.name} {jinfo.iterations} {jinfo.primal_obj!r} / "
              f"{tst.name} {tinfo.iterations} {tinfo.primal_obj!r}")
        assert int(tst) == int(jst) == int(HighsModelStatus.kOptimal)
        assert tinfo.iterations == jinfo.iterations
        assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
            1e-8 * max(1.0, abs(jinfo.primal_obj))
        # a frozen instance's restart count stops at its finish in the
        # port; the JAX package's goes on counting until the batch ends
        assert 0 < tinfo.restarts <= jinfo.restarts
    for lp, (tst, tsol, tinfo) in zip(lps, tres):
        # the port reports the iterate its convergence check passed (the
        # JAX package the frozen iterate at the batch's end)
        assert abs(float(lp.col_cost @ tsol.col_value) - tinfo.primal_obj) \
            <= 1e-9 * max(1.0, abs(tinfo.primal_obj))


def test_batch_matches_single_solves():
    # the tolerance of tests/test_batch.py::test_batch_matches_single_solves
    lps = _synth_lps([120, 160])
    opts = HighsOptions()
    for lp, (st_b, sol_b, info_b) in zip(
            lps, tb.solve_lp_batch(lps, opts, device="cpu")):
        st_s, sol_s, info_s = solve_lp_pdlp(lp, opts, device="cpu")
        assert int(st_b) == int(st_s) == int(HighsModelStatus.kOptimal)
        assert abs(info_b.iterations - info_s.iterations) <= \
            10 * opts.tpu_check_interval
        np.testing.assert_allclose(sol_b.col_value, sol_s.col_value,
                                   atol=2e-4)


def test_instances_do_not_mix():
    # one LP scaled by 1e3: its norms dwarf its neighbours'.  Every
    # reduction is per instance, so the batch reproduces each instance's
    # solve alone (batches of one, the same padded shape)
    lps = _synth_lps([100, 110, 120], scaled=1)
    opts = HighsOptions()
    together = tb.solve_lp_batch(lps, opts, device="cpu")
    for i in (1, 2):
        (st_a, sol_a, info_a), = tb.solve_lp_batch([lps[i]], opts,
                                                   device="cpu")
        st_t, sol_t, info_t = together[i]
        assert int(st_a) == int(st_t) == int(HighsModelStatus.kOptimal)
        assert info_a.iterations == info_t.iterations
        assert info_a.restarts == info_t.restarts
        for name in ("col_value", "row_dual"):
            a, t = getattr(sol_a, name), getattr(sol_t, name)
            assert np.max(np.abs(a - t)) <= 1e-10 * max(1.0,
                                                         np.max(np.abs(a)))


def test_batch_dtype_resolution():
    opts = HighsOptions()
    assert opts.tpu_dtype == "choose"
    # the card has FP64 and the batch has no f32 -> f64 refinement:
    # 'choose' is float64 on every device
    assert tb.resolve_batch_dtype(opts) == "float64"
    opts.tpu_dtype = "float32"
    assert tb.resolve_batch_dtype(opts) == "float32"
    opts.tpu_dtype = "float64"
    assert tb.resolve_batch_dtype(opts) == "float64"
    # the single-instance path keeps f32 (with refinement) on CUDA
    from highs_tpu_torch.solvers.pdlp.wrapper import _resolve_dtype
    assert _resolve_dtype(HighsOptions(), torch.device("cuda")) == "float32"
