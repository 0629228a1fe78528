"""Halpern PDHG pieces: the port against the JAX package, from one
problem and one state carried over by convert.py (f64, 1e-10 relative;
restart counts exactly).

For block-CSR the JAX side runs the same matrix as a dense operator: the
JAX package's `linop_dtype` has no block-CSR case and answers float32,
so its f64 Halpern step rounds the vectors it hands to a block-CSR
product to f32 (about 1e-8 relative).  The port keeps them in f64; the
port's block-CSR operator itself is carried over from the JAX layout."""
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from highs_tpu.ops import linops as jlin
from highs_tpu.solvers.pdlp import pdhg as jp
from highs_tpu_torch.convert import (block_csr_from_numpy, linop_from_numpy,
                                     pdhg_problem_from_numpy,
                                     pdhg_state_from_numpy,
                                     restart_ctl_from_numpy)
from highs_tpu_torch.ops.block_csr import BlockCsrMatrix
from highs_tpu_torch.solvers.pdlp import pdhg as tp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

RTOL = 1e-10
M, N, NEQ = 256, 384, 64


def _close(got, want, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= RTOL * scale, (what, err, scale)


def _torch_op(k, fmt):
    jop = jlin.from_scipy(k, fmt=fmt, dtype=jnp.float64)
    if fmt == "dense":
        return linop_from_numpy({"a": np.asarray(jop.a)}, device="cpu")
    if fmt == "ell":
        return linop_from_numpy({f: np.asarray(getattr(jop, f))
                                 for f in jop._fields}, device="cpu")
    halves = [block_csr_from_numpy(
        *(np.asarray(getattr(d, f)) for f in
          ("blocks", "block_row", "block_col", "first_in_row")),
        shape=d.shape, device="cpu") for d in (jop.fwd, jop.bwd)]
    return BlockCsrMatrix(*halves)


def _problem(fmt, seed=0, with_y_lo=False):
    """The same scaled standard-form problem in both packages:
    K x >= b with NEQ equality rows, mixed finite/infinite bounds."""
    rng = np.random.default_rng(seed)
    k = sp.random(M, N, density=0.05, random_state=rng, format="csr")
    xstar = rng.uniform(0.0, 1.0, N)
    b = k @ xstar
    b[NEQ:] -= np.abs(rng.standard_normal(M - NEQ)) * 0.1
    c = rng.uniform(-0.5, 1.0, N)
    big = np.finfo(np.float64).max / 4
    lo_fin = (rng.uniform(size=N) < 0.9).astype(np.float64)
    up_fin = (rng.uniform(size=N) < 0.7).astype(np.float64)
    lo = np.where(lo_fin > 0, 0.0, -big)
    up = np.where(up_fin > 0, rng.uniform(1.0, 5.0, N), big)
    arrays = dict(
        b=b, c=c, lo=lo, up=up,
        is_eq=(np.arange(M) < NEQ).astype(np.float64),
        lo_fin=lo_fin, up_fin=up_fin,
        inv_row_scale=rng.uniform(0.5, 2.0, M),
        inv_col_scale=rng.uniform(0.5, 2.0, N),
        norm_b=np.asarray(np.linalg.norm(b)),
        norm_c=np.asarray(np.linalg.norm(c)))
    if with_y_lo:
        arrays["y_lo"] = np.where(arrays["is_eq"] > 0, 0.0,
                                  -rng.uniform(0.0, 0.5, M))
    jop = jlin.from_scipy(k, fmt="dense" if fmt == "blockcsr" else fmt,
                          dtype=jnp.float64)
    jprob = jp.PdhgProblem(k_op=jop, **{
        name: jnp.asarray(v) for name, v in arrays.items()})
    tprob = pdhg_problem_from_numpy(dict(arrays, k_op=_torch_op(k, fmt)),
                                    device="cpu")
    return jprob, tprob


def _state(jprob, seed=1, k=5):
    rng = np.random.default_rng(seed)
    lo = np.asarray(jprob.lo)
    up = np.asarray(jprob.up)

    def xs():
        return np.clip(rng.standard_normal(N), lo, up)

    def ys():
        y = rng.standard_normal(M)
        return np.where(np.asarray(jprob.is_eq) > 0, y, np.abs(y))
    y = ys()
    norm_k = float(jp.power_method(jprob.k_op, N, 30, jnp.float64))
    s = dict(x=xs(), y=y, x_pd=xs(), y_pd=ys(), x_anchor=xs(),
             y_anchor=ys(), aty=np.asarray(jprob.k_op.rmv(jnp.asarray(y))),
             k=np.asarray(k, np.int32), eta=np.asarray(0.998 / norm_k),
             omega=np.asarray(0.7))
    jstate = jp.PdhgState(**{name: jnp.asarray(v) for name, v in s.items()})
    return jstate, pdhg_state_from_numpy(s, device="cpu")


def _compare_states(tstate, jstate):
    for name in jp.PdhgState._fields:
        _close(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
               name)


FORMATS = ["dense", "ell", "blockcsr"]


@pytest.mark.parametrize("with_y_lo", [False, True])
@pytest.mark.parametrize("gamma", [1.0, 0.9])
@pytest.mark.parametrize("fmt", FORMATS)
def test_halpern_step(fmt, gamma, with_y_lo):
    jprob, tprob = _problem(fmt, with_y_lo=with_y_lo)
    jstate, tstate = _state(jprob)
    _compare_states(tp._halpern_step(tprob, tstate, gamma),
                    jp._halpern_step(jprob, jstate, gamma))
    tnew, tfpe = tp._halpern_step_fpe(tprob, tstate, gamma)
    jnew, jfpe = jp._halpern_step_fpe(jprob, jstate, gamma)
    _compare_states(tnew, jnew)
    _close(tfpe.numpy(), np.asarray(jfpe), "fpe")


def _ctl(total_k=0, n_restarts=0):
    return dict(fpe_init=np.asarray(np.inf), fpe_last=np.asarray(np.inf),
                fresh=np.asarray(True), total_k=np.asarray(total_k, np.int32),
                n_restarts=np.asarray(n_restarts, np.int32))


@pytest.mark.parametrize("n_windows,theta", [(1, 0.0), (6, 0.0), (6, 0.5)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_block_windows(fmt, n_windows, theta):
    jprob, tprob = _problem(fmt, seed=3)
    jstate, tstate = _state(jprob, seed=4, k=0)
    ctl = _ctl()
    js, jc, jm = jp.pdhg_block_windows(
        jprob, jstate, jp.RestartCtl(**{k: jnp.asarray(v)
                                        for k, v in ctl.items()}),
        n_windows, 1.0, 40, jnp.asarray(theta))
    ts, tc, tm = tp.pdhg_block_windows(
        tprob, tstate, restart_ctl_from_numpy(ctl, device="cpu"),
        n_windows, 1.0, 40,
        torch.tensor(theta, dtype=torch.float64))
    _compare_states(ts, js)
    assert int(tc.n_restarts) == int(jc.n_restarts) >= 1
    assert int(tc.total_k) == int(jc.total_k) == 40 * n_windows
    assert bool(tc.fresh) == bool(jc.fresh)
    for name in ("fpe_init", "fpe_last"):
        want = float(getattr(jc, name))
        got = float(getattr(tc, name))
        if math.isinf(want):
            assert got == want, name
        else:
            _close(got, want, name)
    for name in jp.PdhgMetrics._fields:
        _close(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_compute_metrics(fmt):
    jprob, tprob = _problem(fmt, seed=5)
    jstate, tstate = _state(jprob, seed=6)
    jm = jp._compute_metrics(jprob, jstate)
    tm = tp._compute_metrics(tprob, tstate)
    for name in jp.PdhgMetrics._fields:
        _close(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), name)
    host, restarts = tp.read_metrics(tm)
    assert restarts is None
    for name in jp.PdhgMetrics._fields:
        _close(getattr(host, name), np.asarray(getattr(jm, name)), name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_power_method(fmt):
    jprob, tprob = _problem(fmt, seed=7)
    want = float(jp.power_method(jprob.k_op, N, 30, jnp.float64))
    got = float(tp.power_method(tprob.k_op, N, 30, torch.float64, "cpu"))
    _close(got, want, "norm_k")


def test_restart_state_and_step_size_stats():
    jprob, tprob = _problem("dense", seed=8)
    jstate, tstate = _state(jprob, seed=9)
    _compare_states(tp._restart_state(tstate, torch.tensor(1.3,
                                                            dtype=torch.float64)),
                    jp._restart_state(jstate, jnp.asarray(1.3)))
    jstate2, tstate2 = _state(jprob, seed=10)
    jmv, jint = jp._step_size_stats(jprob, jstate, jstate2.x_pd,
                                    jstate2.y_pd)
    tmv, tint = tp._step_size_stats(tprob, tstate, tstate2.x_pd,
                                    tstate2.y_pd)
    _close(tmv.numpy(), np.asarray(jmv), "movement")
    _close(tint.numpy(), np.asarray(jint), "interaction")


@pytest.mark.parametrize("device_restarts", [True, False])
def test_solve_pdhg_restart_counts(device_restarts):
    jprob, tprob = _problem("dense", seed=11)
    settings = dict(eps_optimal=1e-6, iteration_limit=2000,
                    device_restarts=device_restarts)
    jr = jp.solve_pdhg(jprob, N, M, jp.PdhgSettings(**settings))
    tr = tp.solve_pdhg(tprob, N, M, tp.PdhgSettings(**settings))
    assert tr.status == jr.status
    assert tr.iterations == jr.iterations
    assert tr.restarts == jr.restarts
    _close(tr.x, jr.x, "x")
    _close(tr.y, jr.y, "y")


def test_average_mode_not_yet_ported():
    _, tprob = _problem("dense")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tp.solve_pdhg(tprob, N, M, tp.PdhgSettings(mode="average"))


def test_block_csr_metrics_against_jax_kernel():
    # metrics and the power method take the operator at full precision
    # in both packages, so here the JAX side runs its own block-CSR
    # kernel (Pallas, interpret mode)
    jdense, tprob = _problem("blockcsr", seed=12)
    k_np = np.asarray(jdense.k_op.a)
    jprob = jdense._replace(k_op=jlin.from_scipy(
        sp.csr_matrix(k_np), fmt="blockcsr", dtype=jnp.float64))
    jstate, tstate = _state(jdense, seed=13)
    jm = jp._compute_metrics(jprob, jstate)
    tm = tp._compute_metrics(tprob, tstate)
    for name in jp.PdhgMetrics._fields:
        _close(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), name)
    _close(float(tp.power_method(tprob.k_op, N, 30, torch.float64, "cpu")),
           float(jp.power_method(jprob.k_op, N, 30, jnp.float64)), "norm_k")


@pytest.mark.parametrize("strategy", ["adaptive", "malitsky_pock"])
def test_solve_pdhg_step_size_strategies(strategy):
    jprob, tprob = _problem("dense", seed=14)
    settings = dict(eps_optimal=1e-6, iteration_limit=2000,
                    step_size_strategy=strategy)
    jr = jp.solve_pdhg(jprob, N, M, jp.PdhgSettings(**settings))
    tr = tp.solve_pdhg(tprob, N, M, tp.PdhgSettings(**settings))
    assert tr.status == jr.status
    assert tr.iterations == jr.iterations
    assert tr.restarts == jr.restarts
    _close(tr.x, jr.x, "x")


def test_checkpoint_written_by_jax_resumes_in_port(tmp_path):
    # both packages keep the same checkpoint file format: a run the JAX
    # package checkpointed resumes in either package to the same result
    jprob, tprob = _problem("dense", seed=15)
    first = str(tmp_path / "first.npz")
    jp.solve_pdhg(jprob, N, M, jp.PdhgSettings(
        eps_optimal=1e-6, iteration_limit=200, checkpoint_file=first,
        checkpoint_interval=1))
    saved = np.load(first)
    assert int(saved["total_iters"]) >= 200
    results = []
    for pkg, prob in ((jp, jprob), (tp, tprob)):
        path = str(tmp_path / f"{pkg.__name__}.npz")
        with open(first, "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
        results.append(pkg.solve_pdhg(prob, N, M, pkg.PdhgSettings(
            eps_optimal=1e-6, iteration_limit=2000, checkpoint_file=path,
            checkpoint_interval=1)))
    jr, tr = results
    assert tr.status == jr.status
    assert tr.iterations == jr.iterations > int(saved["total_iters"])
    _close(tr.x, jr.x, "x")
    _close(tr.y, jr.y, "y")
