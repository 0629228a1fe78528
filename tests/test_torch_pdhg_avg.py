"""Average-iterate PDHG (solver "pdlp", cuPDLP-C): the port against the
JAX package on the same inputs, on the CPU.

The pieces (one step, one block with both metric sets, the restart) from
one problem and one state carried over by convert.py agree to 1e-12
relative in f64.  Whole f64 solves take the same iterations and restarts
as the JAX package, with the objective within 1e-9; for block-CSR and
one-hot (the kernels' plain versions here) the JAX side runs the same
matrix as a dense operator (its f64 steps on those formats round to
f32, ROADMAP queue 3).  The f32 facade run with
refinement is held to the JAX facade's status and objective, and its
iteration count to the spread measured between the packages."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import highs_tpu
import highs_tpu_torch
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.solvers.pdlp import pdhg as jp
from highs_tpu.solvers.pdlp.wrapper import solve_lp_pdlp as jax_solve
from highs_tpu_torch.convert import lp_from_numpy, pdhg_avg_state_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.pdlp import pdhg as tp
from highs_tpu_torch.solvers.pdlp.wrapper import solve_lp_pdlp
from highs_tpu_torch.utils.gen_block_lp import gen_block_lp
from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp
from test_torch_pdhg import M, N, _problem
from test_torch_pdlp import _jax_lp, _lp_dict

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

RTOL = 1e-12
FORMATS = ["dense", "ell", "blockcsr"]


def _close(got, want, what="", rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= rtol * scale, (what, err, scale)


def _avg_state(jprob, tprob, seed=1, k=5):
    """An average-mode state mid-run: iterates in the feasible box and
    cone, running sums of k earlier iterates."""
    rng = np.random.default_rng(seed)
    lo, up = np.asarray(jprob.lo), np.asarray(jprob.up)
    is_eq = np.asarray(jprob.is_eq) > 0

    def xs():
        return np.clip(rng.standard_normal(N), lo, up)

    def ys():
        y = rng.standard_normal(M)
        return np.where(is_eq, y, np.abs(y))
    norm_k = float(jp.power_method(jprob.k_op, N, 30, jnp.float64))
    d = dict(x=xs(), y=ys(), x_sum=sum(xs() for _ in range(k)),
             y_sum=sum(ys() for _ in range(k)), k=k,
             eta=0.998 / norm_k, omega=0.7)
    tstate = pdhg_avg_state_from_numpy(d, tprob.k_op, device="cpu")
    jstate = jp.PdhgState(
        x=jnp.asarray(d["x"]), y=jnp.asarray(d["y"]),
        x_pd=jnp.asarray(d["x"]), y_pd=jnp.asarray(d["y"]),
        x_anchor=jnp.asarray(d["x_sum"]), y_anchor=jnp.asarray(d["y_sum"]),
        aty=jprob.k_op.rmv(jnp.asarray(d["y"])),
        k=jnp.asarray(k, jnp.int32), eta=jnp.asarray(d["eta"]),
        omega=jnp.asarray(d["omega"]))
    return jstate, tstate


def _compare_states(tstate, jstate):
    for name in jp.PdhgState._fields:
        _close(getattr(tstate, name).numpy(),
               np.asarray(getattr(jstate, name)), name)


@pytest.mark.parametrize("with_y_lo", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_avg_step(fmt, with_y_lo):
    jprob, tprob = _problem(fmt, seed=21, with_y_lo=with_y_lo)
    jstate, tstate = _avg_state(jprob, tprob, seed=22)
    _compare_states(tp._avg_pdhg_step(tprob, tstate),
                    jp._avg_pdhg_step(jprob, jstate))


@pytest.mark.parametrize("fmt", FORMATS)
def test_block_avg_both_metric_sets(fmt):
    jprob, tprob = _problem(fmt, seed=23)
    jstate, tstate = _avg_state(jprob, tprob, seed=24, k=3)
    jout = jp.pdhg_block_avg(jprob, jstate, 37)
    tout = tp.pdhg_block_avg(tprob, tstate, 37)
    _compare_states(tout[0], jout[0])
    m_cur, m_avg = tp.read_metric_pair(tout[1], tout[2])
    for host, jm in ((m_cur, jout[1]), (m_avg, jout[2])):
        for name in jp.PdhgMetrics._fields:
            # the metrics the JAX host loop reads with device_get
            _close(getattr(host, name), float(getattr(jm, name)), name)
    _close(tout[3].numpy(), np.asarray(jout[3]), "x_avg")
    _close(tout[4].numpy(), np.asarray(jout[4]), "y_avg")


def test_restart_state_avg():
    jprob, tprob = _problem("ell", seed=25)
    jstate, tstate = _avg_state(jprob, tprob, seed=26)
    _, t2 = _avg_state(jprob, tprob, seed=27)
    j2 = jp.PdhgState(*(jnp.asarray(v.numpy()) for v in t2))
    got = tp._restart_state_avg(tprob, tstate, t2.x_pd, t2.y_pd,
                                torch.tensor(1.7, dtype=torch.float64))
    want = jp._restart_state_avg(jprob, jstate, j2.x_pd, j2.y_pd,
                                 jnp.asarray(1.7))
    _compare_states(got, want)
    assert float(got.x_anchor.abs().max()) == 0.0 and int(got.k) == 0


def _block_lp_dict(nblocks=4):
    a, b, c = gen_block_lp(nblocks=nblocks)
    n, m = a.shape[1], a.shape[0]
    return _lp_dict(a, c, np.zeros(n), np.full(n, 10.0), b,
                    np.full(m, np.inf))


def _synth_lp_dict(m=300, n=300):
    a, b, c = gen_synth_lp(m, n)
    return _lp_dict(a, c, np.zeros(n), np.full(n, 10.0), b,
                    np.full(m, np.inf))


@functools.lru_cache(maxsize=None)
def _lp_dict_of(name):
    return _block_lp_dict() if name == "block4" else _synth_lp_dict()


@functools.lru_cache(maxsize=None)
def _jax_run(name, jax_format, opts):
    """The JAX package's solve of a named LP, once per module."""
    jopts = JOptions()
    jopts.solver = "pdlp"
    jopts.tpu_matrix_format = jax_format
    for k, v in opts:
        setattr(jopts, k, v)
    jst, _, jinfo = jax_solve(_jax_lp(_lp_dict_of(name)), jopts)
    return jst, jinfo


def _solve_pair(d, port_format, jax_format, **opts):
    topts = HighsOptions()
    topts.solver = "pdlp"
    topts.tpu_matrix_format = port_format
    for k, v in opts.items():
        setattr(topts, k, v)
    if isinstance(d, str):
        jst, jinfo = _jax_run(d, jax_format, tuple(sorted(opts.items())))
        d = _lp_dict_of(d)
    else:
        jopts = JOptions()
        jopts.solver = "pdlp"
        jopts.tpu_matrix_format = jax_format
        for k, v in opts.items():
            setattr(jopts, k, v)
        jst, _, jinfo = jax_solve(_jax_lp(d), jopts)
    tst, tsol, tinfo = solve_lp_pdlp(lp_from_numpy(d), topts, device="cpu")
    print(f"{port_format} vs JAX {jax_format} {opts}: JAX {jst.name} "
          f"{jinfo.iterations} iterations {jinfo.restarts} restarts obj "
          f"{jinfo.primal_obj!r}; port {tst.name} {tinfo.iterations} "
          f"iterations {tinfo.restarts} restarts obj {tinfo.primal_obj!r}")
    return (jst, jinfo), (tst, tinfo)


@pytest.mark.parametrize("lp,port_format,jax_format", [
    ("block4", "dense", "dense"), ("block4", "blockcsr", "dense"),
    ("synth300", "dense", "dense"), ("synth300", "onehot", "dense")])
def test_solve_average_mode_like_jax(lp, port_format, jax_format):
    # the JAX side runs each LP once (the dense operator for every port
    # format)
    (jst, jinfo), (tst, tinfo) = _solve_pair(
        lp, port_format, jax_format, tpu_dtype="float64",
        pdlp_optimality_tolerance=1e-6)
    assert int(tst) == int(jst) == int(highs_tpu_torch.HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    assert tinfo.restarts == jinfo.restarts > 0
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-9 * max(1.0, abs(jinfo.primal_obj))


@pytest.mark.parametrize("strategy,restart", [(0, 2), (1, 1), (2, 1)])
def test_step_size_and_restart_strategies_like_jax(strategy, restart):
    # the codes of tests/test_lp_solve.py::test_pdlp_step_size_strategies
    # (0 fixed, 1 adaptive, 2 Malitsky-Pock), on a generated LP
    (jst, jinfo), (tst, tinfo) = _solve_pair(
        _synth_lp_dict(120, 150), "dense", "dense", tpu_dtype="float64",
        pdlp_optimality_tolerance=1e-5, pdlp_step_size_strategy=strategy,
        pdlp_restart_strategy=restart)
    assert int(tst) == int(jst) == int(highs_tpu_torch.HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    assert tinfo.restarts == jinfo.restarts
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-9 * max(1.0, abs(jinfo.primal_obj))


# f32 with refinement: the two packages may round differently in f32.
# Measured on this LP: the same count in both (20,320 iterations).
# Held to the 5% of tests/test_torch_pdlp.py's f32 comparisons.
F32_ITERATION_SPREAD = 0.05


def test_facade_float32_refinement_like_jax():
    d = _block_lp_dict()
    objs, iters = [], []
    for h, lp in ((highs_tpu_torch.Highs(device="cpu"), lp_from_numpy(d)),
                  (highs_tpu.Highs(), _jax_lp(d))):
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "pdlp")
        h.setOptionValue("tpu_dtype", "float32")
        h.passModel(lp)
        h.run()
        assert int(h.getModelStatus()) == \
            int(highs_tpu_torch.HighsModelStatus.kOptimal)
        objs.append(h.getObjectiveValue())
        iters.append(h.getInfo().pdlp_iteration_count)
    print(f"f32 + refinement, port/JAX: iterations {iters}, objectives "
          f"{objs}")
    assert abs(objs[0] - objs[1]) <= 1e-6 * max(1.0, abs(objs[1]))
    assert abs(iters[0] - iters[1]) <= F32_ITERATION_SPREAD * iters[1]


def test_bfloat16_step_products_in_average_mode_like_jax():
    # tpu_step_dtype="bfloat16" steps on a bf16 copy of K until the
    # residuals reach 1e-3 (or stall), then at full precision; the two
    # packages round their bf16 products differently, so the counts are
    # printed and the status and objective held to the JAX package's
    (jst, jinfo), (tst, tinfo) = _solve_pair(
        _synth_lp_dict(120, 150), "dense", "dense", tpu_dtype="float64",
        tpu_step_dtype="bfloat16", pdlp_optimality_tolerance=1e-5)
    assert int(tst) == int(jst) == int(highs_tpu_torch.HighsModelStatus.kOptimal)
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-6 * max(1.0, abs(jinfo.primal_obj))
