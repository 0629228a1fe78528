"""PDLP over several devices: the port's `parallel/` against the JAX
package's on the same seeded inputs.

The JAX side runs on the tests' 8 virtual CPU devices
(`tests/conftest.py`), the port's on meshes of CPU views: the partition,
the per-shard products and the sums run as they would on d cards."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu.constants import HighsModelStatus as JStatus
from highs_tpu.models.lp import HighsLp as JLp
from highs_tpu.models.lp import HighsSparseMatrix as JMatrix
from highs_tpu.ops import linops as jlinops
from highs_tpu.options import HighsOptions as JOptions
from highs_tpu.parallel import mesh as jmesh
from highs_tpu.parallel import shard_ops as jshard
from highs_tpu.solvers.pdlp import pdhg as jpdhg
from highs_tpu.solvers.pdlp.wrapper import solve_lp_pdlp as jax_solve
from highs_tpu_torch import Highs
from highs_tpu_torch.constants import HighsModelStatus
from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
from highs_tpu_torch.ops import block_csr, linops
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.parallel import dryrun, mesh, shard_ops
from highs_tpu_torch.solvers.pdlp import pdhg
from highs_tpu_torch.solvers.pdlp.wrapper import solve_lp_pdlp
from highs_tpu_torch.utils import gen_block_lp as port_gen

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import gen_block_lp as jax_gen  # noqa: E402

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("spec", ["", "  ", "8", " 2 ", "4x2", "2x2x2"])
def test_parse_mesh_shape_like_jax(spec):
    assert mesh.parse_mesh_shape(spec) == jmesh.parse_mesh_shape(spec)


def _small_lp():
    rng = np.random.default_rng(3)
    m, n = 120, 150
    a = sp.random(m, n, density=0.05, random_state=rng, format="csc") + \
        sp.eye(m, n)
    b = a @ rng.uniform(0, 1, n)
    return a.tocsc(), b, rng.uniform(0.5, 1.5, n)


def _lps(a, b, c):
    m, n = a.shape
    kw = dict(num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
              col_upper=np.full(n, 5.0), row_lower=np.asarray(b),
              row_upper=np.asarray(b), sense=1)
    return (JLp(a_matrix=JMatrix.from_scipy(a), **kw),
            HighsLp(a_matrix=HighsSparseMatrix.from_scipy(a), **kw))


@pytest.mark.parametrize("case", [
    "multi-axis mesh", "multi-axis option", "oversize mesh",
    "oversize option"])
def test_multi_axis_and_oversize_shapes_raise(case, monkeypatch):
    # both packages raise ValueError; neither falls back to one device
    if case == "multi-axis mesh":
        with pytest.raises(ValueError):  # JAX: one axis name, two axes
            jmesh.make_mesh(jmesh.parse_mesh_shape("4x2"))
        with pytest.raises(ValueError, match="axis names"):
            mesh.make_mesh(mesh.parse_mesh_shape("4x2"), device="cpu")
    elif case == "multi-axis option":
        jlp, tlp = _lps(*_small_lp())
        for pkg_opts, solve, kw in ((JOptions(), jax_solve, {}),
                                    (HighsOptions(), solve_lp_pdlp,
                                     {"device": "cpu"})):
            pkg_opts.tpu_mesh_shape = "4x2"
            pkg_opts.tpu_matrix_format = "ell"
            with pytest.raises(ValueError):
                solve(jlp if solve is jax_solve else tlp, pkg_opts, **kw)
    elif case == "oversize mesh":
        with pytest.raises(ValueError):  # 16 of the 8 virtual devices
            jmesh.make_mesh((16,))
        with pytest.raises(ValueError, match="needs 16 devices; 8"):
            mesh.make_mesh((16,), devices=[CPU] * 8)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="needs 2 CUDA devices; this "
                                             "machine has 1"):
            mesh.make_mesh((2,), device="cuda")
    else:
        # more cards than the machine has, through the option: raises
        # before any tensor reaches a device
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        opts = HighsOptions()
        opts.tpu_mesh_shape = "2"
        with pytest.raises(ValueError, match="machine has 1"):
            solve_lp_pdlp(_lps(*_small_lp())[1], opts, device="cuda")


def test_mesh_layout():
    m2 = mesh.make_mesh((4, 2), ("rows", "cols"), device="cpu")
    assert m2.shape == {"rows": 4, "cols": 2} and m2.devices.size == 8
    assert m2.home == CPU
    devs, procs = m2.grid("cols", "rows")
    assert devs.shape == (2, 4) and procs is None
    assert m2.grid("rows")[0].shape == (4,)
    with pytest.raises(ValueError, match="no axis"):
        m2.grid("batch")
    # an explicit list may repeat a device; the first is home
    m1 = mesh.make_mesh((3,), devices=["cpu", "cpu", "cpu", "cpu"])
    assert m1.shape == {"rows": 3} and list(m1.devices) == [CPU] * 3


def _products(m, n, m_pad, n_pad, rng):
    x = np.zeros(n_pad)
    x[:n] = rng.standard_normal(n)
    y = np.zeros(m_pad)
    y[:m] = rng.standard_normal(m)
    return x, y


@pytest.mark.parametrize("fmt", ["panelell", "ell", "blockcsr"])
def test_row_sharded_products_match_jax_and_scipy(fmt):
    rng = np.random.default_rng(11)
    m, n = 700, 500
    a = sp.random(m, n, density=0.02, random_state=rng, format="csr")
    jop, jm_pad = jshard.make_row_sharded(
        a, jmesh.make_mesh((8,), axis_names=("rows",)), "rows", fmt=fmt,
        dtype=jnp.float64)
    before = shard_ops.REDUCTIONS
    op, m_pad = shard_ops.make_row_sharded(
        a, mesh.make_mesh((8,), device="cpu"), "rows", fmt=fmt,
        dtype=torch.float64)
    assert (m_pad, op.shape) == (jm_pad, tuple(jop.shape))
    assert len(op.shards) == 8 and op.m_local == m_pad // 8
    if fmt == "blockcsr":
        # each shard's tiles are its nonzero 128x128 blocks, K' too: no
        # zero tile fills the block-rows its rows miss
        for k, s in enumerate(op.shards):
            assert isinstance(s, block_csr.BlockCsrMatrix)
            rows = sp.csr_matrix(a)
            rows.resize((m_pad, op.shape[1]))
            rows = rows[k * op.m_local:(k + 1) * op.m_local]
            for bc, half in ((s.fwd, rows), (s.bwd, rows.T.tocsr())):
                assert bool((bc.blocks != 0).flatten(1).any(1).all())
                tiles = half.tobsr(blocksize=(128, 128))
                tiles.eliminate_zeros()
                assert bc.blocks.shape[0] == int(
                    (tiles.data.reshape(-1, 128 * 128) != 0).any(1).sum())
    x, y = _products(m, n, m_pad, op.shape[1], rng)
    mv = op.mv(torch.as_tensor(x)).numpy()
    rmv = op.rmv(torch.as_tensor(y)).numpy()
    assert shard_ops.REDUCTIONS == before + 1  # one sum of 8 partials
    jmv = np.asarray(jax.jit(lambda o, v: o.mv(v))(jop, jnp.asarray(x)))
    jrmv = np.asarray(jax.jit(lambda o, v: o.rmv(v))(jop, jnp.asarray(y)))
    np.testing.assert_allclose(mv, jmv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rmv, jrmv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mv[:m], a @ x[:n], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rmv[:n], a.T @ y[:m], rtol=0, atol=1e-12)
    assert np.all(mv[m:] == 0.0)


@pytest.mark.parametrize("fmt", ["panelell", "ell", "blockcsr"])
def test_2d_sharded_products_match_jax_and_scipy(fmt):
    rng = np.random.default_rng(13)
    m, n = 700, 500
    a = sp.random(m, n, density=0.02, random_state=rng, format="csr")
    jop, jm_pad, jn_pad = jshard.make_2d_sharded(
        a, jmesh.make_mesh((4, 2), axis_names=("rows", "cols")), "rows",
        "cols", fmt=fmt, dtype=jnp.float64)
    op, m_pad, n_pad = shard_ops.make_2d_sharded(
        a, mesh.make_mesh((4, 2), ("rows", "cols"), device="cpu"), "rows",
        "cols", fmt=fmt, dtype=torch.float64)
    assert (m_pad, n_pad) == (jm_pad, jn_pad)
    assert (op.m_local, op.n_local) == (jop.m_local, jop.n_local)
    x, y = _products(m, n, m_pad, n_pad, rng)
    mv = op.mv(torch.as_tensor(x)).numpy()
    rmv = op.rmv(torch.as_tensor(y)).numpy()
    jmv = np.asarray(jax.jit(lambda o, v: o.mv(v))(jop, jnp.asarray(x)))
    jrmv = np.asarray(jax.jit(lambda o, v: o.rmv(v))(jop, jnp.asarray(y)))
    np.testing.assert_allclose(mv, jmv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rmv, jrmv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mv[:m], a @ x[:n], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rmv[:n], a.T @ y[:m], rtol=0, atol=1e-12)
    assert np.all(mv[m:] == 0.0)


def test_sharded_values_cast_and_dtype():
    a = sp.random(300, 200, density=0.05, random_state=4, format="csr")
    m8 = mesh.make_mesh((4,), device="cpu")
    for fmt, lowprec in (("ell", True), ("blockcsr", False)):
        op, _ = shard_ops.make_row_sharded(a, m8, "rows", fmt=fmt,
                                           dtype=torch.float64)
        assert linops.linop_dtype(op) == torch.float64
        f32 = op.astype_values(torch.float32)
        assert linops.linop_dtype(f32) == torch.float32
        assert f32.row_bounds == op.row_bounds
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(
            op.shape[1]))
        np.testing.assert_allclose(f32.mv(x.float()).double().numpy(),
                                   op.mv(x).numpy(), rtol=0, atol=1e-5)
        # cast_linop: a low-precision step copy exactly where the
        # unsharded family has one (dense, ELL, panel ELL)
        cast = linops.cast_linop(op, torch.bfloat16)
        assert (cast is not None) == lowprec
        if lowprec:
            assert linops.linop_dtype(cast) == torch.bfloat16
            assert op.shards[0].idx.dtype == cast.shards[0].idx.dtype


def _pdhg_512(pkg_linops, pkg_pdhg, t, ones, zeros, full, scalar):
    rng = np.random.default_rng(14)
    m = n = 512
    a = (sp.random(m, n, density=0.01, random_state=rng, format="csr") +
         sp.identity(m)).tocsr()
    b = rng.standard_normal(m)
    c = rng.uniform(0.1, 1.0, n)
    prob = pkg_pdhg.PdhgProblem(
        k_op=None, b=t(b), c=t(c), lo=zeros(n), up=full(n, 10.0),
        is_eq=zeros(m), lo_fin=ones(n), up_fin=ones(n),
        inv_row_scale=ones(m), inv_col_scale=ones(n),
        norm_b=scalar(np.linalg.norm(b)), norm_c=scalar(np.linalg.norm(c)))
    st = pkg_pdhg.PdhgState(
        x=zeros(n), y=zeros(m), x_pd=zeros(n), y_pd=zeros(m),
        x_anchor=zeros(n), y_anchor=zeros(m), aty=zeros(n),
        k=scalar(0, int), eta=scalar(0.05), omega=scalar(1.0))
    return a, prob, st


def test_2d_sparse_pdhg_steps_match_jax():
    a, jprob, jst = _pdhg_512(
        jlinops, jpdhg, jnp.asarray, jnp.ones, jnp.zeros, jnp.full,
        lambda v, k=float: jnp.asarray(v, jnp.int32 if k is int else None))
    jprob = jprob._replace(k_op=jlinops.from_scipy_ell(a,
                                                       dtype=jnp.float64))
    jprob, jst = jmesh.shard_pdhg_2d(
        jprob, jst, jmesh.make_mesh((4, 2), axis_names=("rows", "cols")),
        mat=a, fmt="ell")
    js, jm = jpdhg.pdhg_block(jprob, jst, 40, 1.0)

    d = torch.float64
    _, prob, st = _pdhg_512(
        linops, pdhg, lambda v: torch.as_tensor(v, dtype=d),
        lambda k: torch.ones(k, dtype=d), lambda k: torch.zeros(k, dtype=d),
        lambda k, v: torch.full((k,), v, dtype=d),
        lambda v, k=float: torch.tensor(
            v, dtype=torch.int32 if k is int else d))
    prob = prob._replace(k_op=linops.from_scipy_ell(a, dtype=d,
                                                    device="cpu"))
    prob, st = mesh.shard_pdhg_2d(
        prob, st, mesh.make_mesh((4, 2), ("rows", "cols"), device="cpu"),
        mat=a, fmt="ell")
    assert isinstance(prob.k_op, shard_ops.TwoDShardedOp)
    s, mt = pdhg.pdhg_block(prob, st, 40, 1.0)
    for f in ("x_pd", "y_pd", "x", "y"):
        np.testing.assert_allclose(getattr(s, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-12)
    assert abs(float(mt.primal_res) - float(jm.primal_res)) <= 1e-10


def test_dense_problem_splits_by_rows():
    prob, st = dryrun._synthetic_problem(m=40, n=24, dtype=torch.float64)
    sharded, st2 = mesh.shard_pdhg(prob, st, mesh.make_mesh((3,),
                                                            device="cpu"))
    op = sharded.k_op
    assert isinstance(op, shard_ops.RowShardedOp)
    assert op.row_bounds == [(0, 14), (14, 27), (27, 40)]
    x = torch.linspace(-1, 1, 24, dtype=torch.float64)
    y = torch.linspace(2, -1, 40, dtype=torch.float64)
    np.testing.assert_allclose(op.mv(x).numpy(), prob.k_op.mv(x).numpy(),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(op.rmv(y).numpy(), prob.k_op.rmv(y).numpy(),
                               rtol=0, atol=1e-13)
    a, _ = pdhg.pdhg_block(prob, st, 10, 1.0)
    b, _ = pdhg.pdhg_block(sharded, st2, 10, 1.0)
    np.testing.assert_allclose(b.x.numpy(), a.x.numpy(), rtol=0, atol=1e-12)


def _lp_1200():
    # tests/test_mesh_invariance.py::test_sharded_sparse_pdlp_solve's LP
    rng = np.random.default_rng(12)
    m = n = 1200
    a = sp.random(m, n, density=0.004, random_state=rng,
                  format="csc") + sp.identity(m) * 2.0
    b = a @ rng.uniform(0, 1, n)
    c = rng.uniform(0.5, 1.5, n)
    kw = dict(num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
              col_upper=np.full(n, 5.0), row_lower=np.asarray(b).ravel(),
              row_upper=np.asarray(b).ravel(), sense=1)
    return (JLp(a_matrix=JMatrix.from_scipy(a.tocsc()), **kw),
            HighsLp(a_matrix=HighsSparseMatrix.from_scipy(a.tocsc()), **kw))


def _options(cls, mesh_spec, **kw):
    o = cls()
    o.solver = "hipdlp"
    o.output_flag = False
    o.tpu_matrix_format = "ell"
    o.pdlp_optimality_tolerance = 1e-7
    o.tpu_mesh_shape = mesh_spec
    for k, v in kw.items():
        setattr(o, k, v)
    return o


@pytest.mark.parametrize("mesh_spec", ["", "2", "8"])
def test_sharded_pdlp_solve_like_jax(mesh_spec):
    jlp, tlp = _lp_1200()
    jst, _, jinfo = jax_solve(jlp, _options(JOptions, mesh_spec))
    before = shard_ops.REDUCTIONS
    tst, tsol, tinfo = solve_lp_pdlp(tlp, _options(HighsOptions, mesh_spec),
                                     device="cpu")
    print(f"mesh {mesh_spec!r}: JAX {jinfo.iterations} iterations obj "
          f"{jinfo.primal_obj!r}; port {tinfo.iterations} iterations obj "
          f"{tinfo.primal_obj!r}")
    assert int(jst) == int(JStatus.kOptimal)
    assert int(tst) == int(HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-9 * abs(jinfo.primal_obj)
    # K' y went through the sum of the shards' partials at every step
    reductions = shard_ops.REDUCTIONS - before
    assert reductions >= (tinfo.iterations if mesh_spec not in ("",)
                          else 0)
    assert (reductions == 0) == (mesh_spec == "")


def test_sharded_pdlp_average_mode_like_jax():
    jlp, tlp = _lp_1200()
    kw = dict(solver="pdlp", pdlp_optimality_tolerance=1e-6)
    jst, _, jinfo = jax_solve(jlp, _options(JOptions, "4", **kw))
    tst, _, tinfo = solve_lp_pdlp(tlp, _options(HighsOptions, "4", **kw),
                                  device="cpu")
    assert int(tst) == int(jst) == int(HighsModelStatus.kOptimal)
    assert tinfo.iterations == jinfo.iterations
    assert tinfo.restarts == jinfo.restarts
    assert abs(tinfo.primal_obj - jinfo.primal_obj) <= \
        1e-9 * abs(jinfo.primal_obj)


def _block_lps(nblocks=2):
    a, b, c = port_gen.gen_block_lp(nblocks=nblocks)
    ja, jb, jc = jax_gen.gen_block_lp(nblocks=nblocks)
    assert (a != ja).nnz == 0
    m, n = a.shape
    kw = dict(num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
              col_upper=np.full(n, port_gen.UPPER), row_lower=b,
              row_upper=np.full(m, np.inf), sense=1)
    a = sp.csc_matrix(a)
    return (JLp(a_matrix=JMatrix.from_scipy(a), **kw),
            HighsLp(a_matrix=HighsSparseMatrix.from_scipy(a), **kw))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_blockcsr_mesh_solve(dtype):
    # the block LP row-sharded in block-CSR over 4 devices: the port's
    # unsharded block-CSR solve and the JAX package's ELL mesh solve; in
    # f32 the cold round and the refinement rounds keep the mesh
    jlp, tlp = _block_lps()
    kw = dict(tpu_dtype=dtype, pdlp_optimality_tolerance=1e-7)
    one = solve_lp_pdlp(tlp, _options(HighsOptions, "",
                                      tpu_matrix_format="blockcsr", **kw),
                        device="cpu")
    four = solve_lp_pdlp(tlp, _options(HighsOptions, "4",
                                       tpu_matrix_format="blockcsr", **kw),
                         device="cpu")
    jst, _, jinfo = jax_solve(jlp, _options(JOptions, "4",
                                            tpu_dtype="float64"))
    print(f"{dtype}: unsharded {one[2].iterations} iterations "
          f"{one[2].primal_obj!r}; 4 shards {four[2].iterations} "
          f"{four[2].primal_obj!r}; JAX ell mesh {jinfo.iterations} "
          f"{jinfo.primal_obj!r}")
    assert int(one[0]) == int(four[0]) == int(HighsModelStatus.kOptimal)
    assert int(jst) == int(JStatus.kOptimal)
    assert abs(four[2].iterations - one[2].iterations) <= \
        0.05 * one[2].iterations
    for ref in (one[2].primal_obj, jinfo.primal_obj):
        assert abs(four[2].primal_obj - ref) <= 1e-6 * max(1.0, abs(ref))


def test_checkpoint_restart_keeps_the_mesh(tmp_path):
    # a run stopped at its iteration limit leaves a checkpoint; the
    # restarted run reads it, lays the state out on the mesh again and
    # finishes in the iterations that were left
    _, tlp = _lp_1200()
    ckpt = str(tmp_path / "pdlp.npz")
    kw = dict(pdlp_checkpoint_file=ckpt, pdlp_checkpoint_interval=1)
    full = solve_lp_pdlp(tlp, _options(HighsOptions, "2"), device="cpu")
    cut = solve_lp_pdlp(tlp, _options(HighsOptions, "2",
                                      pdlp_iteration_limit=1000, **kw),
                        device="cpu")
    assert int(cut[0]) == int(HighsModelStatus.kIterationLimit)
    assert os.path.exists(ckpt)
    rest = solve_lp_pdlp(tlp, _options(HighsOptions, "2", **kw),
                         device="cpu")
    assert int(rest[0]) == int(HighsModelStatus.kOptimal)
    assert abs(rest[2].primal_obj - full[2].primal_obj) <= \
        1e-6 * abs(full[2].primal_obj)


def test_facade_mesh_on_the_cpu():
    # Highs(device="cpu") with tpu_mesh_shape "8": the same answer as
    # without a mesh
    _, tlp = _lp_1200()
    objs = {}
    for spec in ("", "8"):
        h = Highs(device="cpu")
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "hipdlp")
        h.setOptionValue("presolve", "off")
        h.setOptionValue("tpu_matrix_format", "ell")
        h.setOptionValue("tpu_mesh_shape", spec)
        h.passModel(tlp)
        h.run()
        assert h.getModelStatus() == HighsModelStatus.kOptimal
        objs[spec] = (h.getObjectiveValue(),
                      h.getInfo().pdlp_iteration_count)
    assert objs[""][1] == objs["8"][1]
    assert abs(objs[""][0] - objs["8"][0]) <= 1e-9 * abs(objs[""][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dryrun_multichip_matches_one_device(dtype):
    report = dryrun.dryrun_multichip(8, device="cpu", dtype=dtype)
    for part in ("dense_batch_rows", "dense_2d", "rows_panelell",
                 "rows_ell", "rows_blockcsr", "sparse_2d", "invariance_2",
                 "invariance_4", "invariance_8"):
        assert report[part] <= dryrun.TOLERANCE[dtype], part
    census = report["reductions_per_step"]
    assert census[1] == 0 and all(census[d] >= 1 for d in (2, 4, 8))
