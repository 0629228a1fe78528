"""Dry run of the PDHG step over a mesh of n devices, on tiny shapes.

The port's counterpart of the JAX package's `__graft_entry__.py`
`dryrun_multichip`: every layout of `parallel/` runs one or two PDHG
blocks and is held against the same block on one device.

    python3 -m highs_tpu_torch.parallel.dryrun [n] [--device cpu] [--share]

(`--share`: all n shards on one device, as on a machine with one card.)

Parts (each raises on failure):
1. the dense (batch, rows) step: a batch of instances, each device group
   of the "batch" axis advancing its instances under `torch.func.vmap`
   with K's rows split over the "rows" axis;
2. the 2-D dense step: K tiled over (rows x cols);
3. one PDHG block over each row-sharded sparse family (ELL, panel ELL,
   block-CSR);
4. the 2-D sparse tiling (ELL tiles);
5. mesh invariance: a fixed LP's iterates on 1, 2, 4, 8 devices (those
   not above n) within 1e-5 (f32) of the one-device run, with the
   partial-sum reductions per step counted: at least one when d > 1
   (the JAX dry run counts XLA's all-reduces instead).

On the CPU the n devices are n views of the CPU; `devices` may repeat a
card.  `_synthetic_problem` is a copy of the JAX entry's (that module
imports JAX).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..ops import linops
from ..ops.linops import DenseMatrix
from ..solvers.pdlp.pdhg import PdhgProblem, PdhgState, pdhg_block
from . import shard_ops
from .mesh import (BATCH_AXIS, COL_AXIS, ROW_AXIS, make_mesh, shard_pdhg,
                   shard_pdhg_2d)

TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-12}

_VECTORS = ("b", "c", "lo", "up", "is_eq", "lo_fin", "up_fin",
            "inv_row_scale", "inv_col_scale", "norm_b", "norm_c")


def _synthetic_problem(m=256, n=384, batch=None, dtype=torch.float32,
                       seed=0, device="cpu"):
    """A feasible dense LP (rows b = A x_feas, 0 <= x <= 10) and a zero
    state, or `batch` of them stacked (seeds seed, seed + 1, ...)."""
    def build(s):
        r = np.random.default_rng(s)
        a = r.standard_normal((m, n)) * (r.random((m, n)) < 0.05)
        x_feas = r.random(n)
        b = a @ x_feas
        c = r.standard_normal(n)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        problem = PdhgProblem(
            k_op=DenseMatrix(t(a)), b=t(b), c=t(c), lo=t(np.zeros(n)),
            up=t(np.full(n, 10.0)), is_eq=t(np.ones(m)),
            lo_fin=t(np.ones(n)), up_fin=t(np.ones(n)),
            inv_row_scale=t(np.ones(m)), inv_col_scale=t(np.ones(n)),
            norm_b=t(np.linalg.norm(b)), norm_c=t(np.linalg.norm(c)))
        return problem, _zero_state(m, n, dtype, device)

    if batch is None:
        return build(seed)
    problems, states = zip(*[build(seed + i) for i in range(batch)])
    problem = PdhgProblem(
        k_op=DenseMatrix(torch.stack([p.k_op.a for p in problems])),
        **{f: torch.stack([getattr(p, f) for p in problems])
           for f in _VECTORS})
    state = PdhgState(*(torch.stack(list(v)) for v in zip(*states)))
    return problem, state


def _zero_state(m, n, dtype, device):
    def z(k):
        return torch.zeros((k,), dtype=dtype, device=device)
    return PdhgState(
        x=z(n), y=z(m), x_pd=z(n), y_pd=z(m), x_anchor=z(n),
        y_anchor=z(m), aty=z(n),
        k=torch.zeros((), dtype=torch.int32, device=device),
        eta=torch.tensor(0.05, dtype=dtype, device=device),
        omega=torch.tensor(1.0, dtype=dtype, device=device))


def _diff(a: PdhgState, b: PdhgState) -> float:
    return max(float((getattr(a, f).double().cpu() -
                      getattr(b, f).double().cpu()).abs().max())
               for f in ("x", "y", "x_pd", "y_pd"))


def _check(name: str, err: float, tol: float, report: dict) -> None:
    report[name] = err
    if not err <= tol:
        raise RuntimeError(f"dry run, {name}: the sharded iterates differ "
                           f"from one device's by {err:.3e} (limit {tol:g})")


def _sparse_problem(k_op, a, b, c, m_pad, n_pad, dtype, device):
    """PdhgProblem of min c'x, a x = b, 0 <= x <= 10 over the padded
    operator `k_op` (padded rows are 0 = 0)."""
    m, n = a.shape

    def pad(v, size, fill=0.0):
        out = np.full(size, fill)
        out[:len(v)] = v
        return torch.as_tensor(out, dtype=dtype, device=device)
    problem = PdhgProblem(
        k_op=k_op, b=pad(b, m_pad), c=pad(c, n_pad),
        lo=pad(np.zeros(n), n_pad), up=pad(np.full(n, 10.0), n_pad),
        is_eq=pad(np.ones(m), m_pad, 1.0), lo_fin=pad(np.ones(n), n_pad, 1.0),
        up_fin=pad(np.ones(n), n_pad, 1.0),
        inv_row_scale=pad(np.ones(m), m_pad, 1.0),
        inv_col_scale=pad(np.ones(n), n_pad, 1.0),
        norm_b=torch.tensor(float(np.linalg.norm(b)), dtype=dtype,
                            device=device),
        norm_c=torch.tensor(1.0, dtype=dtype, device=device))
    return problem, _zero_state(m_pad, n_pad, dtype, device)


def _padded(a, m_pad, n_pad):
    out = a.tocsr().copy()
    out.resize((m_pad, n_pad))
    return out


def dryrun_multichip(n_devices: int, device=None, devices=None,
                     dtype=torch.float32) -> dict:
    """Run every sharded layout of one PDHG step over an n-device mesh
    (default: n devices of `device`'s type, CUDA by default, n views of
    the CPU on the CPU; or `devices`, which may repeat one) and hold it
    against one device.  Returns a report of the differences and the
    reductions per step; raises on a failed part."""
    if devices is None:
        dev = resolve_device(device)
        devices = list(make_mesh((n_devices,), device=dev).devices)
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"{n_devices} devices asked for, "
                         f"{len(devices)} given")
    home = devices[0]
    tol = TOLERANCE[dtype]
    report = {"n_devices": n_devices,
              "devices": sorted({str(d) for d in devices})}

    # ---- 1. dense (batch, rows): the batch axis splits the instances
    # into device groups, each group's instances vmapped, K's rows split
    # over the group's devices
    b_size = 2 if n_devices % 2 == 0 else 1
    r_size = n_devices // b_size
    mesh = make_mesh((b_size, r_size), (BATCH_AXIS, ROW_AXIS),
                     devices=devices)
    m, n = 8 * max(r_size, 1), 16
    lanes = 2  # instances per batch group
    problem, state = _synthetic_problem(m=m, n=n, batch=b_size * lanes,
                                        dtype=dtype, device=home)

    def step(k_op_of, blocks, vecs, st):
        # vmapped: each half of a step one batched launch of its kernel
        # (the step operators' vmap rule)
        prob = PdhgProblem(k_op=k_op_of(blocks), **vecs)
        return pdhg_block(prob, st, 4, 1.0)

    def vmapped(k_op_of, blocks, vecs, st):
        return torch.func.vmap(
            lambda bl, v, s: step(k_op_of, bl, v, s))(blocks, vecs, st)

    def lanes_of(tree, g):
        return torch.utils._pytree.tree_map(
            lambda t: t[g * lanes:(g + 1) * lanes], tree)

    vecs = {f: getattr(problem, f) for f in _VECTORS}
    ref = vmapped(lambda a: DenseMatrix(a), problem.k_op.a, vecs, state)
    ref = vmapped(lambda a: DenseMatrix(a), problem.k_op.a, vecs, ref[0])
    err = 0.0
    for g in range(b_size):
        group = list(mesh.devices[g])
        g_home = group[0]
        bounds = [(k * (m // r_size), (k + 1) * (m // r_size))
                  for k in range(r_size)]
        blocks = [problem.k_op.a[g * lanes:(g + 1) * lanes, a:b].to(dev)
                  for (a, b), dev in zip(bounds, group)]

        def sharded(bl, _group=group, _bounds=bounds, _home=g_home):
            return shard_ops.RowShardedOp(
                [DenseMatrix(t) for t in bl], _group, _bounds, (m, n),
                _home)
        g_vecs = {f: v.to(g_home) for f, v in lanes_of(vecs, g).items()}
        g_state = torch.utils._pytree.tree_map(lambda t: t.to(g_home),
                                               lanes_of(state, g))
        out = vmapped(sharded, blocks, g_vecs, g_state)
        out = vmapped(sharded, blocks, g_vecs, out[0])
        err = max(err, _diff(out[0], lanes_of(ref[0], g)))
    _check("dense_batch_rows", err, tol, report)

    # ---- 2. dense 2-D: K tiled over (rows x cols)
    if n_devices >= 2:
        r2 = 2 if n_devices % 2 == 0 else 1
        c2 = n_devices // r2
        mesh2d = make_mesh((r2, c2), (ROW_AXIS, COL_AXIS), devices=devices)
        prob2, st2 = _synthetic_problem(m=8 * r2, n=16 * c2, dtype=dtype,
                                        device=home)
        ref2, _ = pdhg_block(prob2, st2, 4, 1.0)
        ref2, _ = pdhg_block(prob2, ref2, 4, 1.0)
        p2, s2 = shard_pdhg_2d(prob2, st2, mesh2d)
        out2, _ = pdhg_block(p2, s2, 4, 1.0)
        out2, _ = pdhg_block(p2, out2, 4, 1.0)
        _check("dense_2d", _diff(out2, ref2), tol, report)

    # ---- 3. each row-sharded sparse family (the JAX entry's draws)
    mesh1d = make_mesh((n_devices,), (ROW_AXIS,), devices=devices)
    rng = np.random.default_rng(0)
    ms, ns = 128 * n_devices, 256
    a_sp = sp.random(ms, ns, density=0.05, random_state=rng, format="csr")
    b_sp = a_sp @ rng.random(ns)
    for fmt in ("panelell", "ell", "blockcsr"):
        c_sp = rng.standard_normal(ns)
        k_op, m_pad = shard_ops.make_row_sharded(a_sp, mesh1d, ROW_AXIS,
                                                 fmt=fmt, dtype=dtype)
        prob3, st3 = _sparse_problem(k_op, a_sp, b_sp, c_sp, m_pad, ns,
                                     dtype, home)
        one = linops.from_scipy_ell(_padded(a_sp, m_pad, ns), dtype=dtype,
                                    device=home)
        ref3, _ = pdhg_block(prob3._replace(k_op=one), st3, 4, 1.0)
        out3, _ = pdhg_block(prob3, st3, 4, 1.0)
        _check(f"rows_{fmt}", _diff(out3, ref3), tol, report)

    # ---- 4. sparse 2-D tiling
    if n_devices >= 2:
        mesh2s = make_mesh((r2, c2), (ROW_AXIS, COL_AXIS), devices=devices)
        m4, n4 = 128 * r2, 128 * c2
        a4 = sp.random(m4, n4, density=0.05,
                       random_state=np.random.default_rng(7), format="csr")
        k4, m4p, n4p = shard_ops.make_2d_sharded(a4, mesh2s, ROW_AXIS,
                                                 COL_AXIS, fmt="ell",
                                                 dtype=dtype)
        prob4, st4 = _sparse_problem(k4, a4, np.zeros(m4), np.ones(n4),
                                     m4p, n4p, dtype, home)
        one4 = linops.from_scipy_ell(_padded(a4, m4p, n4p), dtype=dtype,
                                     device=home)
        ref4, _ = pdhg_block(prob4._replace(k_op=one4), st4, 4, 1.0)
        out4, _ = pdhg_block(prob4, st4, 4, 1.0)
        _check("sparse_2d", _diff(out4, ref4), tol, report)

    # ---- 5. mesh invariance and the reductions per step
    def row_sharded_block(nd, steps=8):
        mesh_k = make_mesh((nd,), (ROW_AXIS,), devices=devices[:nd])
        rng_k = np.random.default_rng(5)
        ms_k, ns_k = 128 * 8, 256  # the same LP at every mesh size
        a_k = sp.random(ms_k, ns_k, density=0.05, random_state=rng_k,
                        format="csr")
        k_opk, m_padk = shard_ops.make_row_sharded(
            a_k, mesh_k, ROW_AXIS, fmt="ell", dtype=dtype)
        bk = a_k @ rng_k.random(ns_k)
        probk, stk = _sparse_problem(k_opk, a_k, bk,
                                     rng_k.standard_normal(ns_k), m_padk,
                                     ns_k, dtype, mesh_k.home)
        probk, stk = shard_pdhg(probk, stk, mesh_k)
        before = shard_ops.REDUCTIONS
        out, _ = pdhg_block(probk, stk, steps, 1.0)
        per_step = (shard_ops.REDUCTIONS - before) / steps
        return out.x.double().cpu(), per_step

    census = {}
    x_ref = None
    for nd in (1, 2, 4, 8):
        if nd > n_devices:
            continue
        x_out, per_step = row_sharded_block(nd)
        census[nd] = per_step
        if x_ref is None:
            x_ref = x_out
        else:
            _check(f"invariance_{nd}",
                   float((x_out - x_ref).abs().max()), 1e-5, report)
        if nd > 1 and per_step < 1:
            raise RuntimeError(
                f"dry run: the {nd}-device row-sharded block made "
                f"{per_step} partial-sum reductions a step (need >= 1)")
    report["reductions_per_step"] = census
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--share", action="store_true",
                    help="put all n shards on the one device")
    args = ap.parse_args(argv)
    devices = ([resolve_device(args.device)] * args.n if args.share
               else None)
    print(dryrun_multichip(args.n, device=args.device, devices=devices),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
