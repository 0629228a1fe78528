#!/usr/bin/env python3
"""Chip smoke test of highs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build    the CUDA kernels of `highs_tpu_torch/csrc/` with nvcc
            (sm_90a), one nvcc process per source, all started together;
2. blockcsr the block-CSR kernel on the block64k operator (65,536 x
            65,536, 1,534 dense 128x128 tiles per direction), in float32
            and float64, K x and K' y: against its plain PyTorch version
            on the card (f64: 1e-12, f32: 1e-5, both relative to
            ||(|A| |x|)||_inf), and the times of the kernel, the plain
            version and one PyTorch BSR product (a yardstick only),
            beside the byte and operation bound;
3. onehot   the fused one-hot kernel (the whole product y = K x in one
            launch) on the synth50k operator (50,176 x 50,176 padded,
            P = 7 slots per cell, a table of 499,953 entries per
            direction), in float32 and float64, K x and K' y: against its
            plain PyTorch version over the same table and against the JAX
            package's composition over the padded cells (gather, relayout,
            scatter, spill) in f64 (f64: 1e-12, f32: 1e-5, relative to
            ||(|A| |x|)||_inf), the same bits on a rerun, one launch per
            product, with the times of the kernel, its plain version and
            one `torch.sparse_csr_tensor @ x` of the same matrix (a
            yardstick only) beside the byte bound of the table;
4. probe    the gather-rate probe at the shapes of the JAX package's two
            probes, f32 and f64: exactly equal to `torch.gather`, rates;
5. small    a 256 x 256 block LP through `Highs` on the card and on the
            CPU: the two objectives agree to 1e-6 relative;
6. formats  a 4,096 x 4,096 synth LP through `Highs(device="cuda")` with
            solver "hipdlp" at tolerance 1e-5 in each of the formats
            dense, ell, panelell, bucketell, bucketperm, bcoo and onehot,
            and bucketperm again at 1e-6, below the f32 floor, so that
            its f64 refinement runs in the permuted space: every run
            kOptimal, every objective within 1e-6 relative of an f64 CPU
            `ell` run of the port at the same tolerance;
7. block64k through `Highs().run()` with the default options (solver
            "choose", tolerance 1e-7: an f32 cold round and f64
            refinement): kOptimal, an independent f64 KKT check of the
            returned solution (primal and dual residual and gap <= 1e-7),
            the objective against the upstream HiGHS run recorded in
            BASELINE_MEASURED.json, and at least two block-CSR launches
            per PDLP iteration;
8. synth50k through `Highs().run()` with solver "hipdlp" and
            tpu_matrix_format "onehot" (tolerance 1e-7): kOptimal, the
            same independent KKT check, the objective within 1e-6 of
            upstream HiGHS's, and the one-hot kernel launched at least
            twice per PDLP iteration.

Kernel times (`ms`, `plain_ms`, `library_ms`) are device times with a
cold L2, as the PDLP loop finds its operator (`tools/card.py`
`time_ms`: a CUDA graph cycling through clones of the inputs that fill
four times the L2); a kernel timed below its byte or operation bound
fails the run.  `call_ms` is one call's time with the host's launch
gap.  Each path's launch counts are set to 0 just before its run and
read just after.  It prints the kernels' summary as one JSON line, the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card, or without the rest of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

TOLERANCE = {"float32": 1e-5, "float64": 1e-12}
KKT_TOL = 1e-7
SOLVE_TIME_LIMIT = 600.0
SOURCES = ["block_csr_spmv", "onehot_spmv", "gather_probe"]
# upstream HiGHS's hipdlp on synth50k: optimal at 6704.2920770 in
# 47,080 iterations (bench.py:215-220, BENCH_DETAILS.json)
SYNTH50K_OBJECTIVE = 6704.2920770
FORMATS = ["dense", "ell", "panelell", "bucketell", "bucketperm", "bcoo",
           "onehot"]
FORMATS_ROWS = 4096
# (format, tolerance) of the formats phase
FORMATS_RUNS = [(fmt, 1e-5) for fmt in FORMATS] + [("bucketperm", 1e-6)]
KERNELS = {
    "block_csr_spmv": ("highs_tpu_torch/csrc/block_csr_spmv.cu",
                       "highs_tpu/ops/block_csr.py:111"),
    "onehot_spmv": ("highs_tpu_torch/csrc/onehot_spmv.cu",
                    "highs_tpu/ops/onehot_spmv.py:132, "
                    "highs_tpu/ops/onehot_spmv.py:146"),
    "gather_probe": ("highs_tpu_torch/csrc/gather_probe.cu",
                     "tools/gather_probe.py:79, tools/gather_probe2.py:33"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def sync(device) -> None:
    """Wait for the card (phases also run on the CPU, in rehearsals)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def relative_error(got, want, scale: float):
    err = (got.double() - want.double()).abs().max().item()
    return err, err / max(scale, 1e-300)


def block_bound_ms(bc):
    """The least time of one block-CSR product: each input read once
    (tiles, column indices, row pointer, x), y written once; 2
    operations per tile element."""
    from highs_tpu_torch.tools.card import bound_ms
    mb = bc.shape[0] // 128
    nb = bc.shape[1] // 128
    item = bc.blocks.element_size()
    nbytes = (bc.blocks.numel() * item + bc.block_col.numel() * 4 +
              (mb + 1) * 4 + nb * 128 * item + mb * 128 * item)
    return bound_ms(nbytes, 2.0 * bc.blocks.numel(), bc.blocks.dtype)


def library_bsr(bc, x):
    """One PyTorch call for the same product, as (fn, inputs): a BSR
    tensor of the untransposed tiles times x.  A yardstick; the port
    never calls it."""
    import torch
    with warnings.catch_warnings():  # BSR tensors are in beta
        warnings.simplefilter("ignore", UserWarning)
        bsr = torch.sparse_bsr_tensor(
            bc.row_ptr, bc.block_col,
            bc.blocks.transpose(1, 2).contiguous(), size=bc.shape)

    def run(bsr, x):
        return (bsr @ x.unsqueeze(1)).squeeze(1)
    return run, (bsr, x)


def timed_library(make, device, want):
    """(device ms, note) of a library yardstick `fn(*inputs)`, `make()`
    giving (fn, inputs), or (None, why) where PyTorch has no such
    product for these inputs on this card."""
    from highs_tpu_torch.tools.card import time_ms
    try:
        fn, inputs = make()
        diff = (fn(*inputs).double() - want.double()).abs().max().item()
        return (time_ms(fn, device, *inputs),
                f"max abs diff to plain {diff:.3e}")
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return None, (f"unavailable: {type(exc).__name__}: "
                      f"{str(exc).splitlines()[0][:160]}")


def blockcsr_phase(a, device):
    """Block-CSR kernel against plain on the block64k operator."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.tools.card import call_ms, time_ms

    op64 = block_csr.from_scipy_block_csr(a, dtype=torch.float64,
                                          device=device)
    rng = np.random.default_rng(7)
    variants = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for direction, bc64 in (("mv", op64.fwd), ("rmv", op64.bwd)):
            bc = bc64._replace(blocks=bc64.blocks.to(dtype))
            abs_bc = bc64._replace(blocks=bc64.blocks.abs())
            x = torch.as_tensor(rng.standard_normal(bc.shape[1]),
                                dtype=dtype, device=device)
            before = block_csr.LAUNCHES
            got = block_csr.block_csr_spmv(bc, x)
            sync(device)
            if device.type == "cuda" and block_csr.LAUNCHES != before + 1:
                raise RuntimeError("the block-CSR wrapper did not launch "
                                   "its kernel on a CUDA tensor")
            want = block_csr.spmv_plain(bc, x)
            scale = block_csr.spmv_plain(
                abs_bc, x.abs().double()).abs().max().item()
            err, rel = relative_error(got, want, scale)
            ok = bool(math.isfinite(err) and rel <= TOLERANCE[name])
            k_ms = time_ms(block_csr.block_csr_spmv, device, bc, x)
            k_call_ms = call_ms(lambda: block_csr.block_csr_spmv(bc, x),
                                device)
            p_ms = time_ms(block_csr.spmv_plain, device, bc, x)
            lib_ms, lib_note = timed_library(lambda: library_bsr(bc, x),
                                             device, want)
            b_ms, b_by = block_bound_ms(bc)
            rec = dict(dtype=name, direction=direction,
                       nnzb=int(bc.blocks.shape[0]), max_abs_err=err,
                       rel_err=rel, tolerance=TOLERANCE[name], ok=ok,
                       ms=k_ms, call_ms=k_call_ms, plain_ms=p_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            log(f"blockcsr {name} {direction}: nnzb {rec['nnzb']} "
                f"max_abs_err {err:.3e} rel {rel:.3e} "
                f"(tol {TOLERANCE[name]:g}) kernel_ms {k_ms:.4f} "
                f"(per call {k_call_ms:.4f}) "
                f"plain_ms {p_ms:.4f} bound_us {b_ms * 1e3:.2f} ({b_by}) "
                f"library_ms {lib_ms} [{lib_note}]")
            variants.append(rec)
            del bc, abs_bc
    del op64
    bad = [v for v in variants if not v["ok"]]
    if bad:
        raise RuntimeError(f"block-CSR kernel disagrees with its plain "
                           f"version: {bad}")
    return variants


def check_timings(records):
    """Fail on a kernel timed below its bound: such a time was taken
    with its data in the L2, not as the PDLP loop finds it."""
    below = [f"{name} {r['dtype']} {r.get('direction', r.get('name'))}: "
             f"{r['ms']:.5f} ms < {r['bound_ms']:.5f} ms"
             for name, recs in records.items() for r in recs
             if r["ms"] < r["bound_ms"]]
    if below:
        raise RuntimeError(f"kernels timed below their bound: {below}")


def padded_synth50k():
    """The unscaled synth50k matrix and vectors, and the matrix padded
    as the PDLP wrapper pads it (50,176 = 392 x 128)."""
    import numpy as np
    import scipy.sparse as sp
    from highs_tpu_torch.solvers.pdlp.wrapper import _bucket
    from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp
    a, b, c = gen_synth_lp()
    m, n = a.shape
    csr = a.tocsr()
    indptr = np.concatenate([csr.indptr, np.full(_bucket(m) - m,
                                                 csr.indptr[-1])])
    a_pad = sp.csr_matrix((csr.data, csr.indices, indptr),
                          shape=(_bucket(m), _bucket(n)))
    return a, b, c, a_pad


def onehot_bound_ms(tab):
    """The least time of one fused one-hot product: the table (row
    pointer, columns, values) and x read once, y written once; 2
    operations a term."""
    from highs_tpu_torch.tools.card import bound_ms
    item = tab.val.element_size()
    nbytes = (tab.row_ptr.numel() * 4 + tab.col.numel() * 4 +
              tab.val.numel() * item + (tab.shape[0] + tab.shape[1]) * item)
    return bound_ms(nbytes, 2.0 * tab.val.numel(), tab.val.dtype)


def onehot_phase(a_pad, device):
    """The fused one-hot kernel against plain on the synth50k operator."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import linops
    from highs_tpu_torch.ops import onehot_spmv as oh
    from highs_tpu_torch.tools.card import call_ms, time_ms

    op64 = oh.from_scipy_onehot(a_pad, torch.float64, device=device)
    p = op64.fwd.p_slots
    abs_op = oh.from_scipy_onehot(abs(a_pad), torch.float64, p_slots=p,
                                  device=device)
    # the JAX package's padded cells, for the JAX-shaped plain product
    cells = (oh.build_cells(a_pad, p, torch.float64, device),
             oh.build_cells(a_pad.T.tocsr(), p, torch.float64, device))
    log(f"onehot: synth50k padded to {a_pad.shape}, {a_pad.nnz} nonzeros, "
        f"P {p}, table entries {op64.fwd.col.numel()} (K) "
        f"{op64.bwd.col.numel()} (K'), of them spilled {op64.fwd.pad_cnt} "
        f"(K) {op64.bwd.pad_cnt} (K'); padded-cell slots per direction "
        f"{cells[0].gcol.numel()}")
    rng = np.random.default_rng(8)
    records = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        op = op64 if dtype == torch.float64 else oh.from_scipy_onehot(
            a_pad, dtype, p_slots=p, device=device)
        lib = linops.from_scipy_bcoo(a_pad, dtype=dtype, device=device)
        for direction, tab, abs_tab, oc, lib_a in (
                ("mv", op.fwd, abs_op.fwd, cells[0], lib.a),
                ("rmv", op.bwd, abs_op.bwd, cells[1], lib.at)):
            x = torch.as_tensor(rng.standard_normal(tab.shape[1]),
                                dtype=dtype, device=device)
            before = oh.LAUNCHES["onehot_spmv"]
            got = oh.onehot_spmv(tab, x)
            sync(device)
            if device.type == "cuda" and \
                    oh.LAUNCHES["onehot_spmv"] != before + 1:
                raise RuntimeError("the one-hot wrapper did not launch its "
                                   "kernel once on a CUDA tensor")
            same_bits = bool(torch.equal(got, oh.onehot_spmv(tab, x)))
            want = oh.onehot_spmv_plain(tab, x)
            scale = oh.onehot_spmv_plain(
                abs_tab, x.abs().double()).abs().max().item()
            err, rel = relative_error(got, want, scale)
            # the JAX-shaped composition over the padded cells, in f64
            cells_err, cells_rel = relative_error(
                got, oh.spmv_cells_plain(oc, x.double()), scale)
            lib_ms, lib_note = timed_library(
                lambda: (torch.mv, (lib_a, x)), device, want)
            b_ms, b_by = onehot_bound_ms(tab)
            tol = TOLERANCE[name]
            rec = dict(
                dtype=name, direction=direction, entries=tab.col.numel(),
                max_abs_err=err, rel_err=rel, tolerance=tol,
                cells_rel_err=cells_rel, same_bits=same_bits,
                ok=bool(math.isfinite(err) and rel <= tol and
                        cells_rel <= tol and same_bits),
                ms=time_ms(oh.onehot_spmv, device, tab, x),
                call_ms=call_ms(lambda: oh.onehot_spmv(tab, x), device),
                plain_ms=time_ms(oh.onehot_spmv_plain, device, tab, x),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            log(f"onehot {name} {direction}: entries {rec['entries']} "
                f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}; vs the "
                f"padded-cell composition {cells_rel:.3e}; same bits on a "
                f"rerun: {same_bits}) kernel_ms {rec['ms']:.4f} (per call "
                f"{rec['call_ms']:.4f}) plain_ms {rec['plain_ms']:.4f} "
                f"bound_us {b_ms * 1e3:.2f} ({b_by}) library_ms {lib_ms} "
                f"[torch.sparse_csr_tensor @ x, {lib_note}]")
            records.append(rec)
        del op, lib
    del op64, abs_op, cells
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"the one-hot kernel disagrees with its plain "
                           f"version: {bad}")
    return records


def probe_phase(device):
    """The gather probe: exact against torch.gather, with its rates."""
    from highs_tpu_torch.tools import gather_probe
    records = gather_probe.measure(device)
    for r in records:
        log(f"probe {r['name']} {r['dtype']}: equal {r['equal']} kernel_ms "
            f"{r['ms']:.4f} ({r['gelem_per_s']:.2f} Gelem/s; per call "
            f"{r['call_ms']:.4f}) "
            f"torch.gather_ms {r['plain_ms']:.4f} "
            f"({r['plain_gelem_per_s']:.2f} Gelem/s) bound_us "
            f"{r['bound_ms'] * 1e3:.2f} ({r['bound_by']})")
    if not all(r["equal"] for r in records):
        raise RuntimeError("the gather probe differs from torch.gather")
    return records


def small_phase(device):
    """A small block LP on the device and on the CPU: same objective."""
    import highs_tpu_torch
    from highs_tpu_torch.utils.gen_block_lp import block_lp

    objs = {}
    for dev in (device, "cpu"):
        h = highs_tpu_torch.Highs(device=dev)
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "hipdlp")
        h.setOptionValue("tpu_matrix_format", "blockcsr")
        h.passModel(block_lp(nblocks=2))
        h.run()
        status = h.getModelStatus()
        if status != highs_tpu_torch.HighsModelStatus.kOptimal:
            raise RuntimeError(f"small LP on {dev}: status {status!r}")
        objs[str(dev)] = h.getObjectiveValue()
    on_dev, on_cpu = objs[str(device)], objs["cpu"]
    rel = abs(on_dev - on_cpu) / max(1.0, abs(on_cpu))
    log(f"small: objective on {device} {on_dev!r}, on cpu {on_cpu!r}, "
        f"rel diff {rel:.3e}")
    if not rel <= 1e-6:
        raise RuntimeError("small LP: device and CPU objectives differ")


def formats_phase(device):
    """A small synth LP in every format on the card against the CPU."""
    import torch
    import highs_tpu_torch
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp

    lp = synth_lp(m=FORMATS_ROWS, n=FORMATS_ROWS)

    def solve(dev, fmt, tol):
        h = highs_tpu_torch.Highs(device=dev)
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "hipdlp")
        h.setOptionValue("tpu_matrix_format", fmt)
        h.setOptionValue("pdlp_optimality_tolerance", tol)
        h.passModel(lp)
        t0 = time.perf_counter()
        h.run()
        sync(torch.device(dev))
        seconds = time.perf_counter() - t0
        status = h.getModelStatus()
        iters = int(h.getInfo().pdlp_iteration_count)
        log(f"formats: {fmt} on {dev} at {tol:g}: {status.name} objective "
            f"{h.getObjectiveValue()!r} iterations {iters} seconds "
            f"{seconds:.3f}")
        if status != highs_tpu_torch.HighsModelStatus.kOptimal:
            raise RuntimeError(f"synth LP, {fmt} on {dev}: {status!r}")
        return h.getObjectiveValue(), iters, seconds

    refs = {tol: solve("cpu", "ell", tol)[0]
            for tol in sorted({tol for _, tol in FORMATS_RUNS})}
    runs = {}
    for fmt, tol in FORMATS_RUNS:
        obj, iters, seconds = solve(device, fmt, tol)
        ref = refs[tol]
        rel = abs(obj - ref) / max(1.0, abs(ref))
        runs[f"{fmt}@{tol:g}"] = dict(objective=obj, iterations=iters,
                                      seconds=seconds, rel_diff_to_cpu=rel)
        if not rel <= 1e-6:
            raise RuntimeError(f"synth LP, {fmt}: objective {obj!r} is "
                               f"{rel:.3e} from the CPU's {ref!r}")
    return runs


def kkt_check(a, b, c, upper, sol):
    """f64 KKT of min c'x s.t. Ax >= b, 0 <= x <= upper, from the
    returned solution alone: relative primal residual, dual residual
    and gap, each against (1 + norm)."""
    import numpy as np
    x = np.asarray(sol.col_value, dtype=np.float64)
    y = np.asarray(sol.row_dual, dtype=np.float64)
    row_viol = np.maximum(b - a @ x, 0.0)
    bound_viol = np.maximum(-x, 0.0) + np.maximum(x - upper, 0.0)
    rel_p = math.hypot(np.linalg.norm(row_viol),
                       np.linalg.norm(bound_viol)) / (1 + np.linalg.norm(b))
    # rows Ax >= b of a minimisation carry duals y >= 0; every column is
    # boxed, so any reduced cost z = c - A'y is absorbed by its bounds
    z = c - a.T @ y
    rel_d = np.linalg.norm(np.minimum(y, 0.0)) / (1 + np.linalg.norm(c))
    pobj = float(c @ x)
    dobj = float(b @ y) + float(upper @ np.minimum(z, 0.0))
    gap = abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj))
    return rel_p, rel_d, gap, pobj, dobj


def reset_launches():
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.ops import onehot_spmv
    from highs_tpu_torch.tools import gather_probe
    block_csr.LAUNCHES = 0
    gather_probe.LAUNCHES = 0
    onehot_spmv.LAUNCHES["onehot_spmv"] = 0


def read_launches():
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.ops import onehot_spmv
    from highs_tpu_torch.tools import gather_probe
    return {"block_csr_spmv": block_csr.LAUNCHES,
            "gather_probe": gather_probe.LAUNCHES,
            "onehot_spmv": onehot_spmv.LAUNCHES["onehot_spmv"]}


def solve_phase(name, a, b, c, upper, options, anchor, path_kernels,
                device):
    """One LP through the facade: status, independent KKT, objective
    against upstream HiGHS, and the path's kernels launched at least
    twice per PDLP iteration.  Returns (launches, iterations)."""
    import numpy as np
    import torch
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix

    m, n = a.shape
    lp = HighsLp(num_col=n, num_row=m, col_cost=c.copy(),
                 col_lower=np.zeros(n), col_upper=upper.copy(),
                 row_lower=b.copy(), row_upper=np.full(m, np.inf),
                 a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("time_limit", SOLVE_TIME_LIMIT)
    for key, val in options.items():
        h.setOptionValue(key, val)
    h.passModel(lp)
    reset_launches()
    t0 = time.perf_counter()
    h.run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    status = h.getModelStatus()
    rd = h.getRunData()
    iters = int(h.getInfo().pdlp_iteration_count)
    log(f"{name}: status {status.name} objective {h.getObjectiveValue()!r} "
        f"iterations {iters} seconds {seconds:.3f} "
        f"iterations_per_s {iters / seconds:.1f} "
        f"presolve_s {rd.presolve_time:.3f} solve_s {rd.solve_time:.3f} "
        f"postsolve_s {rd.postsolve_time:.3f} "
        f"presolved {rd.presolved_model_num_row}x"
        f"{rd.presolved_model_num_col} kernel_launches {launches}")
    if status != highs_tpu_torch.HighsModelStatus.kOptimal:
        raise RuntimeError(f"{name}: status {status!r}, not kOptimal")
    rel_p, rel_d, gap, pobj, dobj = kkt_check(a, b, c, upper,
                                              h.getSolution())
    log(f"{name}: independent f64 KKT rel_primal {rel_p:.3e} "
        f"rel_dual {rel_d:.3e} rel_gap {gap:.3e} (limit {KKT_TOL:g}); "
        f"primal obj {pobj!r} dual obj {dobj!r}")
    if not max(rel_p, rel_d, gap) <= KKT_TOL:
        raise RuntimeError(f"{name}: the solution fails the KKT check")
    rel_obj = abs(pobj - anchor) / abs(anchor)
    log(f"{name}: upstream HiGHS objective {anchor!r}, rel diff "
        f"{rel_obj:.3e}")
    if not rel_obj <= 1e-6:
        raise RuntimeError(f"{name}: objective differs from upstream HiGHS")
    for kernel in path_kernels:
        if device.type == "cuda" and launches[kernel] < 2 * iters:
            raise RuntimeError(f"{name}: {launches[kernel]} launches of "
                               f"{kernel} for {iters} iterations (need "
                               ">= 2 per iteration)")
    return launches, iters, seconds


def headline(records, launches, extra=None):
    """One kernel's line: the f32 records (the main path's type), the
    mean of its directions."""
    path = [r for r in records if r["dtype"] == "float32"]

    def mean(key):
        vals = [r.get(key) for r in path]
        return None if None in vals else statistics.fmean(vals)
    out = {"launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in path),
           "ms": mean("ms"), "plain_ms": mean("plain_ms"),
           "bound_ms": mean("bound_ms"), "bound_by": path[0]["bound_by"],
           "library_ms": mean("library_ms"),
           "ok": all(r["ok"] for r in records), "dtype": "float32"}
    out.update(extra or {})
    out["variants"] = records
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import numpy as np
    from highs_tpu_torch.ops import block_csr, cuda_build, onehot_spmv
    from highs_tpu_torch.tools import gather_probe
    from highs_tpu_torch.tools.card import card_line
    from highs_tpu_torch.utils.gen_block_lp import UPPER, gen_block_lp

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    block_csr._lib()
    onehot_spmv._lib()
    gather_probe._lib()
    for name, (secs, out) in cuda_build.BUILD_INFO.items():
        log(f"build {name}: nvcc {secs:.2f} s")
        for line in out.strip().splitlines():
            log(f"  {line}")
    log(f"build: kernels ready in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    a64, b64, c64 = gen_block_lp()
    log(f"block64k: {a64.shape[0]}x{a64.shape[1]}, {a64.nnz} nonzeros, "
        f"generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    a50, b50, c50, a50_pad = padded_synth50k()
    log(f"synth50k: {a50.shape[0]}x{a50.shape[1]}, {a50.nnz} nonzeros, "
        f"generated in {time.perf_counter() - t0:.1f} s")

    phase_s = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    with open(os.path.join(HERE, "BASELINE_MEASURED.json")) as f:
        block64k_anchor = json.load(f)["block64k_anchor"]["objective"]
    bc_records = run("blockcsr", blockcsr_phase, a64, device)
    oh_records = run("onehot", onehot_phase, a50_pad, device)
    probe_records = run("probe", probe_phase, device)
    check_timings({"block_csr_spmv": bc_records, "onehot_spmv": oh_records,
                   "gather_probe": probe_records})
    run("small", small_phase, device)
    formats = run("formats", formats_phase, device)
    bc_launches, bc_iters, _ = run(
        "block64k", solve_phase, "block64k", a64, b64, c64,
        np.full(a64.shape[1], UPPER), {}, block64k_anchor,
        ["block_csr_spmv"], device)
    oh_launches, oh_iters, oh_seconds = run(
        "synth50k", solve_phase, "synth50k", a50, b50, c50,
        np.full(a50.shape[1], UPPER),
        {"solver": "hipdlp", "tpu_matrix_format": "onehot"},
        SYNTH50K_OBJECTIVE, ["onehot_spmv"], device)

    probe_head = [r for r in probe_records
                  if r["name"] == gather_probe.SHAPES[0][0]]
    lines = {
        "block_csr_spmv": headline(
            bc_records, bc_launches["block_csr_spmv"],
            {"path": "block64k", "pdlp_iterations": bc_iters}),
        "gather_probe": headline(
            probe_head, 0,
            {"path": None, "shape": gather_probe.SHAPES[0][0],
             "library": "torch.gather (also its plain version)",
             "all_shapes": probe_records}),
        "onehot_spmv": headline(
            oh_records, oh_launches["onehot_spmv"],
            {"path": "synth50k", "pdlp_iterations": oh_iters,
             "library": "torch.sparse_csr_tensor @ x of the same matrix"}),
    }
    lines["gather_probe"]["variants"] = probe_head
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **lines[name]}
        for name in ("block_csr_spmv", "onehot_spmv", "gather_probe")],
        "formats": formats, "synth50k_seconds": oh_seconds,
        "phase_seconds": phase_s,
        "total_seconds": time.perf_counter() - t_start}
    log(json.dumps(summary))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
