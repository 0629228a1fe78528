#!/usr/bin/env python3
"""Chip smoke test of highs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build   the CUDA kernels of `highs_tpu_torch/csrc/` with nvcc (sm_90a);
2. kernel  on the block64k operator (65,536 x 65,536, 1,534 dense
           128x128 tiles per direction), in float32 and float64, K x and
           K' y: the kernel against its plain PyTorch version on the card
           (f64: 1e-12, f32: 1e-5, both relative to ||(|A| |x|)||_inf),
           and the times of the kernel, the plain version and one PyTorch
           BSR product (a yardstick only), beside the byte and operation
           bound;
3. small   a 256 x 256 block LP through `Highs` on the card and on the
           CPU: the two objectives agree to 1e-6 relative;
4. solve   block64k through `Highs().run()` with the default options
           (solver "choose", presolve "choose", tolerance 1e-7: an f32
           cold round and f64 refinement): kOptimal, an independent f64
           KKT check of the returned solution (primal and dual residual
           and gap <= 1e-7), the objective against the upstream HiGHS
           run recorded in BASELINE_MEASURED.json, and at least two
           kernel launches per PDLP iteration.

It prints the kernels' summary as one JSON line, the card's name and
power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card, or without the rest of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and the
# non-tensor-core FMA rates of the two types the kernel takes
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TOLERANCE = {"float32": 1e-5, "float64": 1e-12}
KKT_TOL = 1e-7
SOLVE_TIME_LIMIT = 600.0
TIMED_RUNS = 25
KERNEL_SOURCE = "highs_tpu_torch/csrc/block_csr_spmv.cu"
TPU_KERNEL = "highs_tpu/ops/block_csr.py:111"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device) -> float:
    """Median wall time of one call of `fn` on the device, in ms: CUDA
    events around each of TIMED_RUNS calls after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(bc, dtype_name: str):
    """The least time of one product: each input read once (tiles, the
    column indices, the row pointer, x), y written once, over the HBM
    rate; 2 operations per tile element over the peak FMA rate."""
    mb = bc.shape[0] // 128
    nb = bc.shape[1] // 128
    item = bc.blocks.element_size()
    nbytes = (bc.blocks.numel() * item + bc.block_col.numel() * 4 +
              (mb + 1) * 4 + nb * 128 * item + mb * 128 * item)
    ops = 2.0 * bc.blocks.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_product(bc):
    """One PyTorch call for the same product: a BSR tensor of the
    untransposed tiles times x.  A yardstick; the port never calls it."""
    import torch
    with warnings.catch_warnings():  # BSR tensors are in beta
        warnings.simplefilter("ignore", UserWarning)
        bsr = torch.sparse_bsr_tensor(
            bc.row_ptr, bc.block_col,
            bc.blocks.transpose(1, 2).contiguous(), size=bc.shape)

    def run(x):
        return (bsr @ x.unsqueeze(1)).squeeze(1)
    return run


def kernel_phase(a, device):
    """Kernel against plain on the block64k operator; returns the
    per-variant records."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import block_csr

    op64 = block_csr.from_scipy_block_csr(a, dtype=torch.float64,
                                          device=device)
    rng = np.random.default_rng(7)
    variants = []
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        for direction, bc64 in (("mv", op64.fwd), ("rmv", op64.bwd)):
            bc = bc64._replace(blocks=bc64.blocks.to(dtype))
            abs_bc = bc64._replace(blocks=bc64.blocks.abs())
            x = torch.as_tensor(rng.standard_normal(bc.shape[1]),
                                dtype=dtype, device=device)
            before = block_csr.LAUNCHES
            got = block_csr.block_csr_spmv(bc, x)
            if device.type == "cuda":
                torch.cuda.synchronize()
                if block_csr.LAUNCHES != before + 1:
                    raise RuntimeError("the wrapper did not launch the "
                                       "kernel on a CUDA tensor")
            want = block_csr.spmv_plain(bc, x)
            scale = block_csr.spmv_plain(
                abs_bc, x.abs().double()).abs().max().item()
            err = (got.double() - want.double()).abs().max().item()
            rel = err / max(scale, 1e-300)
            ok = bool(math.isfinite(err) and rel <= TOLERANCE[dtype_name])
            k_ms = time_ms(lambda: block_csr.block_csr_spmv(bc, x), device)
            p_ms = time_ms(lambda: block_csr.spmv_plain(bc, x), device)
            try:
                lib = library_product(bc)
                lib_err = (lib(x).double() - want.double()).abs().max().item()
                lib_ms = time_ms(lambda: lib(x), device)
                lib_note = f"max abs diff to plain {lib_err:.3e}"
            except (RuntimeError, NotImplementedError, TypeError) as exc:
                lib_ms = None
                lib_note = f"unavailable: {type(exc).__name__}: " \
                    f"{str(exc).splitlines()[0][:160]}"
            b_ms, b_by = bound_ms(bc, dtype_name)
            rec = dict(dtype=dtype_name, direction=direction,
                       nnzb=int(bc.blocks.shape[0]), max_abs_err=err,
                       rel_err=rel, tolerance=TOLERANCE[dtype_name], ok=ok,
                       ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            log(f"kernel {dtype_name} {direction}: nnzb {rec['nnzb']} "
                f"max_abs_err {err:.3e} rel {rel:.3e} "
                f"(tol {TOLERANCE[dtype_name]:g}) kernel_ms {k_ms:.4f} "
                f"plain_ms {p_ms:.4f} bound_us {b_ms * 1e3:.2f} ({b_by}) "
                f"library_ms {lib_ms} [{lib_note}]")
            variants.append(rec)
            del bc, abs_bc
    del op64
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bad = [v for v in variants if not v["ok"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain version: {bad}")
    return variants


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


def solve_phase(a, b, c, device):
    """block64k through the facade with default options."""
    import numpy as np
    import torch
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.utils.gen_block_lp import UPPER

    m, n = a.shape
    upper = np.full(n, UPPER)
    lp = HighsLp(num_col=n, num_row=m, col_cost=c.copy(),
                 col_lower=np.zeros(n), col_upper=upper.copy(),
                 row_lower=b.copy(), row_upper=np.full(m, np.inf),
                 a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("time_limit", SOLVE_TIME_LIMIT)
    h.passModel(lp)
    block_csr.LAUNCHES = 0
    t0 = time.perf_counter()
    h.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = block_csr.LAUNCHES
    status = h.getModelStatus()
    info = h.getInfo()
    rd = h.getRunData()
    iters = int(info.pdlp_iteration_count)
    log(f"solve: status {status.name} objective {h.getObjectiveValue()!r} "
        f"iterations {iters} seconds {seconds:.3f} "
        f"iterations_per_s {iters / seconds:.1f} "
        f"presolve_s {rd.presolve_time:.3f} solve_s {rd.solve_time:.3f} "
        f"postsolve_s {rd.postsolve_time:.3f} "
        f"presolved {rd.presolved_model_num_row}x"
        f"{rd.presolved_model_num_col} kernel_launches {launches}")
    if status != highs_tpu_torch.HighsModelStatus.kOptimal:
        raise RuntimeError(f"block64k: status {status!r}, not kOptimal")
    rel_p, rel_d, gap, pobj, dobj = kkt_check(a, b, c, upper,
                                              h.getSolution())
    log(f"solve: independent f64 KKT rel_primal {rel_p:.3e} "
        f"rel_dual {rel_d:.3e} rel_gap {gap:.3e} (limit {KKT_TOL:g}); "
        f"primal obj {pobj!r} dual obj {dobj!r}")
    if not max(rel_p, rel_d, gap) <= KKT_TOL:
        raise RuntimeError("block64k: the solution fails the KKT check")
    with open(os.path.join(HERE, "BASELINE_MEASURED.json")) as f:
        anchor = json.load(f)["block64k_anchor"]
    rel_obj = abs(pobj - anchor["objective"]) / abs(anchor["objective"])
    log(f"solve: upstream HiGHS objective {anchor['objective']!r} "
        f"({anchor['solver']}), rel diff {rel_obj:.3e}")
    if not rel_obj <= 1e-6:
        raise RuntimeError("block64k: objective differs from upstream HiGHS")
    if launches < 2 * iters:
        raise RuntimeError(f"block64k: {launches} kernel launches for "
                           f"{iters} iterations (need >= 2 per iteration)")
    return launches, iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.ops.cuda_build import BUILD_INFO
    from highs_tpu_torch.utils.gen_block_lp import gen_block_lp

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    block_csr._lib()
    build_s = time.perf_counter() - t0
    for name, (secs, out) in BUILD_INFO.items():
        log(f"build {name}: nvcc {secs:.2f} s")
        for line in out.strip().splitlines():
            log(f"  {line}")
    log(f"build: kernels ready in {build_s:.2f} s")

    t0 = time.perf_counter()
    a, b, c = gen_block_lp()
    log(f"block64k: {a.shape[0]}x{a.shape[1]}, {a.nnz} nonzeros, "
        f"generated in {time.perf_counter() - t0:.1f} s")

    variants = kernel_phase(a, device)
    small_phase(device)
    launches, iters = solve_phase(a, b, c, device)

    # the headline is one float32 product (the main path's type), the
    # mean of K x and K' y, which stream the same number of tiles
    path = [v for v in variants if v["dtype"] == "float32"]

    def mean(key):
        vals = [v[key] for v in path]
        return None if None in vals else statistics.fmean(vals)
    summary = {"kernels": [{
        "name": "block_csr_spmv", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in path),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": path[0]["bound_by"],
        "library_ms": mean("library_ms"),
        "ok": all(v["ok"] for v in variants),
        "dtype": "float32", "pdlp_iterations": iters,
        "variants": variants}]}
    log(json.dumps(summary))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
