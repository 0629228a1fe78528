"""Where the time of a block64k or synth50k solve goes on one CUDA card.

    python3 -m highs_tpu_torch.tools.profile_block64k [--dtype float32]
        [--nblocks 512] [--out profile_block64k.json]
    python3 -m highs_tpu_torch.tools.profile_block64k --lp synth50k
        --format onehot [--out profile_synth50k.json]

Solves the block64k LP (`utils/gen_block_lp.py`) through `Highs().run()`
with the default options, or the synth50k LP (`utils/gen_synth_lp.py`)
with solver "hipdlp" (`choose` sends an LP of its size to the IPM, not
ported yet) in the matrix format `--format` (`--dtype` sets `tpu_dtype`;
the default, "choose", is float32 with f64 refinement on CUDA), and
splits the run's
host-clock time into presolve, the PDLP wrapper's host setup (standard
form, scaling, operator build), each PDHG round (the refinement's host
KKT oracle runs inside its round), recovery, and the rest of the
solve, by timing the wrapper's steps from outside.  Then it
runs 10 restart windows (400 Halpern steps) of the final problem once
plainly, for the wall time of a step, and once under `torch.profiler`,
for the device time of a step by kernel; their ratio is the device's
busy share.  Prints one JSON object as its last line and writes it to
`--out`.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import Highs, HighsModelStatus
from ..ops import block_csr, onehot_spmv
from ..solvers.pdlp import pdhg, wrapper
from ..utils.gen_block_lp import NBLOCKS, block_lp
from ..utils.gen_synth_lp import synth_lp
from .card import card_line

WINDOWS = 10
INTERVAL = 40


def _timed(module, name, sink):
    """Replace module.name by a wrapper that appends (seconds, args,
    result) to sink, syncing the card at the end of each call."""
    inner = getattr(module, name)

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0, args, out))
        return out
    setattr(module, name, run)


def _profile_windows(problem, dtype, device):
    """Wall and device time of one Halpern step in 40-step windows."""
    n = problem.c.shape[0]
    m = problem.b.shape[0]
    x = torch.minimum(torch.clamp_min(problem.lo, 0.0), problem.up)
    y = torch.zeros(m, dtype=dtype, device=device)
    state = pdhg.PdhgState(
        x=x, y=y, x_pd=x, y_pd=y, x_anchor=x, y_anchor=y,
        aty=problem.k_op.rmv(y),
        k=torch.zeros((), dtype=torch.int32, device=device),
        eta=torch.tensor(0.5 / np.sqrt(n), dtype=dtype, device=device),
        omega=torch.tensor(1.0, dtype=dtype, device=device))

    def ctl():
        return pdhg.RestartCtl(
            fpe_init=torch.tensor(np.inf, dtype=dtype, device=device),
            fpe_last=torch.tensor(np.inf, dtype=dtype, device=device),
            fresh=torch.ones((), dtype=torch.bool, device=device),
            total_k=torch.zeros((), dtype=torch.int32, device=device),
            n_restarts=torch.zeros((), dtype=torch.int32, device=device))
    theta = torch.tensor(0.0, dtype=dtype, device=device)

    def run():
        out = pdhg.pdhg_block_windows(problem, state, ctl(), WINDOWS, 1.0,
                                      INTERVAL, theta)
        pdhg.read_metrics(out[2], out[1])

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    steps = WINDOWS * INTERVAL
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    result = {"steps": steps, "wall_ms_per_step": wall_ms}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = {"calls": ev.count,
                               "device_ms_per_step":
                               ev.self_device_time_total / 1e3 / steps}
    device_ms = sum(k["device_ms_per_step"] for k in kernels.values())
    launches = sum(k["calls"] for k in kernels.values())
    result.update({
        "device_ms_per_step": device_ms if kernels else None,
        "device_busy_share": device_ms / wall_ms if kernels else None,
        "kernels_per_step": launches / steps if kernels else None,
        "top_kernels": dict(sorted(
            kernels.items(), key=lambda kv: -kv[1]["device_ms_per_step"])[:8]),
    })
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="choose",
                    choices=["choose", "float32", "float64"])
    ap.add_argument("--lp", default="block64k",
                    choices=["block64k", "synth50k"])
    ap.add_argument("--format", default="choose",
                    help="tpu_matrix_format")
    ap.add_argument("--nblocks", type=int, default=NBLOCKS,
                    help="block-rows of block64k")
    ap.add_argument("--out", default="profile_block64k.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_block64k: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    t0 = time.perf_counter()
    lp = (block_lp(nblocks=args.nblocks) if args.lp == "block64k"
          else synth_lp())
    gen_s = time.perf_counter() - t0

    steps = {name: [] for name in ("preprocess_lp", "scale_problem",
                                   "solve_pdhg", "recover_solution")}
    for name, sink in steps.items():
        _timed(wrapper, name, sink)
    build = []
    _timed(wrapper.linops, "from_scipy", build)

    h = Highs(device=device)
    h.setOptionValue("output_flag", False)
    h.setOptionValue("tpu_dtype", args.dtype)
    h.setOptionValue("tpu_matrix_format", args.format)
    if args.lp == "synth50k":
        h.setOptionValue("solver", "hipdlp")
    h.passModel(lp)
    block_csr.LAUNCHES = 0
    for key in onehot_spmv.LAUNCHES:
        onehot_spmv.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    h.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"block_csr_spmv": block_csr.LAUNCHES,
                **onehot_spmv.LAUNCHES}
    rd = h.getRunData()
    rounds = [{"seconds": s, "iterations": out.iterations,
               "restarts": out.restarts, "status": out.status.name}
              for s, _, out in steps["solve_pdhg"]]
    pdhg_s = sum(r["seconds"] for r in rounds)
    iters = sum(r["iterations"] for r in rounds)
    setup_s = (sum(s for s, _, _ in steps["preprocess_lp"]) +
               sum(s for s, _, _ in steps["scale_problem"]) +
               sum(s for s, _, _ in build))
    recover_s = sum(s for s, _, _ in steps["recover_solution"])
    problem = steps["solve_pdhg"][0][1][0]
    dtype = problem.c.dtype

    report = {
        "card": card_line(), "lp": args.lp, "format": args.format,
        "nblocks": args.nblocks if args.lp == "block64k" else None,
        "tpu_dtype": args.dtype,
        "device_dtype": str(dtype).replace("torch.", ""),
        "status": HighsModelStatus(h.getModelStatus()).name,
        "objective": h.getObjectiveValue(),
        "iterations": iters, "kernel_launches": launches,
        "generate_s": gen_s, "run_s": run_s,
        "presolve_s": rd.presolve_time, "solve_s": rd.solve_time,
        "postsolve_s": rd.postsolve_time,
        "pdlp_setup_s": setup_s, "pdhg_rounds_s": pdhg_s,
        "other_solve_s": rd.solve_time - setup_s - pdhg_s - recover_s,
        "recover_s": recover_s, "rounds": rounds,
        "ms_per_iteration": pdhg_s * 1e3 / max(1, iters),
    }
    report["windows"] = _profile_windows(problem, dtype, device)
    for key, val in report.items():
        if key != "windows":
            print(f"{key}: {val}", flush=True)
    for key, val in report["windows"].items():
        print(f"windows.{key}: {val}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
