"""Where the time of a block64k or synth50k solve goes on one CUDA card.

    python3 -m highs_tpu_torch.tools.profile_block64k [--dtype float32]
        [--nblocks 512] [--out profile_block64k.json]
    python3 -m highs_tpu_torch.tools.profile_block64k --lp synth50k
        --format onehot [--out profile_synth50k.json]
    python3 -m highs_tpu_torch.tools.profile_block64k --solver pdlp
        [--out profile_block64k_avg.json]

Solves the block64k LP (`utils/gen_block_lp.py`) through `Highs().run()`
with the default options, or the synth50k LP (`utils/gen_synth_lp.py`)
with solver "hipdlp" (`choose` sends an LP of its size to the IPM) in
the matrix format `--format` (`--dtype` sets `tpu_dtype`; the default,
"choose", is float32 with f64 refinement on CUDA); `--solver pdlp` runs
the average-iterate engine instead.  The run goes under
`torch.profiler`; it prints the run's split from the facade's clocks
(`getTimer()`): presolve and its rule families, the PDLP wrapper's
set-up, its PDHG rounds (the power method, the blocks, the graph
captures), the refinement's host oracle and the recovery, and the share
of the "highs.solve" span that the spans directly under it cover
(`solve_cover`).  Then it builds the cold round's problem again (`Highs.presolve()` and
the wrapper's `pdlp_problem`) and runs 10 restart windows (400 Halpern
steps; with `--solver pdlp` one average-mode block of 400 steps and its
two metric sets) of it (`profile_blocks`) as replays of captured CUDA
graphs,
as `solve_pdhg` runs them on one card: once for the wall time of a step
(and once op by op beside it), and once under `torch.profiler`, for the
device time of a step by kernel (`by_kernel`: the primal and dual step
kernels, the products and the rest); their ratio is the device's busy
share.  Prints one JSON object as its last line and writes it to
`--out`.  Needs a CUDA card.  `profile_batch_blocks` splits the blocks
of the batched LP solve (`solvers/pdlp/batch.py`) the same way
(`chip_smoke.py`'s batch phase).
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
from ..options import HighsOptions
from ..ops import block_csr, onehot_spmv
from ..solvers.capture import read_counts
from ..solvers.pdlp import graph, pdhg, wrapper
from ..utils.gen_block_lp import NBLOCKS, block_lp
from ..utils.gen_synth_lp import synth_lp
from .card import card_line

WINDOWS = 10
INTERVAL = 40
# the kernels a step is split into, by a part of their name in the
# profiler: the two step kernels of csrc/pdhg_step.cu and the products of
# csrc/block_csr_spmv.cu and csrc/onehot_spmv.cu (and cuBLAS's batched
# products of the batch's dense K, gemv2N and gemv2T)
KERNEL_GROUPS = {"pdhg_primal_step": ("primal_kernel",),
                 "pdhg_dual_step": ("dual_kernel",),
                 "product": ("block_csr_spmv_kernel", "onehot_spmv_kernel",
                             "gemv2N_kernel", "gemv2T_kernel")}


def kernel_groups(kernels: dict, device_ms: float) -> dict:
    """Device ms per step of each group of KERNEL_GROUPS, and of the
    rest, from `kernels` (profiler name -> {"device_ms_per_step": ...})
    and the step's device ms in all."""
    out = {group: sum(k["device_ms_per_step"] for name, k in kernels.items()
                      if any(part in name for part in parts))
           for group, parts in KERNEL_GROUPS.items()}
    out["rest"] = device_ms - sum(out.values())
    return out


# the program's spans directly under "highs.solve" on the PDLP route
SOLVE_PARTS = ("highs.pdlp.setup", "highs.pdlp_round", "highs.pdlp.oracle",
               "highs.pdlp.recover")


def solve_cover(prof) -> float:
    """The share of the run's "highs.solve" span (host events of a
    stopped profile) that the union of the SOLVE_PARTS spans covers."""
    from torch.autograd import DeviceType
    solve, parts = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CPU:
            continue
        iv = (ev.start_ns(), ev.end_ns())
        if ev.name() == "highs.solve":
            solve.append(iv)
        elif ev.name() in SOLVE_PARTS:
            parts.append(iv)
    covered, end = 0, None
    for s, e in sorted(parts):
        s = s if end is None else max(s, end)
        if e > s:
            covered += e - s
            end = e
    return covered / sum(e - s for s, e in solve)


def _start(problem, dtype, device):
    """A cold start on `problem`: x at its bounds' projection of 0, y 0,
    and the restart control of a fresh solve."""
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
    ctl = pdhg.RestartCtl(
        fpe_init=torch.tensor(np.inf, dtype=dtype, device=device),
        fpe_last=torch.tensor(np.inf, dtype=dtype, device=device),
        fresh=torch.ones((), dtype=torch.bool, device=device),
        total_k=torch.zeros((), dtype=torch.int32, device=device),
        n_restarts=torch.zeros((), dtype=torch.int32, device=device))
    return state, ctl


def profile_blocks(problem, device, mode="halpern"):
    """Wall and device time of one step of `problem` with the graphs on
    (`solvers/pdlp/graph.py`): 10 restart windows of 40 Halpern steps,
    or one average-mode block of 400 steps, each as replays of captured
    graphs and then the metrics graph and its host read.  The same block
    issued op by op gives the eager wall beside it.  The device time by
    kernel comes from `torch.profiler` (CUPTI records the kernels a
    graph replay launches; where it records none, the device numbers are
    None); device time over wall is the busy share."""
    dtype = problem.c.dtype
    state, ctl = _start(problem, dtype, device)
    if mode == "average":
        state = state._replace(x_anchor=torch.zeros_like(state.x),
                               y_anchor=torch.zeros_like(state.y))
    theta = torch.tensor(0.0, dtype=dtype, device=device)
    steps = WINDOWS * INTERVAL

    def run(blocks):
        if mode == "average":
            out = blocks.block_avg(state, steps, None)
            pdhg.read_metric_pair(out[1], out[2])
        else:
            out = blocks.windows(state, ctl, WINDOWS, 1.0, INTERVAL, theta,
                                 None)
            pdhg.read_metrics(out[2], out[1])
    return dict(mode=mode, **_profile(
        run, graph.GraphBlocks(problem, INTERVAL),
        graph.EagerBlocks(problem), steps))


def profile_batch_blocks(start, device):
    """`profile_blocks` for the batched LP solve (`solvers/pdlp/batch.py`):
    10 vmapped restart windows of 40 steps of every instance of `start`
    (a `batch.BatchStart`) from its cold state, as the batch's runner
    replays them, then its metrics graph and the host read of its
    metrics; the same block op by op beside it.  A step is one step of
    every instance."""
    from ..solvers.pdlp import batch
    problem, state, ctl = start.problem, start.state, start.ctl
    theta = torch.zeros((), dtype=problem.c.dtype, device=device)

    def run(blocks):
        _, c, metrics = blocks.windows(state, ctl, WINDOWS, 1.0, INTERVAL,
                                       theta, None)
        torch.stack(list(metrics) + [c.n_restarts.to(theta.dtype)]).cpu()
    return dict(mode="halpern", batch=problem.c.shape[0], **_profile(
        run, batch.batch_runner(problem, INTERVAL),
        graph.EagerBlocks(problem, batch.batched_window,
                          batch.batched_metrics), WINDOWS * INTERVAL))


def _profile(run, runner, eager, steps):
    """The wall per step of `run(runner)` (a `GraphBlocks`, replayed
    graphs) and of `run(eager)` (op by op), each after a warm-up run,
    then one `run(runner)` under `torch.profiler`: device ms per step
    by kernel, the busy share, kernels and counted launches per step."""
    def wall_ms(blocks):
        run(blocks)  # warm-up (and the captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(blocks)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    result = {"steps": steps, "wall_ms_per_step": wall_ms(runner),
              "eager_wall_ms_per_step": wall_ms(eager)}
    before = read_counts()
    replays = graph.COUNTS["replays"]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(runner)
        torch.cuda.synchronize()
    after = read_counts()
    runner.close()
    kernels = {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = {"calls": ev.count,
                               "device_ms_per_step":
                               ev.self_device_time_total / 1e3 / steps}
    device_ms = sum(k["device_ms_per_step"] for k in kernels.values())
    wall = result["wall_ms_per_step"]
    result.update({
        "replays_per_block": graph.COUNTS["replays"] - replays,
        "launches_per_step": {k: (after[k] - before[k]) / steps
                              for k in after if after[k] != before[k]},
        "device_ms_per_step": device_ms if kernels else None,
        "by_kernel": kernel_groups(kernels, device_ms) if kernels else None,
        "device_busy_share": device_ms / wall if kernels else None,
        "kernels_per_step": (sum(k["calls"] for k in kernels.values()) /
                             steps if kernels else None),
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
    ap.add_argument("--solver", default=None,
                    choices=["choose", "hipdlp", "pdlp"],
                    help="solver option (default: choose for block64k, "
                    "hipdlp for synth50k)")
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

    h = Highs(device=device)
    h.setOptionValue("output_flag", False)
    solver = args.solver or ("hipdlp" if args.lp == "synth50k"
                             else "choose")
    opts = HighsOptions()
    for key, val in (("tpu_dtype", args.dtype),
                     ("tpu_matrix_format", args.format),
                     ("solver", solver)):
        h.setOptionValue(key, val)
        opts.set(key, val)
    h.passModel(lp)
    block_csr.LAUNCHES = 0
    onehot_spmv.LAUNCHES["onehot_spmv"] = 0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = {"block_csr_spmv": block_csr.LAUNCHES,
                "onehot_spmv": onehot_spmv.LAUNCHES["onehot_spmv"]}
    rd = h.getRunData()
    timer = h.getTimer()
    iters = h.getInfo().pdlp_iteration_count
    pdhg_s = timer.read("pdlp_round")
    fresh = Highs(device=device)  # its presolve leaves h's clocks whole
    fresh.setOptionValue("output_flag", False)
    fresh.passModel(lp)
    fresh.presolve()
    problem = wrapper.pdlp_problem(fresh.getPresolvedLp(), opts,
                                   device).problem
    dtype = problem.c.dtype

    report = {
        "card": card_line(), "lp": args.lp, "format": args.format,
        "nblocks": args.nblocks if args.lp == "block64k" else None,
        "tpu_dtype": args.dtype, "solver": solver,
        "device_dtype": str(dtype).replace("torch.", ""),
        "status": HighsModelStatus(h.getModelStatus()).name,
        "objective": h.getObjectiveValue(),
        "iterations": iters, "kernel_launches": launches,
        "generate_s": gen_s, "run_s": run_s,
        "presolve_s": rd.presolve_time, "solve_s": rd.solve_time,
        "postsolve_s": rd.postsolve_time,
        "pdlp_setup_s": timer.read("pdlp.setup"), "pdhg_rounds_s": pdhg_s,
        "oracle_s": timer.read("pdlp.oracle"),
        "recover_s": timer.read("pdlp.recover"),
        # every clock and counter of the run, as a table
        "clocks": timer.report(),
        "solve_cover": solve_cover(prof),
        "ms_per_iteration": pdhg_s * 1e3 / max(1, iters),
    }
    report["windows"] = profile_blocks(
        problem, device, "average" if solver == "pdlp" else "halpern")
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
