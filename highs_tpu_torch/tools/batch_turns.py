"""The batched LP solve of two trees, in turns on one CUDA card.

    python3 -m highs_tpu_torch.tools.batch_turns --parent DIR
        [--out batch_turns.json]

DIR is an unpacked checkout of another commit of this repository (the
parent).  The tool runs one worker process in DIR and one in this tree,
in turns (parent, this, this, parent); host and card vary between
calls, so only numbers of one call compare.  Each worker solves the 16
synth LPs of `chip_smoke.py`'s batch phase (`tools/lp_anchors.py`
`BATCH_SEEDS`, padded to 2,048 x 2,048, f64) with `solve_lp_batch` and
the default options, and reports:

- each instance's status, iterations, restarts and objective;
- the host-clock ms a step over the blocks after the first (the card
  synchronised at each block's end), the whole solve's seconds and
  those to the first block's end (set-up, the graphs' captures), and the
  step kernels' launches a step;
- 10 restart windows of 40 steps of every instance from the batch's cold
  start, then the metrics and their host read, as the tree runs a
  block: the wall ms a step (after a warm-up run), and under
  `torch.profiler` the device ms a step, the busy share (device over
  wall) and the kernels a step (`tools/profile_block64k.py`
  `profile_batch_blocks`; a tree without it runs its
  `batched_pdhg_windows` the same way).

Prints one line per run, then the summary as one JSON object as its
last line, and writes it to `--out`.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
TREE = HERE.parents[2]
WINDOWS = 10
INTERVAL = 40


def _lps():
    from highs_tpu_torch.tools import lp_anchors
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp
    return [synth_lp(lp_anchors.batch_rows(s), lp_anchors.batch_rows(s),
                     seed=s) for s in lp_anchors.BATCH_SEEDS]


def _older_blocks(batch, start, device):
    """`profile_batch_blocks`' numbers for a tree whose batch runs its
    windows op by op (`batched_pdhg_windows`), from `start`, its first
    call's (problem, state, ctl)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    problem, state, ctl = start
    theta = torch.zeros((), dtype=problem.c.dtype, device=device)
    steps = WINDOWS * INTERVAL

    def run():
        _, c, metrics = batch.batched_pdhg_windows(
            problem, state, ctl, WINDOWS, 1.0, INTERVAL, theta)
        torch.stack(list(metrics) + [c.n_restarts.to(theta.dtype)]).cpu()
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and
              ev.self_device_time_total]
    device_ms = sum(ev.self_device_time_total for ev in events) / 1e3 / steps
    return {"wall_ms_per_step": wall, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall,
            "kernels_per_step": sum(ev.count for ev in events) / steps}


def _worker(device) -> dict:
    """One tree's measurements (module doc) on `device` (a card; the CPU
    for a rehearsal of the tool, where `torch.cuda.synchronize` does
    nothing)."""
    import torch
    from highs_tpu_torch.ops import pdhg_step
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.solvers.pdlp import batch
    from highs_tpu_torch.tools.card import card_line

    device = torch.device(device)
    lps = _lps()
    first = []
    if not hasattr(batch, "prepare_batch"):
        inner = batch.batched_pdhg_windows

        def keep(problem, state, ctl, *args):
            if not first:
                first.append((problem, state, ctl))
            return inner(problem, state, ctl, *args)
        batch.batched_pdhg_windows = keep
    blocks = []
    t0 = time.perf_counter()

    def on_block(msg):
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0, int(msg.split()[2][:-1])))
    before = dict(pdhg_step.LAUNCHES)
    results = batch.solve_lp_batch(lps, HighsOptions(), log=on_block,
                                   device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = blocks[-1][1]
    launches = {k: (v - before[k]) / steps
                for k, v in pdhg_step.LAUNCHES.items()}
    if first:
        batch.batched_pdhg_windows = inner
        window = _older_blocks(batch, first[0], device)
    else:
        from highs_tpu_torch.tools.profile_block64k import \
            profile_batch_blocks
        window = profile_batch_blocks(
            batch.prepare_batch(lps, HighsOptions(), device), device)
    return {
        "card": card_line(), "torch": torch.__version__,
        "instances": [{"status": st.name, "iterations": info.iterations,
                       "restarts": info.restarts,
                       "primal_obj": info.primal_obj}
                      for st, _, info in results],
        "seconds": seconds, "first_block_s": blocks[0][0],
        "blocks": len(blocks), "steps": steps,
        "ms_per_step": 1e3 * (blocks[-1][0] - blocks[0][0]) /
        max(1, steps - blocks[0][1]),
        "launches_per_step": launches,
        "window": {k: window[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "kernels_per_step")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the other commit")
    ap.add_argument("--out", default="batch_turns.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.device)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("batch_turns: needs a CUDA card", file=sys.stderr)
        return 1
    parent = pathlib.Path(args.parent).resolve()
    runs = []
    for label, tree in (("parent", parent), ("change", TREE),
                        ("change", TREE), ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, str(HERE), "--worker"],
                              cwd=tree, env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"worker in {tree} failed ({proc.returncode})"
                               f":\n{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((label, run))
        print(f"{label}: {run['seconds']!r} s (set-up and the first "
              f"block {run['first_block_s']!r}), {run['steps']} steps in "
              f"{run['blocks']} blocks, {run['ms_per_step']!r} ms a step "
              f"after the first block, launches a step "
              f"{run['launches_per_step']}, window {run['window']}; "
              f"iterations {[i['iterations'] for i in run['instances']]}",
              flush=True)
    summary = {}
    for label, run in runs:
        rec = summary.setdefault(label, {})
        for key, val in (("seconds", run["seconds"]),
                         ("first_block_s", run["first_block_s"]),
                         ("ms_per_step", run["ms_per_step"]),
                         *run["window"].items()):
            rec.setdefault(key, []).append(val)

    def counts(run):
        return [(i["status"], i["iterations"], i["restarts"])
                for i in run["instances"]]
    same = all(counts(run) == counts(runs[0][1]) for _, run in runs)
    obj_diff = max(abs(i["primal_obj"] - j["primal_obj"]) /
                   max(1.0, abs(j["primal_obj"]))
                   for _, run in runs for i, j in zip(
                       run["instances"], runs[0][1]["instances"]))
    out = {"card": runs[0][1]["card"], "torch": runs[0][1]["torch"],
           "order": [label for label, _ in runs],
           "same_counts": same, "objective_rel_diff": obj_diff,
           "instances": runs[0][1]["instances"],
           "launches_per_step": {label: run["launches_per_step"]
                                 for label, run in runs},
           "summary": summary}
    for label, rec in summary.items():
        print(f"{label}: " + ", ".join(
            f"{key} {statistics.fmean(vals)!r} [{min(vals)!r}, "
            f"{max(vals)!r}]" for key, vals in rec.items()), flush=True)
    print(f"every run's statuses, iterations and restarts equal: {same}; "
          f"objectives within {obj_diff!r} relative", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        # a worker imports the tree it runs in (PYTHONPATH), not the tree
        # of this file's folder
        sys.path.remove(str(HERE.parent))
    sys.exit(main())
