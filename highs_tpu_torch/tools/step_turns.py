"""The PDHG step kernels of two trees, in turns on one CUDA card.

    python3 -m highs_tpu_torch.tools.step_turns --parent DIR
        [--out step_turns.json]

DIR is an unpacked checkout of another commit of this repository (the
parent).  The tool builds the first PDLP round's problem of block64k
and of synth50k (one-hot) once, through the facade's presolve and the
PDLP wrapper's `pdlp_problem`, and saves it for every worker.  Then it
runs one worker process in DIR and one in this tree, in turns (parent,
this, this, parent), and compares what they measured; host and card
vary between calls, so only numbers of one call compare.  Each worker:

- runs `tools/profile_block64k.py` `profile_blocks` on block64k
  (Halpern windows), synth50k (Halpern windows) and block64k in
  average mode: the wall ms of a step with the graphs on, its device
  ms by kernel (`by_kernel`: the two step kernels, the products, the
  rest) and the busy share;
- times both step kernels (`tools/step_bench.py` `step_kernel_records`:
  65,536 and 50,176, f32 and f64, both modes, with and without y_lo):
  cold device time, time per call, the plain chains' cold time and the
  byte bound.

A tree older than `tools/step_bench.py` is measured through its
`chip_smoke.py`'s `step_kernel_records`, and its kernel groups are
summed from the profile's top kernels.  Last, the tool reads from the
library each tree built every step kernel's registers and whether a
global load follows its first division in the SASS (`kernel_sass`).
Prints one line per run and cell, then the summary as one JSON object
as its last line, and writes it to `--out`.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile

CELLS = (("block64k", "halpern"), ("synth50k", "halpern"),
         ("block64k_avg", "average"))
HERE = pathlib.Path(__file__).resolve()
TREE = HERE.parents[2]


def first_round_problems(device) -> dict:
    """block64k's and synth50k's problem of the first PDLP round of
    `Highs().run()` (presolve, then the wrapper's scaling, padding and
    operator), by cell."""
    from highs_tpu_torch import Highs
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.solvers.pdlp.wrapper import pdlp_problem
    from highs_tpu_torch.utils.gen_block_lp import block_lp
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp

    out = {}
    for cell, lp, options in (
            ("block64k", block_lp(), {}),
            ("synth50k", synth_lp(), {"solver": "hipdlp",
                                      "tpu_matrix_format": "onehot"})):
        h = Highs(device=device)
        h.setOptionValue("output_flag", False)
        h.passModel(lp)
        h.presolve()
        opts = HighsOptions()
        for key, val in options.items():
            opts.set(key, val)
        out[cell] = pdlp_problem(h.getPresolvedLp(), opts, device).problem
    out["block64k_avg"] = out["block64k"]
    return out


def _records(device):
    """The tree's step kernel records (module doc)."""
    try:
        from highs_tpu_torch.tools.step_bench import step_kernel_records
    except ImportError:  # a tree from before tools/step_bench.py
        from chip_smoke import step_kernel_records
    return step_kernel_records(device)


def _worker(problems_file) -> dict:
    """One tree's measurements (module doc)."""
    import torch
    from highs_tpu_torch.tools.card import card_line
    from highs_tpu_torch.tools.profile_block64k import profile_blocks

    device = torch.device("cuda")
    problems = torch.load(problems_file, weights_only=False)
    cells = {cell: profile_blocks(problems[cell], device, mode)
             for cell, mode in CELLS}
    return {"card": card_line(), "torch": torch.__version__,
            "cells": cells, "kernels": _records(device)}


def summary(runs) -> dict:
    """Per cell and tree: the walls, device ms, busy shares and device ms
    by kernel group of every run; per kernel record the times of every
    run.  `runs`: [(tree label, worker output)]."""
    from highs_tpu_torch.tools.profile_block64k import kernel_groups

    cells, kernels = {}, {}
    for label, run in runs:
        for cell, r in run["cells"].items():
            groups = r.get("by_kernel") or kernel_groups(
                r["top_kernels"], r["device_ms_per_step"] or 0.0)
            rec = cells.setdefault(cell, {}).setdefault(label, {
                "wall_ms_per_step": [], "device_ms_per_step": [],
                "busy_share": [], **{g: [] for g in groups}})
            rec["wall_ms_per_step"].append(r["wall_ms_per_step"])
            rec["device_ms_per_step"].append(r["device_ms_per_step"])
            rec["busy_share"].append(r["device_busy_share"])
            for g, ms in groups.items():
                rec[g].append(ms)
        for k in run["kernels"]:
            key = (f"{k['name']} {k['path']} {k['dtype']} {k['mode']}"
                   f"{' y_lo' if k['y_lo'] else ''}")
            rec = kernels.setdefault(key, {"bound_ms": k["bound_ms"]})
            for field in ("ms", "call_ms", "plain_ms"):
                rec.setdefault(f"{label} {field}", []).append(k[field])
    return {"cells": cells, "kernels": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the other commit")
    ap.add_argument("--out", default="step_turns.json")
    ap.add_argument("--worker", metavar="PROBLEMS", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("step_turns: needs a CUDA card", file=sys.stderr)
        return 1
    from highs_tpu_torch.tools.step_bench import kernel_sass

    parent = pathlib.Path(args.parent).resolve()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        problems_file = os.path.join(tmp, "problems.pt")
        torch.save(first_round_problems(torch.device("cuda")),
                   problems_file)
        torch.cuda.empty_cache()
        for label, tree in (("parent", parent), ("change", TREE),
                            ("change", TREE), ("parent", parent)):
            env = dict(os.environ, PYTHONPATH=str(tree))
            proc = subprocess.run(
                [sys.executable, str(HERE), "--worker", problems_file],
                cwd=tree, env=env, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"worker in {tree} failed ({proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append((label, run))
            for cell, r in run["cells"].items():
                print(f"{label} {cell}: wall {r['wall_ms_per_step']!r} ms "
                      f"a step, device {r['device_ms_per_step']!r}, busy "
                      f"{r['device_busy_share']!r}", flush=True)
    # each worker built its tree's library of the step kernels
    sass = {"parent": kernel_sass(next(
                (parent / "highs_tpu_torch" / "_build").glob(
                    "libpdhg_step-*.so"))),
            "change": kernel_sass()}
    for label, kernels in sass.items():
        for name, r in kernels.items():
            print(f"SASS {label} {name}: {r}", flush=True)
    out = {"card": runs[0][1]["card"], "torch": runs[0][1]["torch"],
           "order": [label for label, _ in runs], "sass": sass,
           **summary(runs)}
    for cell, trees in out["cells"].items():
        for label, rec in trees.items():
            print(f"{cell} {label}: " + ", ".join(
                f"{key} {statistics.fmean(vals)!r} "
                f"[{min(vals)!r}, {max(vals)!r}]"
                for key, vals in rec.items() if None not in vals),
                flush=True)
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
