"""The readings that the limit of `correct` is set from, and its control.

    python3 lpbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--bases 42,43,...] [--out readings.jsonl]

In one process (set-up once): for each seed of `--seeds`, the first call
of a run of that seed, as the window makes it, judged by the harness's
`judge`: the sound readings. With `--bases`, each of those seeds is
read with the next base seed of the list in place of every member's
pool, so that the readings cover other LPs of the family than the
pool's. Then for each seed of `--control-seeds`, the same call with the
traffic's `control` in the program's place (an entry that computes the
LPs one precision below the configuration's, or the program's own
option for it), judged the same way: it has to come out not correct.
Each reading is printed as one JSON line (and written to `--out`): the
seed, the base seeds, whether it is the control, `correct`, the
numbers compared and each answer's status and KKT measures. The
benchmark's runs never run this; it is how the limits in PERF.md were
read.
"""
import argparse
import copy
import importlib
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lpbench import harness  # noqa: E402


def control_cell(cell: harness.Cell) -> harness.Cell:
    """`cell` with its traffic's control in the program's place."""
    ctl = cell.traffic["control"]
    out = copy.copy(cell)
    out.traffic = {**cell.traffic, "route": None,
                   "options": {**cell.traffic.get("options", {}),
                               **ctl.get("options", {})}}
    if "entry" in ctl:
        out.entry = importlib.import_module(f"lpbench.entries.{ctl['entry']}")
    return out


def on_base(cell: harness.Cell, base_seed: int) -> harness.Cell:
    """`cell` with every member's pool replaced by `base_seed`."""
    out = copy.copy(cell)
    members = [{**{k: v for k, v in m.items() if k != "seeds"},
                "seed": int(base_seed)} for m in cell.traffic["members"]]
    out.traffic = {**cell.traffic, "members": members}
    return out


def reading(cell: harness.Cell, bases: harness.Bases, seed: int, device,
            log, is_control: bool) -> dict:
    """One call of a run of `seed`, judged by the harness."""
    run = harness.Run()
    harness.window(cell, run, bases, seed, 0.0, False, device, log)
    checks, failed = harness.judge(cell, run, bases, seed, log)
    (rec,) = run.calls
    return {"workload": cell.name, "seed": seed, "control": is_control,
            "bases": sorted({a["base"] for a in run.judged}),
            "correct": harness.is_correct(checks, failed),
            "seconds": rec["seconds"], "route": rec["route"],
            "worst": checks["kkt_worst"]["value"],
            "checks": {k: c["value"] for k, c in checks.items()},
            "answers": run.judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--bases", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    cell = harness.load_cell(args.workload)
    bases = harness.Bases(cell)
    harness.warm_up(cell, device, log)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    base_seeds = [int(s) for s in args.bases.split(",") if s]
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    for i, seed in enumerate(seeds):
        one = on_base(cell, base_seeds[i]) if base_seeds else cell
        emit(reading(one, harness.Bases(one) if base_seeds else bases,
                     seed, device, log, False))
    ctl = control_cell(cell)
    for seed in ctl_seeds:
        emit(reading(ctl, bases, seed, device, log, True))
    for kind in (False, True):
        got = [r for r in rows if r["control"] is kind]
        if got:
            vals = [r["worst"] for r in got]
            print(f"{'control' if kind else 'sound'}: {len(vals)} seeds, "
                  f"correct {sum(r['correct'] for r in got)} of "
                  f"{len(got)}, kkt_worst from {min(vals):.4e} to "
                  f"{max(vals):.4e} (limit "
                  f"{cell.config['kkt_tolerance']:g})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
