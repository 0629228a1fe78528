"""The MIP's batched node-LP rounds of two trees, in turns on one CUDA card.

    python3 -m highs_tpu_torch.tools.node_turns --parent DIR
        [--out node_turns.json]

DIR is an unpacked checkout of another commit of this repository (the
parent).  The tool runs one worker process in DIR and one in this tree,
in turns (parent, this, this, parent); host and card vary between
calls, so only numbers of one call compare.  Each worker builds
`BatchNodeEvaluator` (`solvers/mip/batch_nodes.py`) on the LP relaxation
of `chip_smoke.py`'s set cover (`tools/mip_anchors.py` "setcover": 500
rows, 1,000 columns; standard form m = 500, n_std = 1,000) and evaluates
fixed seeded rounds (`ROUNDS`: K nodes a round, each with `FIXED`
columns fixed to 0 or 1, as branching leaves them) twice: the first pass
(with the graphs' captures, where the tree has them) and a warm one. It
reports:

- each round's batched iterations and converged lanes, and the
  certified dual bounds (which the two trees compare);
- the first pass's seconds, and the graphs captured by the evaluator;
- over the warm pass (`profile_rounds`): the wall ms per batched IPM
  iteration (a round's host work included, as `chip_smoke.py` phase 16
  counts it), and under `torch.profiler` the device ms per iteration by
  kernel group and for the top kernels, the busy share (device over
  wall) and the kernels per iteration;
- in a tree with graphs, the same rounds through an evaluator that runs
  op by op (the attribute `capture` set to None): equal bit for bit
  (each lane's flag, bound and x, each round's iterations), and its wall
  ms per iteration.

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
# (K, seed) of the rounds: full rounds of chip_smoke.py's K = 8, and the
# partial ones a MIP's round makes when its heap runs short
ROUNDS = [(8, 0), (8, 1), (8, 2), (5, 3), (8, 4), (3, 5), (8, 6), (8, 7)]
FIXED = 20
# the kernels of a batched IPM step, by a part of their profiler name:
# cuSOLVER's batched Cholesky factor, cuBLAS's triangular solves, the
# products (K Theta K' and the K x, K' y products), the reductions; the
# rest are PyTorch's elementwise kernels and copies
KERNEL_GROUPS = {"factor": ("potrf",),
                 "triangular_solves": ("trsv", "trsm"),
                 "products": ("gemm", "gemv", "dot_kernel", "splitK"),
                 "reductions": ("reduce_kernel",)}


def relaxation():
    """The LP relaxation of the set cover as a port `HighsLp`."""
    import numpy as np
    from highs_tpu_torch.convert import lp_from_numpy
    from highs_tpu_torch.tools.mip_anchors import model
    d = model("setcover")
    return lp_from_numpy(dict(d, integrality=np.zeros(d["num_col"],
                                                      dtype=np.uint8)))


def node_rounds(lp, rounds=ROUNDS, fixed=FIXED):
    """(los, ups) of each round: per node `fixed` seeded columns fixed to
    a seeded 0 or 1, the rest at the relaxation's bounds."""
    import numpy as np
    out = []
    for K, seed in rounds:
        rng = np.random.default_rng(seed)
        los = np.tile(lp.col_lower, (K, 1))
        ups = np.tile(lp.col_upper, (K, 1))
        for lane in range(K):
            js = rng.choice(lp.num_col, fixed, replace=False)
            los[lane, js] = ups[lane, js] = rng.integers(0, 2, fixed)
        out.append((los, ups))
    return out


def run_rounds(ev, rounds):
    """Each round through `ev`: (results, batched iterations) a round."""
    from highs_tpu_torch.solvers.mip import batch_nodes
    out = []
    for los, ups in rounds:
        it0 = batch_nodes.COUNTS["iterations"]
        out.append((ev.evaluate(los, ups),
                    batch_nodes.COUNTS["iterations"] - it0))
    return out


def same_bits(a, b) -> bool:
    """Two `run_rounds` outputs equal bit for bit."""
    import numpy as np
    if [it for _, it in a] != [it for _, it in b]:
        return False
    for (ra, _), (rb, _) in zip(a, b):
        for (ca, ba, xa), (cb, bb, xb) in zip(ra, rb):
            if ca != cb or np.float64(ba).tobytes() != \
                    np.float64(bb).tobytes():
                return False
            if (xa is None) != (xb is None) or \
                    (xa is not None and xa.tobytes() != xb.tobytes()):
                return False
    return True


def kernel_groups(kernels: dict, device_ms: float) -> dict:
    out = {group: sum(k["device_ms_per_iteration"]
                      for name, k in kernels.items()
                      if any(part in name for part in parts))
           for group, parts in KERNEL_GROUPS.items()}
    out["elementwise_and_rest"] = device_ms - sum(out.values())
    return out


def profile_rounds(ev, rounds) -> dict:
    """The rounds through `ev` once more for the wall ms per batched
    iteration (the card synchronised at the end), then once under
    `torch.profiler`: device ms per iteration by kernel group and of the
    top kernels, the busy share and the kernels per iteration."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = run_rounds(ev, rounds)
    torch.cuda.synchronize()
    iterations = sum(it for _, it in runs)
    wall = (time.perf_counter() - t0) * 1e3 / iterations
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_rounds(ev, rounds)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            kernels[e.key] = {"calls": e.count / iterations,
                              "device_ms_per_iteration":
                              e.self_device_time_total / 1e3 / iterations}
    device_ms = sum(k["device_ms_per_iteration"] for k in kernels.values())
    return {
        "iterations": iterations, "wall_ms_per_iteration": wall,
        "device_ms_per_iteration": device_ms if kernels else None,
        "device_busy_share": device_ms / wall if kernels else None,
        "kernels_per_iteration": (sum(k["calls"] for k in kernels.values())
                                  if kernels else None),
        "by_group": kernel_groups(kernels, device_ms) if kernels else None,
        "top_kernels": dict(sorted(
            kernels.items(),
            key=lambda kv: -kv[1]["device_ms_per_iteration"])[:12])}


def _worker(device) -> dict:
    """One tree's measurements (module doc) on `device`."""
    import torch
    from highs_tpu_torch.solvers.ipm import solver as ipm_solver
    from highs_tpu_torch.solvers.mip import batch_nodes
    from highs_tpu_torch.tools.card import card_line

    device = torch.device(device)
    lp = relaxation()
    rounds = node_rounds(lp)
    counts0 = dict(batch_nodes.COUNTS)
    factors0 = dict(ipm_solver.DENSE_FACTORS)
    t0 = time.perf_counter()
    ev = batch_nodes.BatchNodeEvaluator(lp, device=device)
    first = run_rounds(ev, rounds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    iterations = sum(it for _, it in first)
    out = {
        "card": card_line(), "torch": torch.__version__,
        "graphs": getattr(ev, "capture", None) is not None,
        "first_pass_s": first_s, "iterations": iterations,
        "rounds": [{"K": len(res), "iterations": it,
                    "converged": sum(r[0] for r in res),
                    "bounds": [r[1] if r[1] > -float("inf") else None
                               for r in res]} for res, it in first],
        "captures": (batch_nodes.COUNTS["captures"] - counts0["captures"]
                     if "captures" in counts0 else None),
        "dense_factors": {k: ipm_solver.DENSE_FACTORS[k] - factors0[k]
                          for k in factors0},
        "profile": profile_rounds(ev, rounds)}
    if out["graphs"]:
        eager = batch_nodes.BatchNodeEvaluator(lp, device=device)
        eager.capture = None
        out["equal_to_eager"] = same_bits(first, run_rounds(eager, rounds))
        out["eager_profile"] = profile_rounds(eager, rounds)
        eager.close()
        ev.close()
    return out


def _line(label, run) -> str:
    p = run["profile"]
    text = (f"{label}: graphs {run['graphs']}, first pass "
            f"{run['first_pass_s']!r} s ({run['captures']} captures), "
            f"{run['iterations']} batched iterations; warm: "
            f"{p['wall_ms_per_iteration']!r} ms an iteration, device "
            f"{p['device_ms_per_iteration']!r}, busy "
            f"{p['device_busy_share']!r}, kernels "
            f"{p['kernels_per_iteration']!r}, by group {p['by_group']}")
    if run["graphs"]:
        text += (f"; op by op {run['eager_profile']['wall_ms_per_iteration']!r}"
                 f" ms an iteration, equal bits {run['equal_to_eager']}")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the other commit")
    ap.add_argument("--out", default="node_turns.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker("cuda")), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("node_turns: needs a CUDA card", file=sys.stderr)
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
        print(_line(label, run), flush=True)
    summary = {}
    for label, run in runs:
        rec = summary.setdefault(label, {})
        p = run["profile"]
        vals = {"first_pass_s": run["first_pass_s"],
                "wall_ms_per_iteration": p["wall_ms_per_iteration"],
                "device_ms_per_iteration": p["device_ms_per_iteration"],
                "device_busy_share": p["device_busy_share"],
                "kernels_per_iteration": p["kernels_per_iteration"]}
        if run["graphs"]:
            vals["eager_wall_ms_per_iteration"] = \
                run["eager_profile"]["wall_ms_per_iteration"]
        for key, val in vals.items():
            rec.setdefault(key, []).append(val)
    by_label = {}
    for label, run in runs:
        by_label.setdefault(label, run)
    # the trees' rounds side by side: iterations, converged lanes and the
    # largest relative difference of two certified bounds
    rounds_cmp = []
    for rp, rc in zip(by_label["parent"]["rounds"],
                      by_label["change"]["rounds"]):
        diffs = [abs(a - b) / max(1.0, abs(a))
                 for a, b in zip(rp["bounds"], rc["bounds"])
                 if a is not None and b is not None]
        rounds_cmp.append({"K": rp["K"],
                           "iterations": [rp["iterations"],
                                          rc["iterations"]],
                           "converged": [rp["converged"], rc["converged"]],
                           "bound_rel_diff": max(diffs, default=None)})
    out = {"card": runs[0][1]["card"], "torch": runs[0][1]["torch"],
           "order": [label for label, _ in runs],
           "rounds": ROUNDS, "fixed": FIXED, "trees_rounds": rounds_cmp,
           "captures": {label: run["captures"] for label, run in runs},
           "equal_to_eager": [run.get("equal_to_eager") for _, run in runs
                              if run["graphs"]],
           "profiles": {label: {"graphs": run["profile"],
                                "eager": run.get("eager_profile")}
                        for label, run in by_label.items()},
           "summary": summary}
    for label, rec in summary.items():
        print(f"{label}: " + ", ".join(
            f"{key} {statistics.fmean(vals)!r} [{min(vals)!r}, "
            f"{max(vals)!r}]" for key, vals in rec.items()), flush=True)
    print(f"rounds (parent, change): {rounds_cmp}", flush=True)
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
