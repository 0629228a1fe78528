"""The reference objectives of `chip_smoke.py`'s batch and simplex
phases, from scipy's bundled HiGHS (an implementation independent of
this repo).

    python3 -m highs_tpu_torch.tools.lp_anchors [--write]

- the batch: `gen_synth_lp(m, m, seed=s)` for s = 0..15 with
  m = 1,536 + 32 s (every LP pads to 2,048);
- the simplex LP: `gen_synth_lp(1500, 1500)` (seed 42), which `choose`
  sends to the native simplex.

Each is solved with `linprog(method="highs")`.  Prints one line per LP
and the whole as JSON; `--write` stores the JSON in `lp_anchors.json`
beside this file, which `chip_smoke.py` reads.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import scipy
from scipy.optimize import linprog

from ..utils.gen_synth_lp import UPPER, gen_synth_lp

ANCHORS_FILE = pathlib.Path(__file__).with_name("lp_anchors.json")
BATCH_SEEDS = range(16)
SIMPLEX_SHAPE = (1500, 1500)


def batch_rows(seed: int) -> int:
    return 1536 + 32 * seed


def synth_objective(m: int, n: int, seed: int = 42) -> float:
    a, b, c = gen_synth_lp(m, n, seed=seed)
    # A x >= b as -A x <= -b
    res = linprog(c, A_ub=-a, b_ub=-b, bounds=(0.0, UPPER), method="highs")
    if res.status != 0:
        raise RuntimeError(f"scipy's HiGHS: status {res.status} on the "
                           f"synth LP {m} x {n}, seed {seed}")
    return float(res.fun)


def load() -> dict:
    """The stored anchors: {"batch": [16 objectives], "simplex": obj}."""
    with open(ANCHORS_FILE) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help=f"store the anchors in {ANCHORS_FILE.name}")
    args = ap.parse_args()
    out = {"scipy": scipy.__version__, "batch": [], "simplex": None}
    for s in BATCH_SEEDS:
        m = batch_rows(s)
        t0 = time.perf_counter()
        out["batch"].append(synth_objective(m, m, seed=s))
        print(f"batch seed {s} ({m} x {m}): objective "
              f"{out['batch'][-1]!r} seconds "
              f"{time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    out["simplex"] = synth_objective(*SIMPLEX_SHAPE)
    print(f"simplex synth {SIMPLEX_SHAPE[0]} x {SIMPLEX_SHAPE[1]}: objective "
          f"{out['simplex']!r} seconds {time.perf_counter() - t0:.1f}",
          flush=True)
    print(json.dumps(out))
    if args.write:
        ANCHORS_FILE.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
