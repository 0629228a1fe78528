"""The reference objectives of `chip_smoke.py`'s MIP phase, from scipy's
bundled HiGHS (an implementation independent of this repo).

    python3 -m highs_tpu_torch.tools.mip_anchors [--write]

- `setcover`: `gen_mip.set_cover(500, 1000, 0.05, seed=0)`, the "easy"
  set-covering size of Gasse et al. (2019) (this generator's seed-0
  instance at their 1,000-row "medium" size takes scipy 98 s and is not
  proven by the MIP engine within the phase's 300 s: PERF.md);
- `cfl`: `gen_mip.facility_location(100, 100, 5.0, seed=0)`, their
  capacitated facility location (10,201 rows).

Each is solved by `scipy.optimize.milp` with `mip_rel_gap` 0, so the
objective is a proven optimum.  Prints one line per MIP and the whole as
JSON; `--write` stores the JSON in `mip_anchors.json` beside this file,
which `chip_smoke.py` reads.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import scipy
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from ..utils.gen_mip import facility_location, set_cover

ANCHORS_FILE = pathlib.Path(__file__).with_name("mip_anchors.json")
INSTANCES = {
    "setcover": (set_cover, dict(nrows=500, ncols=1000, density=0.05,
                                 seed=0)),
    "cfl": (facility_location, dict(n_customers=100, n_facilities=100,
                                    ratio=5.0, seed=0)),
}


def model(name: str) -> dict:
    make, kwargs = INSTANCES[name]
    return make(**kwargs)


def scipy_milp(d: dict, time_limit: float = 3600.0):
    """scipy's HiGHS on a model dict: (status, objective, x, seconds)."""
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    t0 = time.perf_counter()
    res = milp(np.asarray(d["col_cost"]),
               constraints=LinearConstraint(a, d["row_lower"],
                                            d["row_upper"]),
               bounds=Bounds(d["col_lower"], d["col_upper"]),
               integrality=np.asarray(d["integrality"]),
               options={"mip_rel_gap": 0.0, "time_limit": time_limit})
    return res.status, res.fun, res.x, time.perf_counter() - t0


def load() -> dict:
    """The stored anchors: {"setcover": obj, "cfl": obj, ...}."""
    with open(ANCHORS_FILE) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help=f"store the anchors in {ANCHORS_FILE.name}")
    args = ap.parse_args()
    out = {"scipy": scipy.__version__, "mip_rel_gap": 0.0}
    for name in INSTANCES:
        status, obj, _, secs = scipy_milp(model(name))
        if status != 0:
            raise RuntimeError(f"scipy's HiGHS: status {status} on {name}")
        out[name] = float(obj)
        print(f"{name}: objective {obj!r} seconds {secs:.1f}", flush=True)
    print(json.dumps(out))
    if args.write:
        ANCHORS_FILE.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
