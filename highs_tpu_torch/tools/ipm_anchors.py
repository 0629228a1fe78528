"""The reference objectives of `chip_smoke.py`'s two IPM phases, from
scipy's bundled HiGHS (an implementation independent of this repo).

    python3 -m highs_tpu_torch.tools.ipm_anchors

- the synth LP 2,400 x 20,000 (`gen_synth_lp(2400, 20000)`, seed 42):
  `linprog(method="highs")`;
- the 240 x 240 grid min-cost flow (`grid_flow_lp(240)`, seed 5):
  `linprog(method="highs-ipm")`.

Prints each objective with scipy's version and the seconds it took.
"""
from __future__ import annotations

import time

import numpy as np
import scipy
from scipy.optimize import linprog

from ..utils.gen_grid_flow_lp import grid_flow_lp
from ..utils.gen_synth_lp import UPPER, gen_synth_lp


def synth_anchor(method: str = "highs"):
    a, b, c = gen_synth_lp(2400, 20000)
    # A x >= b as -A x <= -b
    return linprog(c, A_ub=-a, b_ub=-b, bounds=(0.0, UPPER), method=method)


def grid_anchor(method: str = "highs-ipm"):
    lp = grid_flow_lp(240)
    return linprog(lp.col_cost, A_eq=lp.a_matrix.to_scipy(),
                   b_eq=lp.row_lower,
                   bounds=np.stack([lp.col_lower, lp.col_upper], 1),
                   method=method)


def main() -> None:
    for name, fn in (("synth 2400x20000", synth_anchor),
                     ("grid flow 240x240", grid_anchor)):
        t0 = time.perf_counter()
        res = fn()
        print(f"{name}: scipy {scipy.__version__} status {res.status} "
              f"objective {res.fun!r} seconds "
              f"{time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
