"""Both sides of the LP IPM's fill gate: the "ldl" route (M factored
sparse on the host) against the "dense_m" route (M factored dense on the
device) on LPs whose normal matrix fills in and on LPs whose does not.

    python3 -m highs_tpu_torch.tools.ipm_route_probe [--device cuda|cpu]
        [--out FILE]

LPs, each solved by `solve_lp_ipm_native` with default options but the
route:

- `grid`: `grid_flow_lp(122)`, 14,884 rows, a grid Laplacian;
- `cfl_small`: the LP relaxation of `gen_mip.facility_location(50, 60)`,
  3,111 rows;
- `cfl`: the LP relaxation of `gen_mip.facility_location(100, 100)`,
  10,201 rows (the MIP phase's facility location).

For each: its rows, the share of M's lower triangle that the native LDL'
factor fills, the gate's answer (`_fills_in`) and its seconds on a cold
cache, the route that `choose` takes, and for each route the status,
objective, IPM iterations, seconds, and ms per iteration of the Newton
phases (normal matrix, factor, solves), under `choose` and under the
other route.  On `cfl` the "ldl" route is not solved, since its host
factor takes minutes: the seconds of one native LDL' of its K K' + I
(analysis and numeric factor) stand in for it.
Prints one JSON line, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import scipy.sparse as sp
import torch

from highs_tpu_torch.convert import lp_from_numpy
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.ipm import solver
from highs_tpu_torch.solvers.ipm.sparse_ldl import SparseLdl
from highs_tpu_torch.solvers.pdlp.preprocess import preprocess_lp
from highs_tpu_torch.utils.gen_grid_flow_lp import grid_flow_lp
from highs_tpu_torch.utils.gen_mip import facility_location


class _Clock:
    """Collects the IPM's named clocks (the facade's timer interface)."""

    def __init__(self):
        self.seconds = {}

    def add(self, name, seconds, calls=1):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


def relaxation(n_customers: int, n_facilities: int):
    d = facility_location(n_customers, n_facilities)
    d["integrality"] = np.zeros_like(d["integrality"])
    return lp_from_numpy(d)


def gram(lp) -> sp.csc_matrix:
    a = preprocess_lp(lp).a.tocsr()
    out = (a @ a.T + sp.identity(a.shape[0])).tocsc()
    out.sum_duplicates()
    return out


def solve(lp, route: str, device) -> dict:
    opts = HighsOptions()
    opts.tpu_ipm_newton = route
    clock = _Clock()
    opts._timer = clock
    t0 = time.perf_counter()
    st, _, info = solver.solve_lp_ipm_native(lp, opts, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    it = max(info.iterations, 1)
    return dict(
        route=info.newton, status=st.name, objective=info.primal_obj,
        iterations=info.iterations, seconds=seconds,
        setup_s=clock.seconds.get("ipm_setup"),
        ms_per_iteration={k: 1e3 * clock.seconds.get(f"ipm_{k}", 0.0) / it
                          for k in ("iterations", "normal", "factor",
                                    "solve")})


def probe(name: str, lp, device) -> dict:
    g = gram(lp)
    m = g.shape[0]
    t0 = time.perf_counter()
    h = SparseLdl(g, numeric=False)
    share = h.lnnz / (m * (m + 1) / 2)
    analyse_s = time.perf_counter() - t0
    h.close()
    solver._FILL_CACHE.clear()
    t0 = time.perf_counter()
    fills_in = solver._fills_in(preprocess_lp(lp).a)
    rec = dict(lp=name, rows=lp.num_row, fill_share=share,
               analysis_s=analyse_s, fills_in=fills_in,
               gate_s=time.perf_counter() - t0)
    rec["choose"] = solve(lp, "choose", device)
    other = "ldl" if rec["choose"]["route"] == "dense_m" else "dense_m"
    if name != "cfl":
        rec[other] = solve(lp, other, device)
    else:
        t0 = time.perf_counter()
        SparseLdl(g).close()
        rec["host_ldl_factor_s"] = time.perf_counter() - t0
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = torch.device(args.device)
    rec = {"gate": solver.DENSE_M_FILL}
    if device.type == "cuda":
        from highs_tpu_torch.tools.card import card_line
        rec["card"] = card_line()
    rec["lps"] = [probe("grid", grid_flow_lp(122), device),
                  probe("cfl_small", relaxation(50, 60), device),
                  probe("cfl", relaxation(100, 100), device)]
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
