"""Split an interior-point solve, with a host yardstick beside it.

    python3 -m highs_tpu_torch.tools.profile_ipm [--lp grid|dense]
        [--side G] [--device cuda|cpu] [--out FILE]

Solves one of `chip_smoke.py`'s IPM LPs (`grid`: the G x G grid
min-cost flow, G = 240 by default; `dense`: synth 2,400 x 20,000)
through `Highs().run()` with default options and prints one JSON line:
the card's name and power limit, the status, objective and seconds of
`run()`, the IPM iterations, the facade's IPM clocks per iteration, the
factors by route and device, and a host yardstick: the seconds of three
SuperLU factors (scipy `splu`) of the grid's K K' + I, which no solver
code runs, so that two calls can be told apart by their host's speed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import highs_tpu_torch
from highs_tpu_torch.solvers.ipm import banded_chol, solver
from highs_tpu_torch.utils.gen_grid_flow_lp import grid_flow_lp
from highs_tpu_torch.utils.gen_synth_lp import synth_lp


def splu_seconds(lp, repeat: int = 3) -> list:
    """Seconds of `repeat` SuperLU factors of K K' + I for the LP's K."""
    a = lp.a_matrix.to_scipy().tocsr()
    mmat = (a @ a.T + sp.identity(a.shape[0])).tocsc()
    out = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        spla.splu(mmat)
        out.append(time.perf_counter() - t0)
    return out


def profile(lp, device) -> dict:
    h = highs_tpu_torch.Highs(device=device)
    h.passModel(lp)
    dense0 = dict(solver.DENSE_FACTORS)
    banded0 = dict(banded_chol.FACTORS)
    t0 = time.perf_counter()
    h.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    iters = int(h.getInfo().ipm_iteration_count)
    clocks = {k: h.getTimer().read(f"ipm_{k}") for k in
              ("setup", "iterations", "normal", "factor", "solve")}
    return dict(
        status=h.getModelStatus().name, objective=h.getObjectiveValue(),
        seconds=seconds, ipm_iterations=iters,
        presolve_s=h.getRunData().presolve_time, ipm_setup_s=clocks["setup"],
        ms_per_iteration={k: 1e3 * clocks[k] / max(iters, 1) for k in
                          ("iterations", "normal", "factor", "solve")},
        dense_factors={k: solver.DENSE_FACTORS[k] - dense0[k]
                       for k in dense0},
        banded_factors={k: banded_chol.FACTORS[k] - banded0[k]
                        for k in banded0})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lp", choices=("grid", "dense"), default="grid")
    ap.add_argument("--side", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = torch.device(args.device)
    grid = grid_flow_lp(args.side)
    lp = grid if args.lp == "grid" else synth_lp(2400, 20000)
    rec = {"lp": args.lp, "side": args.side if args.lp == "grid" else None}
    if device.type == "cuda":
        from highs_tpu_torch.tools.card import card_line
        rec["card"] = card_line()
    rec["host_splu_s"] = splu_seconds(grid)
    rec.update(profile(lp, device))
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
