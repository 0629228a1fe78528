#!/usr/bin/env python3
"""Chip smoke test of highs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build    the CUDA kernels of `highs_tpu_torch/csrc/` with nvcc
            (sm_90a), one nvcc process per source, all started together;
2. blockcsr the block-CSR kernel on the block64k operator (65,536 x
            65,536, 1,534 dense 128x128 tiles per direction), in float32
            and float64, K x and K' y: against its plain PyTorch version
            on the card (f64: 1e-12, f32: 1e-5, both relative to
            ||(|A| |x|)||_inf), and the times of the kernel, the plain
            version and one PyTorch BSR product (a yardstick only),
            beside the byte and operation bound;
3. onehot   the fused one-hot kernel (the whole product y = K x in one
            launch) on the synth50k operator (50,176 x 50,176 padded,
            P = 7 slots per cell, a table of 499,953 entries per
            direction), in float32 and float64, K x and K' y: against its
            plain PyTorch version over the same table and against the JAX
            package's composition over the padded cells (gather, relayout,
            scatter, spill) in f64 (f64: 1e-12, f32: 1e-5, relative to
            ||(|A| |x|)||_inf), the same bits on a rerun, one launch per
            product, with the times of the kernel, its plain version and
            one `torch.sparse_csr_tensor @ x` of the same matrix (a
            yardstick only) beside the byte bound of the table;
4. probe    the gather-rate probe (16-byte index loads and output
            stores, a one-wave grid) at the shapes of the JAX package's
            two probes, f32 and f64: exactly equal to `torch.gather`, its
            cold time beside its byte bound and `torch.gather`'s, rates;
5. small    a 256 x 256 block LP through `Highs` on the card and on the
            CPU: the two objectives agree to 1e-6 relative;
6. formats  a 4,096 x 4,096 synth LP through `Highs(device="cuda")` with
            solver "hipdlp" at tolerance 1e-5 in each of the formats
            dense, ell, panelell, bucketell, bucketperm, bcoo and onehot,
            and bucketperm again at 1e-6, below the f32 floor, so that
            its f64 refinement runs in the permuted space: every run
            kOptimal, every objective within 1e-6 relative of an f64 CPU
            `ell` run of the port at the same tolerance;
7. block64k through `Highs().run()` with the default options (solver
            "choose", tolerance 1e-7: an f32 cold round and f64
            refinement): kOptimal, an independent f64 KKT check of the
            returned solution (primal and dual residual and gap <= 1e-7),
            the objective against the upstream HiGHS run recorded in
            BASELINE_MEASURED.json, and at least two block-CSR launches
            per PDLP iteration;
8. synth50k through `Highs().run()` with solver "hipdlp" and
            tpu_matrix_format "onehot" (tolerance 1e-7): kOptimal, the
            same independent KKT check, the objective within 1e-6 of
            upstream HiGHS's, and the one-hot kernel launched at least
            twice per PDLP iteration;
9. ipm_dense  the synth LP 2,400 x 20,000 (seed 42) through `Highs().run()`
            with the default options, which send it to the interior-point
            solver's dense route: kOptimal in IPM iterations only, a dense
            Cholesky of the normal matrix on the card in every iteration
            and none on the CPU, the same independent KKT check (<= 1e-7),
            the objective within 1e-6 of scipy's HiGHS
            (`tools/ipm_anchors.py`);
10. ipm_sparse the 240 x 240 grid min-cost flow (57,600 rows) the same
            way, which the IPM solves by its sparse route (the banded f64
            factor on the card as replayed CUDA graphs, the starting
            point's and every iteration's, with no hand-off to the host
            by the Newton residual's gate): kOptimal in IPM iterations
            only, an independent f64
            check of L <= Ax <= U and l <= x <= u (<= 1e-7 relative), the
            objective within 1e-6 of scipy's HiGHS IPM.  Both IPM phases
            print their iterations and seconds, and per iteration the
            normal-matrix product, the factorization, the solves and the
            rest (host work and the elementwise chain); the dense one
            the normal phase's full-GEMM f64 rate and the share of the
            FP64 tensor peak its useful (symmetric) operations make, the
            sparse one the banded factors run on the card, the graphs'
            captures and replays and the starting point's factor;
11. block64k_avg block64k through `Highs().run()` with solver "pdlp" (the
            average-iterate engine) and every other option at its default
            (block-CSR, an f32 cold round and f64 refinement): kOptimal,
            the same independent KKT check, the objective within 1e-6 of
            upstream HiGHS's, and at least two block-CSR launches per PDLP
            iteration; it prints the iterations, restarts, seconds, wall
            time per step and launches;
12. batch    the batch on the card: the two step kernels' batched
            launches under `torch.func.vmap` (`tools/step_bench.py`
            `batched_step_records`: 1, 3 and 16 instances of 128 and
            2,048, f32 and f64, both modes, with and without y_lo, every
            third lane frozen) against the vmapped plain chains bit for
            bit, one launch a vmapped call, timed at 16 x 2,048; the
            batch's runner (two captured graphs) against its windows op
            by op, bit for bit across a freeze; the busy share and
            device ms of its blocks (`profile_batch_blocks`); then
            `solve_lp_batch` on 16 synth LPs (`gen_synth_lp(m, m,
            seed=s)`, s = 0..15, m = 1,536 + 32 s: all pad to 2,048 x
            2,048) with the default options (f64 on the card): per
            instance kOptimal, the independent KKT check, the objective
            within 1e-6 of scipy's HiGHS (`tools/lp_anchors.py`, stored
            in `tools/lp_anchors.json`) and the parent tree's iterations
            (`PARENT_ITERATIONS["batch"]`), one launch of each step
            kernel a step and every block replayed; it prints each
            instance's iterations, blocks and seconds, the ms a step
            after the first block against the byte floor of reading the
            stacked dense K twice a step, the busy share and the launches
            a step;
13. simplex  the synth LP 1,500 x 1,500 through `Highs().run()` with the
            default options, which send it to the native simplex on the
            host: kOptimal, a valid basis, pivots counted, the KKT check and
            scipy's objective; then ipm_dense's LP with solver "ipm" (the
            IPM on the card, then crossover on the host): kOptimal, a valid
            basis, the crossover's count reported, scipy's objective;
14. qp       the convex QP path, on the card:
            qp_dense  `gen_mm_style(7, 10000, 5000, "full", 1e4, 0.3, 5e-4)`
                      (`utils/gen_mm_qp.py`: the size of the Maros-Meszaros
                      CVXQP1_L, 10,000 columns and 5,000 rows, a nearly
                      dense Q) through `Highs().run()` with the default
                      options: kOptimal, every dense Cholesky of the QP IPM
                      on the card and none on the CPU, and an independent
                      f64 certificate from the model's data alone (primal
                      infeasibility of rows and bounds and stationarity
                      c + Qx - A'y - z each <= 1e-7 relative, the
                      multipliers' weight on infinite bounds <= 1e-7, and
                      the gap between the primal objective and the QP's
                      dual objective -1/2 x'Qx + the row and bound terms <=
                      1e-6 relative); it prints the iterations, the set-up
                      seconds, the ms per iteration split into factor(Q+D),
                      the A' solves, A W, factor(M) and the rest, and the
                      FP64 rate of the iteration's useful operations;
            qpasm     `gen_mm_style(7, 300, 150, ...)` with solver "qpasm"
                      (the active set on the host): kOptimal, the same
                      certificate, the objective within 1e-6 of the QP IPM's
                      on the card for the same QP, and whether the active
                      set fell back to the IPM;
            qp_status a seeded infeasible and a seeded unbounded QP through
                      `Highs().run()`: kInfeasible and kUnbounded, their
                      classification LPs factored on the card; an MIQP
                      gives kError;
15. mip      the MIP path (branch-and-cut on the host; node relaxations
            above 10,000 rows and the root's central rounding on the
            card), each run through `Highs().run()` with the default
            options and a `time_limit` (`utils/gen_mip.py`; the anchors
            are scipy 1.17's proven optima, `tools/mip_anchors.py`):
            mip_setcover  set covering 500 x 1,000, density 0.05, seed 0
                      (Gasse et al. 2019's easy size: this generator's
                      seed-0 instance at their medium size is not proven
                      within the limit, PERF.md), time_limit 300:
                      kOptimal, the objective within mip_rel_gap of
                      the anchor, integrality violation and every row and
                      bound of the model's data <= 1e-6 in f64; it prints
                      nodes, LP iterations, seconds, the root bound after
                      cuts, the cut rounds and the IPM factors by device;
            mip_cfl   capacitated facility location, 100 customers x 100
                      facilities (10,201 rows: the presolved relaxation has
                      more than 10,000 rows, so every node LP goes to the
                      IPM with its iterate on the card and its normal
                      matrix factored dense there), time_limit 150:
                      kOptimal within mip_rel_gap of the anchor, or
                      kTimeLimit with a feasible incumbent and dual bound <=
                      anchor <= incumbent (1e-6 slack); at least one IPM
                      solve on the card, and `run()` back within time_limit
                      + 30 s; it prints the status, nodes, gap, IPM solves
                      and factors by device and the mean ms per node LP;
            mip_small a semi-continuous MIP, an SOS1 MIP, an equality
                      knapsack program whose root reaches central rounding
                      (its analytic-centre IPM solve on the card) and an
                      infeasible MIP: the statuses and, where optimal, the
                      objectives of scipy's `milp` on the card's host;
16. mip_batch the same set cover with `tpu_mip_batch_nodes` 8 (rounds of
            8 open nodes, the IPM's dense step under vmap on the card,
            each round's starting point and steps as replays of CUDA
            graphs captured once per round size) and `time_limit` 180:
            kOptimal within mip_rel_gap of the anchor or kTimeLimit with
            a certified sandwich, the incumbent feasible and integral to
            1e-6, at least one batched round, every batched iteration on
            the card and no dense factor on the CPU, every round's start
            and steps replayed (replays = rounds + iterations); each
            lane of its first 4 rounds against its node LP solved by the
            native dual simplex on the host (a converged lane's
            objective within 1e-6 relative, every certified dual bound at
            most the optimum + 1e-6 (1 + |opt|)); the same 4 rounds
            through fresh evaluators as graphs and op by op: equal bit
            for bit to each other and to the run; it prints the rounds,
            lanes, converged share, captures and replays, ms per batched
            IPM iteration, nodes and seconds beside phase 15's, and on
            the 4 rounds the ms per batched iteration as graphs and op by
            op, the busy share and the device ms by kernel
            (`tools/node_turns.py` `profile_rounds`);
17. interfaces ipm_dense's LP written with `write_lp` and read back,
            solved by `python3 -m highs_tpu_torch <file>.lp` in a
            subprocess (exit 0, "Optimal", the objective within 1e-6 of
            scipy's) and by `capi.Highs_lpCall` on its arrays (the IPM on
            the card); `getRanging()` on phase 13's solved facade, with
            10 sampled nonbasic columns re-solved warm from its basis
            (inside the cost range 0 pivots and the predicted objective,
            outside at least one pivot); `getIis()` from the dual ray on
            a 202-row infeasible synth LP (infeasible, and feasible with
            any one of its rows dropped; its feasibility LPs on the
            card); a lexicographic two-objective solve of ipm_dense's LP
            on the card (the second objective over the points within 1%
            of the first's optimum), checked by a solve of the second
            objective with the first fixed as a row;
18. mesh     PDLP over a mesh: block64k through `Highs().run()` with
            tpu_matrix_format "blockcsr" and tpu_mesh_shape the machine's
            card count: kOptimal, phase 7's KKT check, the objective
            within 1e-6 of upstream HiGHS's, at least 2 d block-CSR
            launches per PDLP iteration, its iterations beside phase 7's;
            a multi-axis tpu_mesh_shape and one of more cards than the
            machine has raise ValueError; block64k's operator row-sharded
            in block-CSR over 4 shards of the one card
            (`make_row_sharded`), f32 and f64: K x and K' y against the
            unsharded kernel (f64: 1e-12, f32: 1e-5, relative to
            ||(|A| |x|)||_inf), 4 launches a product, the cold times of
            both; one `solve_pdhg` of block64k (unscaled, f32, tolerance
            1e-4) on the 4-shard and on the unsharded operator: both
            kOptimal, their iterations printed; `dryrun_multichip(8)`
            over the card (every sharded layout within 1e-5 of one
            device, at least one partial-sum reduction a step);
19. graphs   the PDHG inner block on the card: the two step kernels
            (`csrc/pdhg_step.cu`: `pdhg_primal_step`, `pdhg_dual_step`)
            against their plain chains (`ops/pdhg_step.py`) at block64k's
            (65,536) and synth50k's (50,176) widths, f32 and f64, Halpern
            and average mode, with and without a dual floor y_lo: equal
            bit for bit, their cold times beside the byte bound
            (`tools/step_bench.py`); the same
            bit checks at widths off the vector grid (1, 3, 5, 127,
            65,537) and a view offset by one element refused; each
            kernel's registers and whether a global load follows its
            first division in the SASS (`cuobjdump`: none may); one
            captured restart window (`solvers/pdlp/graph.py`) against the
            eager window with the kernels and against the plain chain, on
            block64k's scaled problem (the f32 cold round of phase 7): the
            state, restart control and metrics equal bit for bit after 4
            windows; the wall, the device ms by kernel (step kernels,
            products, the rest), the busy share and the launches per step
            of block64k's windows, synth50k's and block64k's average
            blocks with the graphs on (`tools/profile_block64k.py`).
20. scaling  the PDLP scaling (`solvers/pdlp/scaling.py`, default
            mode 5: Ruiz, then L2) of block64k's and synth50k's
            standard-form K on the card and in its CPU form: the card's
            scaled values, row and column scales and Ruiz passes equal
            the CPU form's bit for bit, each one's seconds (host clock,
            the card's ending in a synchronize), and the segment-sum
            kernel (`csrc/segment_sum.cu`) on block64k's scaled K, rows
            and columns, |a| and a * a: equal to its plain version bit
            for bit, its cold time beside the byte bound, the plain
            version's and one `torch.segment_reduce` call's (rows, a
            yardstick only).  Phases 7 and 8 print the span
            `pdlp.scale`'s seconds.
21. presolve presolve (`presolve/presolve.py`, default options) on the
            card of each LP cell's bases (block64k: `block_lp` at 512
            block-rows, seeds 2024 and 2025; synth50k: `synth_lp` at
            50,000 x 50,000 and ipm20k: at 2,400 x 20,000, seeds 42 to
            45): a digest of the status, stack, reduced LP and kept rows
            and columns equal to the tree's before the device copy
            (`PARENT_PRESOLVE`), one device copy of A a block64k base,
            each base's seconds (host clock), counters and peak card
            memory; then the segment-sum kernel's signed mode
            (`signed_dot`) on block64k's A with the bounds its presolve
            passed: equal to its plain version bit for bit and to scipy's
            max(A, 0) @ l + min(A, 0) @ u and max(A, 0) @ u + min(A, 0) @ l,
            its cold time beside the byte bound and the plain version's.
            The signed mode's launches are read from the block64k,
            synth50k and ipm_dense (ipm20k's shape) runs.

The PDLP phases (5-8, 11, 12, 18) run every ramped block as replays of
captured CUDA graphs (one restart window, or one chunk of steps, and the
metrics), each minor step as the two step kernels and the two products;
the launch counters are kept true across replays.  Phases 7, 8, 11 and
18 must take the iterations the parent tree took (`PARENT_ITERATIONS`),
and print the graph replays per block.

Kernel times (`ms`, `plain_ms`, `library_ms`) are device times with a
cold L2, as the PDLP loop finds its operator (`tools/card.py`
`time_ms`: a CUDA graph cycling through clones of the inputs that fill
four times the L2); a kernel timed below its byte or operation bound
fails the run.  `call_ms` is one call's time with the host's launch
gap.  Each path's launch counts are set to 0 just before its run and
read just after.  It prints the kernels' summary as one JSON line, the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card, or without the rest of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

TOLERANCE = {"float32": 1e-5, "float64": 1e-12}
KKT_TOL = 1e-7
SOLVE_TIME_LIMIT = 600.0
SOURCES = ["block_csr_spmv", "onehot_spmv", "gather_probe", "pdhg_step",
           "segment_sum"]
# presolve's result on each LP cell's bases, as the first 16 hex digits
# of `presolve_digest`, on the tree before the device copy (its rule
# families on the host; an H100's machine): the copy must not move a bit
PRESOLVE_BASES = {
    "block64k": ("block", dict(nblocks=512), (2024, 2025)),
    "synth50k": ("synth", dict(m=50000, n=50000), (42, 43, 44, 45)),
    "ipm20k": ("synth", dict(m=2400, n=20000), (42, 43, 44, 45)),
}
PARENT_PRESOLVE = {
    "block64k.2024": "06d2bc19e095f1b2", "block64k.2025": "06d2bc19e095f1b2",
    "synth50k.42": "fef0d2d73be17c6d", "synth50k.43": "43daf92203d81249",
    "synth50k.44": "072448b8460a9dca", "synth50k.45": "557bbd5b0750eada",
    "ipm20k.42": "fa15e2de5ba3d90e", "ipm20k.43": "5151f23541984761",
    "ipm20k.44": "4af89c3767959916", "ipm20k.45": "8396a9a22a343651",
}
# the PDLP iterations of the phases on the tree before the step kernels
# and graphs (its chip_smoke.py on an H100): the graphs replay the same
# arithmetic, so the counts must not move
PARENT_ITERATIONS = {"block64k": 56160, "synth50k": 48480,
                     "block64k_avg": 94560, "mesh_block64k": 56160,
                     # each batch instance's, on the tree before the
                     # batch's graphs (`tools/batch_turns.py` on an H100)
                     "batch": [12640, 22880, 15200, 33120, 15200, 15200,
                               20320, 20320, 15200, 10080, 12640, 33120,
                               22880, 20320, 17760, 7520]}
# upstream HiGHS's hipdlp on synth50k: optimal at 6704.2920770 in
# 47,080 iterations (bench.py:215-220, BENCH_DETAILS.json)
SYNTH50K_OBJECTIVE = 6704.2920770
# the IPM phases' LPs and scipy 1.17's HiGHS objectives for them
# (python3 -m highs_tpu_torch.tools.ipm_anchors)
IPM_DENSE_SHAPE = (2400, 20000)
IPM_DENSE_OBJECTIVE = 402.6279984586837
GRID_SIDE = 240
IPM_SPARSE_OBJECTIVE = -1567218.130564652
# the QP phase's full-width QP (gen_mm_style's arguments) and the
# active set's QP (seed, n, m)
QP_DENSE = dict(seed=7, n=10000, m=5000, hess_rank="full", cond=1e4,
                eq_frac=0.3, density=5e-4)
QP_ASM = (7, 300, 150)
GAP_TOL = 1e-6
FORMATS = ["dense", "ell", "panelell", "bucketell", "bucketperm", "bcoo",
           "onehot"]
FORMATS_ROWS = 4096
# (format, tolerance) of the formats phase
FORMATS_RUNS = [(fmt, 1e-5) for fmt in FORMATS] + [("bucketperm", 1e-6)]
KERNELS = {
    "block_csr_spmv": ("highs_tpu_torch/csrc/block_csr_spmv.cu",
                       "highs_tpu/ops/block_csr.py:111"),
    "onehot_spmv": ("highs_tpu_torch/csrc/onehot_spmv.cu",
                    "highs_tpu/ops/onehot_spmv.py:132, "
                    "highs_tpu/ops/onehot_spmv.py:146"),
    "gather_probe": ("highs_tpu_torch/csrc/gather_probe.cu",
                     "tools/gather_probe.py:79, tools/gather_probe2.py:33"),
    # no TPU kernel: the elementwise chain XLA fuses in the jitted step
    "pdhg_primal_step": ("highs_tpu_torch/csrc/pdhg_step.cu",
                         "highs_tpu/solvers/pdlp/pdhg.py:180 (XLA-fused "
                         "_halpern_step; :438 _avg_pdhg_step), no "
                         "pl.pallas_call"),
    "pdhg_dual_step": ("highs_tpu_torch/csrc/pdhg_step.cu",
                       "highs_tpu/solvers/pdlp/pdhg.py:180 (XLA-fused "
                       "_halpern_step; :438 _avg_pdhg_step), no "
                       "pl.pallas_call"),
    # no TPU kernel: the JAX package scales K on the host with numpy
    "segment_sum": ("highs_tpu_torch/csrc/segment_sum.cu",
                    "highs_tpu/solvers/pdlp/scaling.py:82 and :98 "
                    "(np.bincount on the host), no pl.pallas_call"),
    # no TPU kernel: the JAX package's presolve takes its activity bounds
    # with scipy on the host
    "segment_signed_dot": ("highs_tpu_torch/csrc/segment_sum.cu",
                           "highs_tpu/presolve/rules.py:325 and :819 "
                           "(scipy csr_matvec on the host), no "
                           "pl.pallas_call"),
}
# the cold-round problem of phases 7 and 8, for phase 19
FIRST_ROUND = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def sync(device) -> None:
    """Wait for the card (phases also run on the CPU, in rehearsals)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def relative_error(got, want, scale: float):
    err = (got.double() - want.double()).abs().max().item()
    return err, err / max(scale, 1e-300)


def block_bound_ms(bc):
    """The least time of one block-CSR product: each input read once
    (tiles, column indices, row pointer, x), y written once; 2
    operations per tile element."""
    from highs_tpu_torch.tools.card import bound_ms
    mb = bc.shape[0] // 128
    nb = bc.shape[1] // 128
    item = bc.blocks.element_size()
    nbytes = (bc.blocks.numel() * item + bc.block_col.numel() * 4 +
              (mb + 1) * 4 + nb * 128 * item + mb * 128 * item)
    return bound_ms(nbytes, 2.0 * bc.blocks.numel(), bc.blocks.dtype)


def library_bsr(bc, x):
    """One PyTorch call for the same product, as (fn, inputs): a BSR
    tensor of the untransposed tiles times x.  A yardstick; the port
    never calls it."""
    import torch
    with warnings.catch_warnings():  # BSR tensors are in beta
        warnings.simplefilter("ignore", UserWarning)
        bsr = torch.sparse_bsr_tensor(
            bc.row_ptr, bc.block_col,
            bc.blocks.transpose(1, 2).contiguous(), size=bc.shape)

    def run(bsr, x):
        return (bsr @ x.unsqueeze(1)).squeeze(1)
    return run, (bsr, x)


def timed_library(make, device, want):
    """(device ms, note) of a library yardstick `fn(*inputs)`, `make()`
    giving (fn, inputs), or (None, why) where PyTorch has no such
    product for these inputs on this card."""
    from highs_tpu_torch.tools.card import time_ms
    try:
        fn, inputs = make()
        diff = (fn(*inputs).double() - want.double()).abs().max().item()
        return (time_ms(fn, device, *inputs),
                f"max abs diff to plain {diff:.3e}")
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return None, (f"unavailable: {type(exc).__name__}: "
                      f"{str(exc).splitlines()[0][:160]}")


def blockcsr_phase(a, device):
    """Block-CSR kernel against plain on the block64k operator."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.tools.card import call_ms, time_ms

    op64 = block_csr.from_scipy_block_csr(a, dtype=torch.float64,
                                          device=device)
    rng = np.random.default_rng(7)
    variants = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for direction, bc64 in (("mv", op64.fwd), ("rmv", op64.bwd)):
            bc = bc64._replace(blocks=bc64.blocks.to(dtype))
            abs_bc = bc64._replace(blocks=bc64.blocks.abs())
            x = torch.as_tensor(rng.standard_normal(bc.shape[1]),
                                dtype=dtype, device=device)
            before = block_csr.LAUNCHES
            got = block_csr.block_csr_spmv(bc, x)
            sync(device)
            if device.type == "cuda" and block_csr.LAUNCHES != before + 1:
                raise RuntimeError("the block-CSR wrapper did not launch "
                                   "its kernel on a CUDA tensor")
            want = block_csr.spmv_plain(bc, x)
            scale = block_csr.spmv_plain(
                abs_bc, x.abs().double()).abs().max().item()
            err, rel = relative_error(got, want, scale)
            ok = bool(math.isfinite(err) and rel <= TOLERANCE[name])
            k_ms = time_ms(block_csr.block_csr_spmv, device, bc, x)
            k_call_ms = call_ms(lambda: block_csr.block_csr_spmv(bc, x),
                                device)
            p_ms = time_ms(block_csr.spmv_plain, device, bc, x)
            lib_ms, lib_note = timed_library(lambda: library_bsr(bc, x),
                                             device, want)
            b_ms, b_by = block_bound_ms(bc)
            rec = dict(dtype=name, direction=direction,
                       nnzb=int(bc.blocks.shape[0]), max_abs_err=err,
                       rel_err=rel, tolerance=TOLERANCE[name], ok=ok,
                       ms=k_ms, call_ms=k_call_ms, plain_ms=p_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            log(f"blockcsr {name} {direction}: nnzb {rec['nnzb']} "
                f"max_abs_err {err:.3e} rel {rel:.3e} "
                f"(tol {TOLERANCE[name]:g}) kernel_ms {k_ms:.4f} "
                f"(per call {k_call_ms:.4f}) "
                f"plain_ms {p_ms:.4f} bound_us {b_ms * 1e3:.2f} ({b_by}) "
                f"library_ms {lib_ms} [{lib_note}]")
            variants.append(rec)
            del bc, abs_bc
    del op64
    bad = [v for v in variants if not v["ok"]]
    if bad:
        raise RuntimeError(f"block-CSR kernel disagrees with its plain "
                           f"version: {bad}")
    return variants


def check_timings(records):
    """Fail on a kernel timed below its bound: such a time was taken
    with its data in the L2, not as the PDLP loop finds it."""
    below = [f"{name} {r['dtype']} {r.get('direction', r.get('name'))}: "
             f"{r['ms']:.5f} ms < {r['bound_ms']:.5f} ms"
             for name, recs in records.items() for r in recs
             if r["ms"] < r["bound_ms"]]
    if below:
        raise RuntimeError(f"kernels timed below their bound: {below}")


def padded_synth50k():
    """The unscaled synth50k matrix and vectors, and the matrix padded
    as the PDLP wrapper pads it (50,176 = 392 x 128)."""
    import numpy as np
    import scipy.sparse as sp
    from highs_tpu_torch.solvers.pdlp.wrapper import _bucket
    from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp
    a, b, c = gen_synth_lp()
    m, n = a.shape
    csr = a.tocsr()
    indptr = np.concatenate([csr.indptr, np.full(_bucket(m) - m,
                                                 csr.indptr[-1])])
    a_pad = sp.csr_matrix((csr.data, csr.indices, indptr),
                          shape=(_bucket(m), _bucket(n)))
    return a, b, c, a_pad


def onehot_bound_ms(tab):
    """The least time of one fused one-hot product: the table (row
    pointer, columns, values) and x read once, y written once; 2
    operations a term."""
    from highs_tpu_torch.tools.card import bound_ms
    item = tab.val.element_size()
    nbytes = (tab.row_ptr.numel() * 4 + tab.col.numel() * 4 +
              tab.val.numel() * item + (tab.shape[0] + tab.shape[1]) * item)
    return bound_ms(nbytes, 2.0 * tab.val.numel(), tab.val.dtype)


def onehot_phase(a_pad, device):
    """The fused one-hot kernel against plain on the synth50k operator."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import linops
    from highs_tpu_torch.ops import onehot_spmv as oh
    from highs_tpu_torch.tools.card import call_ms, time_ms

    op64 = oh.from_scipy_onehot(a_pad, torch.float64, device=device)
    p = op64.fwd.p_slots
    abs_op = oh.from_scipy_onehot(abs(a_pad), torch.float64, p_slots=p,
                                  device=device)
    # the JAX package's padded cells, for the JAX-shaped plain product
    cells = (oh.build_cells(a_pad, p, torch.float64, device),
             oh.build_cells(a_pad.T.tocsr(), p, torch.float64, device))
    log(f"onehot: synth50k padded to {a_pad.shape}, {a_pad.nnz} nonzeros, "
        f"P {p}, table entries {op64.fwd.col.numel()} (K) "
        f"{op64.bwd.col.numel()} (K'), of them spilled {op64.fwd.pad_cnt} "
        f"(K) {op64.bwd.pad_cnt} (K'); padded-cell slots per direction "
        f"{cells[0].gcol.numel()}")
    rng = np.random.default_rng(8)
    records = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        op = op64 if dtype == torch.float64 else oh.from_scipy_onehot(
            a_pad, dtype, p_slots=p, device=device)
        lib = linops.from_scipy_bcoo(a_pad, dtype=dtype, device=device)
        for direction, tab, abs_tab, oc, lib_a in (
                ("mv", op.fwd, abs_op.fwd, cells[0], lib.a),
                ("rmv", op.bwd, abs_op.bwd, cells[1], lib.at)):
            x = torch.as_tensor(rng.standard_normal(tab.shape[1]),
                                dtype=dtype, device=device)
            before = oh.LAUNCHES["onehot_spmv"]
            got = oh.onehot_spmv(tab, x)
            sync(device)
            if device.type == "cuda" and \
                    oh.LAUNCHES["onehot_spmv"] != before + 1:
                raise RuntimeError("the one-hot wrapper did not launch its "
                                   "kernel once on a CUDA tensor")
            same_bits = bool(torch.equal(got, oh.onehot_spmv(tab, x)))
            want = oh.onehot_spmv_plain(tab, x)
            scale = oh.onehot_spmv_plain(
                abs_tab, x.abs().double()).abs().max().item()
            err, rel = relative_error(got, want, scale)
            # the JAX-shaped composition over the padded cells, in f64
            cells_err, cells_rel = relative_error(
                got, oh.spmv_cells_plain(oc, x.double()), scale)
            lib_ms, lib_note = timed_library(
                lambda: (torch.mv, (lib_a, x)), device, want)
            b_ms, b_by = onehot_bound_ms(tab)
            tol = TOLERANCE[name]
            rec = dict(
                dtype=name, direction=direction, entries=tab.col.numel(),
                max_abs_err=err, rel_err=rel, tolerance=tol,
                cells_rel_err=cells_rel, same_bits=same_bits,
                ok=bool(math.isfinite(err) and rel <= tol and
                        cells_rel <= tol and same_bits),
                ms=time_ms(oh.onehot_spmv, device, tab, x),
                call_ms=call_ms(lambda: oh.onehot_spmv(tab, x), device),
                plain_ms=time_ms(oh.onehot_spmv_plain, device, tab, x),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            log(f"onehot {name} {direction}: entries {rec['entries']} "
                f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}; vs the "
                f"padded-cell composition {cells_rel:.3e}; same bits on a "
                f"rerun: {same_bits}) kernel_ms {rec['ms']:.4f} (per call "
                f"{rec['call_ms']:.4f}) plain_ms {rec['plain_ms']:.4f} "
                f"bound_us {b_ms * 1e3:.2f} ({b_by}) library_ms {lib_ms} "
                f"[torch.sparse_csr_tensor @ x, {lib_note}]")
            records.append(rec)
        del op, lib
    del op64, abs_op, cells
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"the one-hot kernel disagrees with its plain "
                           f"version: {bad}")
    return records


def probe_phase(device):
    """The gather probe: exact against torch.gather, with its rates."""
    from highs_tpu_torch.tools import gather_probe
    records = gather_probe.measure(device)
    for r in records:
        log(f"probe {r['name']} {r['dtype']}: equal {r['equal']} kernel_ms "
            f"{r['ms']:.4f} ({r['gelem_per_s']:.2f} Gelem/s; per call "
            f"{r['call_ms']:.4f}) "
            f"torch.gather_ms {r['plain_ms']:.4f} "
            f"({r['plain_gelem_per_s']:.2f} Gelem/s) bound_us "
            f"{r['bound_ms'] * 1e3:.2f} ({r['bound_by']})")
    if not all(r["equal"] for r in records):
        raise RuntimeError("the gather probe differs from torch.gather")
    return records


def small_phase(device):
    """A small block LP on the device and on the CPU: same objective."""
    import highs_tpu_torch
    from highs_tpu_torch.utils.gen_block_lp import block_lp

    objs = {}
    for dev in (device, "cpu"):
        h = highs_tpu_torch.Highs(device=dev)
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "hipdlp")
        h.setOptionValue("tpu_matrix_format", "blockcsr")
        h.passModel(block_lp(nblocks=2))
        h.run()
        status = h.getModelStatus()
        if status != highs_tpu_torch.HighsModelStatus.kOptimal:
            raise RuntimeError(f"small LP on {dev}: status {status!r}")
        objs[str(dev)] = h.getObjectiveValue()
    on_dev, on_cpu = objs[str(device)], objs["cpu"]
    rel = abs(on_dev - on_cpu) / max(1.0, abs(on_cpu))
    log(f"small: objective on {device} {on_dev!r}, on cpu {on_cpu!r}, "
        f"rel diff {rel:.3e}")
    if not rel <= 1e-6:
        raise RuntimeError("small LP: device and CPU objectives differ")


def formats_phase(device):
    """A small synth LP in every format on the card against the CPU."""
    import torch
    import highs_tpu_torch
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp

    lp = synth_lp(m=FORMATS_ROWS, n=FORMATS_ROWS)

    def solve(dev, fmt, tol):
        h = highs_tpu_torch.Highs(device=dev)
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "hipdlp")
        h.setOptionValue("tpu_matrix_format", fmt)
        h.setOptionValue("pdlp_optimality_tolerance", tol)
        h.passModel(lp)
        t0 = time.perf_counter()
        h.run()
        sync(torch.device(dev))
        seconds = time.perf_counter() - t0
        status = h.getModelStatus()
        iters = int(h.getInfo().pdlp_iteration_count)
        log(f"formats: {fmt} on {dev} at {tol:g}: {status.name} objective "
            f"{h.getObjectiveValue()!r} iterations {iters} seconds "
            f"{seconds:.3f}")
        if status != highs_tpu_torch.HighsModelStatus.kOptimal:
            raise RuntimeError(f"synth LP, {fmt} on {dev}: {status!r}")
        return h.getObjectiveValue(), iters, seconds

    refs = {tol: solve("cpu", "ell", tol)[0]
            for tol in sorted({tol for _, tol in FORMATS_RUNS})}
    runs = {}
    for fmt, tol in FORMATS_RUNS:
        obj, iters, seconds = solve(device, fmt, tol)
        ref = refs[tol]
        rel = abs(obj - ref) / max(1.0, abs(ref))
        runs[f"{fmt}@{tol:g}"] = dict(objective=obj, iterations=iters,
                                      seconds=seconds, rel_diff_to_cpu=rel)
        if not rel <= 1e-6:
            raise RuntimeError(f"synth LP, {fmt}: objective {obj!r} is "
                               f"{rel:.3e} from the CPU's {ref!r}")
    return runs


def kkt_check(a, b, c, upper, sol):
    """f64 KKT of min c'x s.t. Ax >= b, 0 <= x <= upper, from the
    returned solution alone: relative primal residual, dual residual
    and gap, each against (1 + norm)."""
    import numpy as np
    x = np.asarray(sol.col_value, dtype=np.float64)
    y = np.asarray(sol.row_dual, dtype=np.float64)
    row_viol = np.maximum(b - a @ x, 0.0)
    bound_viol = np.maximum(-x, 0.0) + np.maximum(x - upper, 0.0)
    rel_p = math.hypot(np.linalg.norm(row_viol),
                       np.linalg.norm(bound_viol)) / (1 + np.linalg.norm(b))
    # rows Ax >= b of a minimisation carry duals y >= 0; every column is
    # boxed, so any reduced cost z = c - A'y is absorbed by its bounds
    z = c - a.T @ y
    rel_d = np.linalg.norm(np.minimum(y, 0.0)) / (1 + np.linalg.norm(c))
    pobj = float(c @ x)
    dobj = float(b @ y) + float(upper @ np.minimum(z, 0.0))
    gap = abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj))
    return rel_p, rel_d, gap, pobj, dobj


def reset_launches():
    from highs_tpu_torch.ops import (block_csr, onehot_spmv, pdhg_step,
                                     segment_sum)
    from highs_tpu_torch.solvers.pdlp import graph
    from highs_tpu_torch.tools import gather_probe
    block_csr.LAUNCHES = 0
    segment_sum.LAUNCHES = 0
    segment_sum.SIGNED_LAUNCHES = 0
    gather_probe.LAUNCHES = 0
    onehot_spmv.LAUNCHES["onehot_spmv"] = 0
    for name in pdhg_step.LAUNCHES:
        pdhg_step.LAUNCHES[name] = 0
    graph.COUNTS.clear()


def read_launches():
    from highs_tpu_torch.ops import (block_csr, onehot_spmv, pdhg_step,
                                     segment_sum)
    from highs_tpu_torch.tools import gather_probe
    return {"block_csr_spmv": block_csr.LAUNCHES,
            "gather_probe": gather_probe.LAUNCHES,
            "onehot_spmv": onehot_spmv.LAUNCHES["onehot_spmv"],
            "segment_sum": segment_sum.LAUNCHES,
            "segment_signed_dot": segment_sum.SIGNED_LAUNCHES,
            **pdhg_step.LAUNCHES}


def read_graph_counts():
    from highs_tpu_torch.solvers.pdlp import graph
    return dict(graph.COUNTS)


class first_round_problem:
    """Keep the problem of the first `solve_pdhg` call of a run (the
    cold round) in FIRST_ROUND[name]."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from highs_tpu_torch.solvers.pdlp import wrapper
        self.inner = inner = wrapper.solve_pdhg
        name = self.name

        def keep(problem, *args, **kwargs):
            FIRST_ROUND.setdefault(name, problem)
            return inner(problem, *args, **kwargs)
        wrapper.solve_pdhg = keep
        return self

    def __exit__(self, *exc):
        from highs_tpu_torch.solvers.pdlp import wrapper
        wrapper.solve_pdhg = self.inner
        return False


def solve_phase(name, a, b, c, upper, options, anchor, path_kernels,
                device, keep_problem=False):
    """One LP through the facade: status, independent KKT, objective
    against upstream HiGHS, the path's kernels launched at least twice
    per PDLP iteration, every block as graph replays and the parent's
    iterations.  Returns (launches, iterations, seconds, the PDLP
    loop's numbers)."""
    import numpy as np
    import torch
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix

    m, n = a.shape
    lp = HighsLp(num_col=n, num_row=m, col_cost=c.copy(),
                 col_lower=np.zeros(n), col_upper=upper.copy(),
                 row_lower=b.copy(), row_upper=np.full(m, np.inf),
                 a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("time_limit", SOLVE_TIME_LIMIT)
    for key, val in options.items():
        h.setOptionValue(key, val)
    h.passModel(lp)
    reset_launches()
    t0 = time.perf_counter()
    if keep_problem:
        with first_round_problem(name):
            h.run()
    else:
        h.run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    graphs = read_graph_counts()
    status = h.getModelStatus()
    rd = h.getRunData()
    iters = int(h.getInfo().pdlp_iteration_count)
    timer = h.getTimer()
    pdhg_s = timer.read("pdlp_round")
    log(f"{name}: pdlp.scale {timer.read('pdlp.scale'):.3f} s of "
        f"pdlp.setup {timer.read('pdlp.setup'):.3f} s")
    log(f"{name}: status {status.name} objective {h.getObjectiveValue()!r} "
        f"iterations {iters} restarts {timer.num_calls('pdlp_restart')} "
        f"seconds {seconds:.3f} iterations_per_s {iters / seconds:.1f} "
        f"presolve_s {rd.presolve_time:.3f} solve_s {rd.solve_time:.3f} "
        f"postsolve_s {rd.postsolve_time:.3f} "
        f"presolved {rd.presolved_model_num_row}x"
        f"{rd.presolved_model_num_col} kernel_launches {launches}")
    blocks = graphs.get("metrics", 0)
    per_iter = {k: round(v / max(iters, 1), 3) for k, v in launches.items()}
    log(f"{name}: PDHG rounds {timer.num_calls('pdlp_round')} in "
        f"{pdhg_s:.3f} s; wall per "
        f"step {1e3 * pdhg_s / max(iters, 1):.4f} ms; launches per "
        f"iteration {per_iter}; "
        f"graphs captured {graphs.get('captures', 0)}, blocks {blocks}, "
        f"replays per block {graphs.get('replays', 0) / max(blocks, 1):.2f}")
    if status != highs_tpu_torch.HighsModelStatus.kOptimal:
        raise RuntimeError(f"{name}: status {status!r}, not kOptimal")
    if device.type == "cuda" and not blocks:
        raise RuntimeError(f"{name}: no PDHG block ran as graph replays")
    want_iters = PARENT_ITERATIONS.get(name)
    if want_iters is not None and iters != want_iters:
        raise RuntimeError(f"{name}: {iters} iterations, the parent tree "
                           f"took {want_iters}")
    rel_p, rel_d, gap, pobj, dobj = kkt_check(a, b, c, upper,
                                              h.getSolution())
    log(f"{name}: independent f64 KKT rel_primal {rel_p:.3e} "
        f"rel_dual {rel_d:.3e} rel_gap {gap:.3e} (limit {KKT_TOL:g}); "
        f"primal obj {pobj!r} dual obj {dobj!r}")
    if not max(rel_p, rel_d, gap) <= KKT_TOL:
        raise RuntimeError(f"{name}: the solution fails the KKT check")
    rel_obj = abs(pobj - anchor) / abs(anchor)
    log(f"{name}: upstream HiGHS objective {anchor!r}, rel diff "
        f"{rel_obj:.3e}")
    if not rel_obj <= 1e-6:
        raise RuntimeError(f"{name}: objective differs from upstream HiGHS")
    for kernel in path_kernels:
        # two products an iteration; one launch of each step kernel
        need = 1 if kernel.startswith("pdhg_") else 2
        if device.type == "cuda" and launches[kernel] < need * iters:
            raise RuntimeError(f"{name}: {launches[kernel]} launches of "
                               f"{kernel} for {iters} iterations (need "
                               f">= {need} per iteration)")
    return launches, iters, seconds, dict(
        wall_ms_per_step=1e3 * pdhg_s / max(iters, 1), blocks=blocks,
        replays_per_block=graphs.get("replays", 0) / max(blocks, 1),
        captures=graphs.get("captures", 0),
        launches_per_iteration={k: v / max(iters, 1)
                                for k, v in launches.items()})


def standard_form_k(a, b):
    """K of min c'x s.t. Ax >= b, 0 <= x <= 10 as `pdlp_problem` scales
    it (`preprocess_lp`)."""
    import numpy as np
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    from highs_tpu_torch.solvers.pdlp.preprocess import preprocess_lp
    m, n = a.shape
    lp = HighsLp(num_col=n, num_row=m, col_cost=np.ones(n),
                 col_lower=np.zeros(n), col_upper=np.full(n, 10.0),
                 row_lower=b.copy(), row_upper=np.full(m, np.inf),
                 a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
    return preprocess_lp(lp).a


def same_bits(got, want) -> bool:
    import numpy as np
    return (got.dtype == want.dtype == np.float64 and
            got.shape == want.shape and
            bool(np.array_equal(got.view(np.int64), want.view(np.int64))))


def segment_sum_records(k, device):
    """The segment-sum kernel on a scaled K: rows and columns, |a| and
    a * a, against its plain version bit for bit, with its cold time, the
    byte bound, the plain version's per-call time and one
    `torch.segment_reduce` call's (rows only; a yardstick)."""
    import torch
    from highs_tpu_torch.ops import segment_sum as seg
    from highs_tpu_torch.tools.card import bound_ms, call_ms, time_ms
    m, n = k.shape
    values = torch.from_numpy(k.data).to(device)
    row_ptr = torch.from_numpy(k.indptr).to(device, torch.int64)
    cols = torch.from_numpy(k.indices).to(device, torch.int64)
    order = torch.sort(cols, stable=True)[1]
    col_ptr = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=device),
        torch.cumsum(torch.bincount(cols, minlength=n), 0)])
    del cols
    records = []
    for direction, ptr, o in (("rows", row_ptr, None),
                              ("columns", col_ptr, order)):
        nseg = ptr.shape[0] - 1
        nbytes = (8 * k.nnz + 8 * (nseg + 1) + 8 * nseg +
                  (8 * k.nnz if o is not None else 0))
        b_ms, b_by = bound_ms(nbytes, 2 * k.nnz, torch.float64)
        for square in (False, True):
            before = seg.LAUNCHES
            got = seg.segment_sum(values, ptr, o, square=square)
            sync(device)
            if device.type == "cuda" and seg.LAUNCHES != before + 1:
                raise RuntimeError("the segment-sum wrapper did not "
                                   "launch its kernel on a CUDA tensor")
            want = seg.segment_sum_plain(values, ptr, o, square)
            ok = bool(torch.equal(got, want))
            k_ms = time_ms(seg.segment_sum, device, values, ptr, o, square)
            p_ms = call_ms(lambda: seg.segment_sum_plain(values, ptr, o,
                                                         square),
                           device, runs=3, warmup=1)
            lib_ms = None
            if o is None:
                terms = values * values if square else values.abs()
                lib_ms = call_ms(lambda: torch.segment_reduce(
                    terms, "sum", offsets=ptr), device)
                del terms
            rec = dict(name="segment_sum", dtype="float64",
                       direction=f"{direction} {'a*a' if square else '|a|'}",
                       segments=nseg, nnz=int(k.nnz), ok=ok, ms=k_ms,
                       plain_call_ms=p_ms, library_call_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            log(f"segment_sum {rec['direction']}: {nseg} segments, "
                f"same bits {ok}, kernel_ms {k_ms:.4f} bound_ms "
                f"{b_ms:.4f} ({b_by}) plain per call {p_ms:.3f} ms, "
                f"torch.segment_reduce per call {lib_ms}")
            records.append(rec)
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"segment-sum kernel disagrees with its plain "
                           f"version: {bad}")
    return records


def scaling_phase(device, cells):
    """Phase 20: the PDLP scaling on the card and in its CPU form on each
    cell's standard-form K (`cells`: name -> (A, b)), default options,
    bit for bit, with each one's seconds; then the segment-sum kernel on
    block64k's scaled K."""
    import torch
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.solvers.pdlp.scaling import scale_problem
    opts = HighsOptions()
    mode, passes = opts.pdlp_scaling_mode, opts.pdlp_ruiz_iterations
    out = {}
    scaled = {}
    for name, (a, b) in cells.items():
        k = standard_form_k(a, b)
        t0 = time.perf_counter()
        host, hv = scale_problem(k, mode, passes, "cpu")
        cpu_s = time.perf_counter() - t0
        card_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            card, cv = scale_problem(k, mode, passes, device)
            sync(device)
            card_s.append(time.perf_counter() - t0)
        same = {"values": same_bits(card.data, host.data),
                "row_scale": same_bits(cv.row_scale, hv.row_scale),
                "col_scale": same_bits(cv.col_scale, hv.col_scale),
                "ruiz_passes": cv.ruiz_passes == hv.ruiz_passes,
                "structure": bool(
                    (card.indices == host.indices).all() and
                    (card.indptr == host.indptr).all())}
        out[name] = dict(nnz=int(k.nnz), shape=list(k.shape),
                         ruiz_passes=hv.ruiz_passes, cpu_s=cpu_s,
                         card_s=card_s, same=same)
        log(f"scaling {name}: {k.shape[0]}x{k.shape[1]}, {k.nnz} "
            f"nonzeros, Ruiz passes {hv.ruiz_passes}; CPU form "
            f"{cpu_s:.3f} s, card {', '.join(f'{t:.3f}' for t in card_s)}"
            f" s; same bits {same}")
        if not all(same.values()):
            raise RuntimeError(f"scaling {name}: the card differs from "
                               f"the CPU form: {same}")
        scaled[name] = host
        del k, card
    out["segment_sum"] = segment_sum_records(scaled["block64k"], device)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    return out


def presolve_digest(result) -> str:
    """SHA-256 over every bit of a `PresolveResult` that postsolve and
    the solver read: the status, the stack, the reduced LP's arrays and
    matrix, the kept rows and columns."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, (np.ndarray, np.generic)):
            x = np.asarray(x)
            h.update(f"{x.dtype.str}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, (tuple, list)):
            h.update(f"{type(x).__name__}{len(x)}".encode())
            for y in x:
                feed(y)
        elif isinstance(x, float):
            h.update(b"f" + np.float64(x).tobytes())
        else:
            h.update(f"{type(x).__name__}:{x!r}".encode())

    feed(int(result.status))
    feed(bool(result.reduced))
    feed(list(result.stack))
    if result.reduced:
        lp = result.reduced_lp
        for name in ("num_col", "num_row", "col_cost", "col_lower",
                     "col_upper", "row_lower", "row_upper", "offset",
                     "integrality"):
            feed(getattr(lp, name))
        feed([lp.a_matrix.start, lp.a_matrix.index, lp.a_matrix.value])
        feed([result.keep_rows, result.keep_cols])
    return h.hexdigest()


def signed_dot_records(calls, device):
    """The segment-sum kernel's signed mode on the CSR and bounds of
    `calls` (each (values, cols, ptr, x1, x2) as presolve passed them):
    against its plain version bit for bit, the first call also against
    scipy's `csr_matvec` of max(A, 0) and min(A, 0), with its cold time,
    the byte bound and the plain version's per-call time."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from highs_tpu_torch.ops import segment_sum as seg
    from highs_tpu_torch.tools.card import bound_ms, call_ms, time_ms
    records = []
    for k, (values, cols, ptr, x1, x2) in enumerate(calls):
        nnz, nseg, n = values.shape[0], ptr.shape[0] - 1, x1.shape[0]
        # 12 B a value (value and column), ptr, x1 and x2 once, four sums
        # a row; two products and two sums a value
        nbytes = 12 * nnz + 8 * (nseg + 1) + 16 * n + 32 * nseg
        b_ms, b_by = bound_ms(nbytes, 4 * nnz, torch.float64)
        before = seg.SIGNED_LAUNCHES
        got = seg.signed_dot(values, cols, ptr, x1, x2)
        sync(device)
        if device.type == "cuda" and seg.SIGNED_LAUNCHES != before + 1:
            raise RuntimeError("the signed mode's wrapper did not launch "
                               "its kernel on a CUDA tensor")
        want = seg.signed_dot_plain(values, cols, ptr, x1, x2)
        ok = bool(torch.equal(got.view(torch.int64), want.view(torch.int64)))
        scipy_ok = None
        if k == 0:
            a = sp.csr_matrix((values.cpu().numpy(), cols.cpu().numpy(),
                               ptr.cpu().numpy()), shape=(nseg, n))
            lo, up = x1.cpu().numpy(), x2.cpu().numpy()
            pos, neg = a.copy(), a.copy()
            pos.data = np.maximum(pos.data, 0.0)
            neg.data = np.minimum(neg.data, 0.0)
            out = got.cpu()
            scipy_ok = (same_bits((out[0] + out[1]).numpy(),
                                  pos @ lo + neg @ up) and
                        same_bits((out[2] + out[3]).numpy(),
                                  pos @ up + neg @ lo))
            del a, pos, neg
        k_ms = time_ms(seg.signed_dot, device, values, cols, ptr, x1, x2)
        p_ms = call_ms(lambda: seg.signed_dot_plain(values, cols, ptr, x1,
                                                    x2),
                       device, runs=3, warmup=1)
        rec = dict(name="segment_signed_dot", dtype="float64",
                   direction=f"rows, call {k}", segments=nseg, nnz=nnz,
                   ok=ok, scipy_ok=scipy_ok, ms=k_ms, plain_call_ms=p_ms,
                   library_call_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"segment_signed_dot call {k}: {nseg} rows, {nnz} values, same "
            f"bits as plain {ok}, as scipy {scipy_ok}, kernel_ms "
            f"{k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) plain per call "
            f"{p_ms:.3f} ms")
        records.append(rec)
        del got, want
    bad = [r for r in records if not r["ok"] or r["scipy_ok"] is False]
    if not records or bad:
        raise RuntimeError(f"the signed mode disagrees with its plain "
                           f"version or scipy, or presolve never called "
                           f"it: {bad}")
    return records


def presolve_phase(device):
    """Phase 21: presolve of each LP cell's bases on the card, with the
    digests of the tree before the device copy; then the signed mode on
    block64k's A with the bounds its presolve passed."""
    import torch
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.presolve import device as presolve_device
    from highs_tpu_torch.presolve.presolve import presolve_lp
    from highs_tpu_torch.utils.gen_block_lp import block_lp
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp
    from highs_tpu_torch.utils.timer import HighsTimer

    calls = []
    kernel = presolve_device.signed_dot

    def keep(values, cols, ptr, x1, x2):
        calls.append((values, cols, ptr, x1.clone(), x2.clone()))
        return kernel(values, cols, ptr, x1, x2)

    out = {}
    for cell, (kind, size, seeds) in PRESOLVE_BASES.items():
        for seed in seeds:
            name = f"{cell}.{seed}"
            made = (block_lp if kind == "block" else synth_lp)(
                **size, seed=seed)
            a = made.a_matrix.to_scipy().tocsc()
            m, n = a.shape
            lp = HighsLp(num_col=n, num_row=m, col_cost=made.col_cost,
                         col_lower=made.col_lower, col_upper=made.col_upper,
                         row_lower=made.row_lower, row_upper=made.row_upper,
                         a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
            del made, a
            opts = HighsOptions()
            opts._timer = timer = HighsTimer()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            presolve_device.signed_dot = keep if name == "block64k.2024" \
                else kernel
            try:
                t0 = time.perf_counter()
                result = presolve_lp(lp, opts, device)
                sync(device)
                seconds = time.perf_counter() - t0
            finally:
                presolve_device.signed_dot = kernel
            digest = presolve_digest(result)[:16]
            rec = dict(digest=digest, same=digest == PARENT_PRESOLVE[name],
                       seconds=seconds, stack=len(result.stack),
                       reduced=bool(result.reduced),
                       counters={k: timer.counter(k) for k in (
                           "presolve.device_builds",
                           "presolve.device_sweeps")},
                       upload_s=timer.read("presolve.upload"),
                       peak_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0))
            log(f"presolve {name}: {m}x{n}, {seconds:.3f} s (upload "
                f"{rec['upload_s']:.3f} s), stack {rec['stack']}, reduced "
                f"{rec['reduced']}, counters {rec['counters']}, peak "
                f"{rec['peak_bytes']} B, digest {digest} (parent "
                f"{PARENT_PRESOLVE[name]})")
            out[name] = rec
            del lp, result
    bad = [name for name, r in out.items() if not r["same"]]
    if bad:
        raise RuntimeError(f"presolve differs from the parent tree's on "
                           f"{bad}")
    builds = [r["counters"]["presolve.device_builds"] for name, r in
              out.items() if name.startswith("block64k")]
    if builds != [1] * len(builds):
        raise RuntimeError(f"block64k's presolve built {builds} copies of "
                           f"A, not one")
    out["signed_dot"] = signed_dot_records(calls, device)
    return out


def feasibility_check(lp, sol):
    """Relative f64 violation of L <= Ax <= U and l <= x <= u by the
    returned x, from the LP's data alone, against 1 + the norm of the
    finite row bounds."""
    import numpy as np
    x = np.asarray(sol.col_value, dtype=np.float64)
    ax = lp.a_matrix.to_scipy() @ x

    def excess(v, lo, up):
        return (np.where(np.isfinite(lo), np.maximum(lo - v, 0.0), 0.0) +
                np.where(np.isfinite(up), np.maximum(v - up, 0.0), 0.0))
    rows = excess(ax, lp.row_lower, lp.row_upper)
    cols = excess(x, lp.col_lower, lp.col_upper)
    bounds = np.concatenate([lp.row_lower, lp.row_upper])
    scale = 1.0 + np.linalg.norm(bounds[np.isfinite(bounds)])
    return math.hypot(np.linalg.norm(rows), np.linalg.norm(cols)) / scale


def ipm_phase(name, lp, anchor, check, device):
    """One LP through `Highs().run()` with the default options, which
    send it to the IPM: kOptimal in IPM iterations only, `check(sol)` <=
    KKT_TOL, the objective within 1e-6 of `anchor`, the Newton phases per
    iteration from the facade's clocks, and the factors by device."""
    import highs_tpu_torch
    from highs_tpu_torch.solvers.ipm import banded_chol, solver
    from highs_tpu_torch.tools.card import FP64_TENSOR_FLOPS

    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("time_limit", SOLVE_TIME_LIMIT)
    h.passModel(lp)
    dense0 = dict(solver.DENSE_FACTORS)
    sparse0 = dict(solver.SPARSE_FACTORS)
    start0 = dict(solver.START_FACTORS)
    graphs0 = banded_chol.GRAPHS.copy()
    handoffs0 = solver.BANDED_HANDOFFS["gate"]
    reset_launches()
    t0 = time.perf_counter()
    h.run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    dense = {k: solver.DENSE_FACTORS[k] - dense0[k] for k in dense0}
    sparse = {k: solver.SPARSE_FACTORS[k] - sparse0[k] for k in sparse0}
    start = {k: solver.START_FACTORS[k] - start0[k] for k in start0}
    graphs = dict(banded_chol.GRAPHS - graphs0)
    handoffs = solver.BANDED_HANDOFFS["gate"] - handoffs0
    status = h.getModelStatus()
    info = h.getInfo()
    iters = int(info.ipm_iteration_count)
    rd = h.getRunData()
    clocks = {k: h.getTimer().read(f"ipm_{k}") for k in
              ("setup", "iterations", "normal", "factor", "solve")}
    per_it = {k: 1e3 * clocks[k] / max(iters, 1)
              for k in ("iterations", "normal", "factor", "solve")}
    per_it["rest"] = per_it["iterations"] - per_it["normal"] - \
        per_it["factor"] - per_it["solve"]
    m, n = rd.presolved_model_num_row, rd.presolved_model_num_col
    rec = dict(status=status.name, objective=h.getObjectiveValue(),
               ipm_iterations=iters,
               pdlp_iterations=int(info.pdlp_iteration_count),
               seconds=seconds, presolve_s=rd.presolve_time,
               solve_s=rd.solve_time, ipm_setup_s=clocks["setup"],
               ipm_iterations_s=clocks["iterations"],
               ms_per_iteration=per_it, presolved=[m, n],
               dense_factors=dense, sparse_factors=sparse,
               start_factors=start, banded_graphs=graphs,
               banded_handoffs=handoffs,
               launches=launches)
    log(f"{name}: status {status.name} objective {rec['objective']!r} "
        f"ipm_iterations {iters} pdlp_iterations "
        f"{rec['pdlp_iterations']} seconds {seconds:.3f} presolve_s "
        f"{rd.presolve_time:.3f} solve_s {rd.solve_time:.3f} "
        f"(ipm setup {clocks['setup']:.3f}, iterations "
        f"{clocks['iterations']:.3f}) presolved {m}x{n} kernel_launches "
        f"{launches}")
    log(f"{name}: ms per iteration: normal matrix {per_it['normal']:.3f} "
        f"factor {per_it['factor']:.3f} solves {per_it['solve']:.3f} rest "
        f"(host work and the elementwise chain) {per_it['rest']:.3f} of "
        f"{per_it['iterations']:.3f}; dense factors {dense} (by device); "
        f"factors of M assembled on the host {sparse} (by engine and "
        f"device), banded precision-gate hand-offs {handoffs}; starting "
        f"point factors {start}; banded graphs {graphs}")
    if dense["cuda"]:
        # the normal phase (the weighted copy of K, the full f64 GEMM
        # K Theta K' of 2 m^2 n operations, the diagonal add) read as a
        # full-GEMM rate, and as the share of the FP64 tensor peak that
        # the symmetric result's m^2 n useful operations make
        flops = 2.0 * m * m * n
        rate = flops / (per_it["normal"] * 1e-3)
        useful = 0.5 * rate / FP64_TENSOR_FLOPS
        rec.update(normal_full_gemm_tflops=rate / 1e12,
                   normal_useful_fp64_share=useful)
        log(f"{name}: normal phase (weighted copy, K Theta K', diagonal) "
            f"at a full-GEMM rate of {rate / 1e12:.2f} TFLOP/s f64 "
            f"({flops / 1e9:.1f} GFLOP per iteration); its m^2 n useful "
            f"operations make {100 * useful:.1f}% of the FP64 tensor "
            f"peak ({FP64_TENSOR_FLOPS / 1e12:.0f} TFLOP/s)")
    if status != highs_tpu_torch.HighsModelStatus.kOptimal:
        raise RuntimeError(f"{name}: status {status!r}, not kOptimal")
    if iters <= 0 or rec["pdlp_iterations"] != -1:
        raise RuntimeError(f"{name}: not solved by the IPM alone "
                           f"({iters} IPM, {rec['pdlp_iterations']} PDLP "
                           "iterations)")
    rec["check"] = check(h.getSolution())
    log(f"{name}: independent f64 check {rec['check']:.3e} (limit "
        f"{KKT_TOL:g})")
    if not rec["check"] <= KKT_TOL:
        raise RuntimeError(f"{name}: the solution fails the check")
    rec["rel_obj"] = abs(rec["objective"] - anchor) / abs(anchor)
    log(f"{name}: scipy HiGHS objective {anchor!r}, rel diff "
        f"{rec['rel_obj']:.3e}")
    if not rec["rel_obj"] <= 1e-6:
        raise RuntimeError(f"{name}: objective differs from scipy's HiGHS")
    return rec


def ipm_dense_phase(device):
    import numpy as np
    from highs_tpu_torch.utils.gen_synth_lp import UPPER, gen_synth_lp, \
        synth_lp
    m, n = IPM_DENSE_SHAPE
    a, b, c = gen_synth_lp(m, n)
    rec = ipm_phase(
        "ipm_dense", synth_lp(m, n), IPM_DENSE_OBJECTIVE,
        lambda sol: max(kkt_check(a, b, c, np.full(n, UPPER), sol)[:3]),
        device)
    if device.type == "cuda" and (
            rec["dense_factors"]["cuda"] < rec["ipm_iterations"] or
            rec["dense_factors"]["cpu"]):
        raise RuntimeError(f"ipm_dense: dense factors {rec['dense_factors']}"
                           f" for {rec['ipm_iterations']} iterations: the "
                           "dense route did not run on the card alone")
    return rec


def ipm_sparse_phase(device):
    """ipm_phase on the grid flow, and the banded f64 factor on the card
    in every factor of the solve: the starting point's and each
    iteration's, no hand-off to the host, one capture of the factor's
    and the solve's graphs and a replay for each factor and solve."""
    from highs_tpu_torch.utils.gen_grid_flow_lp import grid_flow_lp
    lp = grid_flow_lp(GRID_SIDE)
    rec = ipm_phase("ipm_sparse", lp, IPM_SPARSE_OBJECTIVE,
                    lambda sol: feasibility_check(lp, sol), device)
    iters, sparse = rec["ipm_iterations"], rec["sparse_factors"]
    graphs = rec["banded_graphs"]
    served = {**dict.fromkeys(sparse, 0), "banded_" + device.type: iters}
    if sparse != served or rec["banded_handoffs"] or \
            rec["start_factors"]["banded_" + device.type] != 1:
        raise RuntimeError(
            f"ipm_sparse: the banded factor did not serve every factor: "
            f"{sparse}, start {rec['start_factors']}, hand-offs "
            f"{rec['banded_handoffs']}")
    if device.type == "cuda" and (
            graphs.get("captures") != 2 or
            graphs.get("factor_replays") != iters + 1 or
            graphs.get("solve_replays", 0) < 6 * iters):
        raise RuntimeError(f"ipm_sparse: graph counts {graphs} for "
                           f"{iters} iterations")
    return rec


def valid_basis(h, lp) -> bool:
    """The facade's basis: valid, one status per column and row, and as
    many basic variables as rows."""
    from highs_tpu_torch.constants import HighsBasisStatus
    basis = h.getBasis()
    basic = sum(int(s) == int(HighsBasisStatus.kBasic)
                for s in list(basis.col_status) + list(basis.row_status))
    return bool(basis.valid and len(basis.col_status) == lp.num_col and
                len(basis.row_status) == lp.num_row and basic == lp.num_row)


def batch_window_check(start, device, n_windows=2):
    """The batch's runner (`batch.batch_runner`: replayed graphs on a
    card) against its windows op by op (`EagerBlocks` with the vmapped
    window and metrics), from `start`: two blocks of n_windows windows
    with every third instance frozen between them, as `solve_lp_batch`
    freezes a finished one; state, restart control and metrics equal
    bit for bit after each block, and each vmapped step one launch of
    each step kernel."""
    import torch
    from highs_tpu_torch.solvers.pdlp import batch, graph
    from highs_tpu_torch.tools.step_bench import same_bits

    problem = start.problem
    b = problem.c.shape[0]
    frozen = torch.zeros(b, dtype=torch.bool, device=device)
    frozen[1::3] = True
    theta = torch.zeros((), dtype=problem.c.dtype, device=device)

    def two_blocks(runner):
        state, ctl, out = start.state, start.ctl, []
        for block in range(2):
            state, ctl, metrics = runner.windows(state, ctl, n_windows, 1.0,
                                                 40, theta, None)
            out += [t.clone() for part in (state, ctl, metrics)
                    for t in part]
            state = batch.freeze_instances(state, frozen)
        return out
    reset_launches()
    runner = batch.batch_runner(problem, 40)
    got = two_blocks(runner)
    runner.close()
    sync(device)
    launches = read_launches()
    graphs = read_graph_counts()
    want = two_blocks(graph.EagerBlocks(problem, batch.batched_window,
                                        batch.batched_metrics))
    sync(device)
    out = dict(windows=2 * n_windows, frozen=int(frozen.sum()),
               graph_equals_eager=same_bits(got, want),
               launches={k: launches[k] for k in ("pdhg_primal_step",
                                                  "pdhg_dual_step")},
               graphs=graphs)
    log(f"batch: {2 * n_windows} captured vmapped windows of {b} instances "
        f"({out['frozen']} frozen after the first block) equal to the "
        f"windows op by op: {out['graph_equals_eager']}; launches "
        f"{out['launches']} for {2 * n_windows * 40} steps; graphs {graphs}")
    steps = 2 * n_windows * 40
    if not out["graph_equals_eager"]:
        raise RuntimeError(f"captured batch window differs: {out}")
    if device.type == "cuda" and (
            set(out["launches"].values()) != {steps} or
            graphs.get("captures") != 2):
        raise RuntimeError(f"the captured batch window is not one batched "
                           f"launch a step in two graphs: {out}")
    return out


def batch_phase(device):
    """16 synth LPs through one vmapped batch on the card: the batched
    step kernels against the vmapped plain chains, a captured batch
    window against the eager one, the busy share of its blocks, then
    `solve_lp_batch`."""
    import numpy as np
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.solvers.pdlp.batch import (prepare_batch,
                                                    solve_lp_batch)
    from highs_tpu_torch.solvers.pdlp.wrapper import _bucket
    from highs_tpu_torch.tools import lp_anchors, profile_block64k, \
        step_bench
    from highs_tpu_torch.tools.card import HBM_BYTES_PER_S, card_line
    from highs_tpu_torch.utils.gen_synth_lp import UPPER, gen_synth_lp, \
        synth_lp

    anchors = lp_anchors.load()["batch"]
    seeds = list(lp_anchors.BATCH_SEEDS)
    rows = [lp_anchors.batch_rows(s) for s in seeds]
    lps = [synth_lp(m, m, seed=s) for m, s in zip(rows, seeds)]
    m_pad = n_pad = _bucket(max(rows))
    k_bytes = len(lps) * m_pad * n_pad * 8
    floor_ms = 2 * k_bytes / HBM_BYTES_PER_S * 1e3
    log(f"batch: {len(lps)} synth LPs of {rows[0]}..{rows[-1]} rows, padded "
        f"to {m_pad} x {n_pad}; stacked dense K {k_bytes / 1e6:.1f} MB (f64), "
        f"read twice a step: byte floor {floor_ms:.4f} ms a step")

    step_records = step_bench.batched_step_records(device)
    log("batch: the batched launches run the kernels whose SASS phase 19 "
        "reads (the same template instances, b = 1 or more)")
    start = prepare_batch(lps, HighsOptions(), device)
    window = batch_window_check(start, device)
    busy = profile_block64k.profile_batch_blocks(start, device)
    del start
    if busy["by_kernel"] is None:
        raise RuntimeError("the profiler recorded no kernel of the batch's "
                           "graphs")
    log(f"batch: blocks with the graphs on: wall "
        f"{busy['wall_ms_per_step']:.5f} ms a step (op by op "
        f"{busy['eager_wall_ms_per_step']:.4f}), device "
        f"{busy['device_ms_per_step']} ms a step {busy['by_kernel']}, busy "
        f"share {busy['device_busy_share']}, kernels a step "
        f"{busy['kernels_per_step']}, launches a step "
        f"{busy['launches_per_step']}")

    blocks = []
    t0 = time.perf_counter()

    def on_block(msg):
        sync(device)
        blocks.append((time.perf_counter() - t0, int(msg.split()[2][:-1])))
    reset_launches()
    results = solve_lp_batch(lps, HighsOptions(), log=on_block,
                             device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    graphs = read_graph_counts()
    loop_s = blocks[-1][0] - blocks[0][0]
    loop_steps = blocks[-1][1] - blocks[0][1]
    steps = blocks[-1][1]
    per_step = {k: v / steps for k, v in launches.items() if v}
    ms_per_step = 1e3 * loop_s / max(loop_steps, 1)
    log(f"batch: {len(blocks)} blocks, {steps} steps, {seconds:.3f} "
        f"s (setup to the first block's end {blocks[0][0]:.3f} s); after "
        f"the first block {1e3 * loop_s / max(len(blocks) - 1, 1):.3f} ms a "
        f"block, {ms_per_step:.4f} ms a step against the byte floor of "
        f"{floor_ms:.4f}; busy share {busy['device_busy_share']}; launches "
        f"a step {per_step}; graphs {graphs}; card {card_line()}")
    if device.type == "cuda" and (
            launches["pdhg_primal_step"] != steps or
            launches["pdhg_dual_step"] != steps or
            graphs.get("metrics") != len(blocks)):
        raise RuntimeError(f"batch: {launches} launches and graphs {graphs} "
                           f"for {steps} steps in {len(blocks)} blocks (one "
                           f"batched launch of each step kernel a step, "
                           f"every block replayed)")
    recs = []
    for i, ((st, sol, info), m, s) in enumerate(zip(results, rows, seeds)):
        a, b, c = gen_synth_lp(m, m, seed=s)
        rel_p, rel_d, gap, pobj, _ = kkt_check(a, b, c, np.full(m, UPPER),
                                               sol)
        done_block = next(j for j, (_, tot) in enumerate(blocks)
                          if tot >= info.iterations)
        rel_obj = abs(pobj - anchors[i]) / abs(anchors[i])
        rec = dict(seed=s, rows=m, status=st.name,
                   iterations=info.iterations, blocks=done_block + 1,
                   seconds=blocks[done_block][0], objective=pobj,
                   kkt=max(rel_p, rel_d, gap), rel_obj=rel_obj)
        log(f"batch {i}: {m} x {m} {st.name} iterations {info.iterations} "
            f"blocks {rec['blocks']} seconds {rec['seconds']:.3f} objective "
            f"{pobj!r} (scipy {anchors[i]!r}, rel {rel_obj:.3e}) KKT "
            f"{rec['kkt']:.3e}")
        recs.append(rec)
        if st != st.kOptimal or not rec["kkt"] <= KKT_TOL or \
                not rel_obj <= 1e-6:
            raise RuntimeError(f"batch instance {i}: {rec}")
    iters = [r["iterations"] for r in recs]
    if iters != PARENT_ITERATIONS["batch"]:
        raise RuntimeError(f"batch: iterations {iters}, the parent tree "
                           f"took {PARENT_ITERATIONS['batch']}")
    return dict(instances=recs, seconds=seconds, blocks=len(blocks),
                steps=steps, padded=[m_pad, n_pad],
                byte_floor_ms_per_step=floor_ms, ms_per_step=ms_per_step,
                launches=launches, launches_per_step=per_step,
                graphs=graphs, window=window, busy=busy,
                step_records=step_records)


def simplex_phase(device):
    """`choose` on a small LP (native simplex on the host) and the IPM
    with crossover on ipm_dense's LP."""
    import numpy as np
    import highs_tpu_torch
    from highs_tpu_torch.tools import lp_anchors
    from highs_tpu_torch.utils.gen_synth_lp import UPPER, gen_synth_lp, \
        synth_lp

    out = {}
    m, n = lp_anchors.SIMPLEX_SHAPE
    for name, lp, opts, anchor, (a, b, c) in (
            ("simplex_choose", synth_lp(m, n), {},
             lp_anchors.load()["simplex"], gen_synth_lp(m, n)),
            ("ipm_crossover", synth_lp(*IPM_DENSE_SHAPE), {"solver": "ipm"},
             IPM_DENSE_OBJECTIVE, gen_synth_lp(*IPM_DENSE_SHAPE))):
        h = highs_tpu_torch.Highs(device=device)
        h.setOptionValue("time_limit", SOLVE_TIME_LIMIT)
        for key, val in opts.items():
            h.setOptionValue(key, val)
        h.passModel(lp)
        t0 = time.perf_counter()
        h.run()
        sync(device)
        seconds = time.perf_counter() - t0
        info = h.getInfo()
        status = h.getModelStatus()
        rel_p, rel_d, gap, pobj, _ = kkt_check(
            a, b, c, np.full(lp.num_col, UPPER), h.getSolution())
        rec = dict(status=status.name, seconds=seconds,
                   simplex_iterations=int(info.simplex_iteration_count),
                   ipm_iterations=int(info.ipm_iteration_count),
                   crossover_iterations=int(info.crossover_iteration_count),
                   pdlp_iterations=int(info.pdlp_iteration_count),
                   valid_basis=valid_basis(h, lp), objective=pobj,
                   kkt=max(rel_p, rel_d, gap),
                   rel_obj=abs(pobj - anchor) / abs(anchor))
        log(f"{name}: {lp.num_row} x {lp.num_col} {status.name} seconds "
            f"{seconds:.3f} simplex_iterations {rec['simplex_iterations']} "
            f"ipm_iterations {rec['ipm_iterations']} crossover_iterations "
            f"{rec['crossover_iterations']} pdlp_iterations "
            f"{rec['pdlp_iterations']} valid_basis {rec['valid_basis']} "
            f"objective {pobj!r} (scipy {anchor!r}, rel {rec['rel_obj']:.3e})"
            f" KKT {rec['kkt']:.3e}")
        solved_by = (rec["simplex_iterations"] > 0 if not opts else
                     rec["ipm_iterations"] > 0 and
                     rec["crossover_iterations"] >= 0)
        if status != highs_tpu_torch.HighsModelStatus.kOptimal or \
                not rec["valid_basis"] or not solved_by or \
                not rec["kkt"] <= KKT_TOL or not rec["rel_obj"] <= 1e-6:
            raise RuntimeError(f"{name}: {rec}")
        out[name] = rec
        SOLVED[name] = h
    return out


def qp_certificate(model, sol):
    """Independent f64 optimality certificate of a convex QP's solution
    from the model's data alone (minimisation; row duals y >= 0 at a
    lower row bound, z likewise): relative primal infeasibility of rows
    and bounds, stationarity c + Qx - A'y - z, the multipliers' weight
    on infinite bounds, and the relative gap between the primal
    objective and the dual objective -1/2 x'Qx + sum of the finite bound
    terms.  A primal and a dual point that pass it bound the optimum
    from both sides."""
    import numpy as np
    lp = model.lp
    x = np.asarray(sol.col_value, dtype=np.float64)
    y = np.asarray(sol.row_dual, dtype=np.float64)
    z = np.asarray(sol.col_dual, dtype=np.float64)
    c = np.asarray(lp.col_cost, dtype=np.float64)
    a = lp.a_matrix.to_scipy().tocsr()
    qx = model.hessian.to_scipy_full().tocsr() @ x

    def excess(v, lo, up):
        return (np.where(np.isfinite(lo), np.maximum(lo - v, 0.0), 0.0) +
                np.where(np.isfinite(up), np.maximum(v - up, 0.0), 0.0))

    def bound_terms(mult, lo, up):
        pos, neg = np.maximum(mult, 0.0), np.minimum(mult, 0.0)
        lo_f, up_f = np.isfinite(lo), np.isfinite(up)
        return (float(np.where(lo_f, lo, 0.0) @ pos +
                      np.where(up_f, up, 0.0) @ neg),
                np.concatenate([pos[~lo_f], neg[~up_f]]))
    bounds = np.concatenate([lp.row_lower, lp.row_upper, lp.col_lower,
                             lp.col_upper])
    primal = math.hypot(
        np.linalg.norm(excess(a @ x, lp.row_lower, lp.row_upper)),
        np.linalg.norm(excess(x, lp.col_lower, lp.col_upper))) / (
        1.0 + np.linalg.norm(bounds[np.isfinite(bounds)]))
    stationarity = np.linalg.norm(c + qx - a.T @ y - z) / (
        1.0 + np.linalg.norm(c))
    row_term, row_wrong = bound_terms(y, lp.row_lower, lp.row_upper)
    col_term, col_wrong = bound_terms(z, lp.col_lower, lp.col_upper)
    dual_inf = np.linalg.norm(np.concatenate([row_wrong, col_wrong])) / (
        1.0 + np.linalg.norm(c))
    pobj = float(c @ x + 0.5 * x @ qx) + lp.offset
    dobj = float(-0.5 * x @ qx) + row_term + col_term + lp.offset
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return dict(primal=float(primal), stationarity=float(stationarity),
                dual_inf=float(dual_inf), gap=gap, pobj=pobj, dobj=dobj)


def certified(name, cert) -> bool:
    ok = (cert["primal"] <= KKT_TOL and cert["stationarity"] <= KKT_TOL
          and cert["dual_inf"] <= KKT_TOL and cert["gap"] <= GAP_TOL)
    log(f"{name}: independent f64 certificate primal {cert['primal']:.3e} "
        f"stationarity {cert['stationarity']:.3e} dual_inf "
        f"{cert['dual_inf']:.3e} (limits {KKT_TOL:g}) gap "
        f"{cert['gap']:.3e} (limit {GAP_TOL:g}); primal obj "
        f"{cert['pobj']!r} dual obj {cert['dobj']!r}: "
        f"{'passed' if ok else 'FAILED'}")
    return ok


def qp_solve(name, model, device, options=None):
    """One QP through the facade on `device`; returns (facade, record)
    with the QP IPM's dense factors by device and the facade's lines."""
    import highs_tpu_torch
    from highs_tpu_torch.solvers.qp import ipm_qp

    lines = []
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("time_limit", SOLVE_TIME_LIMIT)
    h.setOptionValue("log_to_console", False)
    h.setLogCallback(lambda _kind, msg: lines.append(msg))
    for key, val in (options or {}).items():
        h.setOptionValue(key, val)
    h.passModel(model)
    dense0 = dict(ipm_qp.DENSE_FACTORS)
    t0 = time.perf_counter()
    status = h.run()
    sync(device)
    seconds = time.perf_counter() - t0
    rec = dict(status=h.getModelStatus().name, run_status=int(status),
               objective=h.getObjectiveValue(), seconds=seconds,
               qp_iterations=int(h.getInfo().qp_iteration_count),
               dense_factors={k: ipm_qp.DENSE_FACTORS[k] - dense0[k]
                              for k in dense0},
               fell_back=any("falling back to IPM" in ln for ln in lines))
    log(f"{name}: {model.lp.num_row} x {model.lp.num_col} status "
        f"{rec['status']} objective {rec['objective']!r} qp_iterations "
        f"{rec['qp_iterations']} seconds {seconds:.3f} QP IPM dense "
        f"factors {rec['dense_factors']} (by device)")
    return h, rec


def qp_dense_phase(device):
    """The full-width QP through `Highs().run()` with default options."""
    import highs_tpu_torch
    from highs_tpu_torch.solvers.pdlp.preprocess import preprocess_lp
    from highs_tpu_torch.tools.card import FP64_TENSOR_FLOPS
    from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model

    t0 = time.perf_counter()
    model = mm_qp_model(**QP_DENSE)
    gen_s = time.perf_counter() - t0
    n_std = preprocess_lp(model.lp).num_col
    m = model.lp.num_row
    log(f"qp_dense: {m} x {model.lp.num_col} (standard form {m} x {n_std}),"
        f" {model.lp.a_matrix.num_nz} nonzeros in A, {model.hessian.num_nz} "
        f"in the lower triangle of Q; generated in {gen_s:.1f} s")
    h, rec = qp_solve("qp_dense", model, device)
    iters = rec["qp_iterations"]
    timer = h.getTimer()
    clocks = {k: timer.read(f"qp_{k}") for k in
              ("setup", "iterations", "factor_q", "solve_at", "gemm",
               "factor_m")}
    per_it = {k: 1e3 * clocks[k] / max(iters, 1)
              for k in ("iterations", "factor_q", "solve_at", "gemm",
                        "factor_m")}
    per_it["rest"] = per_it["iterations"] - sum(
        per_it[k] for k in ("factor_q", "solve_at", "gemm", "factor_m"))
    # the iteration's useful operations: the Cholesky of Q + D (n^3/3),
    # the two triangular solves against A' (2 n^2 m), A W (2 m^2 n) and
    # the Cholesky of the Schur complement (m^3/3), n = n_std
    flops = {"factor_q": n_std ** 3 / 3, "solve_at": 2.0 * n_std ** 2 * m,
             "gemm": 2.0 * m * m * n_std, "factor_m": m ** 3 / 3}
    total = sum(flops.values())
    rate = total / (per_it["iterations"] * 1e-3)
    rates = {k: flops[k] / (per_it[k] * 1e-3) / 1e12 for k in flops
             if per_it[k] > 0}
    rec.update(generate_s=gen_s, n_std=n_std, qp_setup_s=clocks["setup"],
               qp_iterations_s=clocks["iterations"],
               ms_per_iteration=per_it,
               tflop_per_iteration=total / 1e12,
               useful_fp64_tflops=rate / 1e12,
               useful_fp64_share=rate / FP64_TENSOR_FLOPS,
               phase_tflops=rates)
    log(f"qp_dense: {iters} iterations, setup {clocks['setup']:.3f} s, "
        f"iterations {clocks['iterations']:.3f} s; ms per iteration: "
        f"factor(Q+D) {per_it['factor_q']:.3f} A' solves "
        f"{per_it['solve_at']:.3f} A W {per_it['gemm']:.3f} factor(M) "
        f"{per_it['factor_m']:.3f} rest {per_it['rest']:.3f} of "
        f"{per_it['iterations']:.3f}")
    log(f"qp_dense: {total / 1e12:.3f} TFLOP of useful FP64 operations an "
        f"iteration at {rate / 1e12:.2f} TFLOP/s, "
        f"{100 * rate / FP64_TENSOR_FLOPS:.1f}% of the FP64 tensor peak "
        f"({FP64_TENSOR_FLOPS / 1e12:.0f} TFLOP/s); by phase "
        f"{ {k: round(v, 2) for k, v in rates.items()} } TFLOP/s")
    if rec["status"] != "kOptimal":
        raise RuntimeError(f"qp_dense: {rec}")
    if device.type == "cuda" and (
            rec["dense_factors"]["cuda"] != 2 * iters or
            rec["dense_factors"]["cpu"]):
        raise RuntimeError(f"qp_dense: dense factors "
                           f"{rec['dense_factors']} for {iters} iterations:"
                           " not every factor ran on the card")
    rec["certificate"] = qp_certificate(model, h.getSolution())
    if not certified("qp_dense", rec["certificate"]):
        raise RuntimeError("qp_dense: the solution fails the certificate")
    return rec


def qpasm_phase(device):
    """The active set on a 300-column QP, against the QP IPM on the card
    for the same QP."""
    from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model
    model = mm_qp_model(*QP_ASM)
    _, ipm = qp_solve("qpasm_ipm", model, device)
    h, rec = qp_solve("qpasm", model, device, {"solver": "qpasm"})
    rec["ipm_objective"] = ipm["objective"]
    rec["rel_obj"] = abs(rec["objective"] - ipm["objective"]) / abs(
        ipm["objective"])
    how = ("fell back to the IPM" if rec["fell_back"] else
           "the active set concluded")
    log(f"qpasm: {how}; objective {rec['objective']!r} against the QP IPM's "
        f"{ipm['objective']!r} on the card, rel diff {rec['rel_obj']:.3e}")
    if rec["status"] != "kOptimal" or ipm["status"] != "kOptimal" or             not rec["rel_obj"] <= 1e-6:
        raise RuntimeError(f"qpasm: {rec}")
    rec["certificate"] = qp_certificate(model, h.getSolution())
    if not certified("qpasm", rec["certificate"]):
        raise RuntimeError("qpasm: the solution fails the certificate")
    return rec


def qp_status_phase(device):
    """An infeasible and an unbounded QP, and an MIQP."""
    import numpy as np
    from highs_tpu_torch.solvers.ipm import solver
    from highs_tpu_torch.utils.gen_mm_qp import mm_qp_model, status_qp_model
    out = {}
    for kind, want in (("infeasible", "kInfeasible"),
                       ("unbounded", "kUnbounded")):
        lp_factors0 = dict(solver.DENSE_FACTORS)
        _, rec = qp_solve(f"qp_{kind}", status_qp_model(kind), device)
        rec["lp_ipm_dense_factors"] = {
            k: solver.DENSE_FACTORS[k] - lp_factors0[k] for k in lp_factors0}
        log(f"qp_{kind}: classification LPs' dense factors "
            f"{rec['lp_ipm_dense_factors']} (by device)")
        if rec["status"] != want or (device.type == "cuda" and (
                not rec["lp_ipm_dense_factors"]["cuda"] or
                rec["lp_ipm_dense_factors"]["cpu"])):
            raise RuntimeError(f"qp_{kind}: {rec}")
        out[kind] = rec
    model = mm_qp_model(11, 24, 12)
    model.lp.integrality = np.ones(24, dtype=np.uint8)
    _, rec = qp_solve("miqp", model, device)
    if rec["run_status"] != -1 or rec["status"] != "kNotset":
        raise RuntimeError(f"miqp: {rec}, not kError")
    out["miqp"] = rec
    return out


def qp_phase(device):
    """Phase 14: the QP path, with the kernels' launch counts around it."""
    reset_launches()
    out = {"qp_dense": qp_dense_phase(device), "qpasm": qpasm_phase(device),
           "qp_status": qp_status_phase(device)}
    out["kernel_launches"] = read_launches()
    log(f"qp: kernel launches on the QP path {out['kernel_launches']}")
    return out


MIP_TIME_LIMIT = 300.0
# facility location's limit: 150 s keeps the script, with phases 16 and
# 17, well inside its 1,200 s (its sandwich holds at 150 s as at 300 s)
MIP_CFL_TIME_LIMIT = 150.0
MIP_FEAS_TOL = 1e-6
# the facades that phases keep solved for later ones (phase 17 ranges
# phase 13's simplex LP without a second cold solve)
SOLVED = {}
# the MipRunInfo of each outermost MIP solve (`record_mip_runs`): its LP
# iterations are not in the facade's info
_MIP_RUNS = []


def mip_counts():
    """The IPM's solves and factors by device and engine so far."""
    from highs_tpu_torch.solvers.ipm import solver
    return {"ipm_solves": dict(solver.SOLVES),
            "dense_factors": dict(solver.DENSE_FACTORS),
            "sparse_factors": dict(solver.SPARSE_FACTORS),
            "ipm_routes": dict(solver.ROUTES)}


def mip_count_delta(after, before):
    return {k: {e: after[k][e] - before[k][e] for e in after[k]}
            for k in after}


def record_mip_runs():
    """Wrap the MIP solver so that the outermost solve's MipRunInfo is
    kept (sub-MIPs and restarts call it again)."""
    from highs_tpu_torch.solvers.mip import solver
    inner = solver.solve_mip
    depth = [0]

    def wrapped(*args, **kwargs):
        depth[0] += 1
        try:
            out = inner(*args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            _MIP_RUNS.append(out[2])
        return out
    solver.solve_mip = wrapped


def model_violation(d, x):
    """Largest violation of the model's rows and bounds by x, in f64, from
    its data alone (absolute)."""
    import numpy as np
    import scipy.sparse as sp
    a = sp.csc_matrix((d["a_value"], d["a_index"], d["a_start"]),
                      shape=(d["num_row"], d["num_col"]))
    ax = a @ x

    def excess(v, lo, up):
        return np.maximum(np.where(np.isfinite(lo), lo - v, 0.0),
                          np.where(np.isfinite(up), v - up, 0.0))
    return float(max(np.max(excess(ax, d["row_lower"], d["row_upper"]),
                            initial=0.0),
                     np.max(excess(x, d["col_lower"], d["col_upper"]),
                            initial=0.0)))


def finite(value):
    """A float for the summary line, None where it is not finite (the
    line stays strict JSON)."""
    value = float(value)
    return value if math.isfinite(value) else None


def mip_solve(name, d, device, options=None):
    """One MIP (a `gen_mip` dict) through the facade on `device`; returns
    (facade, record) with the run's nodes, LP iterations, root cut
    rounds, the IPM's work by device and the facade's node-LP clock."""
    import numpy as np
    import highs_tpu_torch
    from highs_tpu_torch.convert import lp_from_numpy

    lines = []
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("log_to_console", False)
    h.setLogCallback(lambda _kind, msg: lines.append(msg))
    for key, val in (options or {}).items():
        h.setOptionValue(key, val)
    h.passModel(lp_from_numpy(d))
    counts0 = mip_counts()
    runs0 = len(_MIP_RUNS)
    t0 = time.perf_counter()
    status = h.run()
    sync(device)
    seconds = time.perf_counter() - t0
    info = h.getInfo()
    sol = h.getSolution()
    mip_info = _MIP_RUNS[-1] if len(_MIP_RUNS) > runs0 else None
    cut_lines = [ln for ln in lines if ln.startswith("MIP root cuts round")]
    node_lp = h.getTimer().read("mip::node_lp")
    node_lp_calls = h.getTimer().num_calls("mip::node_lp")
    rec = dict(
        status=h.getModelStatus().name, run_status=int(status),
        objective=h.getObjectiveValue(), seconds=seconds,
        rows=d["num_row"], cols=d["num_col"],
        presolved_rows=int(getattr(info, "presolved_num_row", -1)),
        nodes=int(info.mip_node_count), gap=finite(info.mip_gap),
        dual_bound=finite(info.mip_dual_bound),
        integrality_violation=float(info.max_integrality_violation),
        lp_iterations=(mip_info.iterations if mip_info else None),
        cut_rounds=len(cut_lines),
        root_bound_after_cuts=(float(cut_lines[-1].rsplit(" ", 1)[1])
                               if cut_lines else None),
        node_lp_seconds=node_lp, node_lp_calls=node_lp_calls,
        node_lp_mean_ms=(1e3 * node_lp / node_lp_calls
                         if node_lp_calls else None),
        ipm=mip_count_delta(mip_counts(), counts0),
        ipm_clocks={name: (round(h.getTimer().read(name), 4),
                           h.getTimer().num_calls(name))
                    for name in ("ipm_setup", "ipm_iterations",
                                 "ipm_normal", "ipm_factor", "ipm_solve")},
        violation=(model_violation(d, np.asarray(sol.col_value))
                   if sol.value_valid else None))
    log(f"{name}: {d['num_row']} x {d['num_col']} (presolved rows "
        f"{rec['presolved_rows']}) status {rec['status']} objective "
        f"{rec['objective']!r} nodes {rec['nodes']} LP iterations "
        f"{rec['lp_iterations']} gap {rec['gap']} dual bound "
        f"{rec['dual_bound']!r} seconds {seconds:.2f}; root cut rounds "
        f"{rec['cut_rounds']} (bound after them "
        f"{rec['root_bound_after_cuts']}); node LPs "
        f"{node_lp_calls} in {node_lp:.2f} s; IPM {rec['ipm']}; IPM "
        f"clocks (s, calls) {rec['ipm_clocks']}")
    return h, rec


def mip_setcover_phase(device, anchors):
    from highs_tpu_torch.tools.mip_anchors import model
    h, rec = mip_solve("mip_setcover", model("setcover"), device,
                       {"time_limit": MIP_TIME_LIMIT})
    rel_gap = h.getOptionValue("mip_rel_gap")
    rec["anchor"] = anchors["setcover"]
    rec["rel_obj"] = abs(rec["objective"] - rec["anchor"]) / max(
        1.0, abs(rec["anchor"]))
    log(f"mip_setcover: objective {rec['objective']!r} against scipy's "
        f"proven {rec['anchor']!r}: rel {rec['rel_obj']:.3e} (limit "
        f"mip_rel_gap {rel_gap:g}); integrality violation "
        f"{rec['integrality_violation']:.3e}, rows and bounds "
        f"{rec['violation']} (limit {MIP_FEAS_TOL:g})")
    if rec["status"] != "kOptimal" or not rec["rel_obj"] <= rel_gap or \
            not rec["integrality_violation"] <= MIP_FEAS_TOL or \
            not rec["violation"] <= MIP_FEAS_TOL:
        raise RuntimeError(f"mip_setcover: {rec}")
    return rec


def mip_cfl_phase(device, anchors):
    from highs_tpu_torch.presolve.presolve import presolve_lp
    from highs_tpu_torch.convert import lp_from_numpy
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.tools.mip_anchors import model
    d = model("cfl")
    reduced = presolve_lp(lp_from_numpy(d), HighsOptions(),
                          device).reduced_lp
    log(f"mip_cfl: {d['num_row']} rows, {reduced.num_row} after presolve "
        f"(the simplex gate is 10,000)")
    if not reduced.num_row > 10000:
        raise RuntimeError("mip_cfl: the presolved relaxation is under the "
                           "10,000-row gate")
    h, rec = mip_solve("mip_cfl", d, device,
                       {"time_limit": MIP_CFL_TIME_LIMIT})
    rel_gap = h.getOptionValue("mip_rel_gap")
    anchor = rec["anchor"] = anchors["cfl"]
    rec["rel_obj"] = abs(rec["objective"] - anchor) / max(1.0, abs(anchor))
    slack = 1e-6 * max(1.0, abs(anchor))
    if rec["status"] == "kOptimal":
        ok = rec["rel_obj"] <= rel_gap
    else:
        ok = (rec["status"] == "kTimeLimit" and rec["violation"] is not None
              and rec["dual_bound"] is not None
              and rec["dual_bound"] <= anchor + slack
              and anchor <= rec["objective"] + slack)
    ok = ok and rec["violation"] is not None and \
        rec["violation"] <= MIP_FEAS_TOL and \
        rec["integrality_violation"] <= MIP_FEAS_TOL
    on_card = rec["ipm"]["ipm_solves"].get(device.type, 0)
    # the relaxation's M fills 65% of its triangle under the LDL'
    # ordering, so the IPM's fill gate sends its solves to "dense_m"
    dense_m = rec["ipm"]["ipm_routes"]["dense_m"]
    overrun = rec["seconds"] - MIP_CFL_TIME_LIMIT
    log(f"mip_cfl: {rec['status']} objective {rec['objective']!r} dual "
        f"bound {rec['dual_bound']!r} against scipy's proven {anchor!r}; "
        f"IPM solves on {device.type} {on_card} (routes "
        f"{rec['ipm']['ipm_routes']}); mean node LP "
        f"{rec['node_lp_mean_ms']} ms; run() {rec['seconds']:.1f} s "
        f"against a time_limit of {MIP_CFL_TIME_LIMIT:g} s")
    if not ok or not on_card or not dense_m or overrun > 30.0:
        raise RuntimeError(f"mip_cfl: {rec}")
    return rec


def semi_mip():
    """min 0.4 x + y s.t. x + y >= 2, x semi-continuous in {0} or [3, 10],
    0 <= y <= 5: the relaxation's x = 2 is not allowed (optimum 1.2)."""
    import numpy as np
    import scipy.sparse as sp
    a = sp.csc_matrix(np.array([[1.0, 1.0]]))
    return dict(num_col=2, num_row=1, col_cost=np.array([0.4, 1.0]),
                col_lower=np.array([3.0, 0.0]),
                col_upper=np.array([10.0, 5.0]), row_lower=np.array([2.0]),
                row_upper=np.array([np.inf]), a_start=a.indptr,
                a_index=a.indices, a_value=a.data,
                integrality=np.array([2, 0], dtype=np.uint8))


def scipy_objective(d):
    from highs_tpu_torch.tools.mip_anchors import scipy_milp
    status, obj, _, _ = scipy_milp(d, time_limit=60.0)
    if status != 0:
        raise RuntimeError(f"scipy's milp: status {status}")
    return float(obj)


def mip_small_phase(device):
    import numpy as np
    import highs_tpu_torch
    import scipy.sparse as sp
    from highs_tpu_torch.utils.gen_mip import equality_knapsacks
    out = {}
    # semi-continuous
    d = semi_mip()
    _, rec = mip_solve("mip_semi", d, device)
    rec["anchor"] = scipy_objective(d)
    if rec["status"] != "kOptimal" or \
            abs(rec["objective"] - rec["anchor"]) > 1e-6:
        raise RuntimeError(f"mip_semi: {rec}")
    out["semi"] = rec
    # SOS1: max x1 + x2 + x3, each <= 1, at most one nonzero
    lp = highs_tpu_torch.HighsLp(
        num_col=3, num_row=1, col_cost=np.array([-1.0, -1.0, -1.0]),
        col_lower=np.zeros(3), col_upper=np.ones(3),
        row_lower=np.array([-np.inf]), row_upper=np.array([10.0]),
        a_matrix=highs_tpu_torch.HighsSparseMatrix.from_scipy(
            sp.csc_matrix(np.ones((1, 3)))),
        sos=[("S1", 0, [0, 1, 2], [1.0, 2.0, 3.0])])
    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("output_flag", False)
    h.passModel(lp)
    h.run()
    x = np.asarray(h.getSolution().col_value)
    rec = {"status": h.getModelStatus().name,
           "objective": h.getObjectiveValue(),
           "nonzeros": int(np.sum(np.abs(x) > 1e-6))}
    log(f"mip_sos1: {rec}")
    if rec["status"] != "kOptimal" or abs(rec["objective"] + 1.0) > 1e-9 \
            or rec["nonzeros"] > 1:
        raise RuntimeError(f"mip_sos1: {rec}")
    out["sos1"] = rec
    # central rounding: the root has no incumbent after its roundings,
    # so the analytic centre is computed by the IPM on the card
    d = equality_knapsacks(4, 20, seed=0)
    _, rec = mip_solve("mip_central", d, device)
    rec["anchor"] = scipy_objective(d)
    solves = rec["ipm"]["ipm_solves"].get(device.type, 0)
    factors = rec["ipm"]["dense_factors"].get(device.type, 0)
    log(f"mip_central: IPM solves on {device.type} {solves}, dense factors "
        f"{factors}; objective {rec['objective']!r} against scipy's "
        f"{rec['anchor']!r}")
    if rec["status"] != "kOptimal" or \
            abs(rec["objective"] - rec["anchor"]) > 1e-6 or not solves \
            or not factors:
        raise RuntimeError(f"mip_central: {rec}")
    out["central"] = rec
    # infeasible: 1.6 <= x + y <= 1.8 over binaries
    a = sp.csc_matrix(np.array([[1.0, 1.0]]))
    d = dict(num_col=2, num_row=1, col_cost=np.ones(2),
             col_lower=np.zeros(2), col_upper=np.ones(2),
             row_lower=np.array([1.6]), row_upper=np.array([1.8]),
             a_start=a.indptr, a_index=a.indices, a_value=a.data,
             integrality=np.ones(2, dtype=np.uint8))
    _, rec = mip_solve("mip_infeasible", d, device)
    if rec["status"] != "kInfeasible":
        raise RuntimeError(f"mip_infeasible: {rec}")
    out["infeasible"] = rec
    return out


def mip_phase(device):
    """Phase 15: the MIP path, with the kernels' launch counts around it."""
    from highs_tpu_torch.tools.mip_anchors import load
    anchors = load()
    record_mip_runs()
    reset_launches()
    out = {"mip_setcover": mip_setcover_phase(device, anchors),
           "mip_cfl": mip_cfl_phase(device, anchors),
           "mip_small": mip_small_phase(device)}
    out["kernel_launches"] = read_launches()
    log(f"mip: kernel launches on the MIP path {out['kernel_launches']}")
    return out


MIP_BATCH_TIME_LIMIT = 180.0
# the lexicographic solve's relative tolerance on the first objective,
# and each of its solves' time limit
LEX_REL_TOL = 1e-2
LEX_TIME_LIMIT = 120.0
MIP_BATCH_K = 8
# the rounds whose lanes are held against the native simplex
MIP_BATCH_CHECKED_ROUNDS = 4


def watch_batched_rounds(device, keep):
    """Wrap `BatchNodeEvaluator.evaluate` so that each round's seconds
    (up to a sync of the card) are kept, and the first `keep` rounds as
    (relaxation LP, los, ups, results, batched iterations); returns both
    lists and a function that takes the wrapper off."""
    import numpy as np
    from highs_tpu_torch.solvers.mip import batch_nodes
    from highs_tpu_torch.solvers.mip.batch_nodes import BatchNodeEvaluator
    seconds, rounds = [], []
    inner = BatchNodeEvaluator.evaluate

    def watched(self, los, ups):
        t0 = time.perf_counter()
        it0 = batch_nodes.COUNTS["iterations"]
        out = inner(self, los, ups)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        if len(rounds) < keep:
            rounds.append((self.relax_lp, np.array(los), np.array(ups),
                           out, batch_nodes.COUNTS["iterations"] - it0))
        return out
    BatchNodeEvaluator.evaluate = watched

    def unwatch():
        BatchNodeEvaluator.evaluate = inner
    return seconds, rounds, unwatch


def check_lanes(recorded, device):
    """Each lane of the recorded rounds against its node LP solved by the
    native dual simplex on the host: a converged lane's objective within
    1e-6 relative of the simplex optimum, every certified dual bound at
    most that optimum + 1e-6 (1 + |opt|), no lane converged on an
    infeasible node."""
    import numpy as np
    from highs_tpu_torch.options import HighsOptions
    from highs_tpu_torch.solvers.simplex.wrapper import solve_lp_simplex
    out = dict(lanes=0, converged=0, certified=0, infeasible=0,
               worst_obj_rel=0.0, worst_bound_excess=-math.inf)
    for relax_lp, los, ups, results, _ in recorded:
        sense = float(relax_lp.sense)
        for lo, up, (converged, bound, x) in zip(los, ups, results):
            node = relax_lp.copy()
            node.col_lower, node.col_upper = lo.copy(), up.copy()
            status, sol, _ = solve_lp_simplex(node, HighsOptions(),
                                              device=device)
            out["lanes"] += 1
            if status.name == "kInfeasible":
                out["infeasible"] += 1
                if converged:
                    raise RuntimeError("mip_batch: a lane converged on an "
                                       "infeasible node LP")
                continue
            if status.name != "kOptimal":
                raise RuntimeError(f"mip_batch: node LP {status.name}")
            opt = sense * float(node.col_cost @ sol.col_value)
            if converged:
                out["converged"] += 1
                rel = abs(sense * float(node.col_cost @ x) - opt) / max(
                    1.0, abs(opt))
                out["worst_obj_rel"] = max(out["worst_obj_rel"], rel)
                if not rel <= 1e-6:
                    raise RuntimeError(f"mip_batch: lane objective off "
                                       f"the simplex optimum by {rel:.3e}")
            if math.isfinite(bound):
                out["certified"] += 1
                excess = (bound - opt) / (1.0 + abs(opt))
                out["worst_bound_excess"] = max(out["worst_bound_excess"],
                                                excess)
                if not excess <= 1e-6:
                    raise RuntimeError(f"mip_batch: certified bound "
                                       f"{bound!r} above the node optimum "
                                       f"{opt!r}")
    if out["worst_bound_excess"] == -math.inf:
        out["worst_bound_excess"] = None
    return out


def node_graphs_check(recorded, device):
    """The recorded rounds through fresh evaluators of their relaxations,
    as graphs (the card's default) and op by op (`capture` None): equal
    bit for bit to each other and to the rounds of the run (each lane's
    flag, bound and x, each round's iterations); the captures of the
    fresh graph evaluators; then, on the first relaxation's rounds, the
    wall ms per batched iteration of both paths, and the graphs' device
    ms per iteration by kernel and busy share (`tools/node_turns.py`
    `profile_rounds`)."""
    from highs_tpu_torch.solvers.mip import batch_nodes
    from highs_tpu_torch.solvers.mip.batch_nodes import BatchNodeEvaluator
    from highs_tpu_torch.tools.node_turns import (profile_rounds,
                                                  run_rounds, same_bits)
    groups = {}
    for relax_lp, los, ups, results, iterations in recorded:
        g = groups.setdefault(id(relax_lp), (relax_lp, [], []))
        g[1].append((los, ups))
        g[2].append((results, iterations))
    out = dict(relaxations=len(groups), rounds=len(recorded),
               equal_to_eager=True, equal_to_run=True, captures=0)
    for relax_lp, rounds, run in groups.values():
        c0 = batch_nodes.COUNTS["captures"]
        graphs = BatchNodeEvaluator(relax_lp, device=device)
        got = run_rounds(graphs, rounds)
        out["captures"] += batch_nodes.COUNTS["captures"] - c0
        eager = BatchNodeEvaluator(relax_lp, device=device)
        eager.capture = None
        out["equal_to_eager"] &= same_bits(got, run_rounds(eager, rounds))
        out["equal_to_run"] &= same_bits(got, run)
        if "graphs" not in out:
            out["graphs"] = profile_rounds(graphs, rounds)
            out["eager"] = profile_rounds(eager, rounds)
        graphs.close()
        eager.close()
    return out


def mip_batch_phase(device, sequential_seconds):
    """Phase 16: set cover 500 x 1,000 with batched node LPs on the
    card, its lanes checked against the native simplex."""
    from highs_tpu_torch.solvers.ipm import solver as ipm_solver
    from highs_tpu_torch.solvers.mip import batch_nodes
    from highs_tpu_torch.tools.mip_anchors import load, model
    anchor = load()["setcover"]
    round_seconds, rounds, unwatch = watch_batched_rounds(
        device, MIP_BATCH_CHECKED_ROUNDS)
    counts0 = dict(batch_nodes.COUNTS)
    factors0 = dict(ipm_solver.DENSE_FACTORS)
    reset_launches()
    try:
        h, rec = mip_solve("mip_batch", model("setcover"), device,
                           {"time_limit": MIP_BATCH_TIME_LIMIT,
                            "tpu_mip_batch_nodes": MIP_BATCH_K})
    finally:
        unwatch()
    rec["kernel_launches"] = read_launches()
    counts = {k: batch_nodes.COUNTS[k] - counts0[k] for k in counts0}
    factors = {k: ipm_solver.DENSE_FACTORS[k] - factors0[k]
               for k in factors0}
    rec["batch"] = counts
    rec["dense_factors"] = factors
    rec["rounds_seconds"] = sum(round_seconds)
    rec["ms_per_batched_iteration"] = (
        1e3 * rec["rounds_seconds"] / counts["iterations"]
        if counts["iterations"] else None)
    rec["converged_share"] = (counts["converged"] / counts["lanes"]
                              if counts["lanes"] else None)
    rec["sequential_seconds"] = sequential_seconds
    t0 = time.perf_counter()
    rec["lane_check"] = check_lanes(rounds, device)
    rec["lane_check"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["node_graphs"] = node_graphs_check(rounds, device)
    rec["node_graphs"]["seconds"] = time.perf_counter() - t0
    graphs, eager = rec["node_graphs"]["graphs"], rec["node_graphs"]["eager"]
    rel_gap = h.getOptionValue("mip_rel_gap")
    rec["anchor"] = anchor
    rec["rel_obj"] = abs(rec["objective"] - anchor) / max(1.0, abs(anchor))
    slack = 1e-6 * max(1.0, abs(anchor))
    if rec["status"] == "kOptimal":
        ok = rec["rel_obj"] <= rel_gap
    else:
        ok = (rec["status"] == "kTimeLimit" and rec["violation"] is not None
              and rec["dual_bound"] is not None
              and rec["dual_bound"] <= anchor + slack
              and anchor <= rec["objective"] + slack)
    ok = ok and rec["violation"] is not None and \
        rec["violation"] <= MIP_FEAS_TOL and \
        rec["integrality_violation"] <= MIP_FEAS_TOL
    log(f"mip_batch: {rec['status']} objective {rec['objective']!r} dual "
        f"bound {rec['dual_bound']!r} against scipy's proven {anchor!r}; "
        f"{counts['rounds']} batched rounds of up to {MIP_BATCH_K}, "
        f"{counts['lanes']} lanes, {counts['converged']} converged "
        f"({rec['converged_share']}), {counts['iterations']} batched IPM "
        f"iterations (by device: cuda {counts['cuda']}, cpu "
        f"{counts['cpu']}) in {rec['rounds_seconds']:.2f} s, "
        f"{rec['ms_per_batched_iteration']} ms each; dense factors "
        f"{factors}; nodes {rec['nodes']} in {rec['seconds']:.2f} s "
        f"(the sequential engine of phase 15: {sequential_seconds:.2f} s); "
        f"lane check {rec['lane_check']}")
    log(f"mip_batch: graphs: {counts['captures']} captures, "
        f"{counts['replays']} replays ({counts['rounds']} starts, "
        f"{counts['iterations']} steps); the first "
        f"{rec['node_graphs']['rounds']} rounds replayed through fresh "
        f"evaluators: {rec['node_graphs']['captures']} captures, as graphs "
        f"equal bit for bit to op by op {rec['node_graphs']['equal_to_eager']}"
        f" and to the run {rec['node_graphs']['equal_to_run']}; on them "
        f"{graphs['wall_ms_per_iteration']!r} ms a batched iteration "
        f"as graphs, {eager['wall_ms_per_iteration']!r} op by op; device "
        f"{graphs['device_ms_per_iteration']!r} ms an iteration, busy "
        f"share {graphs['device_busy_share']!r}, kernels "
        f"{graphs['kernels_per_iteration']!r} an iteration; device ms by "
        f"group {graphs['by_group']}; top kernels "
        f"{graphs['top_kernels']}")
    other = "cpu" if device.type == "cuda" else "cuda"
    # every round's start and steps as replays, where the card has graphs
    replayed = device.type != "cuda" or (
        counts["captures"] >= 2 and
        counts["replays"] == counts["rounds"] + counts["iterations"])
    if not ok or not counts["rounds"] or counts[other] or \
            counts[device.type] < counts["iterations"] or factors[other] or \
            not replayed or not rec["lane_check"]["lanes"] or \
            not rec["node_graphs"]["equal_to_eager"] or \
            not rec["node_graphs"]["equal_to_run"] or \
            rec["seconds"] > MIP_BATCH_TIME_LIMIT + 30.0:
        raise RuntimeError(f"mip_batch: {rec}")
    return rec


def ipm_counts():
    from highs_tpu_torch.solvers.ipm import solver as ipm_solver
    return dict(solves=dict(ipm_solver.SOLVES),
                dense_factors=dict(ipm_solver.DENSE_FACTORS))


def ipm_count_delta(after, before):
    return {k: {d: after[k][d] - before[k][d] for d in after[k]}
            for k in after}


def on_card_only(delta, device):
    """The IPM ran on `device` alone (no solve or factor elsewhere)."""
    other = "cpu" if device.type == "cuda" else "cuda"
    return delta["solves"][device.type] > 0 and \
        not delta["solves"][other] and not delta["dense_factors"][other]


def lp_file_part(device, tmp):
    """ipm_dense's LP through an .lp file: written and read back, solved
    by `python3 -m highs_tpu_torch` in a subprocess and by
    `capi.Highs_lpCall` on its arrays."""
    import subprocess
    import numpy as np
    from highs_tpu_torch import capi
    from highs_tpu_torch.io.lp_format import read_lp, write_lp
    from highs_tpu_torch.models.lp import HighsModel
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp
    lp = synth_lp(*IPM_DENSE_SHAPE)
    path = os.path.join(tmp, "ipm_dense.lp")
    t0 = time.perf_counter()
    write_lp(HighsModel(lp=lp), path)
    back = read_lp(path).lp
    rec = dict(write_read_seconds=time.perf_counter() - t0,
               file_bytes=os.path.getsize(path))
    same = back.num_row == lp.num_row and back.num_col == lp.num_col and \
        all(np.allclose(getattr(back, f), getattr(lp, f), rtol=1e-11,
                        atol=0) for f in ("col_cost", "col_lower",
                                          "col_upper", "row_lower",
                                          "row_upper")) and \
        abs(back.a_matrix.to_scipy() - lp.a_matrix.to_scipy()).max() <= \
        1e-11 * abs(lp.a_matrix.to_scipy()).max()
    if not same:
        raise RuntimeError("interfaces: the .lp file does not read back "
                           "to the LP written")
    t0 = time.perf_counter()
    sol_path = os.path.join(tmp, "ipm_dense.sol")
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = subprocess.run(
        [sys.executable, "-m", "highs_tpu_torch", path, "--solution_file",
         sol_path], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=600)
    rec["cli_seconds"] = time.perf_counter() - t0
    rec["cli_rc"] = proc.returncode
    status_line = [ln for ln in proc.stdout.splitlines()
                   if ln.startswith("Model status")]
    obj_line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("Objective value")]
    rec["cli_status"] = status_line[0].split(":")[1].strip() \
        if status_line else None
    rec["cli_objective"] = float(obj_line[0].split(":")[1]) \
        if obj_line else None
    rec["cli_solution_file"] = os.path.exists(sol_path)
    log(f"interfaces: ipm_dense's LP as .lp ({rec['file_bytes']} bytes, "
        f"written and read back in {rec['write_read_seconds']:.2f} s); "
        f"python3 -m highs_tpu_torch: rc {proc.returncode} status "
        f"{rec['cli_status']} objective {rec['cli_objective']!r} in "
        f"{rec['cli_seconds']:.2f} s")
    if proc.returncode != 0 or rec["cli_status"] != "Optimal" or \
            rec["cli_objective"] is None or \
            not abs(rec["cli_objective"] - IPM_DENSE_OBJECTIVE) <= 1e-6 * \
            abs(IPM_DENSE_OBJECTIVE) or not rec["cli_solution_file"]:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise RuntimeError(f"interfaces: the CLI run {rec}")
    a = lp.a_matrix.to_scipy().tocsc()
    counts0 = ipm_counts()
    t0 = time.perf_counter()
    st, col_value, _, _, _, model_status = capi.Highs_lpCall(
        lp.num_col, lp.num_row, a.nnz, capi.kHighsMatrixFormatColwise,
        capi.kHighsObjSenseMinimize, 0.0, lp.col_cost, lp.col_lower,
        lp.col_upper, lp.row_lower, lp.row_upper, a.indptr, a.indices,
        a.data, device=device)
    sync(device)
    rec["capi_seconds"] = time.perf_counter() - t0
    rec["capi_ipm"] = ipm_count_delta(ipm_counts(), counts0)
    rec["capi_model_status"] = model_status
    rec["capi_objective"] = float(lp.col_cost @ np.asarray(col_value))
    log(f"interfaces: Highs_lpCall status {st} model status {model_status} "
        f"objective {rec['capi_objective']!r} in {rec['capi_seconds']:.2f} "
        f"s; IPM {rec['capi_ipm']}")
    if st != capi.kHighsStatusOk or model_status != 7 or \
            not abs(rec["capi_objective"] - rec["cli_objective"]) <= 1e-6 * \
            abs(IPM_DENSE_OBJECTIVE) or \
            not on_card_only(rec["capi_ipm"], device):
        raise RuntimeError(f"interfaces: Highs_lpCall {rec}")
    return rec


def ranging_part(device):
    """`getRanging()` on phase 13's solved facade (1,500 x 1,500, the
    native simplex's optimal basis), then 10 sampled nonbasic columns
    re-solved from that basis with their cost moved inside and outside
    the range.  Every nonbasic column of this LP rests at its lower
    bound 0 (c > 0, min), so its cost range is (col_cost_dn, +inf):
    col_cost_up is checked by a cost ten times higher (inside, 0
    pivots), col_cost_dn by a cost just above it (inside: 0 pivots, the
    objective the ranging predicts) and just below it (outside: at least
    one pivot)."""
    import copy
    import numpy as np
    h = SOLVED["simplex_choose"]
    lp = h.getLp()
    t0 = time.perf_counter()
    status, ranging = h.getRanging()
    rec = dict(ranging_seconds=time.perf_counter() - t0,
               valid=bool(ranging is not None and ranging.valid))
    if int(status) != 0 or not rec["valid"]:
        raise RuntimeError(f"interfaces: getRanging {status}")
    basis0 = copy.deepcopy(h.getBasis())
    obj0 = h.getObjectiveValue()
    x0 = np.asarray(h.getSolution().col_value).copy()
    cost0 = lp.col_cost.copy()
    from highs_tpu_torch.constants import HighsBasisStatus
    basic = np.array([int(s) == int(HighsBasisStatus.kBasic)
                      for s in basis0.col_status])
    nonbasic = np.nonzero(~basic)[0]
    cols = np.random.default_rng(0).choice(nonbasic, 10, replace=False)
    h.setOptionValue("presolve", "off")
    h.setOptionValue("solver", "simplex")

    def resolve(j, cost):
        h.changeColCost(j, cost)
        h.setBasis(copy.deepcopy(basis0))
        h.run()
        info = h.getInfo()
        out = (h.getModelStatus().name, max(info.simplex_iteration_count, 0),
               h.getObjectiveValue())
        h.changeColCost(j, cost0[j])
        return out

    checks = []
    t0 = time.perf_counter()
    for j in cols:
        up, dn = ranging.col_cost_up.value_[j], ranging.col_cost_dn.value_[j]
        if math.isfinite(up) or not math.isfinite(dn) or x0[j] != 0.0 or \
                not dn < cost0[j]:
            raise RuntimeError(f"interfaces: column {j} ranging ({dn}, {up})"
                               f" at x = {x0[j]}")
        delta = cost0[j] - dn
        margin = max(1e-3 * delta, 1e-6)
        predicted = ranging.col_cost_dn.objective_[j]
        for side, cost, inside in (("up", 10.0 * cost0[j] + 1.0, True),
                                   ("dn", dn + margin, True),
                                   ("dn", dn - margin, False)):
            st, pivots, obj = resolve(j, cost)
            ok = st == "kOptimal" and (
                (pivots == 0 and abs(obj - predicted) <= 1e-9 *
                 (1.0 + abs(obj0))) if inside else pivots > 0)
            checks.append(dict(col=int(j), side=side, inside=inside,
                               cost=cost, pivots=pivots, objective=obj,
                               ok=ok))
            if not ok:
                raise RuntimeError(f"interfaces: ranging check {checks[-1]}")
    rec["resolves"] = len(checks)
    rec["resolve_seconds"] = time.perf_counter() - t0
    rec["outside_pivots"] = [c["pivots"] for c in checks if not c["inside"]]
    log(f"interfaces: getRanging in {rec['ranging_seconds']:.3f} s; "
        f"{len(cols)} nonbasic columns, {len(checks)} warm re-solves in "
        f"{rec['resolve_seconds']:.2f} s: 0 pivots inside each range, "
        f"{rec['outside_pivots']} pivots outside")
    return rec


def infeasible_synth_lp(m=200, n=300, seed=4):
    """`gen_synth_lp(m, n)` with a contradictory pair of rows added:
    x0 + x1 >= 12 and x0 + x1 <= 8."""
    import numpy as np
    import scipy.sparse as sp
    from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp
    lp = synth_lp(m, n, seed=seed)
    pair = sp.csc_matrix(([1.0] * 4, ([0, 0, 1, 1], [0, 1, 0, 1])),
                         shape=(2, n))
    return HighsLp(
        num_col=n, num_row=m + 2, col_cost=lp.col_cost,
        col_lower=lp.col_lower, col_upper=lp.col_upper,
        row_lower=np.concatenate([lp.row_lower, [12.0, -np.inf]]),
        row_upper=np.concatenate([lp.row_upper, [np.inf, 8.0]]),
        a_matrix=HighsSparseMatrix.from_scipy(
            sp.vstack([lp.a_matrix.to_scipy(), pair]).tocsc()))


def iis_part(device):
    """`getIis()` (iis_strategy 1, from the dual ray) on a 202-row
    infeasible LP: its rows infeasible together, feasible with any one
    dropped."""
    import numpy as np
    import highs_tpu_torch
    lp = infeasible_synth_lp()

    def feasible_with(rows):
        work = lp.copy()
        free = np.setdiff1d(np.arange(lp.num_row), rows)
        work.row_lower[free], work.row_upper[free] = -np.inf, np.inf
        hh = highs_tpu_torch.Highs(device=device)
        hh.setOptionValue("output_flag", False)
        hh.passModel(work)
        hh.run()
        name = hh.getModelStatus().name
        if name not in ("kOptimal", "kInfeasible"):
            raise RuntimeError(f"interfaces: IIS check {name}")
        return name == "kOptimal"

    h = highs_tpu_torch.Highs(device=device)
    h.setOptionValue("output_flag", False)
    h.setOptionValue("iis_strategy", 1)
    h.passModel(lp)
    h.run()
    counts0 = ipm_counts()
    t0 = time.perf_counter()
    status, iis = h.getIis()
    sync(device)
    rec = dict(status=h.getModelStatus().name,
               iis_seconds=time.perf_counter() - t0,
               ipm=ipm_count_delta(ipm_counts(), counts0),
               rows=list(iis.row_index) if iis else None,
               cols=list(iis.col_index) if iis else None)
    t0 = time.perf_counter()
    rec["irreducible"] = bool(
        iis and iis.valid and iis.row_index and
        not feasible_with(iis.row_index) and
        all(feasible_with([k for k in iis.row_index if k != i])
            for i in iis.row_index))
    rec["check_seconds"] = time.perf_counter() - t0
    log(f"interfaces: getIis on {lp.num_row} x {lp.num_col}: rows "
        f"{rec['rows']} columns {rec['cols']} in {rec['iis_seconds']:.2f} "
        f"s (IPM {rec['ipm']}); irreducible {rec['irreducible']} "
        f"(checked in {rec['check_seconds']:.2f} s)")
    if int(status) != 0 or rec["status"] != "kInfeasible" or \
            not rec["irreducible"] or not on_card_only(rec["ipm"], device):
        raise RuntimeError(f"interfaces: getIis {rec}")
    return rec


def multiobjective_part(device):
    """A lexicographic two-objective solve of ipm_dense's LP (cost c,
    then a seeded c2 over the points within `LEX_REL_TOL` of c's
    optimum), both solves on the card; checked by one more solve of c2
    with c fixed as a row.  At a tolerance of 1e-3 or less the second
    LP's feasible set is a slab too thin for the IPM, which stalls, and
    `choose` hands it to PDLP (PERF.md §6)."""
    import numpy as np
    import scipy.sparse as sp
    import highs_tpu_torch
    from highs_tpu_torch.models.lp import HighsSparseMatrix
    from highs_tpu_torch.utils.gen_synth_lp import synth_lp
    lp = synth_lp(*IPM_DENSE_SHAPE)
    c2 = np.random.default_rng(1).uniform(-1.0, 1.0, lp.num_col)
    rel_tol = LEX_REL_TOL

    def facade(model):
        hh = highs_tpu_torch.Highs(device=device)
        hh.setOptionValue("output_flag", False)
        hh.setOptionValue("time_limit", LEX_TIME_LIMIT)
        hh.passModel(model)
        return hh

    h = facade(lp.copy())
    h.setOptionValue("blend_multi_objectives", False)
    h.passLinearObjectives([
        highs_tpu_torch.HighsLinearObjective(
            weight=1.0, priority=2, coefficients=lp.col_cost.copy(),
            abs_tolerance=0.0, rel_tolerance=rel_tol),
        highs_tpu_torch.HighsLinearObjective(
            weight=1.0, priority=1, coefficients=c2.copy(),
            abs_tolerance=0.0, rel_tolerance=0.0)])
    counts0 = ipm_counts()
    t0 = time.perf_counter()
    h.run()
    sync(device)
    rec = dict(status=h.getModelStatus().name,
               seconds=time.perf_counter() - t0,
               ipm=ipm_count_delta(ipm_counts(), counts0))
    x = np.asarray(h.getSolution().col_value)
    rec["first"] = float(lp.col_cost @ x)
    rec["second"] = float(c2 @ x)
    # the check: c alone, then c2 with c'x <= its optimum (1 + rel_tol)
    first = facade(lp.copy())
    first.run()
    v1 = first.getObjectiveValue()
    fixed = lp.copy()
    fixed.col_cost = c2.copy()
    fixed.a_matrix = HighsSparseMatrix.from_scipy(sp.vstack(
        [lp.a_matrix.to_scipy(), sp.csr_matrix(lp.col_cost)]).tocsc())
    fixed.num_row += 1
    fixed.row_lower = np.concatenate([lp.row_lower, [-np.inf]])
    fixed.row_upper = np.concatenate([lp.row_upper,
                                      [v1 + rel_tol * abs(v1)]])
    check = facade(fixed)
    check.run()
    rec.update(first_optimum=v1, check_status=check.getModelStatus().name,
               check_second=check.getObjectiveValue(),
               rows_after=h.getNumRow())
    rec["second_rel"] = abs(rec["second"] - rec["check_second"]) / max(
        1.0, abs(rec["check_second"]))
    log(f"interfaces: lexicographic solve {rec['status']} in "
        f"{rec['seconds']:.2f} s (IPM {rec['ipm']}): c'x {rec['first']!r} "
        f"(c's optimum {v1!r}), c2'x {rec['second']!r}; the check solve "
        f"{rec['check_status']} c2'x {rec['check_second']!r} (rel "
        f"{rec['second_rel']:.3e})")
    if rec["status"] != "kOptimal" or rec["check_status"] != "kOptimal" or \
            rec["ipm"]["solves"][device.type] < 2 or \
            not on_card_only(rec["ipm"], device) or \
            not abs(v1 - IPM_DENSE_OBJECTIVE) <= 1e-6 * abs(v1) or \
            not rec["first"] <= v1 + 2 * rel_tol * abs(v1) or \
            not rec["second_rel"] <= 1e-6 or rec["rows_after"] != lp.num_row:
        raise RuntimeError(f"interfaces: multi-objective {rec}")
    return rec


def interfaces_phase(device):
    """Phase 17: the .lp file, the CLI and the C API on ipm_dense's LP,
    ranging, an IIS and a lexicographic solve, on the card."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for name, part in (("lp_file", lambda: lp_file_part(device, tmp)),
                           ("ranging", lambda: ranging_part(device)),
                           ("iis", lambda: iis_part(device)),
                           ("multiobjective",
                            lambda: multiobjective_part(device))):
            t0 = time.perf_counter()
            out[name] = part()
            out[name]["part_seconds"] = time.perf_counter() - t0
            log(f"interfaces: {name} {out[name]['part_seconds']:.1f} s")
    return out


def mesh_raises(device):
    """A multi-axis tpu_mesh_shape, and a mesh of more cards than the
    machine has, raise ValueError through the facade on the card."""
    import torch
    import highs_tpu_torch
    from highs_tpu_torch.utils.gen_block_lp import block_lp

    out = {}
    for spec in ("4x2", str(torch.cuda.device_count() + 1)):
        h = highs_tpu_torch.Highs(device=device)
        h.setOptionValue("output_flag", False)
        h.setOptionValue("solver", "hipdlp")
        h.setOptionValue("tpu_mesh_shape", spec)
        h.passModel(block_lp(nblocks=2))
        try:
            h.run()
        except ValueError as exc:
            out[spec] = str(exc)
            log(f"mesh: tpu_mesh_shape {spec!r} raises ValueError: {exc}")
            continue
        raise RuntimeError(f"tpu_mesh_shape {spec!r} did not raise")
    return out


def mesh_products(a, device, mesh4):
    """K x and K' y of block64k's operator row-sharded in block-CSR over
    4 shards of one mesh, against the unsharded kernel, in f32 and f64:
    the error relative to ||(|A| |x|)||_inf, 4 launches a product, and
    the cold times of both.  Returns (records, the f32 4-shard operator,
    the f32 unsharded operator)."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.parallel import shard_ops
    from highs_tpu_torch.tools.card import time_ms

    t0 = time.perf_counter()
    one64 = block_csr.from_scipy_block_csr(a, dtype=torch.float64,
                                           device=device)
    four64, m_pad = shard_ops.make_row_sharded(a, mesh4, "rows",
                                               fmt="blockcsr",
                                               dtype=torch.float64)
    log(f"mesh: block64k in block-CSR, unsharded "
        f"({one64.fwd.blocks.shape[0]} tiles of K, "
        f"{one64.bwd.blocks.shape[0]} of K') and in 4 row shards "
        f"({[op.fwd.blocks.shape[0] for op in four64.shards]} of K, "
        f"{[op.bwd.blocks.shape[0] for op in four64.shards]} of K'), "
        f"built in {time.perf_counter() - t0:.1f} s")
    abs_one = block_csr.BlockCsrMatrix(
        one64.fwd._replace(blocks=one64.fwd.blocks.abs()),
        one64.bwd._replace(blocks=one64.bwd.blocks.abs()))
    rng = np.random.default_rng(9)
    records, ops = [], {}
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        if dtype == torch.float64:
            one, four = one64, four64
        else:
            one = block_csr.BlockCsrMatrix(
                one64.fwd._replace(blocks=one64.fwd.blocks.float()),
                one64.bwd._replace(blocks=one64.bwd.blocks.float()))
            four = four64.astype_values(torch.float32)
        ops[name] = (four, one)
        for direction in ("mv", "rmv"):
            x = torch.as_tensor(rng.standard_normal(a.shape[1]),
                                dtype=dtype, device=device)
            before = block_csr.LAUNCHES
            got = getattr(four, direction)(x)
            sync(device)
            launches = block_csr.LAUNCHES - before
            want = getattr(one, direction)(x)
            scale = getattr(abs_one, direction)(
                x.abs().double()).abs().max().item()
            err, rel = relative_error(got, want, scale)
            tol = TOLERANCE[name]
            rec = dict(
                dtype=name, direction=direction, shards=len(four.shards),
                launches_per_product=launches, max_abs_err=err, rel_err=rel,
                tolerance=tol,
                ok=bool(math.isfinite(err) and rel <= tol and
                        (device.type != "cuda" or launches == 4)),
                sharded_ms=time_ms(lambda v: getattr(four, direction)(v),
                                   device, x),
                unsharded_ms=time_ms(lambda v: getattr(one, direction)(v),
                                     device, x))
            log(f"mesh {name} {direction}: 4 shards against the unsharded "
                f"kernel max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}), "
                f"{launches} launches; cold ms 4 shards "
                f"{rec['sharded_ms']:.4f}, unsharded "
                f"{rec['unsharded_ms']:.4f}")
            records.append(rec)
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"the 4-shard block-CSR products disagree with "
                           f"the unsharded kernel: {bad}")
    return records, ops["float32"]


def mesh_solve_pdhg(a, b, c, upper, device, four, one):
    """One solve_pdhg of block64k (min c'x, Ax >= b, 0 <= x <= upper,
    unscaled, f32, tolerance 1e-4) on the 4-shard operator and on the
    unsharded one: status, iterations, seconds, launches."""
    import numpy as np
    import torch
    from highs_tpu_torch.ops import block_csr
    from highs_tpu_torch.solvers.pdlp.pdhg import (PdhgProblem,
                                                   PdhgSettings, solve_pdhg)

    m, n = a.shape
    f32 = torch.float32

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=f32,
                               device=device)
    base = PdhgProblem(
        k_op=one, b=t(b), c=t(c), lo=t(np.zeros(n)), up=t(upper),
        is_eq=t(np.zeros(m)), lo_fin=t(np.ones(n)), up_fin=t(np.ones(n)),
        inv_row_scale=t(np.ones(m)), inv_col_scale=t(np.ones(n)),
        norm_b=t(np.linalg.norm(b)), norm_c=t(np.linalg.norm(c)))
    out = {}
    for name, op in (("unsharded", one), ("4 shards", four)):
        settings = PdhgSettings(eps_optimal=1e-4, dtype="float32",
                                iteration_limit=40000, time_limit=120.0)
        before = block_csr.LAUNCHES
        t0 = time.perf_counter()
        res = solve_pdhg(base._replace(k_op=op), n, m, settings)
        sync(device)
        seconds = time.perf_counter() - t0
        launches = block_csr.LAUNCHES - before
        out[name] = dict(status=res.status.name, iterations=res.iterations,
                         restarts=res.restarts, seconds=seconds,
                         primal_obj=res.primal_obj, launches=launches,
                         rel_gap=res.rel_gap)
        log(f"mesh solve_pdhg {name}: {res.status.name} in "
            f"{res.iterations} iterations ({res.restarts} restarts), "
            f"{seconds:.2f} s, primal obj {res.primal_obj!r} rel gap "
            f"{res.rel_gap:.3e}, {launches} block-CSR launches")
    for name, r in out.items():
        if r["status"] != "kOptimal":
            raise RuntimeError(f"solve_pdhg on block64k, {name}: "
                               f"{r['status']}")
    return out


def mesh_phase(device, a, b, c, anchor, block64k_iters):
    """Phase 18: PDLP over a mesh.  block64k through `Highs().run()` with
    tpu_mesh_shape the machine's card count; the 4-shard products and a
    solve_pdhg over 4 shards of one card; dryrun_multichip(8) over the
    card; the shapes the option refuses."""
    import numpy as np
    import torch
    from highs_tpu_torch.parallel import mesh, shard_ops
    from highs_tpu_torch.parallel.dryrun import dryrun_multichip
    from highs_tpu_torch.utils.gen_block_lp import UPPER

    d = torch.cuda.device_count()
    upper = np.full(a.shape[1], UPPER)
    reductions = shard_ops.REDUCTIONS
    launches, iters, seconds, walls = solve_phase(
        "mesh_block64k", a, b, c, upper,
        {"tpu_matrix_format": "blockcsr", "tpu_mesh_shape": str(d)},
        anchor, ["block_csr_spmv"], device)
    per_iter = launches["block_csr_spmv"] / max(iters, 1)
    log(f"mesh_block64k: mesh of {d} card(s), {iters} iterations against "
        f"phase 7's {block64k_iters}; {per_iter:.3f} block-CSR launches "
        f"per iteration (need >= {2 * d}); {shard_ops.REDUCTIONS - reductions}"
        f" sums of several partials")
    if per_iter < 2 * d:
        raise RuntimeError(f"mesh_block64k: {per_iter:.3f} launches per "
                           f"iteration on a mesh of {d}")
    raised = mesh_raises(device)
    mesh4 = mesh.make_mesh((4,), devices=[device] * 4)
    products, (four, one) = mesh_products(a, device, mesh4)
    pdhg_runs = mesh_solve_pdhg(a, b, c, upper, device, four, one)
    del four, one
    t0 = time.perf_counter()
    dry = dryrun_multichip(8, devices=[device] * 8)
    log(f"mesh: dryrun_multichip(8) over one card in "
        f"{time.perf_counter() - t0:.1f} s: {dry}")
    return {"cards": d, "block64k": dict(
                iterations=iters, seconds=seconds,
                phase7_iterations=block64k_iters,
                launches=launches["block_csr_spmv"],
                launches_pdhg_primal_step=launches["pdhg_primal_step"],
                launches_pdhg_dual_step=launches["pdhg_dual_step"],
                launches_per_iteration=per_iter, pdlp=walls),
            "raises": raised, "products": products,
            "solve_pdhg": pdhg_runs, "dryrun": dry}


class plain_chains:
    """The steps' plain chains in place of the step operators, for a
    comparison run: `pdhg.py` calls `ops/pdhg_step.py` `primal_step` and
    `dual_step` by their module's names."""

    def __enter__(self):
        from highs_tpu_torch.ops import pdhg_step
        self.kept = pdhg_step.primal_step, pdhg_step.dual_step
        pdhg_step.primal_step = pdhg_step.primal_step_plain
        pdhg_step.dual_step = pdhg_step.dual_step_plain
        return self

    def __exit__(self, *exc):
        from highs_tpu_torch.ops import pdhg_step
        pdhg_step.primal_step, pdhg_step.dual_step = self.kept
        return False


def window_check(problem, device, n_windows=4):
    """One captured restart window replayed n_windows times against the
    eager windows with the kernels and with the plain chain, from the
    same start on `problem`: state, restart control and metrics."""
    import math as _m
    import torch
    from highs_tpu_torch.solvers.capture import cuda_graph, eager_recorder
    from highs_tpu_torch.solvers.pdlp import graph, pdhg
    from highs_tpu_torch.tools.step_bench import same_bits

    dtype = problem.c.dtype
    n, m = problem.c.shape[0], problem.b.shape[0]
    x = torch.minimum(torch.clamp_min(problem.lo, 0.0), problem.up)
    y = torch.zeros(m, dtype=dtype, device=device)
    eta = 0.998 / float(pdhg.power_method(problem.k_op, n, 30, dtype,
                                          device))
    state = pdhg.PdhgState(
        x=x, y=y, x_pd=x, y_pd=y, x_anchor=x, y_anchor=y,
        aty=problem.k_op.rmv(y),
        k=torch.zeros((), dtype=torch.int32, device=device),
        eta=torch.tensor(eta, dtype=dtype, device=device),
        omega=torch.tensor(1.0, dtype=dtype, device=device))

    def ctl():
        return pdhg.RestartCtl(
            fpe_init=torch.tensor(_m.inf, dtype=dtype, device=device),
            fpe_last=torch.tensor(_m.inf, dtype=dtype, device=device),
            fresh=torch.ones((), dtype=torch.bool, device=device),
            total_k=torch.zeros((), dtype=torch.int32, device=device),
            n_restarts=torch.zeros((), dtype=torch.int32, device=device))
    theta = torch.tensor(0.5, dtype=dtype, device=device)
    runner = graph.GraphBlocks(problem, 40, cuda_graph
                               if device.type == "cuda"
                               else eager_recorder)
    got = runner.windows(state, ctl(), n_windows, 1.0, 40, theta, None)
    got = [type(part)(*(t.clone() for t in part)) for part in got]
    runner.close()
    eager = pdhg.pdhg_block_windows(problem, state, ctl(), n_windows, 1.0,
                                    40, theta)
    with plain_chains():
        plain = pdhg.pdhg_block_windows(problem, state, ctl(), n_windows,
                                        1.0, 40, theta)
    sync(device)
    flat = [t for part in got for t in part]
    out = dict(
        windows=n_windows,
        graph_equals_eager=same_bits(flat, [t for p in eager for t in p]),
        graph_equals_plain=same_bits(flat, [t for p in plain for t in p]),
        restarts=int(got[1].n_restarts), primal_res=float(got[2].primal_res))
    log(f"graphs: {n_windows} captured windows on block64k's scaled "
        f"problem: equal to the eager windows {out['graph_equals_eager']}, "
        f"to the plain chain {out['graph_equals_plain']} ({out['restarts']} "
        f"restarts, primal residual {out['primal_res']!r})")
    if not (out["graph_equals_eager"] and out["graph_equals_plain"]):
        raise RuntimeError(f"captured window differs: {out}")
    return out


def graphs_phase(device):
    """Phase 19: the step kernels (bit for bit at the PDLP and odd
    widths, timed at the PDLP widths, an offset view refused, their
    registers and load order), a captured window, and the wall, device
    ms by kernel and busy share of a step in the graphs."""
    from highs_tpu_torch.tools import profile_block64k, step_bench

    records = step_bench.step_kernel_records(device)
    odd = step_bench.step_kernel_records(device, step_bench.ODD_WIDTHS,
                                         timed=False)
    refused = step_bench.offset_view_refused(device)
    sass = step_bench.kernel_sass()
    for name, r in sass.items():
        log(f"graphs SASS {name}: {r['registers']} registers, "
            f"{r['loads']} global loads, {r['loads_after_division']} after "
            f"the first division")
    late = [name for name, r in sass.items() if r["loads_after_division"]]
    if late:
        raise RuntimeError(f"step kernels load after a division: {late}")
    window = window_check(FIRST_ROUND["block64k"], device)
    busy = {}
    for name, problem, mode in (
            ("block64k", FIRST_ROUND["block64k"], "halpern"),
            ("synth50k", FIRST_ROUND["synth50k"], "halpern"),
            ("block64k_avg", FIRST_ROUND["block64k"], "average")):
        busy[name] = profile_block64k.profile_blocks(problem, device, mode)
        w = busy[name]
        if w["by_kernel"] is None:
            raise RuntimeError("the profiler recorded no kernel of the "
                               "graphs")
        log(f"graphs: {name} {mode} blocks, graphs on: wall "
            f"{w['wall_ms_per_step']:.5f} ms a step (op by op "
            f"{w['eager_wall_ms_per_step']:.4f}), device "
            f"{w['device_ms_per_step']} ms a step {w['by_kernel']}, busy "
            f"share {w['device_busy_share']}, kernels a step "
            f"{w['kernels_per_step']}, launches a step "
            f"{w['launches_per_step']}")
    FIRST_ROUND.clear()
    return records, {"window": window, "busy": busy, "odd_widths": odd,
                     "offset_view": refused, "sass": sass}


def headline(records, launches, extra=None):
    """One kernel's line: the f32 records (the main path's type), the
    mean of its directions."""
    path = [r for r in records if r["dtype"] == "float32"]

    def mean(key):
        vals = [r.get(key) for r in path]
        return None if None in vals else statistics.fmean(vals)
    out = {"launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in path),
           "ms": mean("ms"), "plain_ms": mean("plain_ms"),
           "bound_ms": mean("bound_ms"), "bound_by": path[0]["bound_by"],
           "library_ms": mean("library_ms"),
           "ok": all(r["ok"] for r in records), "dtype": "float32"}
    out.update(extra or {})
    out["variants"] = records
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import numpy as np
    from highs_tpu_torch.ops import (block_csr, cuda_build, onehot_spmv,
                                     pdhg_step, segment_sum)
    from highs_tpu_torch.tools import gather_probe
    from highs_tpu_torch.tools.card import card_line
    from highs_tpu_torch.utils.gen_block_lp import UPPER, gen_block_lp

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    block_csr._lib()
    onehot_spmv._lib()
    gather_probe._lib()
    pdhg_step._lib()
    segment_sum._lib()
    for name, (secs, out) in cuda_build.BUILD_INFO.items():
        log(f"build {name}: nvcc {secs:.2f} s")
        for line in out.strip().splitlines():
            log(f"  {line}")
    log(f"build: kernels ready in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    a64, b64, c64 = gen_block_lp()
    log(f"block64k: {a64.shape[0]}x{a64.shape[1]}, {a64.nnz} nonzeros, "
        f"generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    a50, b50, c50, a50_pad = padded_synth50k()
    log(f"synth50k: {a50.shape[0]}x{a50.shape[1]}, {a50.nnz} nonzeros, "
        f"generated in {time.perf_counter() - t0:.1f} s")

    phase_s = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    with open(os.path.join(HERE, "BASELINE_MEASURED.json")) as f:
        block64k_anchor = json.load(f)["block64k_anchor"]["objective"]
    bc_records = run("blockcsr", blockcsr_phase, a64, device)
    oh_records = run("onehot", onehot_phase, a50_pad, device)
    probe_records = run("probe", probe_phase, device)
    check_timings({"block_csr_spmv": bc_records, "onehot_spmv": oh_records,
                   "gather_probe": probe_records})
    run("small", small_phase, device)
    formats = run("formats", formats_phase, device)
    step_kernels = ["pdhg_primal_step", "pdhg_dual_step"]
    bc_launches, bc_iters, _, bc_walls = run(
        "block64k", solve_phase, "block64k", a64, b64, c64,
        np.full(a64.shape[1], UPPER), {}, block64k_anchor,
        ["block_csr_spmv"] + step_kernels, device, True)
    oh_launches, oh_iters, oh_seconds, oh_walls = run(
        "synth50k", solve_phase, "synth50k", a50, b50, c50,
        np.full(a50.shape[1], UPPER),
        {"solver": "hipdlp", "tpu_matrix_format": "onehot"},
        SYNTH50K_OBJECTIVE, ["onehot_spmv"] + step_kernels, device, True)

    ipm = {"ipm_dense": run("ipm_dense", ipm_dense_phase, device),
           "ipm_sparse": run("ipm_sparse", ipm_sparse_phase, device)}
    avg_launches, avg_iters, avg_seconds, avg_walls = run(
        "block64k_avg", solve_phase, "block64k_avg", a64, b64, c64,
        np.full(a64.shape[1], UPPER), {"solver": "pdlp"}, block64k_anchor,
        ["block_csr_spmv"] + step_kernels, device)
    batch = run("batch", batch_phase, device)
    simplex = run("simplex", simplex_phase, device)
    qp = run("qp", qp_phase, device)
    mip = run("mip", mip_phase, device)
    mip_batch = run("mip_batch", mip_batch_phase, device,
                    mip["mip_setcover"]["seconds"])
    interfaces = run("interfaces", interfaces_phase, device)
    mesh = run("mesh", mesh_phase, device, a64, b64, c64, block64k_anchor,
               bc_iters)
    step_records, graphs = run("graphs", graphs_phase, device)
    check_timings({"pdhg_step": step_records})
    scaling = run("scaling", scaling_phase, device,
                  {"block64k": (a64, b64), "synth50k": (a50, b50)})
    check_timings({"segment_sum": scaling["segment_sum"]})
    presolve = run("presolve", presolve_phase, device)
    check_timings({"segment_signed_dot": presolve["signed_dot"]})
    signed_paths = {"block64k": bc_launches["segment_signed_dot"],
                    "synth50k": oh_launches["segment_signed_dot"],
                    "ipm20k": ipm["ipm_dense"]["launches"][
                        "segment_signed_dot"]}
    if not all(signed_paths.values()):
        raise RuntimeError(f"presolve's activity bounds did not launch the "
                           f"signed mode on every LP path: {signed_paths}")

    probe_head = [r for r in probe_records
                  if r["name"] == gather_probe.SHAPES[0][0]]
    lines = {
        "block_csr_spmv": headline(
            bc_records, bc_launches["block_csr_spmv"],
            {"path": "block64k", "pdlp_iterations": bc_iters,
             "paths": {"block64k": bc_launches["block_csr_spmv"],
                       "block64k_avg": avg_launches["block_csr_spmv"],
                       "mesh_block64k": mesh["block64k"]["launches"]},
             "block64k_avg_pdlp_iterations": avg_iters}),
        "gather_probe": headline(
            probe_head, 0,
            {"path": None, "shape": gather_probe.SHAPES[0][0],
             "library": "torch.gather (also its plain version)",
             "all_shapes": probe_records}),
        "onehot_spmv": headline(
            oh_records, oh_launches["onehot_spmv"],
            {"path": "synth50k", "pdlp_iterations": oh_iters,
             "library": "torch.sparse_csr_tensor @ x of the same matrix"}),
    }
    for name in step_kernels:
        head = [r for r in step_records
                if r["name"] == name and r["path"] == "block64k" and
                r["mode"] == "halpern" and not r["y_lo"]]
        lines[name] = headline(head, bc_launches[name], {
            "path": "block64k", "pdlp_iterations": bc_iters,
            "in_graph_ms_per_step": {
                cell: w["by_kernel"][name]
                for cell, w in graphs["busy"].items()},
            "paths": {"block64k": bc_launches[name],
                      "synth50k": oh_launches[name],
                      "block64k_avg": avg_launches[name],
                      "mesh_block64k": mesh["block64k"]["launches_" + name],
                      "batch": batch["launches"][name]},
            "library": None,
            "all_variants": [r for r in step_records if r["name"] == name],
            "batch_variants": [r for r in batch["step_records"]
                               if r["name"] == name and "ms" in r]})
    lines["gather_probe"]["variants"] = probe_head
    seg_records = scaling["segment_sum"]
    lines["segment_sum"] = {
        "launches": bc_launches["segment_sum"], "dtype": "float64",
        "ok": all(r["ok"] for r in seg_records),
        "ms": statistics.fmean(r["ms"] for r in seg_records),
        "bound_ms": statistics.fmean(r["bound_ms"] for r in seg_records),
        "bound_by": seg_records[0]["bound_by"], "path": "block64k",
        "paths": {"block64k": bc_launches["segment_sum"],
                  "synth50k": oh_launches["segment_sum"]},
        "library": "torch.segment_reduce (rows; per call)",
        "variants": seg_records}
    signed_records = presolve["signed_dot"]
    lines["segment_signed_dot"] = {
        "launches": bc_launches["segment_signed_dot"], "dtype": "float64",
        "ok": all(r["ok"] and r["scipy_ok"] is not False
                  for r in signed_records),
        "ms": signed_records[0]["ms"],
        "plain_call_ms": signed_records[0]["plain_call_ms"],
        "bound_ms": signed_records[0]["bound_ms"],
        "bound_by": signed_records[0]["bound_by"], "path": "block64k",
        "paths": signed_paths, "library": None,
        "variants": signed_records}
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **lines[name]}
        for name in ("block_csr_spmv", "onehot_spmv", "gather_probe",
                     *step_kernels, "segment_sum", "segment_signed_dot")],
        "pdlp_walls": {"block64k": bc_walls, "synth50k": oh_walls,
                       "block64k_avg": avg_walls},
        "graphs": graphs,
        "formats": formats, "synth50k_seconds": oh_seconds, "ipm": ipm,
        "block64k_avg_seconds": avg_seconds, "batch": batch,
        "simplex": simplex, "qp": qp, "mip": mip, "mip_batch": mip_batch,
        "interfaces": interfaces, "mesh": mesh, "scaling": scaling,
        "presolve": {k: v for k, v in presolve.items()
                     if k != "signed_dot"},
        "phase_seconds": phase_s,
        "total_seconds": time.perf_counter() - t_start}
    log(json.dumps(summary))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
