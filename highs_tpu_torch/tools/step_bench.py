"""The two PDHG step kernels held against their plain chains, timed, and
read from their build.

Shared by `chip_smoke.py` (phase 19) and `tools/step_turns.py`:

- `step_kernel_records`: both kernels (`ops/pdhg_step.py`) against
  `primal_step_plain` and `dual_step_plain`, bit for bit, f32 and f64,
  Halpern and average mode, with and without y_lo, at the PDLP widths
  (`STEP_WIDTHS`) with their cold and per-call times beside the plain
  chains' and the byte bound, or at widths off the 16-byte grid
  (`ODD_WIDTHS`) for the bits alone;
- `batched_step_records`: both kernels' batched launches under
  `torch.func.vmap` (the operators' vmap rule) against the vmapped plain
  chains, bit for bit, at the batch's sizes (`BATCHES`, `BATCH_WIDTHS`),
  f32 and f64, both modes, with and without y_lo, some lanes frozen
  (eta = 0), one launch a vmapped call; timed at the batch phase's
  (16, 2,048) (`BATCH_TIMED`);
- `offset_view_refused`: both wrappers refuse a view one element into
  its storage;
- `kernel_sass`: each kernel's registers, and whether a global load
  follows its first division, from the built library's SASS.
"""
from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import torch

from ..ops import cuda_build, pdhg_step
from .card import bound_ms, call_ms, time_ms

# PDHG widths of the step kernels: block64k and synth50k padded
STEP_WIDTHS = {"block64k": 65536, "synth50k": 50176}
# widths off the PDLP grid, checked bit for bit only: shorter than one
# 16-byte vector, scalar tails of 1 to 3 elements, one past block64k
ODD_WIDTHS = {f"odd{n}": n for n in (1, 3, 5, 127, 65537)}
# the batched launches: instances and widths checked bit for bit, and the
# (instances, width) of chip_smoke.py's batch phase, also timed
BATCHES = (1, 3, 16)
BATCH_WIDTHS = (128, 2048)
BATCH_TIMED = (16, 2048)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_inputs(n, m, dtype, with_y_lo, device, seed):
    """Inputs of the two step kernels at widths (n, m): seeded vectors
    with infinite and finite bounds, a quarter equality rows, the step
    size, primal weight and step count of a run."""
    rng = np.random.default_rng(seed)

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    lo = np.where(rng.uniform(size=n) < 0.8, 0.0, -np.inf)
    up = np.where(rng.uniform(size=n) < 0.6, rng.uniform(1, 5, n), np.inf)
    is_eq = (rng.uniform(size=m) < 0.25).astype(np.float64)
    return dict(
        x=t(np.clip(rng.standard_normal(n), lo, up)),
        c=t(rng.standard_normal(n)), aty=t(rng.standard_normal(n)),
        lo=t(lo), up=t(up),
        x_anchor=t(rng.standard_normal(n)), y=t(rng.standard_normal(m)),
        b=t(rng.standard_normal(m)), ax_r=t(rng.standard_normal(m)),
        is_eq=t(is_eq),
        y_lo=t(-rng.uniform(0, 0.5, m)) if with_y_lo else None,
        y_anchor=t(rng.standard_normal(m)), eta=t(0.0123), omega=t(1.7),
        k=t(37, torch.int32))


def same_bits(got, want) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}

    def bits(t):
        return t.view(ints[t.dtype]) if t.dtype in ints else t
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and
        torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def step_kernel_records(device, widths=STEP_WIDTHS, timed=True):
    """The two step kernels against their plain chains at `widths`, with
    times where `timed`; raises if any output differs in a bit."""
    records = []
    for path, width in widths.items():
        for dtype in (torch.float32, torch.float64):
            item = torch.tensor([], dtype=dtype).element_size()
            for mode in pdhg_step.MODES:
                for with_y_lo in (False, True):
                    v = step_inputs(width, width, dtype, with_y_lo, device,
                                    seed=len(records))
                    gamma = 1.0 if mode == "average" else 0.9
                    p_args = (v["x"], v["c"], v["aty"], v["lo"], v["up"],
                              v["x_anchor"], v["eta"], v["omega"], v["k"],
                              gamma, mode)
                    d_args = (v["y"], v["b"], v["ax_r"], v["is_eq"],
                              v["y_lo"], v["y_anchor"], v["eta"],
                              v["omega"], v["k"], gamma, mode)
                    cases = [("pdhg_dual_step", pdhg_step.dual_step,
                              pdhg_step.dual_step_plain, d_args,
                              (5 + with_y_lo + 2) * width * item +
                              2 * item + 8)]
                    if not with_y_lo:  # the primal half has no y_lo
                        cases.insert(0, (
                            "pdhg_primal_step", pdhg_step.primal_step,
                            pdhg_step.primal_step_plain, p_args,
                            9 * width * item + 2 * item + 4))
                    for name, kernel, plain, args, nbytes in cases:
                        before = pdhg_step.LAUNCHES[name]
                        got = kernel(*args)
                        _sync(device)
                        if device.type == "cuda" and \
                                pdhg_step.LAUNCHES[name] != before + 1:
                            raise RuntimeError(f"{name} did not launch its "
                                               "kernel on a CUDA tensor")
                        want = plain(*args)
                        equal = same_bits(got, want)
                        err = max((g.double() - w.double()).abs().nan_to_num(
                            0.0).max().item() for g, w in zip(got, want)
                            if g.is_floating_point())
                        rec = dict(
                            name=name, path=path, width=width,
                            dtype=str(dtype).replace("torch.", ""),
                            mode=mode, y_lo=with_y_lo, equal_bits=equal,
                            max_abs_err=err, ok=equal)
                        records.append(rec)
                        if not timed:
                            _log(f"graphs {name} {path} {rec['dtype']} "
                                 f"{mode} y_lo {with_y_lo}: equal bits "
                                 f"{equal}")
                            continue
                        # a handful of operations an element: bytes bind
                        b_ms, b_by = bound_ms(nbytes, 12.0 * width, dtype)
                        rec.update(
                            ms=time_ms(kernel, device, *args),
                            call_ms=call_ms(lambda: kernel(*args), device),
                            plain_ms=time_ms(plain, device, *args),
                            library_ms=None, bound_ms=b_ms, bound_by=b_by)
                        _log(f"graphs {name} {path} {rec['dtype']} {mode} "
                             f"y_lo {with_y_lo}: equal bits {equal} "
                             f"(max abs diff {err:.3e}) kernel_ms "
                             f"{rec['ms']:.4f} (per call "
                             f"{rec['call_ms']:.4f}) plain_ms "
                             f"{rec['plain_ms']:.4f} bound_us "
                             f"{b_ms * 1e3:.2f} ({b_by})")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"step kernels differ from their plain chains: "
                           f"{bad}")
    return records


def batch_inputs(b, n, dtype, with_y_lo, device, seed):
    """`step_inputs` for b instances of width n, stacked: (b, n)
    vectors, each instance its own step size, primal weight and step
    count, and every third lane from the second on frozen (eta = 0, as
    `batch.freeze_instances` leaves a finished instance)."""
    lanes = [step_inputs(n, n, dtype, with_y_lo, "cpu", seed + i)
             for i in range(b)]
    out = {name: None if lanes[0][name] is None else
           torch.stack([v[name] for v in lanes]).to(device)
           for name in lanes[0]}
    rng = np.random.default_rng(seed)
    eta = rng.uniform(0.005, 0.02, b)
    eta[1::3] = 0.0
    out["eta"] = torch.as_tensor(eta, dtype=dtype, device=device)
    out["omega"] = torch.as_tensor(rng.uniform(0.5, 2.0, b), dtype=dtype,
                                   device=device)
    out["k"] = torch.as_tensor(rng.integers(0, 200, b), dtype=torch.int32,
                               device=device)
    return out


def _vmapped(fn, y_lo, gamma, mode):
    """`fn` (a step half with y_lo in fifth place, or the primal half
    where `y_lo` is False) under `torch.func.vmap` over its tensors."""
    if y_lo is False:
        return torch.func.vmap(lambda *a: fn(*a, gamma, mode))
    if y_lo is None:
        return torch.func.vmap(
            lambda y, b, ax, eq, anc, eta, om, k: fn(
                y, b, ax, eq, None, anc, eta, om, k, gamma, mode))
    return torch.func.vmap(lambda *a: fn(*a, gamma, mode))


def batched_step_records(device, batches=BATCHES, widths=BATCH_WIDTHS,
                         timed=BATCH_TIMED):
    """Both kernels' batched launches under `torch.func.vmap` against
    the vmapped plain chains, bit for bit, over `batches` x `widths`;
    cold times (`time_ms` of the vmapped call) at `timed` (instances,
    width) beside the vmapped plain chain's and the byte bound.  Raises
    if an output differs in a bit or a vmapped call is not one launch on
    a card."""
    records = []
    for b in batches:
        for width in widths:
            for dtype in (torch.float32, torch.float64):
                item = torch.tensor([], dtype=dtype).element_size()
                for mode in pdhg_step.MODES:
                    gamma = 1.0 if mode == "average" else 0.9
                    for with_y_lo in (False, True):
                        v = batch_inputs(b, width, dtype, with_y_lo, device,
                                         seed=len(records))
                        scalars = (v["eta"], v["omega"], v["k"])
                        d_args = (v["y"], v["b"], v["ax_r"], v["is_eq"]) + \
                            ((v["y_lo"],) if with_y_lo else ()) + \
                            (v["y_anchor"],) + scalars
                        y_lo = v["y_lo"] if with_y_lo else None
                        # bytes: the vectors read and written, the
                        # scalars read, k + 1 written
                        cases = [("pdhg_dual_step", pdhg_step.dual_step,
                                  pdhg_step.dual_step_plain, d_args, y_lo,
                                  b * ((7 + with_y_lo) * width * item +
                                       2 * item + 8))]
                        if not with_y_lo:
                            cases.insert(0, (
                                "pdhg_primal_step", pdhg_step.primal_step,
                                pdhg_step.primal_step_plain,
                                (v["x"], v["c"], v["aty"], v["lo"],
                                 v["up"], v["x_anchor"]) + scalars, False,
                                b * (9 * width * item + 2 * item + 4)))
                        for name, kernel, plain, args, lo, nbytes in cases:
                            fn = _vmapped(kernel, lo, gamma, mode)
                            before = pdhg_step.LAUNCHES[name]
                            got = fn(*args)
                            _sync(device)
                            launches = pdhg_step.LAUNCHES[name] - before
                            want = _vmapped(plain, lo, gamma, mode)(*args)
                            equal = same_bits(got, want)
                            err = max((g.double() - w.double()).abs()
                                      .nan_to_num(0.0).max().item()
                                      for g, w in zip(got, want)
                                      if g.is_floating_point())
                            rec = dict(
                                name=name, batch=b, width=width,
                                dtype=str(dtype).replace("torch.", ""),
                                mode=mode, y_lo=with_y_lo,
                                frozen=int((v["eta"] == 0).sum()),
                                equal_bits=equal, max_abs_err=err,
                                launches=launches,
                                ok=equal and (device.type != "cuda" or
                                              launches == 1))
                            records.append(rec)
                            if (b, width) == timed:
                                b_ms, b_by = bound_ms(
                                    nbytes, 12.0 * b * width, dtype)
                                rec.update(
                                    ms=time_ms(fn, device, *args),
                                    plain_ms=time_ms(
                                        _vmapped(plain, lo, gamma, mode),
                                        device, *args),
                                    library_ms=None, bound_ms=b_ms,
                                    bound_by=b_by)
                            _log(f"batch step {name} b {b} n {width} "
                                 f"{rec['dtype']} {mode} y_lo {with_y_lo} "
                                 f"frozen {rec['frozen']}: equal bits "
                                 f"{equal}, launches {launches}" +
                                 (f", kernel_ms {rec['ms']:.5f} plain_ms "
                                  f"{rec['plain_ms']:.5f} bound_ms "
                                  f"{rec['bound_ms']:.5f} ({b_by})"
                                  if "ms" in rec else ""))
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"batched step kernels differ from the vmapped "
                           f"plain chains: {bad}")
    return records


def offset_view_refused(device):
    """Both step wrappers refuse a vector that starts one element inside
    its storage (the kernels move 16-byte words), launching nothing:
    returns their messages."""
    v = step_inputs(65, 65, torch.float32, False, device, seed=0)
    a = {name: t[:64] if t.dim() else t for name, t in v.items()
         if t is not None}
    calls = {
        "pdhg_primal_step": lambda: pdhg_step.primal_step(
            v["x"][1:], a["c"], a["aty"], a["lo"], a["up"], a["x_anchor"],
            a["eta"], a["omega"], a["k"], 0.9, "halpern"),
        "pdhg_dual_step": lambda: pdhg_step.dual_step(
            v["y"][1:], a["b"], a["ax_r"], a["is_eq"], None, a["y_anchor"],
            a["eta"], a["omega"], a["k"], 0.9, "halpern")}
    out = {}
    for name, call in calls.items():
        before = pdhg_step.LAUNCHES[name]
        try:
            call()
        except ValueError as exc:
            out[name] = str(exc)
        if name not in out or pdhg_step.LAUNCHES[name] != before:
            raise RuntimeError(f"{name} took a view offset by one element")
        _log(f"graphs {name}: a view offset by one element refused: "
             f"{out[name]}")
    return out


def kernel_sass(lib=None) -> dict:
    """Per step kernel of the library `lib` (a build of
    csrc/pdhg_step.cu; by default this tree's): its registers
    (`cuobjdump -res-usage`), and in its SASS (`cuobjdump -sass`) the
    global loads (LDG) and how many of them follow its first division
    (MUFU.RCP, the start of __fdiv_rn / __ddiv_rn; None where it divides
    nowhere)."""
    lib = lib or cuda_build.library_path("pdhg_step")
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, str(lib)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
    regs = dict(re.findall(r"Function (\S+?):\s+REG:(\d+)",
                           dump("-res-usage")))
    out = {}
    for part in dump("-sass").split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        name = name.strip()
        if "primal_kernel" not in name and "dual_kernel" not in name:
            continue
        lines = body.splitlines()
        first_div = next((i for i, line in enumerate(lines)
                          if re.search(r"\bMUFU\.RCP", line)), None)
        loads = [i for i, line in enumerate(lines)
                 if re.search(r"\bLDG\.", line)]
        out[name] = dict(
            registers=int(regs[name]) if name in regs else None,
            loads=len(loads),
            loads_after_division=(None if first_div is None else
                                  sum(i > first_div for i in loads)))
    if not out:
        raise RuntimeError(f"no step kernel in the SASS of {lib}")
    return out
