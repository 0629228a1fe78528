"""Element-gather rate of the card: out[s, j] = table[s, idx[s, j]].

    python3 highs_tpu_torch/tools/gather_probe.py [--out probe.json]

The CUDA kernel `csrc/gather_probe.cu` replaces the two Pallas probes of
the JAX package's tools (`tools/gather_probe.py:79-86` and
`tools/gather_probe2.py:29-39`) and runs their shapes, in float32 and
float64.  Each result is held to exact equality with its plain version,
`torch.gather(table, 1, idx)`, which is also the one PyTorch call timed
beside the kernel.  It prints the µs per call and Gelem/s of both,
beside the byte bound and the card's name and power limit, and as its
last line one JSON object (also written to `--out`).  Needs a CUDA
card.  The solver never launches this kernel: the probe measures the
rate that the ELL and panel formats of `ops/linops.py` live on.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script: the repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from highs_tpu_torch.tools.card import (  # noqa: E402
    bound_ms, call_ms, card_line, time_ms)

# kernel launches in this process (each wrapper call that launches it)
LAUNCHES = 0

# (name, table shape, idx shape, indices drawn from [0, idx_max))
SHAPES = [
    # tools/gather_probe.py:49-53: per-row lookups into 128- and
    # 512-wide tables, W = 4,352 (~ nnz / 128 of synth50k)
    ("probe1 table 128x128", (128, 128), (128, 4352), 128),
    ("probe1 table 128x512", (128, 512), (128, 4352), 512),
    # tools/gather_probe2.py:72-77: same-shape take_along_axis
    ("probe2 128x128 idx<128", (128, 128), (128, 128), 128),
    ("probe2 128x256 idx<128", (128, 256), (128, 256), 128),
    ("probe2 128x256 idx<256", (128, 256), (128, 256), 256),
    ("probe2 128x4352 idx<128", (128, 4352), (128, 4352), 128),
    ("probe2 128x4352 idx<4352", (128, 4352), (128, 4352), 4352),
    ("probe2 256x4352 idx<128", (256, 4352), (256, 4352), 128),
]

_LIB = None


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return torch.gather(table, 1, idx.long())


def _lib():
    global _LIB
    if _LIB is None:
        from highs_tpu_torch.ops.cuda_build import load_library
        lib = load_library("gather_probe")
        for fn in (lib.gather_probe_f32, lib.gather_probe_f64):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def gather_probe(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[s, j] = table[s, idx[s, j]]; idx int32 with entries in
    [0, table.shape[1]).  A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    global LAUNCHES
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"table must be float32 or float64, not "
                        f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 2 or \
            idx.shape[0] != table.shape[0] or table.shape[0] > 65535:
        raise ValueError(f"table {tuple(table.shape)} and idx "
                         f"{tuple(idx.shape)}: two 2-D arrays with the "
                         "same number of rows, at most 65,535")
    if table.device != idx.device or not (table.is_contiguous() and
                                          idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous, on one device")
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    lib = _lib()
    fn = (lib.gather_probe_f32 if table.dtype == torch.float32
          else lib.gather_probe_f64)
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            table.shape[0], table.shape[1], idx.shape[1],
            torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_probe launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def probe_inputs(table_shape, idx_shape, idx_max, dtype, device, seed=0):
    """The probes' inputs: a normal table and uniform indices."""
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.standard_normal(table_shape), dtype=dtype,
                            device=device)
    idx = torch.as_tensor(rng.integers(0, idx_max, idx_shape),
                          dtype=torch.int32, device=device)
    return table, idx


def measure(device, dtypes=(torch.float32, torch.float64)):
    """One record per shape and dtype: exact equality with the plain
    version, kernel and plain device times (`card.time_ms`), the
    kernel's time per call with the host's launch gap, byte bound and
    rates."""
    records = []
    for name, t_shape, i_shape, idx_max in SHAPES:
        for dtype in dtypes:
            table, idx = probe_inputs(t_shape, i_shape, idx_max, dtype,
                                      device)
            got = gather_probe(table, idx)
            want = gather_plain(table, idx)
            equal = bool(torch.equal(got, want))
            k_ms = time_ms(gather_probe, device, table, idx)
            k_call_ms = call_ms(lambda: gather_probe(table, idx), device)
            p_ms = time_ms(gather_plain, device, table, idx)
            item = table.element_size()
            nbytes = (table.numel() * item + idx.numel() * 4 +
                      idx.numel() * item)
            b_ms, b_by = bound_ms(nbytes, 0.0, dtype)
            n_el = idx.numel()
            records.append(dict(
                name=name, dtype=str(dtype).replace("torch.", ""),
                table=list(t_shape), idx=list(i_shape), idx_max=idx_max,
                equal=equal, ok=equal,
                max_abs_err=float((got - want).abs().max().item()),
                ms=k_ms, call_ms=k_call_ms, plain_ms=p_ms, library_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by,
                gelem_per_s=n_el / (k_ms * 1e-3) / 1e9,
                plain_gelem_per_s=n_el / (p_ms * 1e-3) / 1e9))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_probe: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    records = measure(device)
    for r in records:
        print(f"{r['name']} {r['dtype']}: equal {r['equal']} kernel "
              f"{r['ms'] * 1e3:.2f} us ({r['gelem_per_s']:.2f} Gelem/s; "
              f"{r['call_ms'] * 1e3:.2f} us per call), "
              f"torch.gather {r['plain_ms'] * 1e3:.2f} us "
              f"({r['plain_gelem_per_s']:.2f} Gelem/s), bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) [{card}]",
              flush=True)
    report = {"card": card, "launches": LAUNCHES, "records": records}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0 if all(r["equal"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
