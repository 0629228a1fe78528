"""The elementwise chain of one PDHG step, as two CUDA kernels.

A PDHG step of either engine mode is two products around an elementwise
chain: the primal half (gradient step, box projection, reflection, and
the Halpern blend or the average mode's running sum) feeds `K x_r`, and
the dual half (gradient step, cone projection, and the blend or the sum)
feeds `K' y`.  The JAX package leaves the chain to XLA, which fuses it
inside the jitted inner block (`highs_tpu/solvers/pdlp/pdhg.py:180`
`_halpern_step`, `:438` `_avg_pdhg_step`); PyTorch issues it one
operation at a time.  `csrc/pdhg_step.cu` computes each half in one
launch, reading the step size, the primal weight and the step count on
the card, so that a captured CUDA graph replays it with no host value.

`primal_step` and `dual_step` call the two halves as the operators
`highs_tpu_torch::pdhg_primal_step` and `highs_tpu_torch::pdhg_dual_step`
(`torch.library.Library`), which launch the kernels on a CUDA tensor
and take the plain versions, `primal_step_plain` and `dual_step_plain`,
on a CPU tensor.  The plain versions are the chain as PyTorch computes
it; the kernels round every operation as they do and equal them bit for
bit on the card.  `mode` is "halpern" (x_out = the blended iterate) or
"average" (x_out = x_anchor + x_pd, the running sum).

A batch.  Both operators take one instance ((n,) vectors, 0-dim eta,
omega and k) or b instances ((b, n) vectors, (b,) scalars), and carry a
`torch.library.register_vmap` rule: under `torch.func.vmap` (the batched
LP solve, the multi-device dry run) the rule moves each batched input's
vmap dimension to the front, broadcasts an unbatched one to the batch,
and makes ONE batched launch (the plain chain on a CPU tensor), which
`LAUNCHES` counts as one.

The kernels move every vector as 16-byte words, so each CUDA tensor must
start on a 16-byte boundary (a view that starts inside its storage may
not), and a batch's rows must be whole words (n * item size a multiple
of 16): the operators raise `ValueError` otherwise.  They take their
launch geometry from `launch_geometry`, a plain function of the length,
the item size, the card's SM count and the batch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

MODES = ("halpern", "average")

# launches of each CUDA kernel in this process (each wrapper call that
# launches one adds one)
LAUNCHES = {"pdhg_primal_step": 0, "pdhg_dual_step": 0}

# threads a block at most (`kMaxThreads` in csrc/pdhg_step.cu), and
# instances a launch at most (the grid's y dimension)
MAX_THREADS = 256
MAX_BATCH = 65535

_LIB = None


class Geometry(NamedTuple):
    """A launch of the step kernels: a `grid` x `batch` grid of blocks of
    `threads`, block row y on instance y; thread t (its index in the
    row) handles the instance's 16-byte vectors t + j * grid * threads
    for j < per_thread that are below `vectors`, and threads
    0 .. tail-1 the elements vectors * width + t after the last
    vector."""
    grid: int
    threads: int
    per_thread: int
    vectors: int
    tail: int
    batch: int = 1


def launch_geometry(n: int, itemsize: int, sms: int,
                    batch: int = 1) -> Geometry:
    """The launch for `batch` instances of n items of `itemsize` bytes on
    a card of `sms` SMs: each instance's body as 16-byte vectors, one a
    thread while all the batch's vectors fit MAX_THREADS threads on each
    SM, else two, in blocks of a multiple of 32 threads sized so that
    one block on each SM covers the batch (one wave up to
    2 * MAX_THREADS * sms vectors, more blocks beyond) and no wider than
    one instance needs; the remaining n mod (16 / itemsize) items as the
    scalar tail.  A batch's rows must be whole vectors, so that no vector
    spans two instances."""
    if itemsize not in (4, 8):
        raise ValueError(f"item size {itemsize}: the kernels take 4 or 8")
    if n < 0 or sms < 1:
        raise ValueError(f"length {n} and {sms} SMs")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a batch of {batch}: the kernels take 1 to "
                         f"{MAX_BATCH} instances")
    vectors, tail = divmod(n, 16 // itemsize)
    if batch > 1 and tail:
        raise ValueError(f"a batch's rows of {n} items of {itemsize} bytes "
                         f"are off the 16-byte grid")
    total = batch * vectors
    per_thread = 1 if total <= MAX_THREADS * sms else 2
    per_block = -(-total // (per_thread * sms))
    threads = min(MAX_THREADS, max(32, 32 * -(-per_block // 32)),
                  max(32, 32 * -(-vectors // (32 * per_thread))))
    grid = max(1, -(-vectors // (threads * per_thread)))
    return Geometry(grid, threads, per_thread, vectors, tail, batch)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def halpern_weights(k: torch.Tensor, dtype: torch.dtype):
    """(w, 1 - w) with w = (k + 1) / (k + 2), from the step count k."""
    kf = k.to(dtype)
    w = (kf + 1.0) / (kf + 2.0)
    return w, 1.0 - w


def primal_step_plain(x, c, aty, lo, up, x_anchor, eta, omega, k,
                      gamma: float, mode: str, weights=None):
    """(x_pd, x_r, x_out): x_pd = min(max(x - tau (c - aty), lo), up)
    with tau = eta / omega, x_r = 2 x_pd - x, and x_out the Halpern
    blend w (gamma x_r + (1 - gamma) x) + (1 - w) x_anchor with
    w = (k + 1) / (k + 2), or in average mode x_anchor + x_pd.
    `weights`: `halpern_weights(k, ...)` where the caller has them."""
    tau = eta / omega
    x_pd = torch.minimum(torch.maximum(x - tau * (c - aty), lo), up)
    x_r = 2.0 * x_pd - x
    if mode == "average":
        return x_pd, x_r, x_anchor + x_pd
    w, wc = halpern_weights(k, x.dtype) if weights is None else weights
    return x_pd, x_r, w * (gamma * x_r + (1.0 - gamma) * x) + wc * x_anchor


def dual_step_plain(y, b, ax_r, is_eq, y_lo, y_anchor, eta, omega, k,
                    gamma: float, mode: str, weights=None):
    """(y_pd, y_out, k + 1): y_pd = y_raw = y + sigma (b - ax_r) on
    equality rows and max(y_raw, y_lo) (y_lo None: 0) on the others,
    with sigma = eta * omega; y_out the Halpern blend of the reflection
    2 y_pd - y, or in average mode y_anchor + y_pd."""
    sigma = eta * omega
    y_raw = y + sigma * (b - ax_r)
    y_cone = (torch.clamp_min(y_raw, 0.0) if y_lo is None
              else torch.maximum(y_raw, y_lo))
    y_pd = torch.where(is_eq > 0, y_raw, y_cone)
    if mode == "average":
        return y_pd, y_anchor + y_pd, k + 1
    y_r = 2.0 * y_pd - y
    w, wc = halpern_weights(k, y.dtype) if weights is None else weights
    return (y_pd, w * (gamma * y_r + (1.0 - gamma) * y) + wc * y_anchor,
            k + 1)


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("pdhg_step")
        ptr, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.pdhg_primal_step_f32, lib.pdhg_primal_step_f64,
                   lib.pdhg_dual_step_f32, lib.pdhg_dual_step_f64):
            # ..., n, batch, row stride, grid, threads, per_thread,
            # vectors, tail, stream
            fn.argtypes = ([ptr] * 9 + [ctypes.c_double, ctypes.c_double,
                                        c_int] + [ptr] * 3 +
                           [c_ll, c_int, c_ll, c_int, c_int, c_int, c_ll,
                            c_int, ptr])
            fn.restype = c_int
        _LIB = lib
    return _LIB


def _check(vectors, scalars, k, mode):
    """The device of the inputs after checking what the kernels take:
    contiguous vectors of one shape, (n,) or a batch (b, n), one float
    type and one device; eta and omega of that type and k int32, 0-dim
    for one instance and (b,) for a batch."""
    if mode not in MODES:
        raise ValueError(f"unknown PDHG mode {mode!r}")
    first = vectors[0]
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the PDHG step takes float32 or float64, not "
                        f"{first.dtype}")
    if first.dim() not in (1, 2):
        raise ValueError(f"vector of shape {tuple(first.shape)}: the PDHG "
                         f"step takes (n,) or a batch (b, n)")
    for v in vectors:
        if v.shape != first.shape:
            raise ValueError(f"vector of shape {tuple(v.shape)}, expected "
                             f"{tuple(first.shape)}")
        if v.dtype != first.dtype:
            raise TypeError(f"vectors of {v.dtype} and {first.dtype}")
    shape = first.shape[:-1]  # () for one instance, (b,) for a batch
    for s in scalars:
        if s.shape != shape or s.dtype != first.dtype:
            raise TypeError(f"eta and omega must be {first.dtype} of shape "
                            f"{tuple(shape)}, not {s.dtype} of shape "
                            f"{tuple(s.shape)}")
    if k.shape != shape or k.dtype != torch.int32:
        raise TypeError(f"k must be int32 of shape {tuple(shape)}, not "
                        f"{k.dtype} of shape {tuple(k.shape)}")
    device = first.device
    for t in (*vectors, *scalars, k):
        if t.device != device:
            raise ValueError(f"inputs on {t.device} and {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no PDHG step kernel for device {device}")
    if device.type == "cuda":
        for t in (*vectors, *scalars, k):
            if not t.is_contiguous():
                raise ValueError("the PDHG step kernels take contiguous "
                                 "tensors")
        for v in vectors:
            if v.data_ptr() % 16:
                # the kernels move every vector as 16-byte words
                raise ValueError("the PDHG step kernels take vectors that "
                                 "start on a 16-byte boundary (a view that "
                                 "starts inside its storage may not)")
        if first.dim() == 2 and first.shape[0] > 1 and \
                first.stride(0) * first.element_size() % 16:
            raise ValueError("the PDHG step kernels take a batch whose rows "
                             "are whole 16-byte words (a row stride of "
                             f"{first.stride(0)} items of "
                             f"{first.element_size()} bytes is off the "
                             "16-byte grid)")
    return device


def _launch_args(v: torch.Tensor) -> tuple:
    """The C entry point's (n, batch, row stride, geometry...) for the
    vectors of `v`'s shape."""
    batch = v.shape[0] if v.dim() == 2 else 1
    g = launch_geometry(v.shape[-1], v.element_size(),
                        _sms(v.device.index), batch)
    row = v.stride(0) if v.dim() == 2 else v.shape[0]
    return (v.shape[-1], g.batch, row, g.grid, g.threads, g.per_thread,
            g.vectors, g.tail)


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _rows(*scalars):
    """A batch's (b,) scalars as (b, 1), to broadcast over its rows."""
    return tuple(s[:, None] for s in scalars)


def _primal(x: torch.Tensor, c: torch.Tensor, aty: torch.Tensor,
            lo: torch.Tensor, up: torch.Tensor, x_anchor: torch.Tensor,
            eta: torch.Tensor, omega: torch.Tensor, k: torch.Tensor,
            gamma: float, mode: str):
    device = _check((x, c, aty, lo, up, x_anchor), (eta, omega), k, mode)
    if device.type == "cpu":
        if x.dim() == 2:
            eta, omega, k = _rows(eta, omega, k)
        return primal_step_plain(x, c, aty, lo, up, x_anchor, eta, omega,
                                 k, gamma, mode)
    lib = _lib()
    fn = (lib.pdhg_primal_step_f32 if x.dtype == torch.float32
          else lib.pdhg_primal_step_f64)
    x_pd, x_r, x_out = (torch.empty_like(x) for _ in range(3))
    with torch.cuda.device(device):
        rc = fn(x.data_ptr(), c.data_ptr(), aty.data_ptr(), lo.data_ptr(),
                up.data_ptr(), x_anchor.data_ptr(), eta.data_ptr(),
                omega.data_ptr(), k.data_ptr(), float(gamma),
                1.0 - float(gamma), int(mode == "halpern"),
                x_pd.data_ptr(), x_r.data_ptr(), x_out.data_ptr(),
                *_launch_args(x),
                torch.cuda.current_stream(device).cuda_stream)
    _launched("pdhg_primal_step", rc)
    return x_pd, x_r, x_out


def _dual(y: torch.Tensor, b: torch.Tensor, ax_r: torch.Tensor,
          is_eq: torch.Tensor, y_lo: Optional[torch.Tensor],
          y_anchor: torch.Tensor, eta: torch.Tensor, omega: torch.Tensor,
          k: torch.Tensor, gamma: float, mode: str):
    vectors = (y, b, ax_r, is_eq, y_anchor) + (() if y_lo is None
                                               else (y_lo,))
    device = _check(vectors, (eta, omega), k, mode)
    if device.type == "cpu":
        if y.dim() == 2:
            y_pd, y_out, _ = dual_step_plain(y, b, ax_r, is_eq, y_lo,
                                             y_anchor, *_rows(eta, omega, k),
                                             gamma, mode)
            return y_pd, y_out, k + 1
        return dual_step_plain(y, b, ax_r, is_eq, y_lo, y_anchor, eta,
                               omega, k, gamma, mode)
    lib = _lib()
    fn = (lib.pdhg_dual_step_f32 if y.dtype == torch.float32
          else lib.pdhg_dual_step_f64)
    y_pd, y_out = torch.empty_like(y), torch.empty_like(y)
    k_next = torch.empty_like(k)
    with torch.cuda.device(device):
        rc = fn(y.data_ptr(), b.data_ptr(), ax_r.data_ptr(),
                is_eq.data_ptr(), None if y_lo is None else y_lo.data_ptr(),
                y_anchor.data_ptr(), eta.data_ptr(), omega.data_ptr(),
                k.data_ptr(), float(gamma), 1.0 - float(gamma),
                int(mode == "halpern"), y_pd.data_ptr(), y_out.data_ptr(),
                k_next.data_ptr(), *_launch_args(y),
                torch.cuda.current_stream(device).cuda_stream)
    _launched("pdhg_dual_step", rc)
    return y_pd, y_out, k_next


# The two halves as operators of the dispatcher, defined with
# `torch.library.Library` (a `torch.library.custom_op` imports
# torch._dynamo at its first call, seconds of a process's first block)
_LIBRARY = torch.library.Library("highs_tpu_torch", "DEF")
_LIBRARY.define(
    "pdhg_primal_step(Tensor x, Tensor c, Tensor aty, Tensor lo, Tensor up, "
    "Tensor x_anchor, Tensor eta, Tensor omega, Tensor k, float gamma, "
    "str mode) -> (Tensor, Tensor, Tensor)")
_LIBRARY.define(
    "pdhg_dual_step(Tensor y, Tensor b, Tensor ax_r, Tensor is_eq, "
    "Tensor? y_lo, Tensor y_anchor, Tensor eta, Tensor omega, Tensor k, "
    "float gamma, str mode) -> (Tensor, Tensor, Tensor)")
_LIBRARY.impl("pdhg_primal_step", _primal, "CompositeExplicitAutograd")
_LIBRARY.impl("pdhg_dual_step", _dual, "CompositeExplicitAutograd")
_PRIMAL_OP = torch.ops.highs_tpu_torch.pdhg_primal_step.default
_DUAL_OP = torch.ops.highs_tpu_torch.pdhg_dual_step.default


def _vmap_rule(op):
    """The batching rule of a step operator: every tensor argument with
    its vmap dimension in front (an unbatched one broadcast to the
    batch), contiguous, then one batched call of the operator."""
    def rule(info, in_dims, *args):
        def front(a, dim):
            if not isinstance(a, torch.Tensor):
                return a
            a = (a.movedim(dim, 0) if dim is not None
                 else a.expand(info.batch_size, *a.shape))
            return a.contiguous()
        return op(*map(front, args, in_dims)), (0, 0, 0)
    return rule


torch.library.register_vmap("highs_tpu_torch::pdhg_primal_step",
                            _vmap_rule(_PRIMAL_OP), lib=_LIBRARY)
torch.library.register_vmap("highs_tpu_torch::pdhg_dual_step",
                            _vmap_rule(_DUAL_OP), lib=_LIBRARY)


def primal_step(x, c, aty, lo, up, x_anchor, eta, omega, k, gamma: float,
                mode: str):
    """`primal_step_plain`'s (x_pd, x_r, x_out): one kernel launch on a
    CUDA tensor, the plain version on a CPU tensor; (n,) vectors with
    0-dim scalars, or a batch, also under `torch.func.vmap`."""
    return _PRIMAL_OP(x, c, aty, lo, up, x_anchor, eta, omega, k,
                      float(gamma), mode)


def dual_step(y, b, ax_r, is_eq, y_lo: Optional[torch.Tensor], y_anchor,
              eta, omega, k, gamma: float, mode: str):
    """`dual_step_plain`'s (y_pd, y_out, k + 1): one kernel launch on a
    CUDA tensor, the plain version on a CPU tensor; one instance or a
    batch, also under `torch.func.vmap`."""
    return _DUAL_OP(y, b, ax_r, is_eq, y_lo, y_anchor, eta, omega, k,
                    float(gamma), mode)
