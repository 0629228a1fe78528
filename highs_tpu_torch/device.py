"""Device resolution for highs_tpu_torch.

The default device is CUDA.  The CPU is used only when a caller asks for
it by name (the tests do); a request for CUDA on a machine without a
card raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; `"cpu"`/`"cuda"`/`"cuda:N"` or a torch.device as
    given.  Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
