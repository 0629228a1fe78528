"""Build a CUDA source of `highs_tpu_torch/csrc/` into a shared library.

Each source exports a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) at its first use, into `highs_tpu_torch/_build/`, and
loaded with ctypes.  The library's file name carries a hash of the
source, so an edited source is rebuilt and a stale build is never
loaded.  A failed build raises: no caller falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (seconds spent building in this process, nvcc's output)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of highs_tpu_torch cannot be built")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its build is missing, then load it."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_INFO[name] = (time.perf_counter() - t0,
                            proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib_path))
