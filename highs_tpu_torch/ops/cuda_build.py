"""Build the CUDA sources of `highs_tpu_torch/csrc/` into shared libraries.

Each source exports a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) at its first use, into `highs_tpu_torch/_build/`, and
loaded with ctypes.  The library's file name carries a hash of the
source, so an edited source is rebuilt and a stale build is never
loaded.  A failed build raises: no caller falls back to another path.
`build` compiles several sources at once, one nvcc process each.
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

# name -> (seconds from the start of its nvcc to its end as seen by this
# process, nvcc's output)
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


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Compile `csrc/<name>.cu` for every name whose build is missing,
    all nvcc processes started together; raises if any of them fails."""
    started = []
    for name in names:
        src, lib_path = _paths(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started.append((name, src, lib_path, tmp, time.perf_counter(), proc))
    failures = []
    for name, src, lib_path, tmp, t0, proc in started:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed to build {src} (exit "
                            f"{proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, lib_path)
        BUILD_INFO[name] = (time.perf_counter() - t0, out + err)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its build is missing, then load it."""
    build([name])
    return ctypes.CDLL(str(_paths(name)[1]))
