"""One loader for the shared native libraries of `native/`.

The libraries are the repository's `native/lib<name>.so`, loaded as
they are and never rebuilt in place: a fresh checkout's file times say
nothing about which of a source and its library is newer.  Where a
library is missing, or cannot be loaded where it runs, its sources
are compiled with g++ into `highs_tpu_torch/_build/` under a file name
that carries a hash of the sources and flags, once per source version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Callable, Sequence

REPO_DIR = pathlib.Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_DIR / "native"
BUILD_DIR = REPO_DIR / "highs_tpu_torch" / "_build"

_LOCK = threading.Lock()
_LOADED = {}


def built_path(name: str, sources: Sequence[str],
               flags: Sequence[str]) -> pathlib.Path:
    """Compile `native/<source>` files into one shared library in the
    build folder (once per version of the sources) and return its
    path."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update((NATIVE_DIR / src).read_bytes())
    digest.update(" ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, "-fPIC", "-shared", "-std=c++17",
                        *(str(NATIVE_DIR / s) for s in sources),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def load(name: str, sources: Sequence[str],
         declare: Callable[[ctypes.CDLL], None],
         flags: Sequence[str] = ("-O2",)) -> ctypes.CDLL:
    """`native/lib<name>.so` as it is, else the build of `sources`,
    with `declare(lib)` setting the argument types of the functions
    the caller binds; one bound handle per library and process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(NATIVE_DIR / f"lib{name}.so"))
            except OSError:  # missing, or built for another machine
                lib = ctypes.CDLL(str(built_path(name, sources, flags)))
            declare(lib)
            _LOADED[name] = lib
        return lib
