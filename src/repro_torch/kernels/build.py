"""Build the port's CUDA kernel at first use and load it with ctypes.

``csrc/fft_fourstep.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds).
Libraries land in ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the flags, the source and every
header under ``csrc/`` it includes (``#include "..."``, followed
recursively), so an edited source or header rebuilds and an unchanged
one loads at once.  Several
processes may build at the same time: each writes a private file and
renames it into place.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")
SOURCE = "fft_fourstep"


@dataclasses.dataclass
class BuiltLibrary:
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: str            # nvcc's output (ptxas register/shared-memory report)


_LOADED: Dict[str, BuiltLibrary] = {}
_LOCK = threading.Lock()


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source at first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every file under ``csrc/`` it includes with
    ``#include "..."``, directly or through another header, in the order
    first reached."""
    found, todo = [], [csrc_dir() / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            cand = path.parent / inc.decode()
            if cand.exists():
                todo.append(cand)
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str = SOURCE, *,
          timer: Callable[[], float] = time.perf_counter) -> BuiltLibrary:
    """Build ``csrc/<name>.cu`` unless an earlier build is on disk, and load
    it.  A library already loaded is returned as it is.  Raises
    ``RuntimeError`` with nvcc's output when the build fails.
    """
    with _LOCK:
        built = _LOADED.get(name)
        if built is not None:
            return built
        target = _target(name)
        log, seconds = "", 0.0
        if not target.exists():
            build_dir().mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            t0 = timer()
            res = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(csrc_dir() / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            seconds, log = timer() - t0, res.stdout
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {res.returncode}):\n{log}")
            os.replace(tmp, target)
        built = BuiltLibrary(name=name, path=target,
                             lib=ctypes.CDLL(str(target)), seconds=seconds,
                             log=log)
        _LOADED[name] = built
        return built


def load(name: str = SOURCE) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return build(name).lib
