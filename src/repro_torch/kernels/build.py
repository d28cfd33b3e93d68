"""Build the port's CUDA kernel at first use and load it with ctypes.

``csrc/fft_fourstep.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers).  It instantiates every length
the routes take, one kernel each (1299: 813 radix, 295 long-line, 165
wide, the chirp's 16 and the split's and dense route's 10), which one
``nvcc`` run would compile in many
minutes (376 of them took 227-319 s on an H100 machine, PERF.md).  So
the build splits them over
:data:`PARTS` translation units of the same source (``-DREPRO_PART=k``:
the kernels of build part k, ``fft_radix.cuh``'s ``build_part``; ``-1``:
the entry points), compiles all of them at once, one ``nvcc -c`` each,
and links the objects into one library; the first use on a fresh machine
waits for the slowest part.

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
#: Translation units that hold the kernels, compiled beside the one that
#: holds the entry points.
PARTS = 8
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v", f"-DREPRO_BUILD_PARTS={PARTS}")
SOURCE = "fft_fourstep"


@dataclasses.dataclass
class BuiltLibrary:
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float      # the build's wall time (every unit and the link);
                        # 0.0 when an earlier build was reused
    log: str            # nvcc's output (ptxas register/shared-memory report)


_LOADED: Dict[str, BuiltLibrary] = {}
_LOCK = threading.Lock()
#: What this process did: ``nvcc`` runs, and libraries loaded (built here or
#: read from an earlier build on disk).  A warmed service's first drain
#: adds to neither.
counts = {"builds": 0, "loads": 0}


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


def _compile(name: str, out: Path) -> str:
    """``csrc/<name>.cu`` as its ``PARTS + 1`` translation units, one
    ``nvcc -c`` each, all started at once, then linked into ``out``.
    Returns nvcc's output, the units' in order (ptxas's report per
    instantiation); raises ``RuntimeError`` with it when a step fails."""
    src = str(csrc_dir() / f"{name}.cu")
    objs = out.with_suffix(".parts")
    objs.mkdir(exist_ok=True)
    try:
        units = [(part, objs / f"part{part + 1}.o")
                 for part in range(-1, PARTS)]
        procs = [subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, f"-DREPRO_PART={part}", "-c", "-o",
             str(obj), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for part, obj in units]
        log = "".join(proc.communicate()[0] for proc in procs)
        failed = [part for (part, _), proc in zip(units, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed to compile {name}.cu "
                               f"(REPRO_PART {failed}):\n{log}")
        link = subprocess.run(
            [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(out),
             *(str(obj) for _, obj in units)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += link.stdout
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {name}.cu "
                               f"(exit {link.returncode}):\n{log}")
        return log
    finally:
        shutil.rmtree(objs, ignore_errors=True)


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
            log = _compile(name, tmp)
            seconds = timer() - t0
            os.replace(tmp, target)
            counts["builds"] += 1
        counts["loads"] += 1
        built = BuiltLibrary(name=name, path=target,
                             lib=ctypes.CDLL(str(target)), seconds=seconds,
                             log=log)
        _LOADED[name] = built
        return built


def load(name: str = SOURCE) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return build(name).lib
