#!/usr/bin/env python3
"""B1's routes on one card, before and after a change to which line
lengths take which route, for the tree whose root is given.

    python3 scripts/route_times.py times ROOT TAG OUT.json
    python3 scripts/route_times.py sweep ROOT OUT.json
    python3 scripts/route_times.py sass OLD.so NEW.so OUT.json

``times`` runs the port of the tree at ROOT (its ``src`` first on the
path; the kernel is built there at first use): ``fft_fourstep`` on
contiguous lines at :data:`SHAPES`, each on the route that tree's
``radix.kernel_path`` names, beside ``torch.fft.fft`` and the bound, and
a C2C ``plan_fft`` of :data:`GRID` on the kernel backend (launches per
route and layout, line copies) beside ``fftn`` and a ``cufft`` plan.
Compare two trees within one call: parent, change, change, parent.

``sweep`` times every radix-route length of the tree at ROOT whose odd
part is 65 or more, both dtypes, at 64 MB of lines: the radix kernel,
the dense kernel of the same library on the same lines (the route
forced: ``radix.kernel_path`` answers "dense" for the timing), and
``torch.fft.fft``.

``sass`` compares ``cuobjdump -sass`` of two builds function by
function: only instruction and encoding lines (a module's header would
otherwise count as its last function's), each line's address comment
dropped and its whitespace collapsed (cuobjdump pads its columns to each
module's widest line).

CUDA events, 10 calls after 2 of warm-up; every result goes to OUT.json
and a line per measurement to the standard output.  Needs a CUDA card
(``times``, ``sweep``) or ``cuobjdump`` (``sass``).
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys

#: (dtype name, lines, N): (262144, 544 = 17*32) at 512 MB, the dense
#: route's timed shape (a generic 17-stage); at 256 MB of lines the dense
#: route's lengths with the widest gaps to ``torch.fft`` (complex64 4725,
#: 4050, 3430, 2730, complex128 990), its spill lengths (complex64 208,
#: 504, complex128 22), the prime complex64 4831, and the 13-smooth
#: lengths past its old one-block limit that leave the chirp route for it
#: (complex64 16896, 23040, 5460, 28028, complex128 8448, 2420).
SHAPES = (("complex64", 262144, 544),) + tuple(
    (dt, (256 << 20) // (n * (8 if dt == "complex64" else 16)), n)
    for dt, n in (("complex64", 4725), ("complex64", 4050),
                  ("complex64", 3430), ("complex64", 2730),
                  ("complex128", 990), ("complex64", 208),
                  ("complex64", 504), ("complex128", 22),
                  ("complex64", 4831), ("complex64", 16896),
                  ("complex64", 23040), ("complex64", 5460),
                  ("complex64", 28028), ("complex128", 8448),
                  ("complex128", 2420)))
#: One face of the LLC4320 ocean grid (MITgcm/ECCO), complex64.
GRID = (4320, 4320)
SWEEP_BYTES = 64 << 20
#: Published peaks of one H100 SXM (as ``chip_smoke.py``).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


# The helpers below repeat ``chip_smoke.py``'s: importing it would put
# this checkout's ``src`` first on the path, ahead of ROOT's.


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(b: int, n: int, itemsize: int) -> float:
    """Each line read and written once over HBM, or 5 N log2 N flops a
    line over the fp32 peak, whichever takes longer."""
    return max(2 * b * n * itemsize / PEAK_HBM_BYTES,
               b * n * 5 * math.log2(n) / PEAK_FP32_FLOPS) * 1e3


def scaled_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _port(root: str):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("route_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def _lines(torch, dtype, b: int, n: int):
    gen = torch.Generator(device="cuda").manual_seed(n)
    return torch.randn((b, n), dtype=dtype, device="cuda", generator=gen)


def times(root: str, tag: str) -> dict:
    torch = _port(root)
    from repro_torch import make_mesh, plan_fft
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import ops, radix
    out = {"tag": tag, "root": os.path.abspath(root), "lines": []}
    for dt, b, n in SHAPES:
        dtype = getattr(torch, dt)
        x = _lines(torch, dtype, b, n)
        tfm.reset_launch_counts()
        y = tfm.fft_fourstep(x)
        torch.cuda.synchronize()
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "launches": dict(tfm.fft_fourstep.path_launches),
               "err_vs_torch_fft": scaled_err(y, torch.fft.fft(x)),
               "ms": time_ms(lambda: tfm.fft_fourstep(x)),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, x.element_size())}
        del x, y
        torch.cuda.empty_cache()
        print(f"[{tag}] {rec['path']} ({b}, {n}) {dt}: {rec['ms']:.4f} ms, "
              f"torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; vs torch.fft "
              f"{rec['err_vs_torch_fft']:.2e}; launches {rec['launches']}",
              flush=True)
        out["lines"].append(rec)
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = plan_fft(mesh, GRID, backend="kernel")
    cplan = plan_fft(mesh, GRID, backend="cufft")
    gen = torch.Generator(device="cuda").manual_seed(GRID[0])
    x = torch.randn(GRID, dtype=torch.complex64, device="cuda",
                    generator=gen)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    y = plan.forward(x)
    torch.cuda.synchronize()
    rec = {"grid": list(GRID),
           "launches": dict(tfm.fft_fourstep.path_launches),
           "layouts": dict(tfm.fft_fourstep.layout_launches),
           "copies": ops.copies["lines"],
           "err_vs_fftn": scaled_err(y, torch.fft.fftn(x)),
           "fwd_ms": time_ms(lambda: plan.forward(x), 5),
           "inv_ms": time_ms(lambda: plan.inverse(y, sharded_in=True), 5),
           "cufft_ms": time_ms(lambda: cplan.forward(x), 5),
           "fftn_ms": time_ms(lambda: torch.fft.fftn(x), 5),
           "bound_ms": len(GRID) * bound_ms(x.numel() // GRID[-1],
                                            GRID[-1], 8)}
    print(f"[{tag}] plan {GRID}: forward {rec['fwd_ms']:.4f} ms, inverse "
          f"{rec['inv_ms']:.4f}, cufft plan {rec['cufft_ms']:.4f}, fftn "
          f"{rec['fftn_ms']:.4f}, bound {rec['bound_ms']:.4f}; vs fftn "
          f"{rec['err_vs_fftn']:.2e}; launches {rec['launches']} "
          f"{rec['layouts']}, line copies {rec['copies']}", flush=True)
    out["plan"] = rec
    return out


def sweep(root: str) -> dict:
    torch = _port(root)
    from repro_torch.core.transforms import factorize
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix
    routed = radix.kernel_path
    out = {"root": os.path.abspath(root), "bytes": SWEEP_BYTES,
           "lengths": []}
    for dtype, sizes in radix.RADIX_SIZES.items():
        dt = str(dtype).removeprefix("torch.")
        for n in sizes:
            if radix.odd_part(n) < 65:
                continue
            b = SWEEP_BYTES // (n * dtype.itemsize)
            x = _lines(torch, dtype, b, n)
            lib = torch.fft.fft(x)
            radix_err = scaled_err(tfm.fft_fourstep(x), lib)
            radix_ms = time_ms(lambda: tfm.fft_fourstep(x))
            radix.kernel_path = lambda m, d: "dense"
            try:
                dense_err = scaled_err(tfm.fft_fourstep(x), lib)
                dense_ms = time_ms(lambda: tfm.fft_fourstep(x))
            finally:
                radix.kernel_path = routed
            rec = {"dtype": dt, "shape": [b, n],
                   "factors": list(factorize(n)),
                   "radix_ms": radix_ms, "dense_ms": dense_ms,
                   "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
                   "bound_ms": bound_ms(b, n, dtype.itemsize),
                   "radix_err": radix_err, "dense_err": dense_err}
            del x, lib
            print(f"[sweep] ({b}, {n}) {dt} {rec['factors']}: radix "
                  f"{radix_ms:.4f} ms, dense {dense_ms:.4f}, torch.fft "
                  f"{rec['torch_fft_ms']:.4f}, bound {rec['bound_ms']:.4f}"
                  f"; vs torch.fft {radix_err:.2e} / {dense_err:.2e}",
                  flush=True)
            out["lengths"].append(rec)
    recs = out["lengths"]
    slower = [r["shape"][1] for r in recs if r["radix_ms"] > r["dense_ms"]]
    ratio = [r["radix_ms"] / r["torch_fft_ms"] for r in recs]
    print(f"[sweep] {len(recs)} lengths; radix slower than dense at "
          f"{slower}; radix against torch.fft {min(ratio):.2f}x to "
          f"{max(ratio):.2f}x")
    return out


def _cuobjdump() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def _sass(path: str) -> dict:
    listing = subprocess.run([_cuobjdump(), "-sass", path],
                             capture_output=True, text=True,
                             check=True).stdout
    funcs, cur = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "ANON", m.group(1))
            funcs[cur] = []
        elif cur is not None and "/* 0x" in line:
            # an instruction or its encoding; the module headers between
            # functions (cuobjdump prints no end of a function) are not
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
            funcs[cur].append(" ".join(line.split()))
    return funcs


def sass(old: str, new: str) -> dict:
    a, b = _sass(old), _sass(new)
    common = [k for k in a if k in b]
    changed = [k for k in common if a[k] != b[k]]
    out = {"old": len(a), "new": len(b), "kept": len(common) - len(changed),
           "changed": changed, "missing": [k for k in a if k not in b],
           "added": len(b) - len(common),
           "old_lines": sum(map(len, a.values())),
           "new_lines": sum(map(len, b.values()))}
    print(f"[sass] {out['old']} functions before, {out['new']} after: "
          f"{out['kept']} kept their bodies, {len(changed)} changed, "
          f"{len(out['missing'])} missing, {out['added']} added")
    return out


def main(argv) -> int:
    if len(argv) == 5 and argv[1] == "times":
        result = times(argv[2], argv[3])
    elif len(argv) == 4 and argv[1] == "sweep":
        result = sweep(argv[2])
    elif len(argv) == 5 and argv[1] == "sass":
        result = sass(argv[2], argv[3])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[-1], "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
