"""Analytic LogP + roofline performance model of the distributed FFT.

The port's counterpart of the JAX package's ``core/perfmodel.py``: the
tuner prices candidate plans with it (:func:`predict_plan_time`), and the
scheduler's chunk-schedule policy engine reads its per-hop terms
(:func:`hop_cost_terms`).  Machine constants are either model defaults
(:data:`H100_SXM` on a GPU, :data:`CPU_CORE` on the CPU) or measured on the
running hardware by :func:`calibrate`.

Backends price as in the reference under the name map
(``transforms.REFERENCE_BACKEND``): ``cufft`` as ``xla`` (5 N log2 N per
line), ``matmul`` as the dense four-step 8 N (N1 + N2).  The ``kernel``
backend follows what the hand-written kernel runs for the line's length
and dtype (``kernels/radix.kernel_path``): 5 N log2 N on its radix and
long-line paths, that plus 6 N (the inter-step twiddle) on its split
route, two transforms of the padded length and their twiddles on its
chirp route, the dense four-step count on its general path.

Calibration times on the card with CUDA events, after a warm-up call that
also takes the kernel's first-use build, and on the CPU with the host clock
around a synchronized call; ``timer=`` injects a host timer (tests).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .decomp import Decomposition, local_shape
from .redistribute import hop_move_shapes, transpose_cost_bytes
from .scheduler import CostModel, TaskSpec, hop_phase_time
from .transforms import FROM_REFERENCE_BACKEND, LOCAL_BACKENDS


@dataclasses.dataclass(frozen=True)
class Machine:
    """Per-rank hardware constants."""
    name: str
    flops: float                 # sustainable FLOP/s per rank
    mem_bw: float                # HBM/DRAM bytes/s per rank
    net_alpha_s: float           # per-message latency (Eq. 1 alpha)
    net_bw: float                # per-rank injection bandwidth (1/beta)
    overlap: float = 0.0         # 0 = bulk-sync, 1 = perfect Eq. 2 overlap


# NVIDIA H100 SXM (NVIDIA's data sheet): 67 TFLOP/s float32 on the CUDA
# cores and 3.35 TB/s of HBM3, the peaks chip_smoke.py bounds kernels by.
# The network terms are NVLink 4's 900 GB/s per GPU (data sheet), taken as
# 450 GB/s in each direction, and an assumed 10 us per all_to_all peer
# round (not measured); on one card no bytes leave the rank, so they price
# nothing there.
H100_SXM = Machine(name="h100_sxm", flops=67e12, mem_bw=3.35e12,
                   net_alpha_s=10e-6, net_bw=450e9)
# One CPU core with a vendor FFT (the JAX package's CPU default).  net_bw
# is the per-rank share of a node NIC: InfiniBand HDR (~25 GB/s) divided
# across 48 ranks per node with contention ~= 0.5-1 GB/s.
CPU_CORE = Machine(name="cpu_core", flops=8e9, mem_bw=8e9,
                   net_alpha_s=2e-5, net_bw=0.8e9)

# Transform kinds -> cost family.  R2C does half the butterflies on cufft;
# the DCT/DST-II pairs are priced as a C2C of twice the logical length;
# calibration scales each family from measured runs.
KIND_FAMILY = {"fft": "c2c", "ifft": "c2c", "rfft": "r2c", "irfft": "r2c",
               "dct2": "r2r", "dct3": "r2r", "dst2": "r2r", "dst3": "r2r"}


def _map_reference_key(key: str) -> str:
    """A profile key of either package in the port's names: ``xla`` ->
    ``cufft``, ``pallas`` -> ``kernel``, also as a ``"backend:family"``
    prefix."""
    backend, sep, family = key.partition(":")
    backend = FROM_REFERENCE_BACKEND.get(backend, backend)
    return backend + sep + family


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Measured (or default) machine parameters for the kind-aware model.

    * ``backend_flops`` — sustained local-FFT FLOP/s per backend
      (``cufft``/``matmul``/``kernel``), from microbenchmarks of
      ``transforms.apply_1d``;
    * ``kind_scale`` — per kind-family (``c2c``/``r2c``/``r2r``) multiplier
      on compute time.  Bare family keys are the cufft backend's scales;
      ``"kernel:r2c"``/``"kernel:r2r"`` are the kernel backend's own.
      Matmul carries none: its correction lives in ``backend_flops``;
    * ``mem_bw`` — streaming memory bandwidth (roofline denominator);
    * ``net_alpha_s`` / ``net_bw`` — per-mesh-axis all_to_all latency and
      bandwidth.  A size-1 axis cannot be measured, so they stay empty and
      lookups fall back to the base machine's constants.

    ``calibrated`` is False for pure model defaults (``REPRO_CALIBRATE=off``);
    ``net_calibrated`` is False when the network terms fell back to defaults
    (one rank).  ``platform`` is the device's name: the card's
    (``torch.cuda.get_device_name``) or ``"cpu"``.  Profiles round-trip
    through JSON and persist in the wisdom file's ``"machine"`` section;
    :meth:`from_json` also reads a profile written by the JAX package and
    maps its backend names.
    """

    base: Machine
    platform: str = ""
    calibrated: bool = False
    net_calibrated: bool = False
    backend_flops: Tuple[Tuple[str, float], ...] = ()
    kind_scale: Tuple[Tuple[str, float], ...] = ()
    mem_bw: float = 0.0
    net_alpha_s: Tuple[Tuple[str, float], ...] = ()
    net_bw: Tuple[Tuple[str, float], ...] = ()

    @property
    def overlap(self) -> float:
        return self.base.overlap

    def flops_for(self, backend: str) -> float:
        rates = dict(self.backend_flops)
        if backend in rates:
            return rates[backend]
        if backend == "kernel" and "matmul" in rates:
            # A profile without a measured kernel rate: the matmul backend
            # runs the same four-step algorithm, so its rate is the prior.
            return rates["matmul"]
        return self.base.flops

    def scale_for(self, family: str, backend: str = "cufft") -> float:
        """Kind-family time multiplier for ``backend``: the per-backend key
        (``"kernel:r2c"``) first; bare family keys are cufft's; 1.0 for a
        backend without kind keys (matmul)."""
        scales = dict(self.kind_scale)
        v = scales.get(f"{backend}:{family}")
        if v is not None:
            return v
        if backend == "cufft":
            return scales.get(family, 1.0)
        return 1.0

    def alpha_for(self, mesh_axis: str) -> float:
        return dict(self.net_alpha_s).get(mesh_axis, self.base.net_alpha_s)

    def bw_for(self, mesh_axis: str) -> float:
        return dict(self.net_bw).get(mesh_axis, self.base.net_bw)

    @property
    def eff_mem_bw(self) -> float:
        return self.mem_bw if self.mem_bw > 0 else self.base.mem_bw

    def to_json(self) -> Dict[str, Any]:
        return {
            "base": dataclasses.asdict(self.base),
            "platform": self.platform,
            "calibrated": self.calibrated,
            "net_calibrated": self.net_calibrated,
            "backend_flops": dict(self.backend_flops),
            "kind_scale": dict(self.kind_scale),
            "mem_bw": self.mem_bw,
            "net_alpha_s": dict(self.net_alpha_s),
            "net_bw": dict(self.net_bw),
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "MachineProfile":
        def items(key, rename=lambda k: k):
            return tuple(sorted((rename(str(k)), float(v))
                                for k, v in dict(d.get(key, {})).items()))
        return cls(base=Machine(**d["base"]),
                   platform=str(d.get("platform", "")),
                   calibrated=bool(d.get("calibrated", False)),
                   net_calibrated=bool(d.get("net_calibrated", False)),
                   backend_flops=items("backend_flops", _map_reference_key),
                   kind_scale=items("kind_scale", _map_reference_key),
                   mem_bw=float(d.get("mem_bw", 0.0)),
                   net_alpha_s=items("net_alpha_s"), net_bw=items("net_bw"))


def profile_from_machine(machine: Machine,
                         platform: str = "") -> MachineProfile:
    """Uncalibrated profile: every lookup falls back to the model defaults."""
    return MachineProfile(base=machine, platform=platform, calibrated=False,
                          net_calibrated=False, mem_bw=machine.mem_bw)


def as_profile(machine) -> MachineProfile:
    """Accept either a bare :class:`Machine` or a :class:`MachineProfile`."""
    if isinstance(machine, MachineProfile):
        return machine
    return profile_from_machine(machine, platform=machine.name)


def _line_flops(n: int, backend: str, dtype: torch.dtype = torch.complex64
                ) -> float:
    """FLOPs of one C2C line of length n — the single source of truth.

    ``cufft``: 5 n log2 n butterflies.  ``matmul``: the four-step path's
    two complex matmuls plus twiddle, 8 real FLOPs per complex MAC over
    n*(n1+n2) MACs.  ``kernel``: what the kernel runs for this length and
    complex ``dtype`` — 5 n log2 n on its radix (powers of two and mixed
    lengths) and long-line paths; on its split route the same plus the
    inter-step twiddle between its two passes, one complex multiply (6
    FLOPs) per element; on its chirp route two transforms of M =
    ``chirp.chirp_length(n, dtype)`` on M's route, their two twiddle
    epilogues and the input's chirp (6 FLOPs per element each); on its
    dense route (a mixed-radix chain, ``kernels.dense.chain``) 5 n log2 m
    over the chain's 13-smooth part m, plus 8 n p for each generic stage
    of a prime p past 13 (a p-term sum per element).
    """
    if backend == "kernel":
        # deferred: the kernels package imports core
        from ..kernels.chirp import chirp_length
        from ..kernels.radix import kernel_path
        path = kernel_path(n, dtype)
        if path == "split":
            return 5.0 * n * math.log2(n) + 6.0 * n
        if path == "chirp":
            m = chirp_length(n, dtype)
            return 2.0 * _line_flops(m, "kernel", dtype) + 6.0 * (2 * m + n)
        if path == "dense":
            from ..kernels.dense import chain
            rs = chain(n)
            smooth = math.prod(r for r in rs if r <= 13)
            return 5.0 * n * math.log2(smooth) + sum(
                8.0 * n * p for p in rs if p > 13)
        backend = "cufft"
    if backend == "matmul":
        from .transforms import factorize
        n1, n2 = factorize(n)
        return 8.0 * n * (n1 + n2)
    return 5.0 * n * math.log2(max(n, 2))


def kind_dim_flops(eff_grid: Tuple[int, ...], grid: Tuple[int, ...], d: int,
                   kind: str, backend: str = "cufft",
                   dtype: Optional[torch.dtype] = None) -> float:
    """FLOPs of transforming dim ``d`` of the whole (effective) grid once.

    ``rfft`` runs at the logical length ``grid[d]`` and does half the C2C
    butterflies on cufft only (the matmul and kernel backends compute the
    full C2C and trim the Hermitian half); ``dct2``/``dst2`` and their
    inverses are priced as the double-length C2C.  Line counts come from
    ``eff_grid``, which carries the R2C frequency pad.  ``dtype`` (the
    plan's, any precision) picks the kernel's path.
    """
    from .transforms import complex_dtype
    cdt = complex_dtype(dtype) if dtype is not None else torch.complex64
    n_all = math.prod(float(g) for g in eff_grid)
    lines = n_all / eff_grid[d]
    family = KIND_FAMILY.get(kind, "c2c")
    if family == "r2c":
        f = _line_flops(grid[d], backend, cdt)
        if backend == "cufft":
            f *= 0.5
    elif family == "r2r":
        f = _line_flops(2 * grid[d], backend, cdt)
    else:
        f = _line_flops(eff_grid[d], backend, cdt)
    return lines * f


def chunk_overlap_fraction(n_chunks: int) -> float:
    """Fraction of comm/compute overlap the chunked pipeline exposes:
    (n-1)/n with n chunks (chunk k's exchange runs under chunk k-1's
    transform); 0 for the bulk path."""
    if n_chunks <= 1:
        return 0.0
    return (n_chunks - 1) / n_chunks


def stage_comp_times(grid: Tuple[int, ...], decomp: Decomposition,
                     axis_sizes: Dict[str, int], machine, *,
                     backend: str = "cufft", dtype_bytes: int = 8,
                     kinds: Optional[Sequence[str]] = None,
                     eff_grid: Optional[Tuple[int, ...]] = None,
                     dtype: Optional[torch.dtype] = None) -> List[float]:
    """Per-stage local compute time (kind-aware roofline), one per stage."""
    prof = as_profile(machine)
    kinds = tuple(kinds) if kinds is not None else ("fft",) * len(grid)
    eff = tuple(eff_grid) if eff_grid is not None else tuple(grid)
    ranks = 1
    for a in decomp.mesh_axes:
        ranks *= axis_sizes[a]
    rate = prof.flops_for(backend)
    times = []
    for stage in decomp.stages:
        flops = 0.0
        for d in stage.fft_dims:
            family = KIND_FAMILY.get(kinds[d], "c2c")
            scale = prof.scale_for(family, backend)
            flops += kind_dim_flops(eff, grid, d, kinds[d], backend,
                                    dtype) * scale
        shape = local_shape(stage, eff, axis_sizes)
        touched = 2 * dtype_bytes
        for s in shape:
            touched *= s
        times.append(max(flops / ranks / rate, touched / prof.eff_mem_bw))
    return times


def hop_cost_terms(grid: Tuple[int, ...], decomp: Decomposition,
                   axis_sizes: Dict[str, int], machine, *,
                   backend: str = "cufft", dtype_bytes: int = 8,
                   kinds: Optional[Sequence[str]] = None,
                   eff_grid: Optional[Tuple[int, ...]] = None,
                   stage_times: Optional[Sequence[float]] = None,
                   dtype: Optional[torch.dtype] = None
                   ) -> List[Tuple[float, float, float, float]]:
    """Per forward hop: ``(t_comp_next, t_comm_beta, alpha_round, msgs)``.

    ``t_comp_next`` is the downstream stage's local FFT time (the work a
    chunked hop can hide), ``t_comm_beta`` the hop's bandwidth term over
    its moves' per-mesh-axis ``beta``, ``alpha_round`` the latency of one
    chunk round (``alpha * (peers - 1)`` summed over moves, so
    ``T_comm(k) = beta + alpha_round * k``), and ``msgs`` the messages per
    chunk round.  Multi-move hops are priced on the block each
    ``all_to_all`` ships (``hop_move_shapes``).  Pass
    :func:`stage_comp_times`' result as ``stage_times`` to skip
    recomputing it.
    """
    prof = as_profile(machine)
    eff = tuple(eff_grid) if eff_grid is not None else tuple(grid)
    stage_t = (list(stage_times) if stage_times is not None
               else stage_comp_times(grid, decomp, axis_sizes, prof,
                                     backend=backend,
                                     dtype_bytes=dtype_bytes,
                                     kinds=kinds, eff_grid=eff_grid,
                                     dtype=dtype))
    terms = []
    for i, hop in enumerate(decomp.redists):
        start = local_shape(decomp.stages[i], eff, axis_sizes)
        beta = alpha = msgs = 0.0
        for mv, shape in hop_move_shapes(hop, start, axis_sizes):
            peers = axis_sizes[mv.mesh_axis]
            vol = transpose_cost_bytes(shape, dtype_bytes, peers)
            beta += vol / prof.bw_for(mv.mesh_axis)
            alpha += prof.alpha_for(mv.mesh_axis) * (peers - 1)
            msgs += peers - 1
        terms.append((stage_t[i + 1], beta, alpha, msgs))
    return terms


def predict_plan_time(grid: Tuple[int, ...], decomp: Decomposition,
                      axis_sizes: Dict[str, int], machine, *,
                      backend: str = "cufft", n_chunks: int = 1,
                      dtype_bytes: int = 8,
                      sched_overhead_s: float = 0.0,
                      kinds: Optional[Sequence[str]] = None,
                      eff_grid: Optional[Tuple[int, ...]] = None,
                      chunk_schedule: Optional[Sequence[int]] = None,
                      cost_model: Optional[CostModel] = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, float]:
    """LogP/roofline prediction for one candidate plan (tuner pruning).

    Kind-aware with ``kinds`` and ``eff_grid`` (see
    :func:`kind_dim_flops`); ``machine`` is a :class:`Machine` or a
    :class:`MachineProfile`.  With ``n_chunks`` alone the whole plan gets
    one overlap fraction; with a per-hop ``chunk_schedule`` (forward hop
    order) each phase (hop + downstream stage) is priced by
    ``scheduler.hop_phase_time`` at its own chunk count — the objective the
    policy engine argmins per hop — and ``n_chunks`` is ignored.
    """
    prof = as_profile(machine)
    kinds = tuple(kinds) if kinds is not None else ("fft",) * len(grid)
    eff = tuple(eff_grid) if eff_grid is not None else tuple(grid)

    ranks = 1
    for a in decomp.mesh_axes:
        ranks *= axis_sizes[a]

    stage_t = stage_comp_times(grid, decomp, axis_sizes, prof,
                               backend=backend, dtype_bytes=dtype_bytes,
                               kinds=kinds, eff_grid=eff, dtype=dtype)
    t_comp = sum(stage_t)
    hop_terms = hop_cost_terms(grid, decomp, axis_sizes, prof,
                               backend=backend, dtype_bytes=dtype_bytes,
                               kinds=kinds, eff_grid=eff,
                               stage_times=stage_t)

    if chunk_schedule is not None:
        sched = tuple(max(int(k), 1) for k in chunk_schedule)
        if len(sched) != len(hop_terms):
            raise ValueError(
                f"chunk_schedule {sched} has {len(sched)} entries for "
                f"{len(hop_terms)} hops of {decomp.name}")
        cm = cost_model if cost_model is not None else CostModel()
        # tau_s: Eq. 5 at zero transfer volume (the chunk's bytes are in
        # the beta term), as in choose_chunk_schedule.
        tau_s = cm.steal_cost(TaskSpec(data_bytes=0))
        t_comm = 0.0
        n_msgs = 0.0
        total = stage_t[0]
        for (t_next, beta, alpha, msgs), k in zip(hop_terms, sched):
            t_comm += beta + alpha * k
            n_msgs += msgs * k
            total += hop_phase_time(t_next, beta, alpha, k, tau_s=tau_s,
                                    overlap_floor=prof.overlap)
        overlap = max([prof.overlap]
                      + [chunk_overlap_fraction(k) for k in sched])
        return {
            "t_comp_s": t_comp,
            "t_comm_s": t_comm,
            "t_total_s": total + sched_overhead_s,
            "t_sched_s": sched_overhead_s,
            "messages": n_msgs,
            "ranks": ranks,
            "overlap": overlap,
            "chunk_schedule": sched,
        }

    t_comm = 0.0
    n_msgs = 0.0
    for _, beta, alpha, msgs in hop_terms:
        t_comm += beta + alpha * n_chunks
        n_msgs += msgs * n_chunks

    overlap = max(prof.overlap, chunk_overlap_fraction(n_chunks))
    bulk = t_comp + t_comm
    overlapped = max(t_comp, t_comm)
    total = (1 - overlap) * bulk + overlap * overlapped
    return {
        "t_comp_s": t_comp,
        "t_comm_s": t_comm,
        "t_total_s": total + sched_overhead_s,
        "t_sched_s": sched_overhead_s,
        "messages": n_msgs,
        "ranks": ranks,
        "overlap": overlap,
    }


# ---------------------------------------------------------------------------
# Calibration harness: measure a MachineProfile from microbenchmarks.
# ---------------------------------------------------------------------------

def platform_name(device: torch.device) -> str:
    """The name wisdom and profiles are keyed by: the card's name on CUDA
    (an H100's wisdom is not an A100's), ``"cpu"`` on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def default_machine(device) -> Machine:
    """Model-default constants for ``device``: :data:`H100_SXM` on a GPU,
    :data:`CPU_CORE` on the CPU."""
    return H100_SXM if torch.device(device).type == "cuda" else CPU_CORE


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_best(fn, repeats: int, device: torch.device,
               timer=None, before=None) -> float:
    """Best-of-``repeats`` seconds of ``fn()`` after one warm-up call.

    The warm-up takes first-use costs (the kernel's build, cuFFT plans,
    allocator growth) out of every timing.  On CUDA each call is timed with
    CUDA events; on the CPU, or with an injected host ``timer``, with that
    clock around a call that ends in a synchronize.  ``before()`` runs
    untimed ahead of every call (a barrier between ranks).
    """
    fn()
    _sync(device)
    events = timer is None and device.type == "cuda"
    clock = timer if timer is not None else time.perf_counter
    best = float("inf")
    for _ in range(max(repeats, 1)):
        if before is not None:
            before()
            _sync(device)
        if events:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) * 1e-3
        else:
            t0 = clock()
            fn()
            _sync(device)
            dt = clock() - t0
        best = min(best, dt)
    return max(best, 1e-12)


def _calibrate_network(mesh, timer, repeats: int):
    """Per-mesh-axis all_to_all (alpha, bytes/s) from two message sizes.

    Every rank runs ``all_to_all_single`` on each axis's subgroup, after a
    barrier on that subgroup before each timed call.  Axes of size 1 cannot
    be measured and are skipped (callers fall back to the base machine's
    constants for them).
    """
    alpha: Dict[str, float] = {}
    bw: Dict[str, float] = {}
    device = mesh.device
    for axis, p in mesh.axis_sizes.items():
        if p <= 1:
            continue
        group = mesh.groups[axis]
        samples = []
        for rows_per_rank in (8, 512):
            send = torch.zeros((p, rows_per_rank, 8), dtype=torch.float32,
                               device=device)
            recv = torch.empty_like(send)
            dt = _time_best(
                lambda: dist.all_to_all_single(recv, send, group=group),
                repeats, device, timer,
                before=lambda: dist.barrier(group=group))
            vol = transpose_cost_bytes((rows_per_rank, 8 * p), 4, p)
            samples.append((float(vol), dt))
        (v1, t1), (v2, t2) = samples
        if t2 <= t1 or v2 <= v1:
            continue  # timings too noisy to separate alpha from beta
        b = (v2 - v1) / (t2 - t1)
        a = max((t1 - v1 / b) / (p - 1), 0.0)
        alpha[axis] = a
        bw[axis] = b
    return alpha, bw


def calibrate(mesh=None, *, device=None, n: int = 256, batch: int = 1024,
              repeats: int = 3, timer=None, platform: Optional[str] = None,
              base: Optional[Machine] = None) -> MachineProfile:
    """Measure a :class:`MachineProfile` on the running hardware.

    Microbenchmarks, all through ``transforms.apply_1d`` (the code the
    pipeline runs) on ``(batch, n)`` lines of ``mesh.device`` (or
    ``device``; CUDA by default):

    * ``fft`` per backend (``cufft``/``matmul``/``kernel``) -> sustained
      FLOP/s per backend;
    * ``rfft`` and ``dct2`` against ``fft`` -> per-kind-family time scales,
      for cufft and for the kernel, each against its own analytic ratios;
    * an elementwise stream over 32 MiB -> memory bandwidth;
    * ``all_to_all`` at two sizes per mesh axis larger than 1 -> per-axis
      alpha/beta.  With no such axis (one rank) the network terms stay at
      the base machine's defaults and ``net_calibrated`` is False.

    Inputs are drawn on the device from a seeded ``torch.Generator``.
    ``timer`` injects a host clock (tests pass a fake counter).  Every rank
    of a multi-rank mesh must call this together (the network benchmarks
    are collectives).
    """
    from . import transforms
    from ..compat import resolve_device

    dev = mesh.device if mesh is not None else resolve_device(device)
    platform = platform if platform is not None else platform_name(dev)
    if base is None:
        base = default_machine(dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    xc = torch.randn((batch, n), dtype=torch.complex64, device=dev,
                     generator=gen)
    xr = torch.randn((batch, n), dtype=torch.float32, device=dev,
                     generator=gen)

    def bench(kind: str, backend: str, arr) -> float:
        return _time_best(
            lambda: transforms.apply_1d(arr, -1, kind, backend=backend),
            repeats, dev, timer)

    backend_flops: Dict[str, float] = {}
    bench_s: Dict[str, float] = {}
    for backend in LOCAL_BACKENDS:
        dt = bench("fft", backend, xc)
        bench_s[backend] = dt
        backend_flops[backend] = batch * _line_flops(n, backend) / dt

    # Measured time ratio / analytic flop ratio: a scale of 1.0 means the
    # model's ratio holds on this machine.
    t_c2c = bench_s["cufft"]
    kind_scale = {"c2c": 1.0}
    kind_scale["r2c"] = max((bench("rfft", "cufft", xr) / t_c2c) / 0.5, 1e-6)
    r2r_ratio = _line_flops(2 * n, "cufft") / _line_flops(n, "cufft")
    kind_scale["r2r"] = max((bench("dct2", "cufft", xr) / t_c2c) / r2r_ratio,
                            1e-6)
    # The kernel's own family: its rfft is the full C2C (ratio 1.0), its
    # R2R priced as the double-length transform.
    t_kc2c = bench_s["kernel"]
    kind_scale["kernel:r2c"] = max(bench("rfft", "kernel", xr) / t_kc2c, 1e-6)
    k_r2r_ratio = _line_flops(2 * n, "kernel") / _line_flops(n, "kernel")
    kind_scale["kernel:r2r"] = max(
        (bench("dct2", "kernel", xr) / t_kc2c) / k_r2r_ratio, 1e-6)

    big = torch.zeros((1 << 23,), dtype=torch.float32, device=dev)  # 32 MiB
    mem_bw = 2.0 * big.numel() * 4 / _time_best(lambda: big * 1.0000001,
                                                repeats, dev, timer)

    net_alpha: Dict[str, float] = {}
    net_bw_d: Dict[str, float] = {}
    if mesh is not None:
        net_alpha, net_bw_d = _calibrate_network(mesh, timer, repeats)

    return MachineProfile(
        base=base, platform=platform, calibrated=True,
        net_calibrated=bool(net_alpha),
        backend_flops=tuple(sorted(backend_flops.items())),
        kind_scale=tuple(sorted(kind_scale.items())),
        mem_bw=mem_bw,
        net_alpha_s=tuple(sorted(net_alpha.items())),
        net_bw=tuple(sorted(net_bw_d.items())))
