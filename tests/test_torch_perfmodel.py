"""The port's perf model (``repro_torch.core.perfmodel``) against the JAX
package's: under the backend name map (``cufft`` <-> ``xla``, ``matmul``
<-> ``matmul``) and one machine, per-stage compute times, per-hop cost
terms and plan predictions agree to 1e-12 relative; the ``kernel`` backend
is priced by what the kernel runs (``kernels.radix.kernel_path``);
calibration on the CPU with an injected timer skips the network on one
rank."""
import itertools
import math
import types

import numpy as np
import pytest
import torch

from repro.core import decomp as jd
from repro.core import perfmodel as jpm
from repro.core import pipeline as jp
from repro.core import tuner as jt
from repro_torch.compat import Mesh, make_mesh
from repro_torch.core import decomp as td
from repro_torch.core import perfmodel as tpm
from repro_torch.core import pipeline as tp
from repro_torch.core import tuner as tt
from repro_torch.core.transforms import REFERENCE_BACKEND
from repro_torch.kernels import dense
from repro_torch.kernels.chirp import chirp_length
from repro_torch.kernels.radix import kernel_path

REL = 1e-12
NAMES = ("data", "model")


def rank_view(shape):
    """One rank's view of a mesh: the port's and the reference's (the
    reference's spec code reads only axis names and the device shape)."""
    port = Mesh(NAMES[:len(shape)], tuple(shape), (0,) * len(shape),
                torch.device("cpu"), {n: None for n in NAMES[:len(shape)]})
    ref = types.SimpleNamespace(axis_names=NAMES[:len(shape)],
                                devices=np.empty(shape, dtype=object))
    return port, ref


def machines():
    """One uncalibrated machine and one calibrated profile, in both
    packages' vocabularies."""
    ref_prof = jpm.MachineProfile(
        base=jpm.CPU_CORE, platform="cpu", calibrated=True,
        net_calibrated=True,
        backend_flops=(("matmul", 3.1e9), ("pallas", 2.2e9), ("xla", 7.5e9)),
        kind_scale=(("c2c", 1.0), ("pallas:r2c", 1.3), ("pallas:r2r", 0.9),
                    ("r2c", 1.7), ("r2r", 1.2)),
        mem_bw=5.5e9, net_alpha_s=(("data", 3e-5), ("model", 1e-5)),
        net_bw=(("data", 0.5e9), ("model", 2e9)))
    port_prof = tpm.MachineProfile.from_json(ref_prof.to_json())
    return [(tpm.CPU_CORE, jpm.CPU_CORE), (port_prof, ref_prof)]


def test_profile_from_reference_json_maps_backend_names():
    port, _ = machines()[1]
    assert dict(port.backend_flops) == {"cufft": 7.5e9, "matmul": 3.1e9,
                                        "kernel": 2.2e9}
    assert dict(port.kind_scale)["kernel:r2c"] == 1.3
    assert port.scale_for("r2c", "cufft") == 1.7
    assert port.scale_for("r2c", "kernel") == 1.3
    assert port.scale_for("r2c", "matmul") == 1.0
    assert tpm.MachineProfile.from_json(port.to_json()) == port


DECOMPS = [("pencil", NAMES, None, (2, 4), (16, 32, 64)),
           ("pencil", NAMES[::-1], None, (2, 4), (16, 32, 64)),
           ("slab", ("model",), None, (2, 4), (16, 32, 64)),
           ("hybrid", NAMES, ((0,), (1, 2)), (2, 4), (16, 32, 64)),
           ("hybrid", NAMES, ((0, 1), (2, 3)), (2, 2), (8, 8, 16, 16)),
           ("pencil", NAMES, None, (1, 1), (64, 64, 64))]


def _kinds(name, ndim):
    if name == "c2c":
        return ("fft",) * ndim
    if name == "r2c":
        return ("rfft",) + ("fft",) * (ndim - 1)
    return ("dct2",) + ("fft",) * (ndim - 2) + ("dst2",)


def _close(a, b):
    assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b, (a, b)


@pytest.mark.parametrize("case", DECOMPS)
@pytest.mark.parametrize("family", ["c2c", "r2c", "r2r"])
@pytest.mark.parametrize("backend", ["cufft", "matmul"])
@pytest.mark.parametrize("which", [0, 1])
def test_model_matches_reference(case, family, backend, which):
    kind, axes, groups, shape, grid = case
    port_mesh, ref_mesh = rank_view(shape)
    sizes = dict(zip(NAMES, shape))
    kinds = _kinds(family, len(grid))
    tdec = td.make_decomposition(kind, axes, len(grid), dim_groups=groups)
    jdec = jd.make_decomposition(kind, axes, len(grid), dim_groups=groups)
    teff = tp.effective_grid(grid, tdec, sizes, kinds)
    jeff = jp.effective_grid(grid, jdec, sizes, kinds)
    assert teff == jeff
    tm, jm = machines()[which]
    rb = REFERENCE_BACKEND[backend]
    for db in (4, 8, 16):
        got = tpm.stage_comp_times(grid, tdec, sizes, tm, backend=backend,
                                   dtype_bytes=db, kinds=kinds, eff_grid=teff)
        want = jpm.stage_comp_times(grid, jdec, sizes, jm, backend=rb,
                                    dtype_bytes=db, kinds=kinds,
                                    eff_grid=jeff)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
        got_t = tpm.hop_cost_terms(grid, tdec, sizes, tm, backend=backend,
                                   dtype_bytes=db, kinds=kinds, eff_grid=teff)
        want_t = jpm.hop_cost_terms(grid, jdec, sizes, jm, backend=rb,
                                    dtype_bytes=db, kinds=kinds,
                                    eff_grid=jeff)
        for a, b in zip(itertools.chain(*got_t), itertools.chain(*want_t)):
            _close(a, b)
        n_hops = len(tdec.redists)
        schedules = [None, (1,) * n_hops, (4,) * n_hops,
                     tuple(2 ** (i + 1) for i in range(n_hops))]
        for sched in schedules:
            for n_chunks in (1, 4):
                got_p = tpm.predict_plan_time(
                    grid, tdec, sizes, tm, backend=backend,
                    n_chunks=n_chunks, dtype_bytes=db, kinds=kinds,
                    eff_grid=teff, chunk_schedule=sched)
                want_p = jpm.predict_plan_time(
                    grid, jdec, sizes, jm, backend=rb, n_chunks=n_chunks,
                    dtype_bytes=db, kinds=kinds, eff_grid=jeff,
                    chunk_schedule=sched)
                assert got_p.keys() == want_p.keys()
                for k in got_p:
                    if isinstance(got_p[k], tuple):
                        assert got_p[k] == want_p[k]
                    else:
                        _close(got_p[k], want_p[k])
    # the legacy C2C-on-the-logical-grid pricing (kinds=None) too
    _close(tpm.predict_plan_time(grid, tdec, sizes, tm,
                                 backend=backend)["t_total_s"],
           jpm.predict_plan_time(grid, jdec, sizes, jm,
                                 backend=rb)["t_total_s"])


@pytest.mark.parametrize("case", DECOMPS[:4])
@pytest.mark.parametrize("batch_shape", [(), (4,), (3, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_policy_engine_matches_reference_with_batch_dims(case, batch_shape,
                                                         inverse):
    """The per-hop schedule the policy engine proposes (which reads the
    model's hop terms and each hop's feasible counts, batch dims
    included) equals the reference's, on cufft/xla."""
    kind, axes, groups, shape, grid = case
    port_mesh, ref_mesh = rank_view(shape)
    sizes = dict(zip(NAMES, shape))
    for tm, jm in machines():
        for family in ("c2c", "r2c"):
            kinds = _kinds(family, len(grid))
            tdec = td.make_decomposition(kind, axes, len(grid),
                                         dim_groups=groups)
            jdec = jd.make_decomposition(kind, axes, len(grid),
                                         dim_groups=groups)
            bspec = (None,) * len(batch_shape)
            tspec = tp.make_spec(port_mesh, grid, tdec, kinds,
                                 inverse=inverse, batch_spec=bspec)
            jspec = jp.make_spec(ref_mesh, grid, jdec, kinds,
                                 inverse=inverse, batch_spec=bspec)
            got = tt.propose_chunk_schedule(tspec, sizes, tm,
                                            batch_shape=batch_shape)
            want = jt.propose_chunk_schedule(jspec, sizes, jm,
                                             batch_shape=batch_shape)
            assert got == want
            assert tt.feasible_hop_chunk_counts(tspec, sizes, batch_shape) \
                == jt.feasible_hop_chunk_counts(jspec, sizes, batch_shape)


@pytest.mark.parametrize("n", [2, 8, 12, 13, 64, 96, 384, 512, 1024, 2048,
                               3001, 4096, 6144, 8192, 10007, 16384, 32768,
                               1 << 22, 1 << 24, 544, 4725])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kernel_line_flops_follow_kernel_path(n, dtype):
    got = tpm._line_flops(n, "kernel", dtype)
    if kernel_path(n, dtype) in ("radix", "long"):
        assert got == 5.0 * n * math.log2(n)
        assert got == tpm._line_flops(n, "cufft")
    elif kernel_path(n, dtype) == "split":
        # the butterflies plus the inter-step twiddle between the passes,
        # not factorize's dense count
        assert got == 5.0 * n * math.log2(n) + 6.0 * n
        assert tpm._line_flops(n, "cufft") < got \
            < tpm._line_flops(n, "matmul")
    elif kernel_path(n, dtype) == "chirp":
        # two transforms of M on their route, their twiddles and the
        # input's chirp
        m = chirp_length(n, dtype)
        assert got == 2.0 * tpm._line_flops(m, "kernel", dtype) \
            + 6.0 * (2 * m + n)
        assert tpm._line_flops(n, "cufft") < got \
            < tpm._line_flops(n, "matmul")
    else:
        # the dense route's mixed-radix chain: 5 n log2 over its 13-smooth
        # part, 8 n p per generic stage (816 = 17*48: one), not
        # factorize's dense count
        rs = dense.chain(n)
        assert got == 5.0 * n * math.log2(math.prod(
            r for r in rs if r <= 13)) + sum(8.0 * n * p for p in rs
                                             if p > 13)
        assert got < tpm._line_flops(n, "matmul")
    # a kind's flops pick the path at the length the kernel runs
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    grid = (n, 4)
    assert tpm.kind_dim_flops(grid, grid, 0, "fft", "kernel", real) == \
        4 * got
    assert tpm.kind_dim_flops(grid, grid, 0, "dct2", "kernel", dtype) == \
        4 * tpm._line_flops(2 * n, "kernel", dtype)


def test_kernel_stage_time_differs_from_reference_pallas_on_radix_sizes():
    """The reference prices ``pallas`` as the dense four-step at every N;
    the port's ``kernel`` on a radix N costs what cufft costs."""
    grid = (512, 512, 512)
    sizes = {"data": 1, "model": 1}
    tdec = td.make_decomposition("pencil", NAMES, 3)
    fast = tpm.MachineProfile(base=tpm.H100_SXM, platform="x",
                              calibrated=True, backend_flops=(
                                  ("cufft", 1e12), ("kernel", 1e12),
                                  ("matmul", 1e12)), mem_bw=1e15)
    k = tpm.stage_comp_times(grid, tdec, sizes, fast, backend="kernel")
    c = tpm.stage_comp_times(grid, tdec, sizes, fast, backend="cufft")
    m = tpm.stage_comp_times(grid, tdec, sizes, fast, backend="matmul")
    assert k == c and all(a < b for a, b in zip(k, m))


def test_calibrate_on_cpu_with_injected_timer_skips_network():
    ticks = iter(range(10 ** 6))
    timer = lambda: next(ticks) * 1e-3  # noqa: E731
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    prof = tpm.calibrate(mesh, n=32, batch=16, repeats=2, timer=timer)
    assert prof.calibrated and not prof.net_calibrated
    assert prof.net_alpha_s == () and prof.net_bw == ()
    assert prof.platform == "cpu" and prof.base == tpm.CPU_CORE
    assert dict(prof.backend_flops).keys() == {"cufft", "matmul", "kernel"}
    assert set(dict(prof.kind_scale)) == {"c2c", "r2c", "r2r", "kernel:r2c",
                                          "kernel:r2r"}
    # every timing is one tick of the fake clock
    assert dict(prof.backend_flops)["cufft"] == pytest.approx(
        16 * tpm._line_flops(32, "cufft") / 1e-3)
    assert prof.mem_bw == pytest.approx(2.0 * (1 << 23) * 4 / 1e-3)
    assert tpm.MachineProfile.from_json(prof.to_json()) == prof
    # without a mesh, on the device asked for
    prof2 = tpm.calibrate(device="cpu", n=32, batch=16, repeats=1,
                          timer=timer)
    assert not prof2.net_calibrated and prof2.platform == "cpu"


def test_default_machine_and_platform():
    assert tpm.default_machine("cpu") == tpm.CPU_CORE
    assert tpm.default_machine(torch.device("cuda", 0)) == tpm.H100_SXM
    assert tpm.platform_name(torch.device("cpu")) == "cpu"
    assert (tpm.H100_SXM.flops, tpm.H100_SXM.mem_bw) == (67e12, 3.35e12)
    assert not hasattr(tpm, "TPU_V5E")
