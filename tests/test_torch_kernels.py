"""The port's four-step kernel module (``repro_torch/kernels``): every case
of ``tests/test_kernels.py`` on the wrappers, which run the kernel's plain
version for CPU tensors, held against the JAX package's Pallas kernel in
interpret mode (or ``np.fft``, as the reference test does), and the launch
sizing.  The CUDA kernel itself is tested in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hermetic container: fixed-seed shim
    from _propcheck import given, settings, strategies as st

from repro.kernels import fft_matmul as jfm
from repro.kernels import ops as jops
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import ops, radix, ref
from repro_torch.core.redistribute import send_buffer
from torch_harness import assert_scaled_close, cplx

rng = np.random.default_rng(7)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("b,n", [(1, 16), (4, 64), (8, 128), (3, 96),
                                 (130, 512), (2, 33), (5, 1024)])
def test_forward_sweep_matches_pallas(b, n):
    x = cplx((b, n), 100 + n)
    got = ops.fft1d(_t(x)).numpy()
    want = np.asarray(jops.fft1d(jnp.asarray(x)))
    assert_scaled_close(got, want, 5e-6)
    assert_scaled_close(got, ref.fft1d_ref(_t(x)).numpy(), 5e-6)


@pytest.mark.parametrize("b,n", [(4, 64), (2, 256)])
def test_inverse_sweep_matches_pallas(b, n):
    x = cplx((b, n), 200 + n)
    got = ops.ifft1d(_t(x)).numpy()
    assert_scaled_close(got, np.asarray(jops.ifft1d(jnp.asarray(x))), 5e-6)
    assert_scaled_close(got, ref.ifft1d_ref(_t(x)).numpy(), 5e-6)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_axis_handling(axis):
    x = cplx((4, 6, 8), 3)
    got = ops.fft1d(_t(x), axis).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x, axis=axis),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plane_dtypes(dtype):
    xr = rng.standard_normal((4, 32)).astype(dtype)
    xi = rng.standard_normal((4, 32)).astype(dtype)
    cdt = torch.complex64 if dtype == np.float32 else torch.complex128
    out = tfm.fft_fourstep(torch.complex(_t(xr), _t(xi)).to(cdt))
    assert out.dtype == cdt
    refr, refi = ref.fft1d_planes_ref(_t(xr), _t(xi))
    np.testing.assert_allclose(out.real.numpy(), refr.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.imag.numpy(), refi.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_batch_not_a_tile_multiple():
    for b in (1, 127, 129, 300):
        x = cplx((b, 64), b)
        np.testing.assert_allclose(ops.fft1d(_t(x)).numpy(),
                                   np.fft.fft(x, axis=-1),
                                   rtol=1e-4, atol=1e-3)


@settings(max_examples=15, deadline=None)
@given(b=st.integers(1, 9), n=st.sampled_from([8, 16, 32, 48, 64, 128]),
       inverse=st.booleans(), seed=st.integers(0, 2**31 - 1))
def test_property_roundtrip(b, n, inverse, seed):
    x = cplx((b, n), seed)
    fwd = ops.fft1d(_t(x)) if not inverse else ops.ifft1d(_t(x))
    back = ops.ifft1d(fwd) if not inverse else ops.fft1d(fwd)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [13, 17, 31])
@pytest.mark.parametrize("inverse", [False, True])
def test_prime_n_degenerate(n, inverse):
    x = cplx((4, n), n)
    fn, want = (ops.ifft1d, np.fft.ifft) if inverse else (ops.fft1d,
                                                           np.fft.fft)
    np.testing.assert_allclose(fn(_t(x)).numpy(), want(x, axis=-1),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("axis", [0, 1, 2, -1, -2])
@pytest.mark.parametrize("inverse", [False, True])
def test_every_axis_both_directions(axis, inverse):
    x = cplx((3, 5, 8), 17)
    fn, want = (ops.ifft1d, np.fft.ifft) if inverse else (ops.fft1d,
                                                           np.fft.fft)
    np.testing.assert_allclose(fn(_t(x), axis).numpy(), want(x, axis=axis),
                               rtol=1e-4, atol=1e-4)


def test_complex128_parity():
    r = np.random.default_rng(3)
    x = r.standard_normal((5, 48)) + 1j * r.standard_normal((5, 48))
    y = ops.fft1d(_t(x))
    assert y.dtype == torch.complex128
    np.testing.assert_allclose(y.numpy(), np.fft.fft(x, axis=-1),
                               rtol=1e-10, atol=1e-9)
    yi = ops.ifft1d(_t(x), 0)
    np.testing.assert_allclose(yi.numpy(), np.fft.ifft(x, axis=0),
                               rtol=1e-10, atol=1e-9)


def test_empty_batch():
    out = tfm.fft_fourstep(torch.zeros((0, 16), dtype=torch.complex64))
    assert out.shape == (0, 16) and out.dtype == torch.complex64
    packed = tfm.fft_fourstep(torch.zeros((0, 16), dtype=torch.complex64),
                              pack_parts=4)
    assert packed.shape == (0, 4, 4)
    y = ops.fft1d(torch.zeros((0, 8, 16), dtype=torch.complex64), -1)
    assert y.shape == (0, 8, 16) and y.dtype == torch.complex64
    y2 = ops.ifft1d(torch.zeros((4, 0, 16), dtype=torch.complex64), 1)
    assert y2.shape == (4, 0, 16)
    send = ops.packed_fft1d(torch.zeros((0, 8), dtype=torch.complex64), 1, 2)
    assert send.shape == (2, 0, 4)


@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_epilogue_matches_pallas(inverse):
    x = cplx((6, 24), 21)
    t = np.exp(-1j * np.pi * np.arange(24) / 48).astype(np.complex64)
    fn, jfn = (ops.ifft1d, jops.ifft1d) if inverse else (ops.fft1d,
                                                          jops.fft1d)
    got = fn(_t(x), twiddle=_t(t)).numpy()
    want = np.asarray(jfn(jnp.asarray(x), twiddle=jnp.asarray(t)))
    assert_scaled_close(got, want, 5e-6)
    base = np.fft.ifft if inverse else np.fft.fft
    np.testing.assert_allclose(got, t * base(x, axis=-1), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_pack_parts_epilogue_matches_pallas(parts):
    x = cplx((5, 32), 30 + parts)
    got = tfm.fft_fourstep(_t(x), pack_parts=parts)
    assert tuple(got.shape) == (5, parts, 32 // parts)
    # destination-major storage: the (p, B, N/p) buffer is contiguous
    assert got.transpose(0, 1).is_contiguous()
    jr, ji = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              pack_parts=parts)
    assert_scaled_close(got.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
                        5e-6)
    np.testing.assert_allclose(ops.fft1d(_t(x), pack_parts=parts).numpy(),
                               np.fft.fft(x, axis=-1), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="pack_parts"):
        tfm.fft_fourstep(torch.zeros((2, 32), dtype=torch.complex64),
                         pack_parts=5)


@pytest.mark.parametrize("axis,parts", [(0, 2), (1, 4), (2, 2)])
def test_packed_fft1d_is_the_send_buffer(axis, parts):
    """The pipeline's packed store is exactly the send buffer redistribute
    would build from the logical result — as a view of the kernel output."""
    x = _t(cplx((8, 4, 8), 40 + axis))
    send = ops.packed_fft1d(x, axis, parts)
    logical = ops.fft1d(x, axis)
    assert torch.equal(send, send_buffer(logical, axis, parts))
    assert send.is_contiguous()
    ifft_send = ops.packed_fft1d(x, axis, parts, inverse=True)
    assert torch.equal(ifft_send,
                       send_buffer(ops.ifft1d(x, axis), axis, parts))


def test_constant_planes_match_reference():
    """The kernel's complex constants equal the Pallas kernel's planes."""
    for n1, n2, inv in ((16, 32, False), (1, 13, True), (4, 6, False)):
        consts = tfm._device_constants(n1, n2, inv, torch.complex128,
                                       torch.device("cpu"))
        j = jfm._planes(n1, n2, inv, "float64")
        for got, (re, im) in zip(consts, (j[0:2], j[2:4], j[4:6])):
            np.testing.assert_allclose(got.numpy(), re + 1j * im, atol=1e-12)


def test_launch_config_fits_shared_memory():
    cfg = tfm.launch_config(512, 8, False)
    assert cfg.lines == 8 and cfg.w2_in_smem
    assert cfg.smem_bytes == tfm.smem_bytes(16, 32, 8, False, True, 8)
    assert cfg.smem_bytes <= tfm.SMEM_TARGET_BYTES
    prime = tfm.launch_config(521, 8, False)
    assert not prime.w2_in_smem          # 521x521 W2 streams from L2
    assert prime.smem_bytes <= tfm.SMEM_MAX_BYTES
    c128 = tfm.launch_config(1024, 16, True)
    assert c128.w2_in_smem and c128.smem_bytes <= tfm.SMEM_TARGET_BYTES
    limit = tfm.max_line_length(8, False)
    tfm.launch_config(limit, 8, False)
    with pytest.raises(ValueError, match=f"N up to {limit}"):
        tfm.launch_config(limit + 1, 8, False)
    # the radix path's tiles: a row per thread at N = 512, two blocks per
    # SM for contiguous lines, one block's 227 KB for strided tiles
    main = radix.radix_tile(512, 8, False, strided=False)
    assert main.lines == 16 and main.smem_bytes == 8 * (
        512 + 16 + 16 * 16 * 33)
    assert main.lines * 16 == radix.THREADS
    strided = radix.radix_tile(512, 8, True, strided=True)
    assert strided.lines == radix.STRIDED_LINES
    assert strided.smem_bytes == 8 * (512 + 16 + 512 + 16 * 512)
    for dtype, sizes in radix.RADIX_SIZES.items():
        item = dtype.itemsize
        for n in sizes:
            for tw in (False, True):
                tile = radix.radix_tile(n, item, tw, strided=False)
                assert tile.smem_bytes <= tfm.SMEM_TARGET_BYTES
                assert tile.lines & (tile.lines - 1) == 0
                st = radix.radix_tile(n, item, tw, strided=True)
                assert (st is None) == (n * item > 8 * 1024)
                if st is not None:
                    assert st.smem_bytes <= tfm.SMEM_MAX_BYTES
    assert not tfm.strided_supported(2048, torch.complex64, False)
    assert not tfm.strided_supported(1024, torch.complex128, False)
    assert not tfm.strided_supported(96, torch.complex64, False)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="complex64 or complex128"):
        tfm.fft_fourstep(torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        tfm.fft_fourstep(torch.zeros((8, 2), dtype=torch.complex64).T)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tfm.fft_fourstep(torch.zeros((2, 2, 8), dtype=torch.complex64))
    with pytest.raises(ValueError, match="twiddle"):
        tfm.fft_fourstep(torch.zeros((2, 8), dtype=torch.complex64),
                         twiddle=torch.ones(4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="meta"):
        tfm.fft_fourstep(torch.zeros((2, 8), dtype=torch.complex64,
                                     device="meta"))


def test_cpu_runs_the_plain_version_without_counting_launches():
    tfm.reset_launch_counts()
    ops.fft1d(_t(cplx((4, 16), 1)))
    assert tfm.fft_fourstep.launches == 0
    assert set(tfm.fft_fourstep.variant_launches) == {"fourstep", "pack",
                                                      "twiddle"}
    assert tfm.fft_fourstep.path_launches == {"radix": 0, "dense": 0}
    assert tfm.fft_fourstep.layout_launches == {"lines": 0, "strided": 0}


def test_kernel_operands_are_resolved():
    """The kernel reads raw memory: a lazily conjugated operand or twiddle
    (and a negated view) is materialized before its pointer is taken."""
    x = _t(cplx((3, 16), 50))
    tw = _t(np.exp(-1j * np.pi * np.arange(16) / 32).astype(np.complex64))
    assert x.conj().is_conj() and x.conj().imag.is_neg()
    rx, rtw = tfm._resolved(x.conj(), tw.conj())
    assert not rx.is_conj() and not rtw.is_conj()
    assert torch.equal(rx, torch.conj_physical(x))
    assert torch.equal(rtw, torch.conj_physical(tw)) and rtw.is_contiguous()
    neg, _ = tfm._resolved(torch._neg_view(x), None)
    assert not neg.is_neg() and torch.equal(neg, -x)
    assert tfm._resolved(x, None)[0] is x       # nothing to do: no copy
    # the wrapper's result honours the bits (the plain version on the CPU)
    got = tfm.fft_fourstep(x.conj(), twiddle=tw.conj())
    want = np.conj(tw.numpy()) * np.fft.fft(np.conj(x.numpy()), axis=-1)
    assert_scaled_close(got.numpy(), want, 5e-6)


@pytest.mark.parametrize("n,dtype,path", [
    (1, torch.complex64, "dense"), (2, torch.complex64, "radix"),
    (512, torch.complex64, "radix"), (4096, torch.complex64, "radix"),
    (8192, torch.complex64, "dense"), (24, torch.complex64, "dense"),
    (33, torch.complex64, "dense"), (96, torch.complex64, "dense"),
    (521, torch.complex64, "dense"), (1024, torch.complex128, "radix"),
    (2, torch.complex128, "dense"), (4, torch.complex128, "radix"),
    (2048, torch.complex128, "dense"), (4096, torch.complex128, "dense"),
    (48, torch.complex128, "dense")])
def test_kernel_path_selection(n, dtype, path):
    """The path follows N and the dtype alone: power-of-two N with an
    instantiation takes the radix kernel, every other N the dense one."""
    assert radix.kernel_path(n, dtype) == path


def test_radix_plan_factors_and_codelets():
    for k in range(1, 13):
        n = 2 ** k
        plan = radix.radix_plan(n)
        assert (plan.n1, plan.n2) == (2 ** (k // 2), 2 ** (k - k // 2))
        assert len(plan.column) == k // 2 and len(plan.row) == k - k // 2
        # every stage touches each register once; twiddle indices stay
        # inside the shared N2/2-entry table
        for stages, length in ((plan.column, plan.n1), (plan.row, plan.n2)):
            for stage in stages:
                touched = sorted(i for top, bot, _ in stage
                                 for i in (top, bot))
                assert touched == list(range(length))
                assert all(w is None or 0 < w < plan.n2 // 2
                           for _, _, w in stage)
    assert [radix.bitrev(i, 3) for i in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]
    for bad in (0, 1, 12, 96):
        with pytest.raises(ValueError, match="power of two"):
            radix.radix_plan(bad)


@pytest.mark.parametrize("n", [2 ** k for k in range(1, 13)])
@pytest.mark.parametrize("inverse", [False, True])
def test_radix_plan_matches_numpy(n, inverse):
    """The kernel's radix plan, tiles and index maps, run in torch
    (``radix.emulate``), against np.fft: contiguous lines with a ragged
    last tile, the twiddle and pack_parts epilogues, and strided blocks
    with a ragged last group of inner indices."""
    x = cplx((37, n), 300 + n, np.complex128)
    base = np.fft.ifft if inverse else np.fft.fft
    want = base(x, axis=-1)
    got = radix.emulate(_t(x), inverse=inverse).numpy()
    assert_scaled_close(got, want, 1e-12)
    tw = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    got = radix.emulate(_t(x), inverse=inverse, twiddle=_t(tw)).numpy()
    assert_scaled_close(got, tw * want, 1e-12)
    if n >= 4:
        got = radix.emulate(_t(x), inverse=inverse, pack_parts=4).numpy()
        assert_scaled_close(got, want.reshape(37, 4, n // 4)
                            .transpose(1, 0, 2), 1e-12)
    if tfm.strided_supported(n, torch.complex64, True):
        xs = cplx((2, n, 20), 400 + n)
        got = radix.emulate(_t(xs), inverse=inverse, twiddle=_t(tw),
                            strided=True).numpy()
        assert_scaled_close(got, tw[:, None] * base(xs, axis=1), 5e-6)


def _grid_layouts(x):
    """A contiguous grid and a permuted view of another contiguous block,
    as a previous stage may leave it."""
    return [x, x.permute(2, 0, 1).contiguous().permute(1, 2, 0)]


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("op", ["fft", "ifft", "twiddle"])
def test_strided_routing_matches_pallas(axis, op):
    """ops.fft1d/ifft1d (and the twiddle epilogue) on every axis of a
    small 3-D grid, in place in x's layout: no line copy, the output keeps
    x's strides, and the values match the JAX package's kernel."""
    x = cplx((4, 64, 32), 60 + axis)
    n = x.shape[axis]
    tw = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(np.complex64)
    kw, jkw = ({"twiddle": _t(tw)}, {"twiddle": jnp.asarray(tw)}) \
        if op == "twiddle" else ({}, {})
    fn, jfn = (ops.ifft1d, jops.ifft1d) if op == "ifft" else (ops.fft1d,
                                                             jops.fft1d)
    want = np.asarray(jfn(jnp.asarray(x), axis, **jkw))
    for xt in _grid_layouts(_t(x)):
        ops.copies["lines"] = 0
        got = fn(xt, axis, **kw)
        assert ops.copies["lines"] == 0
        assert got.stride() == xt.stride()
        assert_scaled_close(got.numpy(), want, 5e-6)


def test_strided_routing_masks_ragged_inner_and_copies_narrow_ones():
    # inner = 20: one full tile of 16 inner indices and a ragged one of 4
    x = cplx((3, 32, 20), 70)
    ops.copies["lines"] = 0
    got = ops.fft1d(_t(x), 1)
    assert ops.copies["lines"] == 0
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    # inner = 8 is narrower than a strided tile: the lines are copied
    x = cplx((3, 32, 8), 71)
    got = ops.fft1d(_t(x), 1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    # a general-path N on a strided axis and a pack on one are copied too
    ops.fft1d(_t(cplx((3, 24, 16), 72)), 1)
    ops.packed_fft1d(_t(cplx((3, 32, 16), 73)), 1, 2)
    assert ops.copies["lines"] == 3


def test_dense_layout():
    x = torch.zeros((2, 3, 4, 5))
    assert ops.dense_layout(x, 1) == ([0, 1, 2, 3], 2, 20)
    y = x.permute(3, 1, 0, 2)
    perm, outer, inner = ops.dense_layout(y, 1)
    assert y.permute(perm).is_contiguous() and (outer, inner) == (2, 20)
    assert ops.dense_layout(x[:, :, :2], 1) is None     # not dense
    assert ops.dense_layout(torch.zeros(3, 1).expand(3, 4), 0) is None
    assert ops.dense_layout(x[:1], 3) == ([0, 1, 2, 3], 12, 1)


def test_strided_entry_and_its_plain_version():
    x = cplx((3, 64, 17), 80)
    tw = np.exp(-1j * np.pi * np.arange(64) / 128).astype(np.complex64)
    got = tfm.fft_fourstep_strided(_t(x), inverse=True, twiddle=_t(tw))
    assert got.shape == (3, 64, 17) and got.is_contiguous()
    assert_scaled_close(got.numpy(), tw[:, None] * np.fft.ifft(x, axis=1),
                        5e-6)
    with pytest.raises(ValueError, match=r"\(outer, N, inner\)"):
        tfm.fft_fourstep_strided(torch.zeros((4, 64), dtype=torch.complex64))
    with pytest.raises(ValueError, match="contiguous"):
        tfm.fft_fourstep_strided(
            torch.zeros((2, 16, 64), dtype=torch.complex64).transpose(1, 2))
    with pytest.raises(ValueError, match="no strided radix tile"):
        tfm.fft_fourstep_strided(torch.zeros((1, 96, 16),
                                             dtype=torch.complex64))


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ gives a new library name, so a stale
    build is never loaded; an unchanged tree keeps its name."""
    from repro_torch.kernels import build
    src = build.csrc_dir()
    names = [p.name for p in build.sources("fft_fourstep")]
    assert names == ["fft_fourstep.cu", "fft_common.cuh", "fft_radix.cuh"]
    for name in names:
        (tmp_path / name).write_bytes((src / name).read_bytes())
    monkeypatch.setattr(build, "csrc_dir", lambda: tmp_path)
    first = build._target("fft_fourstep")
    assert build._target("fft_fourstep") == first
    common = tmp_path / "fft_common.cuh"
    common.write_bytes(common.read_bytes() + b"\n// edited\n")
    assert build._target("fft_fourstep") != first
