"""The port's local transforms (``repro_torch/core/transforms.py``) against
the JAX package's ``apply_1d``: each port backend against the reference
backend of the same role (``cufft``/``xla``, ``matmul``/``matmul``,
``kernel``/``pallas`` — the Pallas kernel in interpret mode, as the JAX
package's own tests run it).  C2C kinds at ``tests/test_kernels.py``'s 5e-6
scaled; R2C/R2R kinds at ``tests/test_pallas_backend.py``'s 2e-5 scaled,
against ``xla`` and, for the kernel backend, ``pallas``; float64 against
the reference under x64 (complex128) at 1e-12."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as jt
from repro_torch.core import transforms as tt
from torch_harness import assert_scaled_close, cplx, run_reference

R2C_R2R_KINDS = tt.R2C_KINDS + tt.R2R_KINDS

SHAPES = [(1, 16), (4, 64), (8, 128), (3, 96), (130, 512), (2, 33),
          (5, 1024)]
PAIRS = [("cufft", "xla"), ("matmul", "matmul"), ("kernel", "pallas")]


def _pair(x: np.ndarray, axis: int, kind: str, backend: str):
    got = tt.apply_1d(torch.from_numpy(x), axis, kind, backend=backend)
    ref = jt.apply_1d(jnp.asarray(x), axis, kind,
                      backend=tt.REFERENCE_BACKEND[backend])
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("backend", [p[0] for p in PAIRS])
@pytest.mark.parametrize("b,n", SHAPES)
def test_apply_1d_forward_matches_reference(backend, b, n):
    got, ref = _pair(cplx((b, n), b * 1000 + n), -1, "fft", backend)
    assert got.dtype == np.complex64
    assert_scaled_close(got, ref, 5e-6)


@pytest.mark.parametrize("backend", [p[0] for p in PAIRS])
@pytest.mark.parametrize("b,n", [(4, 64), (2, 256), (3, 31)])
def test_apply_1d_inverse_matches_reference(backend, b, n):
    got, ref = _pair(cplx((b, n), 7 + n), -1, "ifft", backend)
    assert_scaled_close(got, ref, 5e-6)


@pytest.mark.parametrize("backend", [p[0] for p in PAIRS])
@pytest.mark.parametrize("axis", [0, 1, 2, -1, -2])
def test_apply_1d_every_axis_matches_reference(backend, axis):
    for kind in ("fft", "ifft"):
        got, ref = _pair(cplx((3, 5, 8), 11), axis, kind, backend)
        assert_scaled_close(got, ref, 5e-6)


@pytest.mark.parametrize("kind", ["fft", "ifft", "dct2", "dct3"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_backend_strided_axes_match_pallas(kind, axis):
    """The kernel backend on every axis of a small 3-D grid whose lengths
    take the radix path: the C2C lines run in the grid's own layout (the
    strided entry for axes 0 and 1) with no line copy, and match the
    Pallas kernel in interpret mode."""
    from repro_torch.kernels import ops
    x = cplx((4, 64, 32), 90 + axis) if kind in tt.C2C_KINDS else \
        np.random.default_rng(90 + axis).standard_normal(
            (4, 64, 32)).astype(np.float32)
    ops.copies["lines"] = 0
    got, ref = _pair(x, axis, kind, "kernel")
    if kind in tt.C2C_KINDS:
        assert ops.copies["lines"] == 0
    assert_scaled_close(got, ref, 5e-6 if kind in tt.C2C_KINDS else 2e-5)


def test_backend_mapping_is_one_to_one():
    assert tt.LOCAL_BACKENDS == ("cufft", "matmul", "kernel")
    assert tuple(tt.REFERENCE_BACKEND[b] for b in tt.LOCAL_BACKENDS) == \
        jt.LOCAL_BACKENDS
    assert all(tt.FROM_REFERENCE_BACKEND[tt.REFERENCE_BACKEND[b]] == b
               for b in tt.LOCAL_BACKENDS)
    assert tt.ALL_KINDS == jt.ALL_KINDS


def test_factorize_matches_reference():
    for n in range(1, 300):
        assert tt.factorize(n) == jt.factorize(n)
    assert tt.factorize(512) == (16, 32) and tt.factorize(521) == (1, 521)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_constant_planes_match_reference(dtype):
    for n, sign in ((16, -1.0), (12, 1.0), (31, -1.0)):
        for a, b in zip(tt._dft_planes(n, sign, dtype),
                        jt._dft_planes(n, sign, dtype)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tt._twiddle_planes(4, 8, -1.0, dtype),
                    jt._twiddle_planes(4, 8, -1.0, dtype)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_planes_match_reference(inverse):
    x = cplx((6, 48), 5)
    outr, outi = tt.fourstep_fft_planes(torch.from_numpy(x.real.copy()),
                                        torch.from_numpy(x.imag.copy()),
                                        inverse=inverse)
    refr, refi = jt.fourstep_fft_planes(jnp.asarray(x.real),
                                        jnp.asarray(x.imag), inverse=inverse)
    assert_scaled_close(outr.numpy() + 1j * outi.numpy(),
                        np.asarray(refr) + 1j * np.asarray(refi), 5e-6)


@pytest.mark.parametrize("backend", ["cufft", "matmul", "kernel"])
def test_precision_follows_input(backend):
    r = np.random.default_rng(9)
    x32 = r.standard_normal((3, 16)).astype(np.float32)
    y32 = tt.apply_1d(torch.from_numpy(x32), -1, "fft", backend=backend)
    assert y32.dtype == torch.complex64
    assert_scaled_close(y32.numpy(), np.fft.fft(x32, axis=-1), 5e-6)
    x64 = r.standard_normal((3, 48)) + 1j * r.standard_normal((3, 48))
    y64 = tt.apply_1d(torch.from_numpy(x64), 0, "ifft", backend=backend)
    assert y64.dtype == torch.complex128
    np.testing.assert_allclose(y64.numpy(), np.fft.ifft(x64, axis=0),
                               rtol=1e-10, atol=1e-12)


def _r2c_r2r_input(kind: str, dtype=np.float32) -> tuple:
    """(operand, axis, irfft_n): real (3, 24, 5) lines along axis 1; irfft
    gets the half spectrum of such lines."""
    x = np.random.default_rng(len(kind) * 31 + 2).standard_normal((3, 24, 5))
    if kind == "irfft":
        cdt = np.complex64 if dtype == np.float32 else np.complex128
        return np.fft.rfft(x, axis=1).astype(cdt), 1, 24
    return x.astype(dtype), 1, None


def _port(x: np.ndarray, kind: str, backend: str, axis: int, n=None):
    return tt.apply_1d(torch.from_numpy(x), axis, kind, backend=backend,
                       irfft_n=n)


def _ref(x: np.ndarray, kind: str, backend: str, axis: int, n=None):
    return np.asarray(jt.apply_1d(jnp.asarray(x), axis, kind,
                                  backend=backend, irfft_n=n))


@pytest.mark.parametrize("kind", R2C_R2R_KINDS)
@pytest.mark.parametrize("backend", tt.LOCAL_BACKENDS)
def test_r2c_r2r_kinds_match_reference(backend, kind):
    """Every R2C/R2R kind on every port backend against the reference's
    ``xla`` backend (``jnp.fft``), with the output dtype it gives."""
    x, axis, n = _r2c_r2r_input(kind)
    got = _port(x, kind, backend, axis, n)
    ref = _ref(x, kind, "xla", axis, n)
    assert str(got.dtype).removeprefix("torch.") == ref.dtype.name
    assert_scaled_close(got.numpy(), ref, 2e-5)


@pytest.mark.parametrize("kind", R2C_R2R_KINDS)
def test_kernel_r2c_r2r_matches_pallas(kind):
    """The kernel backend (its plain version on the CPU) against the Pallas
    kernel in interpret mode: dct2/dst2 through both kernels' twiddle
    epilogue, the others through their C2C core."""
    x, axis, n = _r2c_r2r_input(kind)
    assert_scaled_close(_port(x, kind, "kernel", axis, n).numpy(),
                        _ref(x, kind, "pallas", axis, n), 2e-5)


@pytest.mark.parametrize("kind", tt.R2R_KINDS)
@pytest.mark.parametrize("backend", tt.LOCAL_BACKENDS)
def test_r2r_complex_input_runs_per_plane(backend, kind):
    """Complex input (a C2C stage before a bounded dim) goes through the
    planes branch: the same result as the reference's, complex64 out."""
    x = cplx((4, 5, 16), len(kind) + 3)
    got = _port(x, kind, backend, -1)
    assert got.dtype == torch.complex64
    ref = _ref(x, kind, tt.REFERENCE_BACKEND[backend], -1)
    assert_scaled_close(got.numpy(), ref, 2e-5)
    # a lazily conjugated view transforms like its materialized value
    conj = tt.apply_1d(torch.from_numpy(x).conj(), -1, kind, backend=backend)
    assert_scaled_close(conj.numpy(), np.conj(ref), 2e-5)


@pytest.mark.parametrize("kind", ["fft", "ifft", "dct2", "dst2", "dct3"])
def test_apply_nd_matches_reference(kind):
    x = cplx((4, 6, 8), 8) if kind in tt.C2C_KINDS else \
        np.random.default_rng(8).standard_normal((4, 6, 8)).astype(np.float32)
    for backend in tt.LOCAL_BACKENDS:
        got = tt.apply_nd(torch.from_numpy(x), (0, 2), kind, backend=backend)
        ref = jt.apply_nd(jnp.asarray(x), (0, 2), kind,
                          backend=tt.REFERENCE_BACKEND[backend])
        assert_scaled_close(got.numpy(), np.asarray(ref), 2e-5)


X64_REFERENCE = """
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro.core.transforms import apply_1d
data = np.load({path!r})
out = {{}}
for kind in {kinds!r}:
    n = 24 if kind == "irfft" else None
    y = apply_1d(jnp.asarray(data[kind]), 1, kind, backend="xla", irfft_n=n)
    out[kind] = np.asarray(y)
    print(kind, y.dtype)
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def x64_reference(tmp_path_factory):
    """The reference's float64 results (``jax_enable_x64``, fresh process)."""
    root = str(tmp_path_factory.mktemp("x64"))
    inputs = {k: _r2c_r2r_input(k, np.float64)[0] for k in R2C_R2R_KINDS}
    path, out = os.path.join(root, "in.npz"), os.path.join(root, "out.npz")
    np.savez(path, **inputs)
    log = run_reference(X64_REFERENCE.format(path=path, kinds=R2C_R2R_KINDS,
                                             out=out), devices=1)
    assert "dct2 float64" in log and "rfft complex128" in log
    return inputs, dict(np.load(out))


@pytest.mark.parametrize("kind", R2C_R2R_KINDS)
@pytest.mark.parametrize("backend", tt.LOCAL_BACKENDS)
def test_float64_matches_reference_under_x64(x64_reference, backend, kind):
    """float64 stays in double precision on every backend (complex128
    inside), as the reference does under x64."""
    inputs, refs = x64_reference
    got = _port(inputs[kind], kind, backend, 1, 24 if kind == "irfft"
                else None)
    assert str(got.dtype).removeprefix("torch.") == refs[kind].dtype.name
    assert_scaled_close(got.numpy(), refs[kind], 1e-12)


def test_unknown_backend_and_kind_raise():
    with pytest.raises(ValueError, match="unknown backend 'xla'"):
        tt.apply_1d(torch.zeros(2, 8, dtype=torch.complex64), -1, "fft",
                    backend="xla")
    with pytest.raises(ValueError, match="unknown transform kind"):
        tt.apply_1d(torch.zeros(2, 8, dtype=torch.complex64), -1, "fht")
    with pytest.raises(ValueError, match="irfft_n"):
        tt.apply_1d(torch.zeros(2, 5, dtype=torch.complex64), -1, "irfft")
