"""The port's local transforms (``repro_torch/core/transforms.py``) against
the JAX package's ``apply_1d``: each port backend against the reference
backend of the same role (``cufft``/``xla``, ``matmul``/``matmul``,
``kernel``/``pallas`` — the Pallas kernel in interpret mode, as the JAX
package's own tests run it), at ``tests/test_kernels.py``'s 5e-6 scaled."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as jt
from repro_torch.core import transforms as tt
from torch_harness import assert_scaled_close, cplx

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


@pytest.mark.parametrize("kind", ["rfft", "irfft", "dct2", "dst3"])
def test_unported_kinds_raise(kind):
    with pytest.raises(NotImplementedError, match=kind):
        tt.apply_1d(torch.zeros(2, 8), -1, kind, backend="cufft")


def test_unknown_backend_and_kind_raise():
    with pytest.raises(ValueError, match="unknown backend 'xla'"):
        tt.apply_1d(torch.zeros(2, 8, dtype=torch.complex64), -1, "fft",
                    backend="xla")
    with pytest.raises(ValueError, match="unknown transform kind"):
        tt.apply_1d(torch.zeros(2, 8, dtype=torch.complex64), -1, "fht")
