"""The port's ``models/ssm.py`` against the JAX package's: mLSTM (chunked,
one chunk and several), sLSTM and Mamba (chunked scan, several chunks) in
train, prefill (with the state cache) and decode, the chunk assert, and the
FFT long-convolution mixer on every port backend (``cufft``, ``matmul``,
``kernel``'s plain version on the CPU) against the reference's ``"xla"``.
Tolerances are max-scaled: 1e-4 in float32 (outputs and ``fft_conv``),
5e-2 in bfloat16, caches 1e-5 in float32."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from lm_parity import (BF16_TOL, CACHE_TOL, F32_TOL, f32, jax_init, jx,
                       port_module, randn, scaled_err, tt)
from repro.configs import smoke_config as ref_smoke_config
from repro.distributed.sharding import MeshRules
from repro.models import ssm as ref_ssm
from repro_torch.core.transforms import LOCAL_BACKENDS, REFERENCE_BACKEND
from repro_torch.kernels import fft_matmul, ops
from repro_torch.models import ssm

RULES = MeshRules()
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
# mixer -> (smoke arch, reference init, reference apply, port's)
MIXERS = {
    "mlstm": ("xlstm_125m", ref_ssm.init_mlstm, ref_ssm.mlstm,
              ssm.init_mlstm, ssm.mlstm),
    "slstm": ("xlstm_125m", ref_ssm.init_slstm, ref_ssm.slstm,
              ssm.init_slstm, ssm.slstm),
    "mamba": ("jamba_v0_1_52b", ref_ssm.init_mamba, ref_ssm.mamba,
              ssm.init_mamba, ssm.mamba),
}


def mixer(name, dtype):
    """(cfg, reference params, reference apply, the port's apply on the
    carried-across params)."""
    arch, ref_init, ref_apply, init, apply = MIXERS[name]
    cfg = ref_smoke_config(arch)
    cfg = f32(cfg) if dtype == "float32" else cfg
    tree, ref_p = jax_init(ref_init, cfg, "ssm", seed=1)
    p = port_module(init, tree, "ssm", cfg)
    return cfg, ref_p, ref_apply, lambda x, **kw: apply(p, cfg, None, x,
                                                        **kw)


def cache_err(c, c_ref) -> float:
    return max(scaled_err(c[k], c_ref[k]) for k in c if k != "pos")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_prefill_then_decode_matches_reference(name, dtype):
    """Prefill 32 tokens (the state cache against the reference's), then 3
    decode steps from it; the train mode's output is the prefill's."""
    cfg, ref_p, apply, port = mixer(name, dtype)
    jdt, tdt, tol = DTYPES[dtype]
    s, steps = 32, 3
    x = randn((2, s + steps, cfg.d_model), 2)
    y_tr, _ = port(tt(x[:, :s], tdt), mode="train")
    y_ref, c_ref = apply(ref_p, cfg, RULES, jx(x[:, :s], jdt), mode="prefill")
    y, c = port(tt(x[:, :s], tdt), mode="prefill")
    assert y.dtype == tdt
    assert torch.equal(y, y_tr)
    assert scaled_err(y, y_ref) < tol
    assert c["pos"] == int(c_ref["pos"]) == s
    ctol = CACHE_TOL if dtype == "float32" else tol
    assert cache_err(c, c_ref) < ctol
    for i in range(steps):
        xi = x[:, s + i:s + i + 1]
        y_ref, c_ref = apply(ref_p, cfg, RULES, jx(xi, jdt), mode="decode",
                             cache=c_ref)
        y, c = port(tt(xi, tdt), mode="decode", cache=c)
        assert scaled_err(y, y_ref) < tol, (name, i)
        assert c["pos"] == int(c_ref["pos"])
        assert cache_err(c, c_ref) < (F32_TOL if dtype == "float32" else tol)


def test_mlstm_several_chunks_match_reference():
    """S=512 runs two 256-token chunks, the carried (C, n, m) between."""
    cfg, ref_p, apply, port = mixer("mlstm", "float32")
    x = randn((1, 512, cfg.d_model), 3)
    y_ref, c_ref = apply(ref_p, cfg, RULES, jnp.asarray(x), mode="prefill")
    y, c = port(tt(x), mode="prefill")
    assert scaled_err(y, y_ref) < F32_TOL
    assert cache_err(c, c_ref) < CACHE_TOL


def test_mamba_several_chunks_and_the_chunk_assert():
    """A chunk of 8 on 32 tokens: four chunks, the state carried; a
    sequence that does not divide the chunk raises in both."""
    cfg, ref_p, _, port = mixer("mamba", "float32")
    x = randn((2, 32, cfg.d_model), 4)
    y_ref, c_ref = ref_ssm.mamba(ref_p, cfg, RULES, jnp.asarray(x),
                                 mode="prefill", chunk=8)
    y, c = port(tt(x), mode="prefill", chunk=8)
    assert scaled_err(y, y_ref) < F32_TOL
    assert cache_err(c, c_ref) < CACHE_TOL
    with pytest.raises(AssertionError, match="divide the scan chunk"):
        ref_ssm.mamba(ref_p, cfg, RULES, jnp.asarray(x[:, :24]), chunk=16)
    with pytest.raises(AssertionError, match="divide the scan chunk"):
        port(tt(x[:, :24]), chunk=16)


def fft_conv_pair(dtype="float32"):
    cfg = dataclasses.replace(ref_smoke_config("jamba_v0_1_52b"),
                              ssm_impl="fft_conv")
    cfg = f32(cfg) if dtype == "float32" else cfg
    tree, ref_p = jax_init(ref_ssm.init_fft_conv, cfg, "ssm", seed=2)
    p = port_module(ssm.init_fft_conv, tree, "ssm", cfg)
    return cfg, ref_p, lambda x, **kw: ssm.fft_conv(p, cfg, None, x, **kw)


@pytest.mark.parametrize("backend", LOCAL_BACKENDS)
def test_fft_conv_matches_reference(backend):
    """Every port backend against the reference's default ``"xla"``, float32
    (the ``kernel`` backend runs the kernel's plain version here)."""
    cfg, ref_p, port = fft_conv_pair()
    x = randn((2, 32, cfg.d_model), 5)
    y_ref, c_ref = ref_ssm.fft_conv(ref_p, cfg, RULES, jnp.asarray(x))
    y, c = port(tt(x), fft_backend=backend)
    assert c is None and c_ref is None
    assert scaled_err(y, y_ref) < F32_TOL
    assert REFERENCE_BACKEND["cufft"] == "xla"


def test_fft_conv_bfloat16_and_decode():
    cfg, ref_p, port = fft_conv_pair("bfloat16")
    x = randn((2, 32, cfg.d_model), 6)
    y_ref, _ = ref_ssm.fft_conv(ref_p, cfg, RULES, jx(x, jnp.bfloat16))
    y, _ = port(tt(x, torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert scaled_err(y, y_ref) < BF16_TOL
    with pytest.raises(NotImplementedError, match="training-time mixer"):
        ref_ssm.fft_conv(ref_p, cfg, RULES, jx(x[:, :1], jnp.bfloat16),
                         mode="decode")
    with pytest.raises(NotImplementedError, match="training-time mixer"):
        port(tt(x[:, :1], torch.bfloat16), mode="decode")


def test_fft_conv_kernel_path_takes_three_contiguous_line_batches(
        monkeypatch):
    """``fft_backend="kernel"`` reaches the four-step entry three times per
    call, on contiguous lines of length 2S — (B*di, 2S) for x and for the
    product, (di, 2S) for h — and no line copy (``ops.copies``)."""
    cfg, _, port = fft_conv_pair()
    calls = []
    real = fft_matmul.fft_fourstep

    def spy(x, **kw):
        calls.append((tuple(x.shape), x.is_contiguous(),
                      kw.get("inverse", False)))
        return real(x, **kw)

    monkeypatch.setattr(ops, "fft_fourstep", spy)
    before = ops.copies["lines"]
    b, s, di = 2, 32, cfg.expand * cfg.d_model
    port(tt(randn((b, s, cfg.d_model), 7)), fft_backend="kernel")
    assert calls == [((b * di, 2 * s), True, False),
                     ((di, 2 * s), True, False),
                     ((b * di, 2 * s), True, True)]
    assert ops.copies["lines"] == before
