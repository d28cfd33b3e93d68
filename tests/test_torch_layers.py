"""The port's ``models/layers.py`` against the JAX package's: RMSNorm, RoPE,
the SwiGLU MLP, and GQA attention in every mode (train, prefill with its
cache, decode from the cache) and feature (GQA, qk_norm, softcap, the
sliding window and its ring buffer past the window, cross attention), on
the same seeded inputs and the same parameters (the JAX tree carried
across).  Tolerances are max-scaled: 1e-4 in float32, 5e-2 in bfloat16,
caches 1e-5 in float32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (BF16_TOL, CACHE_TOL, F32_TOL, f32, jax_init, jx,
                       port_module, randn, scaled_err, tt)
from repro.configs import smoke_config as ref_smoke_config
from repro.distributed.sharding import MeshRules
from repro.models import layers as ref_layers
from repro_torch.models import layers

RULES = MeshRules()
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

# feature -> (smoke arch, config overrides)
FEATURES = {
    "gqa_qk_norm": ("qwen3_8b", {}),
    "mha": ("stablelm_1_6b", {}),
    "window": ("h2o_danube_1_8b", {}),
    "softcap": ("phi3_medium_14b", {"attn_logit_softcap": 5.0}),
}


def feature_cfg(name, dtype):
    arch, over = FEATURES[name]
    cfg = dataclasses.replace(ref_smoke_config(arch), **over)
    return f32(cfg) if dtype == "float32" else cfg


def pair(cfg, seed=0):
    tree, ref_p = jax_init(ref_layers.init_attention, cfg, "attn", seed)
    return ref_p, port_module(layers.init_attention, tree, "attn", cfg)


def test_rms_norm_and_rope_match_reference():
    x = randn((2, 8, 4, 16), 1)
    scale = 1.0 + 0.1 * randn((16,), 2)
    got = layers.rms_norm(tt(x), tt(scale), 1e-5)
    ref = ref_layers.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)},
                              1e-5)
    assert scaled_err(got, ref) < F32_TOL
    for pos in (np.arange(8), np.array([37])):
        cos, sin = layers.rope_angles(torch.as_tensor(pos), 16, 1e6)
        rc, rs = ref_layers.rope_angles(jnp.asarray(pos), 16, 1e6)
        assert scaled_err(cos, rc) < F32_TOL and scaled_err(sin, rs) < F32_TOL
        xs = x[:, :len(pos)]
        got = layers.apply_rope(tt(xs), cos, sin)
        ref = ref_layers.apply_rope(jnp.asarray(xs), rc, rs)
        assert scaled_err(got, ref) < F32_TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    cfg = ref_smoke_config("qwen3_8b")
    tree, ref_p = jax_init(ref_layers.init_mlp, cfg, "mlp")
    port = port_module(layers.init_mlp, tree, "mlp", cfg)
    x = randn((2, 16, cfg.d_model), 3)
    got = layers.mlp(port, None, tt(x, tdt))
    ref = ref_layers.mlp(ref_p, RULES, jx(x, jdt))
    assert got.dtype == tdt
    assert scaled_err(got, ref) < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_attention_prefill_then_decode_matches_reference(feature, dtype):
    """Prefill a prompt longer than the smoke window (24 > 16) — the ring
    buffer's roll — then decode 3 tokens from the padded cache; outputs and
    caches against the reference's at every step."""
    cfg = feature_cfg(feature, dtype)
    jdt, tdt, tol = DTYPES[dtype]
    ref_p, port = pair(cfg)
    s, steps = 24, 3
    x = randn((2, s + steps, cfg.d_model), 4)
    kw = dict(window=cfg.window)

    y_ref, c_ref = ref_layers.attention(ref_p, cfg, RULES, jx(x[:, :s], jdt),
                                        mode="prefill", **kw)
    y, c = layers.attention(port, cfg, None, tt(x[:, :s], tdt),
                            mode="prefill", **kw)
    assert scaled_err(y, y_ref) < tol
    assert c["pos"] == int(c_ref["pos"]) == s
    ctol = CACHE_TOL if dtype == "float32" else tol
    assert scaled_err(c["k"], c_ref["k"]) < ctol
    assert scaled_err(c["v"], c_ref["v"]) < ctol

    # the decode budget, as pad_caches grows it (a window stays its size)
    slots = min(cfg.window or s + steps, s + steps)
    pad = [(0, 0), (0, slots - c_ref["k"].shape[1]), (0, 0), (0, 0)]
    c_ref = dict(c_ref, k=jnp.pad(c_ref["k"], pad), v=jnp.pad(c_ref["v"], pad))
    c = dict(c, k=torch.tensor(np.asarray(c_ref["k"], np.float32)).to(tdt),
             v=torch.tensor(np.asarray(c_ref["v"], np.float32)).to(tdt))
    for i in range(steps):
        pos = s + i
        xi = x[:, pos:pos + 1]
        y_ref, c_ref = ref_layers.attention(
            ref_p, cfg, RULES, jx(xi, jdt), mode="decode", cache=c_ref,
            positions=jnp.asarray([pos]), **kw)
        y, c = layers.attention(port, cfg, None, tt(xi, tdt), mode="decode",
                                cache=c, positions=torch.tensor([pos]), **kw)
        assert scaled_err(y, y_ref) < tol, (feature, i)
        assert c["pos"] == int(c_ref["pos"])
        assert scaled_err(c["k"], c_ref["k"]) < ctol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_attention_matches_reference(dtype):
    """Cross attention (seamless smoke): no RoPE, no causal mask, a source
    of another length; its cache from prefill serves decode unchanged."""
    cfg = ref_smoke_config("seamless_m4t_medium")
    cfg = f32(cfg) if dtype == "float32" else cfg
    jdt, tdt, tol = DTYPES[dtype]
    tree, ref_p = jax_init(ref_layers.init_attention, cfg, "cross", 5,
                           cross=True)
    port = port_module(layers.init_attention, tree, "cross", cfg, cross=True)
    x = randn((2, 12, cfg.d_model), 6)
    src = randn((2, 20, cfg.d_model), 7)
    y_ref, c_ref = ref_layers.attention(ref_p, cfg, RULES, jx(x, jdt),
                                        mode="prefill",
                                        kv_source=jx(src, jdt), causal=False)
    y, c = layers.attention(port, cfg, None, tt(x, tdt), mode="prefill",
                            kv_source=tt(src, tdt), causal=False)
    assert scaled_err(y, y_ref) < tol
    assert scaled_err(c["k"], c_ref["k"]) < (CACHE_TOL if dtype == "float32"
                                             else tol)
    xd = randn((2, 1, cfg.d_model), 8)
    y_ref, c2_ref = ref_layers.attention(
        ref_p, cfg, RULES, jx(xd, jdt), mode="decode", cache=c_ref,
        kv_source=jx(src, jdt), positions=jnp.asarray([12]), causal=False)
    y, c2 = layers.attention(port, cfg, None, tt(xd, tdt), mode="decode",
                             cache=c, kv_source=tt(src, tdt),
                             positions=torch.tensor([12]), causal=False)
    assert scaled_err(y, y_ref) < tol
    assert c2["pos"] == int(c2_ref["pos"]) == 12


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 10, None), (False, None, 3.0),
    (True, 7, 2.0)])
def test_flash_tiles_match_reference(causal, window, softcap):
    """Several q and kv tiles with ragged padding (S=37 in tiles of 8 and
    16), q_offset, every mask: the online softmax against the reference's,
    float32."""
    q, k, v = (randn((2, 37, 4, 16), i) for i in (9, 10, 11))
    kw = dict(causal=causal, window=window, softcap=softcap, q_block=8,
              kv_block=16, q_offset=3)
    got = layers._flash_attend(tt(q), tt(k), tt(v), **kw)
    ref = ref_layers._flash_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    assert scaled_err(got, ref) < F32_TOL


def test_decode_attend_matches_reference():
    q = randn((2, 1, 2, 3, 16), 12)
    k, v = randn((2, 9, 2, 16), 13), randn((2, 9, 2, 16), 14)
    mask = np.arange(9)[None, :] <= np.array([[4], [8]])
    got = layers._decode_attend(tt(q), tt(k), tt(v),
                                length_mask=torch.as_tensor(mask),
                                softcap=4.0)
    ref = ref_layers._decode_attend(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    length_mask=jnp.asarray(mask),
                                    softcap=4.0)
    assert scaled_err(got, ref) < F32_TOL
