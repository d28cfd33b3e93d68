"""The port's serving path against the JAX package's: prefill (last logits
and caches), then 4 greedy decode steps, for qwen3, jamba, xlstm and
h2o-danube; the sliding-window ring buffer past the window; decode against
a full forward (the reference's own check); and ``serve()`` end to end on
the CPU, giving the same tokens as the JAX ``serve()`` in float32.  The JAX
parameters are carried across by ``models/convert.py``; each JAX step is
jitted once per test.  Tolerances are max-scaled: logits 1e-4 in float32
(greedy tokens equal), 5e-2 in the configs' bfloat16, caches after
prefill 1e-5 in float32 (1e-4 after decoding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (B, BF16_TOL, CACHE_TOL, F32_TOL, S, f32, jax_batch,
                       make_batch, scaled_err, to_numpy, torch_batch)
from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.launch.steps import build_params as ref_build_params
from repro.launch.steps import make_decode_step as ref_make_decode_step
from repro.launch.steps import make_prefill_step as ref_make_prefill_step
from repro.models import transformer as ref_tfm
from repro_torch import configs
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (caches_to_reference,
                                        params_from_reference)

DECODE_ARCHS = ["qwen3_8b", "jamba_v0_1_52b", "xlstm_125m",
                "h2o_danube_1_8b"]
DTYPES = {"float32": F32_TOL, "bfloat16": BF16_TOL}


def cache_err(got, ref) -> float:
    """Worst max-scaled error over the cache leaves; ``pos`` must match."""
    errs = []

    def leaf(g, r):
        if np.asarray(r).dtype.kind == "i":
            np.testing.assert_array_equal(g, r)
        elif np.abs(np.asarray(r, np.float32)).max() > 0:
            errs.append(scaled_err(g, r))
    jax.tree.map(leaf, got, to_numpy(ref))
    return max(errs)


def setup(arch, dtype, cpu_mesh, rules):
    cfg = ref_configs.smoke_config(arch)
    cfg = f32(cfg) if dtype == "float32" else cfg
    with cpu_mesh:
        params, _ = ref_build_params(cfg, rules, abstract=False)
    return cfg, params, params_from_reference(to_numpy(params), cfg,
                                              device="cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, cpu_mesh, rules):
    cfg, params, model = setup(arch, dtype, cpu_mesh, rules)
    tol = DTYPES[dtype]
    batch = make_batch(cfg)
    with cpu_mesh:
        prefill = jax.jit(ref_make_prefill_step(cfg, rules))
        decode = jax.jit(ref_make_decode_step(cfg, rules))
        last_ref, c_ref = prefill(params, jax_batch(batch))
    last, c = make_prefill_step(cfg, device="cpu")(model, torch_batch(batch))
    assert scaled_err(last, last_ref) < tol
    assert cache_err(caches_to_reference(c), c_ref) < (
        CACHE_TOL if dtype == "float32" else tol)

    steps = 4
    c_ref = ref_tfm.pad_caches(c_ref, cfg, S + steps)
    c = tfm.pad_caches(c, cfg, S + steps)
    step = make_decode_step(cfg, device="cpu")
    cur = np.asarray(jnp.argmax(last_ref, axis=-1))[:, None]
    if dtype == "float32":
        np.testing.assert_array_equal(last.argmax(-1).numpy(), cur[:, 0])
    for i in range(steps):
        with cpu_mesh:
            nxt_ref, lg_ref, c_ref = decode(params, c_ref,
                                            jnp.asarray(cur, jnp.int32),
                                            jnp.asarray(S + i, jnp.int32))
        nxt, lg, c = step(model, c, torch.tensor(cur).long(), S + i)
        assert scaled_err(lg, lg_ref) < tol, (arch, i)
        if dtype == "float32":
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
        cur = np.asarray(nxt_ref)[:, None]   # both continue the same way
    assert cache_err(caches_to_reference(c), c_ref) < (
        F32_TOL if dtype == "float32" else tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_swa_ring_buffer_beyond_window(dtype, cpu_mesh, rules):
    """Prefill past the window (24 > 16), decode one token: the ring buffer
    against a fresh windowed forward (the reference test's 0.15) and
    against the reference's decode."""
    cfg, params, model = setup("h2o_danube_1_8b", dtype, cpu_mesh, rules)
    w = cfg.window
    t = w + 8
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, t + 1))
    with cpu_mesh:
        _, c_ref = jax.jit(ref_make_prefill_step(cfg, rules))(
            params, {"tokens": jnp.asarray(toks[:, :t], jnp.int32)})
        _, lg_ref, _ = jax.jit(ref_make_decode_step(cfg, rules))(
            params, c_ref, jnp.asarray(toks[:, t:], jnp.int32),
            jnp.asarray(t, jnp.int32))
    tt_ = torch.as_tensor(toks).long()
    _, c = make_prefill_step(cfg, device="cpu")(model, {"tokens": tt_[:, :t]})
    assert c["layer0"][0]["attn"]["k"].shape[1] == w
    _, lg, _ = make_decode_step(cfg, device="cpu")(model, c, tt_[:, t:], t)
    with torch.no_grad():
        full, _, _ = tfm.forward(model, cfg, None, {"tokens": tt_})
    assert scaled_err(lg, full[:, -1]) < 0.15
    assert scaled_err(lg, lg_ref) < DTYPES[dtype]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's own check (``tests/test_models_smoke.py:79-102``) on
    the port, in the configs' bfloat16: one decode step after prefill
    against the last position of a full forward, rel < 0.15."""
    cfg = configs.smoke_config(arch)
    from repro_torch.launch.steps import build_params
    model = build_params(cfg, device="cpu")
    batch = torch_batch(make_batch(cfg))
    _, caches = make_prefill_step(cfg, device="cpu")(model, batch)
    new_tok = torch.full((B, 1), 3, dtype=torch.long)
    _, logits, _ = make_decode_step(cfg, device="cpu")(model, caches,
                                                       new_tok, S)
    batch2 = dict(batch, tokens=torch.cat([batch["tokens"], new_tok], 1))
    with torch.no_grad():
        full, _, _ = tfm.forward(model, cfg, None, batch2)
    assert scaled_err(logits, full[:, -1]) < 0.15


def test_serve_matches_reference_tokens(monkeypatch, cpu_mesh):
    """``serve("qwen3-8b")`` with its CLI defaults (8 requests in batches of
    4, 32-token prompts, 16 new tokens) on the smoke config in float32: the
    port on the CPU, with the JAX serve's parameters, gives the same tokens
    as the JAX serve."""
    arch = "qwen3-8b"
    ref_cfg = f32(ref_configs.smoke_config(arch))
    port_cfg = f32(configs.smoke_config(arch))
    monkeypatch.setattr(ref_serve, "smoke_config", lambda a: ref_cfg)
    monkeypatch.setattr(port_serve, "smoke_config", lambda a: port_cfg)
    trees = []
    real_build = ref_serve.build_params

    def keep_tree(cfg, rules, **kw):
        params, specs = real_build(cfg, rules, **kw)
        trees.append(to_numpy(params))
        return params, specs

    monkeypatch.setattr(ref_serve, "build_params", keep_tree)
    ref = ref_serve.serve(arch, mesh=cpu_mesh)
    monkeypatch.setattr(
        port_serve, "build_params",
        lambda cfg, seed, device, mesh=None: params_from_reference(
            trees[0], cfg, device))
    clock = iter(range(10 ** 6))
    got = port_serve.serve(arch, device="cpu",
                           timer=lambda: float(next(clock)))
    assert len(got) == 8 and all(len(r) == 16 for r in got)
    assert got == [list(map(int, r)) for r in ref]
