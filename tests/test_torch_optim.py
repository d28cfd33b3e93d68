"""The port's AdamW, schedule, clipping and gradient compression
(``repro_torch.optim``) against the JAX package's (``repro.optim``): the
counterparts of ``tests/test_substrate.py``'s optimizer and compression
tests, and one update against the reference's on a seeded random tree,
float32 within 1e-6 relative (both do the same float32 arithmetic in the
same order; the pow of the bias correction and the norm's sum order are
the only places they may round apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               bf16_compress, cosine_schedule,
                               error_feedback_int8_decode,
                               error_feedback_int8_encode, global_norm)

UPDATE_RTOL = 1e-6


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0)
    w = torch.tensor([5.0, -3.0], requires_grad=True)
    params = {"w": w}
    state = adamw_init(params, cfg)
    for _ in range(150):
        loss = torch.sum(w ** 2)
        (g,) = torch.autograd.grad(loss, w)
        adamw_update({"w": g}, state, params, cfg)
    assert float(torch.sum(w.detach() ** 2)) < 1e-2
    assert int(state["count"]) == 150


def test_cosine_schedule_matches_reference():
    cfg = AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100)
    ref_cfg = ref_adamw.AdamWConfig(lr_peak=1.0, warmup_steps=10,
                                    total_steps=100)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    ref = [float(ref_adamw.cosine_schedule(ref_cfg, jnp.asarray(s)))
           for s in range(100)]
    assert lrs[0] < lrs[9]                     # warmup rising
    assert max(lrs) == pytest.approx(1.0, rel=1e-2)
    assert lrs[-1] < 0.01                      # cosine decayed
    # one float32 ulp of cos (XLA's and torch's differ there) is 1.2e-7
    # of lr_peak, which near the end of the decay exceeds 1e-6 relative
    np.testing.assert_allclose(lrs, ref, rtol=1e-6, atol=1.2e-7)
    assert float(cosine_schedule(cfg, 12)) == pytest.approx(ref[12],
                                                            rel=1e-6)


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(lr_peak=1e-3, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params, cfg)
    p2, _ = adamw_update({"w": torch.full((4,), 1e9)}, state, params, cfg)
    assert float(p2["w"].abs().max()) < 1e-2
    assert p2["w"] is params["w"]              # updated in place


def test_bf16_moments_supported():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(8)}
    state = adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, s2 = adamw_update({"w": torch.ones(8)}, state, params, cfg)
    assert s2["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(p2["w"]).all())


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal((33,)).astype(np.float32),
            "c": rng.standard_normal((4, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(moments, clip):
    """Three updates of a seeded tree from seeded moments, past the
    warm-up: parameters and moments against the reference's.  float32
    moments within 1e-6 relative; bfloat16 moments are stored rounded, so
    they agree to one bfloat16 unit (2**-7 relative) and the parameters
    to 1e-6."""
    kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10,
              clip_norm=clip, moment_dtype=moments)
    cfg, ref_cfg = AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    params = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    ref_params = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    state = adamw_init(params, cfg)
    ref_state = ref_adamw.adamw_init(ref_params, ref_cfg)
    for step in range(3):
        grads = _tree(10 + step)
        adamw_update({k: torch.from_numpy(v) for k, v in grads.items()},
                     state, params, cfg)
        ref_params, ref_state = ref_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, ref_state,
            ref_params, ref_cfg)
    assert int(state["count"]) == int(ref_state["count"]) == 3
    for k in params:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(ref_params[k]),
                                   rtol=UPDATE_RTOL, atol=1e-7)
        mtol = UPDATE_RTOL if moments == "float32" else 2.0 ** -7
        for name in ("m", "v"):
            assert state[name][k].dtype == (torch.float32 if moments ==
                                            "float32" else torch.bfloat16)
            ref_m = np.asarray(ref_state[name][k], np.float32)
            # max-scaled: an entry summed from terms of both signs loses
            # its relative digits to cancellation, not to the update
            np.testing.assert_allclose(
                state[name][k].float().numpy(), ref_m, rtol=mtol,
                atol=mtol * float(np.abs(ref_m).max()))


def test_global_norm_matches_reference():
    tree = _tree(3)
    got = float(global_norm({k: torch.from_numpy(v)
                             for k, v in tree.items()}))
    ref = float(ref_adamw.global_norm({k: jnp.asarray(v)
                                       for k, v in tree.items()}))
    assert got == pytest.approx(ref, rel=1e-6)
    bf = {k: torch.from_numpy(v).bfloat16() for k, v in tree.items()}
    assert global_norm(bf).dtype == torch.float32


def test_bf16_compress_dtype():
    g = {"a": torch.ones(3)}
    out = bf16_compress(g)
    assert out["a"].dtype == torch.bfloat16
    assert ref_compress.bf16_compress({"a": jnp.ones(3)})["a"].dtype == \
        jnp.bfloat16


def test_error_feedback_invariant_and_reference():
    """Sum of decoded quantized grads + final error == sum of true grads;
    each step's int8 codes equal the reference's."""
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    ref_err = jnp.zeros(64)
    total_true = torch.zeros(64)
    total_dec = torch.zeros(64)
    for _ in range(20):
        g = rng.standard_normal(64).astype(np.float32)
        q, scale, err = error_feedback_int8_encode(torch.from_numpy(g), err)
        rq, rscale, ref_err = ref_compress.error_feedback_int8_encode(
            jnp.asarray(g), ref_err)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(scale) == pytest.approx(float(rscale), rel=1e-6)
        total_true += torch.from_numpy(g)
        total_dec += error_feedback_int8_decode(q, scale)
    np.testing.assert_allclose((total_dec + err).numpy(),
                               total_true.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err), atol=1e-5)
