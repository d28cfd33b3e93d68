"""The port's ``models/moe.py`` against the JAX package's: grouped and global
dispatch agree with each other (as ``tests/test_moe.py``) and each with
the reference, dropless and under a binding capacity, with the same
routing and the same dropped (token, choice) pairs.  Tolerances are
max-scaled: 1e-4 in float32, 5e-2 in bfloat16."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (BF16_TOL, F32_TOL, f32, jax_init, jx, port_module,
                       randn, scaled_err, tt)
from repro.configs import smoke_config as ref_smoke_config
from repro.distributed.sharding import MeshRules
from repro.models import moe as ref_moe
from repro_torch.models import moe

RULES = MeshRules()
IMPLS = {"grouped": (ref_moe.moe_ffn_grouped, moe.moe_ffn_grouped),
         "global": (ref_moe.moe_ffn_global, moe.moe_ffn_global)}
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
# capacity factors: dropless (the reference test's 8.0) and binding (0.25)
CAPACITY = {"dropless": 8.0, "tight": 0.25}


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(ref_smoke_config("olmoe_1b_7b"),
                              capacity_factor=8.0)
    tree, ref_p = jax_init(ref_moe.init_moe, cfg, "moe")
    port = port_module(moe.init_moe, tree, "moe", cfg)
    x = randn((2, 16, cfg.d_model), 1)
    return cfg, ref_p, port, x


def ref_keep(gate_e: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The reference's drop rule in numpy: stable sort by expert, the first
    ``cap`` arrivals at each expert kept (``moe.py:87-95``)."""
    order = np.argsort(gate_e, axis=-1, kind="stable")
    se = np.take_along_axis(gate_e, order, axis=-1)
    counts = np.stack([np.bincount(r, minlength=n_experts)
                       for r in gate_e.reshape(-1, gate_e.shape[-1])])
    counts = counts.reshape(gate_e.shape[:-1] + (n_experts,))
    starts = np.cumsum(counts, axis=-1) - counts
    pos = np.arange(gate_e.shape[-1]) - np.take_along_axis(starts, se,
                                                           axis=-1)
    return order, pos < cap


def test_grouped_matches_global(setup):
    cfg, _, port, x = setup
    out_g, aux_g = moe.moe_ffn_grouped(port, f32(cfg), None, tt(x))
    out_n, aux_n = moe.moe_ffn_global(port, f32(cfg), None, tt(x))
    np.testing.assert_allclose(out_g.numpy(), out_n.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(aux_g) == pytest.approx(float(aux_n), rel=1e-5)


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_moe_matches_reference(setup, impl, dtype, capacity):
    cfg, ref_p, port, x = setup
    cfg = dataclasses.replace(cfg, capacity_factor=CAPACITY[capacity])
    cfg = f32(cfg) if dtype == "float32" else cfg
    jdt, tdt, tol = DTYPES[dtype]
    ref_fn, port_fn = IMPLS[impl]
    out_ref, aux_ref = ref_fn(ref_p, cfg, RULES, jx(x, jdt))
    out, aux = port_fn(port, cfg, None, tt(x, tdt))
    assert out.dtype == tdt
    assert scaled_err(out, out_ref) < tol
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_capacity_drops_match_reference(setup, impl, dtype):
    """Same top-k routing (bfloat16 logits tie: the lower expert first, as
    ``lax.top_k``), and under a binding capacity the same (token, choice)
    pairs kept and dropped as the reference's stable-sort rule."""
    cfg, ref_p, port, x = setup
    jdt, tdt, _ = DTYPES[dtype]
    e, k = cfg.n_experts, cfg.top_k
    xf = x if impl == "grouped" else x.reshape(-1, cfg.d_model)
    _, ge_ref, _ = ref_moe._route(ref_p, cfg, jx(xf, jdt))
    _, ge, _ = moe._route(port, cfg, tt(xf, tdt))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(ge_ref))
    b_, s = x.shape[:2]
    if impl == "grouped":
        flat = np.asarray(ge_ref).reshape(b_, s * k)
        cap = max(4, int(0.25 * s * k / e))
    else:
        flat = np.asarray(ge_ref).reshape(-1)
        cap = max(4, int(0.25 * b_ * s * k / e))
    order_ref, keep_ref = ref_keep(flat, e, cap)
    order, _, keep = moe.dispatch(torch.tensor(flat).long(), e, cap)
    np.testing.assert_array_equal(order.numpy(), order_ref)
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    assert 0 < int((~keep).sum()) < keep.numel()   # the capacity binds


def test_capacity_drop_partial_output(setup):
    cfg, _, port, x = setup
    cfg = f32(cfg)
    tight = dataclasses.replace(cfg, capacity_factor=0.25)
    out_t, _ = moe.moe_ffn_grouped(port, tight, None, tt(x))
    out_f, _ = moe.moe_ffn_grouped(port, cfg, None, tt(x))
    # dropped tokens produce zero contribution, not garbage
    assert bool(torch.isfinite(out_t).all())
    assert float(out_t.abs().max()) <= float(out_f.abs().max()) * 1.5


def test_router_aux_loss_balanced_uniform(setup):
    cfg, _, port, x = setup
    with torch.no_grad():
        saved = port.router.clone()
        port.router.zero_()
        try:
            _, aux = moe.moe_ffn_grouped(port, f32(cfg), None, tt(x))
        finally:
            port.router.copy_(saved)
    assert float(aux) == pytest.approx(1.0, rel=0.3)
