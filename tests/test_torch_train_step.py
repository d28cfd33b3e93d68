"""One train step of the port against the JAX package's, for each of the
10 smoke configs at float32 (jamba under both ``ssm_impl``s): the loss,
the aux loss and every gradient leaf of ``launch/steps.loss_and_grads``
against ``jax.value_and_grad`` of the reference's loss (its train step's
``loss_fn``: forward with ``return_hidden`` and remat, the chunked loss,
the router aux term), the JAX parameters carried across with
``models/convert.py``.  Tolerance 1e-4 max-scaled per leaf, as the
forward parity of the LM slice in float32; the aux loss 1e-3 relative,
as there."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from lm_parity import (F32_TOL, f32, flat_tree, ref_loss_fn, scaled_err,
                       to_numpy, train_batch)
from repro import configs as ref_configs
from repro.configs import smoke_config as ref_smoke_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.convert import leaves_to_tree, params_from_reference

STEP_TOL = F32_TOL


@pytest.fixture(scope="module")
def ref_trees(cpu_mesh, rules):
    from repro.launch.steps import build_params as ref_build_params
    trees = {}

    def get(cfg):
        if cfg not in trees:
            with cpu_mesh:
                p, _ = ref_build_params(cfg, rules, abstract=False)
            trees[cfg] = to_numpy(p)
        return trees[cfg]
    return get


def _cfg(arch, ssm_impl="scan"):
    return f32(dataclasses.replace(ref_smoke_config(arch),
                                   ssm_impl=ssm_impl))


CASES = [(a, "scan") for a in ref_configs.ARCHS] + [("jamba_v0_1_52b",
                                                     "fft_conv")]


@pytest.mark.parametrize("arch,ssm_impl", CASES)
def test_train_step_gradients_match_reference(arch, ssm_impl, ref_trees,
                                              cpu_mesh, rules):
    """Loss, aux loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's loss (remat on both sides,
    float32), within 1e-4 max-scaled per leaf; the port with and without
    remat gives the same numbers."""
    cfg = _cfg(arch, ssm_impl)
    tree = ref_trees(cfg)
    batch = train_batch(cfg)
    with cpu_mesh:
        (_, (ref_loss, ref_aux)), ref_g = jax.value_and_grad(
            ref_loss_fn(cfg, rules), has_aux=True)(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_reference(tree, cfg, device="cpu")
    tb = {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
          else torch.as_tensor(v) for k, v in batch.items()}
    loss, aux, grads = loss_and_grads(model, cfg, None, tb, remat=True)
    assert all(not p.requires_grad and p.grad is None
               for p in model.parameters())
    assert float(loss) == pytest.approx(float(ref_loss), rel=STEP_TOL)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-3, abs=1e-6)
    got = flat_tree(leaves_to_tree(grads, as_numpy=True))
    want = flat_tree(to_numpy(ref_g))
    assert sorted(got) == sorted(want)
    for k in want:
        assert scaled_err(got[k], want[k]) < STEP_TOL, (arch, k)
    loss2, aux2, grads2 = loss_and_grads(model, cfg, None, tb, remat=False)
    assert float(loss2) == float(loss) and float(aux2) == float(aux)
    for k in grads:
        assert torch.allclose(grads2[k], grads[k], rtol=1e-6, atol=1e-9), k


