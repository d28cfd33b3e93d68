"""The port's LM substrate against the JAX package's, model level: the
config registry, ``forward`` of all 10 smoke configs with the JAX
parameters carried across (``models/convert.py``), the analytic costs
against the built modules' ``numel()``, cache construction and padding,
the cache converter, ``lm_loss``, and the entry points' device rule.
Tolerances are max-scaled: logits 1e-4 in float32, 5e-2 in the configs'
bfloat16."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lm_parity import (B, BF16_TOL, F32_TOL, S, f32, jax_batch, make_batch,
                       scaled_err, to_numpy, torch_batch)
from repro import configs as ref_configs
from repro.launch.steps import build_params as ref_build_params
from repro.launch.steps import lm_loss as ref_lm_loss
from repro.models import costs as ref_costs
from repro.models import transformer as ref_tfm
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch import configs
from repro_torch.launch.steps import build_params, lm_loss, \
    make_decode_step, make_prefill_step
from repro_torch.models import costs, transformer as tfm
from repro_torch.models.config import SHAPES
from repro_torch.models.convert import (caches_from_reference,
                                        caches_to_reference,
                                        params_from_reference)

DTYPES = {"float32": F32_TOL, "bfloat16": BF16_TOL}


@pytest.fixture(scope="module")
def ref_params(cpu_mesh, rules):
    """One JAX parameter tree per smoke arch (numpy), built on demand."""
    trees = {}

    def get(arch):
        if arch not in trees:
            with cpu_mesh:
                p, _ = ref_build_params(ref_configs.smoke_config(arch), rules,
                                        abstract=False)
            trees[arch] = to_numpy(p)
        return trees[arch]
    return get


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_config_registry_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.CANONICAL == ref_configs.CANONICAL
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in configs.ARCHS + list(configs.CANONICAL):
        cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
        assert as_dict(cfg) == as_dict(ref), arch
        assert as_dict(configs.smoke_config(arch)) == \
            as_dict(ref_configs.smoke_config(arch)), arch
        assert configs.applicable_shapes(cfg) == \
            ref_configs.applicable_shapes(ref)
        assert dataclasses.asdict(tfm.block_pattern(cfg)) == \
            dataclasses.asdict(ref_tfm.block_pattern(ref))
        assert cfg.layer_kinds() == ref.layer_kinds()
        assert (cfg.padded_vocab, cfg.kv_groups, cfg.subquadratic) == \
            (ref.padded_vocab, ref.kv_groups, ref.subquadratic)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_forward_matches_reference(arch, dtype, ref_params, cpu_mesh, rules):
    """Train-mode logits and aux loss of every smoke config; float32 logits
    within 1e-4 with equal greedy tokens, the configs' bfloat16 within
    5e-2."""
    cfg = ref_configs.smoke_config(arch)
    cfg = f32(cfg) if dtype == "float32" else cfg
    tree = ref_params(arch)
    batch = make_batch(cfg)
    with cpu_mesh:
        ref, _, ref_aux = ref_tfm.forward(jax.tree.map(np.asarray, tree),
                                          cfg, rules, jax_batch(batch),
                                          mode="train", remat=False)
    model = params_from_reference(tree, cfg, device="cpu")
    with torch.no_grad():
        logits, caches, aux = tfm.forward(model, cfg, None,
                                          torch_batch(batch), mode="train")
    assert caches is None
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert logits.dtype == (torch.float32 if dtype == "float32"
                            else torch.bfloat16)
    assert bool(torch.isfinite(logits.float()).all())
    assert scaled_err(logits, ref) < DTYPES[dtype], arch
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-3, abs=1e-6)
    if dtype == "float32":
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      np.asarray(ref).argmax(-1))


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_param_counts_match_built_modules(arch):
    """``costs.param_counts`` against ``numel()`` of the built smoke model,
    and equal to the reference's count.  The analytic count leaves out the
    norms outside the layers, the qk_norm scales and the modality
    projector, and counts a second norm in layers without an FFN; those
    terms are accounted for here by name."""
    cfg = configs.smoke_config(arch)
    model = build_params(cfg, device="cpu")
    numel = sum(p.numel() for p in model.parameters())
    counts = costs.param_counts(cfg)
    assert counts == ref_costs.param_counts(ref_configs.smoke_config(arch))
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    uncounted = d                                         # final_norm
    if cfg.qk_norm:   # every attention module: self, cross, encoder
        n_attn = cfg.layer_kinds().count("attn")
        if cfg.n_enc_layers:
            n_attn += cfg.n_layers + cfg.n_enc_layers
        uncounted += 2 * hd * n_attn
    if cfg.n_enc_layers:
        uncounted += d                                    # enc_norm
    if cfg.modality is not None:
        uncounted += d * d                                # modality_proj
    if cfg.d_ff == 0:
        uncounted -= d * cfg.n_layers                     # no norm2
    assert numel == counts["total"] + uncounted, (numel, counts)


def test_step_flops_match_reference():
    for arch in ref_configs.ARCHS:
        for shape in SHAPES.values():
            got = costs.step_flops(configs.get_config(arch), shape)
            ref = ref_costs.step_flops(ref_configs.get_config(arch),
                                       REF_SHAPES[shape.name])
            assert got == ref, (arch, shape.name)


@pytest.mark.parametrize("arch", ["qwen3_8b", "jamba_v0_1_52b",
                                  "xlstm_125m", "seamless_m4t_medium"])
def test_init_and_pad_caches_match_reference(arch):
    """Zeroed caches, their padding to a decode budget, and the converter
    both ways: the reference's stacked tree leaf by leaf."""
    cfg = configs.smoke_config(arch)
    ref = to_numpy(ref_tfm.init_caches(ref_configs.smoke_config(arch), B, 40))
    got = caches_to_reference(tfm.init_caches(cfg, B, 40, device="cpu"))
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, ref)
    back = caches_to_reference(caches_from_reference(ref, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
        else a, ref))
    small_ref = to_numpy(ref_tfm.init_caches(ref_configs.smoke_config(arch),
                                             B, 24))
    padded_ref = to_numpy(ref_tfm.pad_caches(small_ref,
                                             ref_configs.smoke_config(arch),
                                             40))
    padded = caches_to_reference(tfm.pad_caches(
        caches_from_reference(small_ref, device="cpu"), cfg, 40))
    assert jax.tree.map(np.shape, padded) == jax.tree.map(np.shape,
                                                          padded_ref)


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 16)).astype(np.float32)
    labels = rng.integers(0, 12, (2, 5))
    got = lm_loss(torch.as_tensor(logits), torch.as_tensor(labels), 12)
    ref = ref_lm_loss(logits, labels, 12)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    zeros = torch.zeros((1, 4, 10))
    assert float(lm_loss(zeros, torch.zeros((1, 4), dtype=torch.long),
                         6)) == pytest.approx(np.log(6), rel=1e-5)


def test_host_mesh_one_process_and_two_ranks(tmp_path, monkeypatch):
    """One process means no mesh; under a 2-rank gloo group the world is a
    (1, 2) ("data", "model") mesh, on which ``serve`` (tensor-parallel)
    gives every rank the one-process tokens (float32 smoke config)."""
    import json
    import os

    import repro_torch.launch.serve as serve_mod
    from repro_torch.launch.mesh import make_host_mesh
    from torch_harness import f32_smoke_config, run_ranks
    assert make_host_mesh() is None
    out = run_ranks("lm_mesh_body", 2, tmp_path)
    recs = [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(2)]
    assert [r["coords"] for r in recs] == [[0, 0], [0, 1]]
    assert all(r["shape"] == [1, 2] and r["names"] == ["data", "model"]
               and r["device"] == "cpu" for r in recs)
    monkeypatch.setattr(serve_mod, "smoke_config", f32_smoke_config)
    want = serve_mod.serve("qwen3-8b", requests=1, device="cpu")
    assert all(r["tokens"] == want for r in recs)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is taken")
    cfg = configs.smoke_config("qwen3_8b")
    for fn in (lambda: build_params(cfg), lambda: make_prefill_step(cfg),
               lambda: make_decode_step(cfg),
               lambda: tfm.init_caches(cfg, B, 40)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    from repro_torch.distributed.sharding import ParamBuilder
    with pytest.raises(TypeError, match="device"):
        ParamBuilder(0)      # a builder names its device
    from repro_torch.launch.serve import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("qwen3-8b", requests=1)
    model = build_params(cfg, device="cpu")
    assert model.embed.device.type == "cpu"
    # parameters are the reference's float32 masters; draws depend on the
    # seed and path only
    assert all(p.dtype == torch.float32 for p in model.parameters())
    again = build_params(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    other = build_params(cfg, seed=1, device="cpu")
    assert not torch.equal(model.embed, other.embed)


def test_weight_carrier_needs_a_card_unless_asked_for_the_cpu(
        ref_params, monkeypatch):
    """``params_from_reference`` and ``caches_from_reference`` follow the
    entry points' rule: on a machine with no card their default raises,
    naming ``device='cpu'``; asked for the CPU, they build there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = "qwen3_8b"
    cfg = configs.smoke_config(arch)
    tree = ref_params(arch)
    caches = to_numpy(ref_tfm.init_caches(ref_configs.smoke_config(arch),
                                          B, 8))
    for fn in (lambda: params_from_reference(tree, cfg),
               lambda: caches_from_reference(caches),
               lambda: params_from_reference(tree, cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    model = params_from_reference(tree, cfg, device="cpu")
    assert model.embed.device.type == "cpu"
    got = caches_from_reference(caches, device="cpu")
    leaves = [t for name in got for block in got[name]
              for sub in block.values() for t in sub.values()
              if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)
