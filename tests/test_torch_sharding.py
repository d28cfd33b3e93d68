"""The port's LM sharding specs against the JAX package's, in one process.

For the 10 smoke configs on ``(2, 2)`` and ``(1, 4)`` ("data", "model")
meshes, seen from each position of the mesh (a ``compat.Mesh`` with no
process groups: building and placing parameters needs only the axis
sizes and this rank's coordinates):

* ``sharding.param_pspecs`` equals the reference's ``param_pspecs``
  (``repro.launch.steps.build_params``) leaf for leaf, but for the listed
  deviation: with fewer K/V heads than "model" ranks, ``wk``/``wv`` are
  replicated over "model" (:func:`deviation`);
* every rank holds only its block of each split leaf: the local element
  counts over the ranks add up to the whole leaf's times the ranks that
  hold the same block, and the blocks laid out by their coordinates are
  the one-process model's values, bit for bit;
* ``transformer.cache_pspec`` equals the reference's spec for spec.
"""
import dataclasses
import math

import jax
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed.sharding import MeshRules as RefMeshRules
from repro.launch.steps import build_params as ref_build_params
from repro.models import transformer as ref_tfm
from repro_torch import configs
from repro_torch.compat import Mesh, _spec_axes
from repro_torch.distributed.sharding import (MeshRules, ParamBuilder,
                                              param_pspecs, pspec_tree)
from repro_torch.models import transformer as tfm

ARCHS = list(configs.ARCHS)
MESHES = [(2, 2), (1, 4)]


def virtual_mesh(shape, coords) -> Mesh:
    """One position of a mesh, without process groups."""
    names = ("data", "model")
    return Mesh(names, tuple(shape), tuple(coords), torch.device("cpu"),
                {n: None for n in names}, ranks=tuple(range(math.prod(shape))))


def positions(shape):
    return [(d, m) for d in range(shape[0]) for m in range(shape[1])]


def build(cfg, mesh=None):
    b = ParamBuilder(0, device="cpu", rules=MeshRules.for_mesh(mesh))
    with torch.no_grad():
        return tfm.init_model(b, cfg)


def ref_specs(arch):
    """The reference's spec tree of ``arch``'s smoke config, flattened to
    ``{path: spec tuple}`` (stacked leaves lead with None)."""
    _, specs = ref_build_params(ref_configs.smoke_config(arch),
                                RefMeshRules(), abstract=True)
    flat = {}
    for kp, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.
                                                PartitionSpec))[0]:
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        flat[path] = tuple(spec)
    return flat


def deviation(cfg, path: str, tp: int) -> bool:
    """Where the port's spec differs by design: K/V projections replicated
    over "model" when the K/V heads do not split over it."""
    leaf = path.rsplit("/", 1)[-1]
    return (cfg.n_kv_heads % tp != 0 and leaf in ("wk", "wv")
            and path.split("/")[-2] in ("attn", "cross"))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, shape):
    cfg = configs.smoke_config(arch)
    ref = ref_specs(arch)
    model = build(cfg, virtual_mesh(shape, (0, 0)))
    got = param_pspecs(model)
    tree = {}
    for (path, r), spec in got.items():
        tree[path] = spec if r is None else (None,) + spec
    assert set(tree) == set(ref)
    deviating = []
    for path, spec in tree.items():
        if deviation(cfg, path, shape[1]):
            deviating.append(path)
            assert spec == ref[path][:-1] + (None,), path
        else:
            assert spec == ref[path], path
    # the deviation is the K/V projections of a config with fewer K/V
    # heads than "model" ranks, and nothing else
    want = sorted(p for p in ref if deviation(cfg, p, shape[1]))
    assert sorted(deviating) == want
    assert bool(want) == (cfg.n_kv_heads % shape[1] != 0)
    # the nested spec tree (the checkpoint manifest's) is the same map
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v
    walk(pspec_tree(model), "")
    assert flat == tree


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen3_8b", "olmoe_1b_7b",
                                  "jamba_v0_1_52b", "xlstm_125m",
                                  "seamless_m4t_medium"])
def test_each_rank_holds_only_its_blocks(arch, shape):
    """Local element counts add up to the whole leaf's (times the ranks
    holding the same block), and the blocks reassemble the one-process
    model's values bit for bit."""
    cfg = dataclasses.replace(configs.smoke_config(arch), ssm_impl="fft_conv") \
        if arch == "jamba_v0_1_52b" else configs.smoke_config(arch)
    whole = dict(build(cfg).named_parameters())
    sizes = dict(zip(("data", "model"), shape))
    counts = {k: 0 for k in whole}
    blocks = {k: {} for k in whole}
    specs = None
    for pos in positions(shape):
        model = build(cfg, virtual_mesh(shape, pos))
        specs = {n: p.spec for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            counts[n] += p.numel()
            blocks[n][pos] = p.detach()
    n_split = 0
    for n, w in whole.items():
        axes = {a for e in specs[n] for a in _spec_axes(e)}
        split = math.prod(sizes[a] for a in axes)
        replicas = math.prod(shape) // split
        assert counts[n] == w.numel() * replicas, n
        if split > 1:
            n_split += 1
            assert blocks[n][(0, 0)].numel() * split == w.numel(), n
        # every rank's block is its slice of the one-process leaf
        for (d, m), blk in blocks[n].items():
            view = w.detach()
            for dim, entry in enumerate(specs[n]):
                for ax in _spec_axes(entry):
                    idx = {"data": d, "model": m}[ax]
                    step = view.shape[dim] // sizes[ax]
                    view = view.narrow(dim, idx * step, step)
            assert torch.equal(blk, view), (n, (d, m))
    assert n_split > 0


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen3_8b", "jamba_v0_1_52b",
                                  "xlstm_125m", "seamless_m4t_medium",
                                  "h2o_danube_1_8b"])
def test_cache_pspec_matches_reference(arch, shape, batch):
    sizes = {"data": shape[0], "model": shape[1]}
    ref_cfg = ref_configs.smoke_config(arch)
    ref_caches = jax.eval_shape(lambda: ref_tfm.init_caches(ref_cfg, batch,
                                                            40))
    ref = ref_tfm.cache_pspec(ref_cfg, RefMeshRules(), batch, sizes)(
        ref_caches)
    caches = tfm.init_caches(configs.smoke_config(arch), batch, 40,
                             device="cpu")
    got = tfm.cache_pspec(configs.smoke_config(arch), MeshRules(), batch,
                          sizes)(caches)
    assert set(got) == set(ref)
    for name, reps in got.items():
        for r, sub in enumerate(reps):
            for kind, leaves in sub.items():
                for leaf, spec in leaves.items():
                    want = tuple(ref[name][kind][leaf])
                    if leaf == "pos":
                        assert spec == () and want == ()
                    else:
                        assert spec == want[1:], (name, kind, leaf)
