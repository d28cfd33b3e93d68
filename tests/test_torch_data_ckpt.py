"""The port's synthetic data (``repro_torch.data``) and checkpoints
(``repro_torch.checkpoint``) against the JAX package's: tokens identical to
the reference's ``batch_for_step``, the counterparts of
``tests/test_substrate.py``'s data and checkpoint tests, float32
checkpoints written by either package restored by the other with equal
arrays, a bfloat16 round trip within the port, and a model's training
state in the reference's tree layout."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import flat_tree
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import batch_specs as ref_batch_specs
from repro.distributed.sharding import MeshRules as RefRules
from repro.launch.steps import batch_pspecs as ref_batch_pspecs
from repro.models.config import ShapeConfig as RefShapeConfig
from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM, batch_specs
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch.steps import batch_pspecs
from repro_torch.models.config import ShapeConfig

CPU = torch.device("cpu")


def _pipes(arch, seed=1, seq=16, batch=4):
    return (SyntheticLM(configs.smoke_config(arch),
                        ShapeConfig("t", "train", seq, batch), seed=seed),
            RefSyntheticLM(ref_configs.smoke_config(arch),
                           RefShapeConfig("t", "train", seq, batch),
                           seed=seed))


@pytest.mark.parametrize("arch", ["qwen3_8b", "seamless_m4t_medium",
                                  "llava_next_mistral_7b"])
def test_batches_identical_to_reference(arch):
    """Three steps, every key, bit for bit (the same numpy generator)."""
    pipe, ref = _pipes(arch)
    for step in (0, 1, 7):
        got, want = pipe.batch_for_step(step), ref.batch_for_step(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    cfg = configs.smoke_config(arch)
    keys = set(pipe.batch_for_step(0))
    if cfg.modality is not None:
        assert "modality_embeds" in keys
    elif cfg.n_enc_layers:
        assert "src_tokens" in keys


def test_data_deterministic_by_step():
    pipe, _ = _pipes("qwen3_8b")
    b1, b2 = pipe.batch_for_step(7), pipe.batch_for_step(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], pipe.batch_for_step(8)["tokens"])


def test_data_labels_shifted():
    pipe, _ = _pipes("qwen3_8b")
    cfg = configs.smoke_config("qwen3_8b")
    b = pipe.batch_for_step(0)
    assert b["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].max() < cfg.vocab


def test_device_batch_and_prefetch():
    """``device_batch`` is ``batch_for_step`` as tensors (ids int64); the
    prefetch iterator yields the steps in order and stops its thread."""
    import threading
    pipe, _ = _pipes("seamless_m4t_medium")
    host = pipe.batch_for_step(3)
    dev = pipe.device_batch(3, CPU)
    for k, v in host.items():
        assert dev[k].device == CPU
        assert dev[k].dtype == (torch.int64 if v.dtype.kind == "i"
                                else torch.float32)
        np.testing.assert_array_equal(dev[k].numpy(), v)
    before = threading.active_count()
    it = pipe.prefetch(5, CPU, depth=2)
    for step in range(5, 9):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      pipe.batch_for_step(step)["tokens"])
    it.close()
    assert threading.active_count() <= before


def test_batch_specs_match_reference():
    """``batch_specs`` and ``launch.steps.batch_pspecs`` (a batch of one
    replicated) as the reference's, on a one- and a two-axis fsdp."""
    for arch in ("qwen3_8b", "seamless_m4t_medium", "llava_next_mistral_7b"):
        cfg, ref_cfg = (configs.smoke_config(arch),
                        ref_configs.smoke_config(arch))
        for rules, ref_rules in ((MeshRules(), RefRules()),
                                 (MeshRules(fsdp=("pod", "data")),
                                  RefRules(fsdp=("pod", "data")))):
            for b in (1, 4):
                shape = ShapeConfig("t", "train", 16, b)
                ref_shape = RefShapeConfig("t", "train", 16, b)
                for fn, ref_fn in ((batch_specs, ref_batch_specs),
                                   (batch_pspecs, ref_batch_pspecs)):
                    want = ref_fn(ref_cfg, ref_shape, ref_rules)
                    assert fn(cfg, shape, rules) == {
                        k: tuple(v) for k, v in want.items()}


def test_opt_pspecs_match_reference():
    from jax.sharding import PartitionSpec as P
    from repro.launch.steps import opt_pspecs as ref_opt_pspecs
    from repro_torch.launch.steps import opt_pspecs
    specs = {"embed": ("model", "data"), "final_norm": {"scale": (None,)}}
    ref = ref_opt_pspecs({"embed": P("model", "data"),
                          "final_norm": {"scale": P(None)}})
    got = opt_pspecs(specs)
    assert got["m"] == got["v"] == specs and got["count"] == tuple(
        ref["count"])
    assert tuple(ref["m"]["embed"]) == got["m"]["embed"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"count": torch.tensor(3, dtype=torch.int32)}}
    mgr.save(10, state)
    step, restored = mgr.restore(device="cpu")
    assert step == 10
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert restored["opt"]["count"].dtype == torch.int32
    assert int(restored["opt"]["count"]) == 3


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.tensor([float(s)])})
    assert mgr.latest_step() == 3
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2  # keep_n enforced


def test_checkpoint_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=5)
    mgr.save(1, {"w": torch.tensor([1.0])})
    mgr.save(2, {"w": torch.tensor([2.0])})
    newest = os.path.join(str(tmp_path), "step_0000000002", "w.npy")
    with open(newest, "wb") as f:
        f.write(b"garbage")
    assert mgr.latest_step() == 1  # falls back to the valid one
    step, restored = mgr.restore(device="cpu")
    assert step == 1 and float(restored["w"][0]) == 1.0


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")
    mgr.save(1, {"w": torch.tensor([1.0])})
    assert mgr.latest_step() == 1
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_restore_onto_mesh_device_and_default(tmp_path):
    """With a mesh, arrays land on its device (whole: one process); with
    no device and no card, restore raises as every entry point does."""
    from repro_torch.compat import Mesh
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": torch.arange(8.0)}, pspecs={"w": (None,)})
    manifest = json.load(open(tmp_path / "step_0000000005" /
                              "manifest.json"))
    assert manifest["pspecs"] == {"w": [None]}
    mesh = Mesh(("data", "model"), (1, 1), (0, 0), CPU, {})
    step, restored = mgr.restore(mesh=mesh, pspecs={"w": (None,)})
    assert step == 5 and restored["w"].device == CPU
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mgr.restore()


def _f32_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"decoder": {"layer0": {"attn": {
        "wq": rng.standard_normal((2, 8, 4)).astype(np.float32)}}},
        "embed": rng.standard_normal((16, 8)).astype(np.float32)},
        "opt": {"count": np.asarray(7, np.int32),
                "m": {"embed": rng.standard_normal((16, 8))
                      .astype(np.float32)}}}


def test_reference_checkpoint_restores_in_port(tmp_path):
    state = _f32_state()
    RefCheckpointManager(str(tmp_path)).save(
        4, {"params": {k: jnp.asarray(v) if not isinstance(v, dict) else v
                       for k, v in state["params"].items()},
            "opt": state["opt"]})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    step, restored = mgr.restore(device="cpu")
    assert step == 4
    got, want = flat_tree(restored), flat_tree(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_port_checkpoint_restores_in_reference(tmp_path):
    state = _f32_state(1)
    torch_state = {"params": {
        "decoder": {"layer0": {"attn": {"wq": torch.from_numpy(
            state["params"]["decoder"]["layer0"]["attn"]["wq"])}}},
        "embed": torch.from_numpy(state["params"]["embed"])},
        "opt": {"count": torch.tensor(7, dtype=torch.int32),
                "m": {"embed": torch.from_numpy(state["opt"]["m"]["embed"])}}}
    CheckpointManager(str(tmp_path)).save(9, torch_state)
    ref = RefCheckpointManager(str(tmp_path))
    assert ref.latest_step() == 9
    step, restored = ref.restore()
    got, want = flat_tree(restored), flat_tree(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_bf16_checkpoint_roundtrip(tmp_path):
    """bfloat16 is stored as its uint16 bits with "bfloat16" in the
    manifest, the CRC over those bytes; it restores bit for bit."""
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)) \
        .bfloat16()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"m": {"w": w}, "x": torch.ones(3)})
    meta = json.load(open(tmp_path / "step_0000000002" / "manifest.json"))
    assert meta["arrays"]["m/w"]["dtype"] == "bfloat16"
    raw = np.load(tmp_path / "step_0000000002" / "m__w.npy")
    assert raw.dtype == np.uint16
    assert mgr.latest_step() == 2
    _, restored = mgr.restore(device="cpu")
    assert restored["m"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["m"]["w"].view(torch.int16),
                       w.view(torch.int16))


def test_training_state_tree_matches_reference_layout(tmp_path, cpu_mesh,
                                                      rules):
    """A model carried across from the reference's tree, with AdamW state:
    ``train_state`` in a port checkpoint restores in the reference as the
    reference's own ``{"params", "opt"}`` tree (same names and arrays), and
    back into a fresh port model and state."""
    from repro.launch.steps import build_params as ref_build_params
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro_torch.launch.steps import build_params
    from repro_torch.launch.train import train_state
    from repro_torch.models.convert import (load_params,
                                            opt_state_from_reference,
                                            opt_state_to_reference,
                                            params_from_reference,
                                            params_to_reference,
                                            param_leaves)
    from repro_torch.optim import AdamWConfig, adamw_init
    arch = "jamba_v0_1_52b"
    with cpu_mesh:
        ref_p, _ = ref_build_params(ref_configs.smoke_config(arch), rules,
                                    abstract=False)
    tree = jax.tree.map(np.asarray, ref_p)
    ref_opt = jax.tree.map(np.asarray,
                           ref_adamw_init(ref_p, RefAdamWConfig()))
    cfg = configs.smoke_config(arch)
    model = params_from_reference(tree, cfg, device="cpu")
    state = adamw_init(param_leaves(model), AdamWConfig())
    state["count"] += 4
    back_tree = flat_tree(params_to_reference(model))
    assert sorted(back_tree) == sorted(flat_tree(tree))
    for k, v in flat_tree(tree).items():
        np.testing.assert_array_equal(back_tree[k], v)
    opt_tree = opt_state_to_reference(state)
    assert jax.tree.map(np.shape, opt_tree) == \
        jax.tree.map(np.shape, dict(ref_opt, count=np.asarray(4, np.int32)))
    assert opt_tree["count"].dtype == np.int32 and int(opt_tree["count"]) == 4
    CheckpointManager(str(tmp_path)).save(4, train_state(model, state))
    _, restored = RefCheckpointManager(str(tmp_path)).restore()
    got = flat_tree(restored["params"])
    want = flat_tree(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert sorted(flat_tree(restored["opt"])) == sorted(flat_tree(ref_opt))
    assert int(restored["opt"]["count"]) == 4

    _, back = CheckpointManager(str(tmp_path)).restore(device="cpu")
    fresh = build_params(cfg, seed=3, device="cpu")
    load_params(fresh, back["params"])
    for (k, p), (k2, q) in zip(param_leaves(fresh).items(),
                               param_leaves(model).items()):
        assert k == k2 and torch.equal(p, q), k
    st = opt_state_from_reference(back["opt"], fresh)
    assert int(st["count"]) == 4 and sorted(st["m"]) == sorted(state["m"])
