"""Elastic checkpoints of the port's sharded ``train`` on 4 gloo ranks
(float32 smoke config of olmoe-1b-7b: dense attention and MoE, every
leaf's spec the reference's):

* a checkpoint saved on ``(2, 2)`` restores on ``(1, 4)`` and on one
  process with parameters and AdamW moments bitwise equal to the state
  that saved it;
* a run preempted and resumed on ``(2, 2)`` gives losses bitwise equal to
  the uninterrupted run's; resumed on ``(1, 4)`` (another mesh: other
  summation orders) within 1e-5;
* the manifest's ``pspecs`` equal those the reference's
  ``CheckpointManager`` writes for the reference's spec tree;
* a checkpoint written by the reference's ``train`` on 4 fake XLA devices
  restores onto a ``(1, 4)`` port mesh bitwise.
"""
import json
import os

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.distributed.sharding import MeshRules as RefMeshRules
from repro.launch.steps import build_params as ref_build_params
from repro.launch.steps import opt_pspecs as ref_opt_pspecs
from torch_harness import run_ranks, run_reference

ARCH = "olmoe_1b_7b"

REF_CODE = """
import dataclasses
from repro import configs
from repro.compat import AxisType, make_mesh
import repro.launch.train as rt
rt.smoke_config = lambda name: dataclasses.replace(
    configs.smoke_config(name), dtype="float32")
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rt.train({arch!r}, mesh=mesh, steps=2, seq_len=16, global_batch=2,
         ckpt_dir={out!r}, log_every=99)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    ref_ckpt = str(tmp / "reference")
    run_reference(REF_CODE.format(arch=ARCH, out=ref_ckpt), devices=4)
    out = run_ranks("lm_ckpt_body", 4, tmp, ARCH, ref_ckpt)
    recs = [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(4)]
    return {"recs": recs, "dir": out, "ref_ckpt": ref_ckpt}


def test_restore_on_other_meshes_is_bitwise(run):
    for rec in run["recs"]:
        assert rec["restore_bitwise"] == {"1x4": True, "one": True}


def test_resumed_losses_match_uninterrupted(run):
    for rec in run["recs"]:
        whole = rec["whole"]
        assert len(whole) == 4 and all(np.isfinite(whole))
        assert rec["part"] == whole[:2]
        assert rec["resumed22"] == whole[2:]
        np.testing.assert_allclose(rec["resumed14"], whole[2:], rtol=0,
                                   atol=1e-5)
    assert all(r["whole"] == run["recs"][0]["whole"] for r in run["recs"])


def test_manifest_pspecs_match_reference(run, tmp_path):
    import dataclasses
    cfg = dataclasses.replace(ref_configs.smoke_config(ARCH),
                              dtype="float32")
    _, specs = ref_build_params(cfg, RefMeshRules(), abstract=True)
    mgr = RefCheckpointManager(str(tmp_path))
    mgr.save(0, {"x": np.zeros(1)},
             pspecs={"params": specs, "opt": ref_opt_pspecs(specs)})
    with open(tmp_path / "step_0000000000" / "manifest.json") as f:
        want = json.load(f)["pspecs"]
    got = run["recs"][0]["manifest_pspecs"]
    assert got == want


def test_reference_checkpoint_restores_onto_a_port_mesh(run):
    step = os.path.join(run["ref_ckpt"], "step_0000000002")
    with open(os.path.join(step, "manifest.json")) as f:
        manifest = json.load(f)
    got = np.load(os.path.join(run["dir"], "from_reference.npz"))
    assert sorted(got.files) == sorted(manifest["arrays"])
    for name, meta in manifest["arrays"].items():
        want = np.load(os.path.join(step, meta["file"]))
        np.testing.assert_array_equal(got[name], want, err_msg=name)
