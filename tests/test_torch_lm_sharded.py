"""The port's LM sharded over 4 gloo ranks against the JAX package's on 4
fake XLA devices: float32 smoke configs of qwen3-8b (dense), olmoe-1b-7b
(MoE) and jamba-v0.1-52b with ``ssm_impl="fft_conv"`` (the kernel
backend: its plain version on the CPU), on ``(2, 2)`` and ``(1, 4)``
("data", "model") meshes, all from the reference's parameters:

* ``serve`` gives every rank the reference's tokens, and the one-process
  port's (jamba serves with its Mamba scan: ``fft_conv`` has no decode
  form, in either package);
* 5 ``train`` steps give losses within 1e-4 of the reference's;
* one step's gradients, gathered whole, are within the one-process
  port's by ``tests/test_torch_train_step.py``'s tolerance.

The reference runs in one subprocess per config and the ranks are spawned
once, all at the same time (module fixture).  The reference's ``fft_conv``
does not train on a mesh of several XLA CPU devices (XLA's CPU FFT thunk
fails a layout check, ``fft_thunk.cc:167``, on the sharded operand), so
the sharded jamba ``fft_conv`` losses are held to the reference's train on
one device: the same function of the same parameters and batches.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

from lm_parity import F32_TOL, flat_tree, scaled_err, to_numpy
from repro import configs as ref_configs
from repro.distributed.sharding import MeshRules as RefMeshRules
from repro.launch.steps import build_params as ref_build_params
from torch_harness import (lm_config, load_tree, patch_lm_drivers,
                           run_ranks, run_reference)

# (name, arch, config fields, what runs)
CASES = [("qwen3_8b", "qwen3_8b", {}, ("serve", "train")),
         ("olmoe_1b_7b", "olmoe_1b_7b", {}, ("serve", "train")),
         ("jamba_scan", "jamba_v0_1_52b", {}, ("serve",)),
         ("jamba_fftconv", "jamba_v0_1_52b", {"ssm_impl": "fft_conv"},
          ("train",)),
         # qwen3's smoke config has one K/V head (replicated over "model");
         # four split over it, with qk-norm, as at the published widths
         ("qwen3_kv4", "qwen3_8b", {"n_kv_heads": 4}, ("train",))]
MESHES = [(2, 2), (1, 4)]
SERVE = dict(requests=2, batch=2, prompt_len=8, max_new=4)
TRAIN = dict(steps=5, seq_len=16, global_batch=2)
LOSS_TOL = 1e-4
STEP_TOL = F32_TOL   # tests/test_torch_train_step.py's
# the reference trains these on one device (module docstring)
REF_ONE_DEVICE = {"jamba_fftconv"}

REF_CODE = """
import dataclasses, json
from repro import configs
from repro.compat import AxisType, make_mesh
import repro.launch.serve as rs, repro.launch.train as rt
name, arch, extra, what, out = {case!r} + ({out!r},)
import jax
def cfg_of(name):
    return dataclasses.replace(configs.smoke_config(name), dtype="float32",
                               **extra)
rs.smoke_config = rt.smoke_config = cfg_of
res = {{}}
for shape in {meshes!r}:
    run_on = (1, 1) if name in {one!r} else shape
    mesh = make_mesh(run_on, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:run_on[0] * run_on[1]])
    tag = f"{{name}}-{{shape[0]}}x{{shape[1]}}"
    res[tag] = {{}}
    if "serve" in what:
        res[tag]["tokens"] = rs.serve(arch, mesh=mesh, **{serve!r})
    if "train" in what:
        res[tag]["losses"] = rt.train(arch, mesh=mesh, log_every=99,
                                      **{train!r})["losses"]
json.dump(res, open(out, "w"))
"""


def tags(what: str):
    return [(name, shape) for name, _, _, runs in CASES if what in runs
            for shape in MESHES]


def tag_id(case):
    name, shape = case
    return f"{name}-{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's results, run side by side."""
    tmp = tmp_path_factory.mktemp("lm_sharded")
    trees, ref_out = [], {}
    for name, arch, extra, what in CASES:
        ref_cfg = dataclasses.replace(
            ref_configs.smoke_config(arch), dtype="float32", **extra)
        params, _ = ref_build_params(ref_cfg, RefMeshRules(), abstract=False)
        path = str(tmp / f"{name}.npz")
        np.savez(path, **flat_tree(to_numpy(params)))
        trees.append((name, arch, extra, what, path))
    errors = []

    def reference(*case):
        out = str(tmp / f"ref-{case[0]}.json")
        try:
            run_reference(REF_CODE.format(case=case, out=out, meshes=MESHES,
                                          serve=SERVE, train=TRAIN,
                                          one=REF_ONE_DEVICE),
                          devices=4)
            ref_out[case[0]] = json.load(open(out))
        except Exception as e:   # raised below, once the ranks are done
            errors.append(e)
    threads = [threading.Thread(target=reference, args=c) for c in CASES]
    for t in threads:
        t.start()
    port_dir = run_ranks("lm_sharded_body", 4, tmp, trees,
                         [list(m) for m in MESHES], SERVE, TRAIN)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    ref = {k: v for r in ref_out.values() for k, v in r.items()}
    port = [json.load(open(os.path.join(port_dir, f"rank{r}.json")))
            for r in range(4)]
    return {"ref": ref, "port": port, "dir": port_dir,
            "trees": {c[0]: c[-1] for c in trees}}


@pytest.fixture(scope="module")
def one_process(runs):
    """The one-process port's tokens and one step's gradients, from the
    same parameters."""
    import repro_torch.launch.serve as serve_mod
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.config import ShapeConfig
    out = {}
    for name, arch, extra, what in CASES:
        out[name] = {}
        with pytest.MonkeyPatch.context() as mp:
            patch_lm_drivers(load_tree(runs["trees"][name]), extra,
                             mp.setattr)
            if "serve" in what:
                out[name]["tokens"] = serve_mod.serve(arch, device="cpu",
                                                      **SERVE)
            if "train" not in what:
                continue
            cfg = lm_config(arch, extra)
            model = serve_mod.build_params(cfg, device="cpu")
            data = SyntheticLM(cfg, ShapeConfig(
                "t", "train", TRAIN["seq_len"], TRAIN["global_batch"]))
            _, _, grads = loss_and_grads(model, cfg, None,
                                         data.device_batch(0, "cpu"))
        out[name]["grads"] = {f"{k[0]}|{k[1]}": g.numpy()
                              for k, g in grads.items()}
    return out


@pytest.mark.parametrize("case", tags("serve"), ids=tag_id)
def test_serve_tokens_match_reference_and_one_process(case, runs,
                                                      one_process):
    name, shape = case
    tag = tag_id(case)
    want = runs["ref"][tag]["tokens"]
    assert len(want) == SERVE["requests"]
    for rec in runs["port"]:
        assert rec[tag]["tokens"] == want, (tag, rec[tag]["tokens"], want)
    assert one_process[name]["tokens"] == want


@pytest.mark.parametrize("case", tags("train"), ids=tag_id)
def test_train_losses_match_reference(case, runs):
    tag = tag_id(case)
    want = np.asarray(runs["ref"][tag]["losses"])
    assert want.shape == (TRAIN["steps"],)
    for rec in runs["port"]:
        got = np.asarray(rec[tag]["losses"])
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    # every rank reports the whole batch's loss
    assert all(r[tag]["losses"] == runs["port"][0][tag]["losses"]
               for r in runs["port"])


@pytest.mark.parametrize("case", tags("train"), ids=tag_id)
def test_gathered_gradients_match_one_process(case, runs, one_process):
    name, shape = case
    got = np.load(os.path.join(runs["dir"], f"grads-{tag_id(case)}.npz"))
    want = one_process[name]["grads"]
    assert set(got.files) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert scaled_err(got[k], want[k]) < STEP_TOL, (tag_id(case), k)
    assert any(np.abs(want[k]).max() > 0 for k in want)
