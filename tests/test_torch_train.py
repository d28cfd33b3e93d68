"""The port's training path against the JAX package's: ``fft_conv``'s
gradient through the kernel backend (the autograd Function around the
line transforms, ``kernels/ops.LineTransform``), ``make_train_step`` with
micro-batches, and ``train()`` (the counterparts of
``tests/test_system.py``'s training tests).  One train step's gradients
for every smoke config are in ``test_torch_train_step.py``.

Tolerances: ``fft_conv`` gradients 1e-5 max-scaled (float32, the same
FFTs on both sides); loss 1e-4 relative; parameters after a bfloat16-
compressed AdamW step 1e-5 of the learning rate plus the bfloat16
rounding's share (see
``test_train_step_with_micro_batches_matches_reference``); ``train()``
losses 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (F32_TOL, f32, flat_tree, jax_init, port_module,
                       randn, ref_loss_fn, scaled_err, to_numpy, train_batch,
                       tt)
from repro.configs import smoke_config as ref_smoke_config
from repro.distributed.sharding import MeshRules
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.distributed.sharding import ParamBuilder
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (param_leaves,
                                        params_from_reference,
                                        params_to_reference)

RULES = MeshRules()
GRAD_TOL = 1e-5          # fft_conv gradients, float32
STEP_TOL = F32_TOL       # train-step loss and gradients, float32
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# fft_conv's gradient through the kernel backend
# ---------------------------------------------------------------------------

def _fft_conv_pair():
    cfg = f32(dataclasses.replace(ref_smoke_config("jamba_v0_1_52b"),
                                  ssm_impl="fft_conv"))
    tree, ref_p = jax_init(ref_ssm.init_fft_conv, cfg, "ssm", seed=2)
    return cfg, tree, ref_p


def test_fft_conv_kernel_gradients_match_reference():
    """``fft_backend="kernel"`` (here: the Function over the kernel's plain
    version) against ``jax.grad`` of the reference's ``fft_backend="xla"``
    (its ``"pallas"`` backend cannot be differentiated): w_in, basis_w,
    decay, w_out and the input, within 1e-5 max-scaled."""
    cfg, tree, ref_p = _fft_conv_pair()
    x = randn((2, 32, cfg.d_model), 5)
    r = randn((2, 32, cfg.d_model), 6)

    def ref_loss(p, xx):
        y, _ = ref_ssm.fft_conv(p, cfg, RULES, xx, fft_backend="xla")
        return jnp.sum(y * jnp.asarray(r))

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p,
                                                        jnp.asarray(x))
    p = port_module(ssm.init_fft_conv, tree, "ssm", cfg)
    p.requires_grad_(True)
    xt = tt(x).requires_grad_(True)
    y, _ = ssm.fft_conv(p, cfg, None, xt, fft_backend="kernel")
    (y * tt(r)).sum().backward()
    for name in ("w_in", "basis_w", "decay", "w_out"):
        g = getattr(p, name).grad
        assert g is not None and bool(g.abs().max() > 0), name
        assert scaled_err(g, ref_gp[name]) < GRAD_TOL, name
    assert scaled_err(xt.grad, ref_gx) < GRAD_TOL


def test_fft_conv_kernel_gradients_match_cufft_and_count_transforms(
        monkeypatch):
    """The kernel backend's gradients equal the ``cufft`` backend's (torch.fft
    autograd); one forward and backward makes 3 + 3 line transforms, and 9
    when the layer is recomputed under remat."""
    cfg, tree, _ = _fft_conv_pair()
    x = randn((2, 32, cfg.d_model), 8)

    def grads(backend):
        p = port_module(ssm.init_fft_conv, tree, "ssm", cfg)
        p.requires_grad_(True)
        y, _ = ssm.fft_conv(p, cfg, None, tt(x), fft_backend=backend)
        (y.square()).sum().backward()
        return {n: q.grad for n, q in p.named_parameters()}

    ref = grads("cufft")
    calls = []
    real = ops._apply

    def spy(t, axis, **kw):
        calls.append((tuple(t.shape), kw["inverse"]))
        return real(t, axis, **kw)

    monkeypatch.setattr(ops, "_apply", spy)
    got = grads("kernel")
    for n in ref:
        assert scaled_err(got[n], ref[n]) < GRAD_TOL, n
    b, s, di = 2, 32, cfg.expand * cfg.d_model
    lines, h = (b, di, 2 * s), (di, 2 * s)
    # forward: fft(x), fft(h), ifft(product); backward: the ifft's adjoint
    # (a forward transform), then the adjoints of fft(x) and fft(h)
    assert calls[:3] == [(lines, False), (h, False), (lines, True)]
    assert sorted(calls[3:]) == sorted([(lines, False), (lines, True),
                                        (h, True)])

    # one layer under remat: the forward is run again in backward
    calls.clear()
    rcfg = dataclasses.replace(configs.smoke_config("jamba_v0_1_52b"),
                               ssm_impl="fft_conv", dtype="float32",
                               n_layers=1, attn_every=8)
    model = tfm.init_model(ParamBuilder(0, device=CPU), rcfg)
    model.requires_grad_(True)
    monkeypatch.setattr(ssm.FFTConv, "forward", _kernel_fft_conv)
    (h_out, w), _, _ = tfm.forward(model, rcfg, None, {
        "tokens": torch.zeros((1, 16), dtype=torch.long)}, remat=True,
        return_hidden=True)
    assert len(calls) == 3
    (h_out @ w).square().sum().backward()
    assert len(calls) == 9


_real_fft_conv_forward = ssm.FFTConv.forward


def _kernel_fft_conv(self, x, **kw):
    kw["fft_backend"] = "kernel"
    return _real_fft_conv_forward(self, x, **kw)


def test_line_transform_gradcheck():
    """``torch.autograd.gradcheck`` of the Function in complex128: forward
    and inverse, lines (last axis) and a strided axis, N = 8 and 12, and a
    real operand."""
    for n in (8, 12):
        x = torch.randn(3, n, dtype=torch.complex128,
                        generator=torch.Generator().manual_seed(n),
                        requires_grad=True)
        assert torch.autograd.gradcheck(lambda t: ops.fft1d(t, -1), (x,))
        assert torch.autograd.gradcheck(lambda t: ops.ifft1d(t, -1), (x,))
        y = torch.randn(n, 4, dtype=torch.complex128,
                        generator=torch.Generator().manual_seed(n + 1),
                        requires_grad=True)
        assert torch.autograd.gradcheck(lambda t: ops.fft1d(t, 0), (y,))
        r = torch.randn(2, n, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(n + 2),
                        requires_grad=True)
        assert torch.autograd.gradcheck(lambda t: ops.ifft1d(t, -1), (r,))
        g = torch.randn(n, 4, dtype=torch.complex128)
        (a,) = torch.autograd.grad(ops.fft1d(y, 0), y, g)
        (b,) = torch.autograd.grad(torch.fft.fft(y, dim=0), y, g)
        assert torch.allclose(a, b, atol=1e-12)


def test_epilogues_raise_under_grad():
    """The twiddle and pack epilogues have no backward: under grad, with an
    operand that requires grad, they raise instead of returning a result
    with no graph; without grad they run."""
    x = torch.randn(4, 16, dtype=torch.complex64, requires_grad=True)
    tw = torch.ones(16, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="twiddle"):
        ops.fft1d(x, -1, twiddle=tw)
    with pytest.raises(NotImplementedError, match="pack_parts"):
        ops.ifft1d(x, -1, pack_parts=2)
    with pytest.raises(NotImplementedError, match="pack_parts"):
        ops.packed_fft1d(x, -1, 2)
    with pytest.raises(NotImplementedError, match="twiddle"):
        ops.fft1d(x.detach(), -1, twiddle=tw.clone().requires_grad_(True))
    with torch.no_grad():
        out = ops.fft1d(x, -1, twiddle=tw)
    assert out.grad_fn is None
    assert torch.allclose(ops.fft1d(x.detach(), -1, twiddle=tw),
                          torch.fft.fft(x.detach()), atol=1e-5)


# ---------------------------------------------------------------------------
# the train step with micro-batches
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("arch", ["qwen3_8b", "olmoe_1b_7b"])
def test_train_step_with_micro_batches_matches_reference(arch, ref_trees,
                                                         cpu_mesh, rules):
    """``make_train_step(accum_steps=2, grad_compress=True)`` against the
    reference's: loss, aux, the AdamW count and every parameter after the
    update.

    The tolerance on a parameter is ``lr * (1e-5 + eps * dg / (|g| +
    eps)**2)`` with ``g = (g1 + g2) / 2`` the reference's float32 gradient
    of that entry over the two micro-batches and ``dg = 2**-8 * (|g1| +
    |g2|)``.  The first AdamW step moves an entry by ``lr * g / (|g| +
    eps)`` (plus the decay term, the same on both sides): where ``|g|``
    is far above ``eps`` that is ``lr * sign(g)``, and the packages agree
    to 1e-5 of ``lr``.  But each micro-batch's gradient is rounded to
    bfloat16 and summed in bfloat16 (half a unit, 2**-9 relative, per
    rounding), and two float32 gradients 1e-6 apart can round to
    neighbouring values; where ``g1`` and ``g2`` nearly cancel, that
    error is large beside ``|g|`` and moves the update by ``lr * eps *
    dg / (|g| + eps)**2`` (``dg`` bounds the roundings with a factor 2 of
    margin).  A wrong gradient's sign or scale still moves an entry by up
    to ``2 lr``."""
    from repro.launch.steps import make_train_step as ref_make_train_step
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = _cfg(arch)
    kw = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    lr = kw["lr_peak"]
    tree = ref_trees(cfg)
    batch = train_batch(cfg, b=4)
    with cpu_mesh:
        ref_p = jax.tree.map(jnp.asarray, tree)
        grad_fn = jax.grad(lambda p, b: ref_loss_fn(cfg, rules)(p, b)[0])
        halves = [grad_fn(ref_p, {k: jnp.asarray(v[i * 2:(i + 1) * 2])
                                  for k, v in batch.items()})
                  for i in range(2)]
        g1, g2 = (flat_tree(to_numpy(h)) for h in halves)
        ref_step = ref_make_train_step(cfg, rules, RefAdamWConfig(**kw),
                                       accum_steps=2)
        ref_new, ref_opt, ref_m = ref_step(
            ref_p, ref_adamw_init(ref_p, RefAdamWConfig(**kw)),
            {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_reference(tree, cfg, device="cpu")
    state = adamw_init(param_leaves(model), AdamWConfig(**kw))
    step = make_train_step(cfg, None, AdamWConfig(**kw), accum_steps=2,
                           device="cpu")
    tb = {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
          else torch.as_tensor(v) for k, v in batch.items()}
    model, state, metrics = step(model, state, tb)
    assert float(metrics["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                   rel=STEP_TOL)
    assert float(metrics["aux_loss"]) == pytest.approx(
        float(ref_m["aux_loss"]), rel=1e-3, abs=1e-6)
    assert int(state["count"]) == int(ref_opt["count"]) == 1
    got = flat_tree(params_to_reference(model))
    want = flat_tree(to_numpy(ref_new))
    eps, start = AdamWConfig().eps, flat_tree(tree)
    moved = 0.0
    for k in want:
        g = np.abs((g1[k] + g2[k]) / 2)
        dg = 2.0 ** -8 * (np.abs(g1[k]) + np.abs(g2[k]))
        bound = lr * (1e-5 + eps * dg / (g + eps) ** 2)
        err = np.abs(got[k] - want[k])
        assert bool(np.all(err <= bound)), (k, float(np.max(err / bound)))
        moved = max(moved, float(np.max(np.abs(want[k] - start[k]))))
    assert moved > 0.5 * lr            # the step did move the parameters


# ---------------------------------------------------------------------------
# train(): the counterparts of tests/test_system.py
# ---------------------------------------------------------------------------

def test_training_loss_decreases():
    from repro_torch.launch.train import train
    out = train("stablelm_1_6b", steps=30, seq_len=16, global_batch=2,
                smoke=True, log_every=100, device="cpu")
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert len(out["losses"]) == 30 and out["final_loss"] == out["losses"][-1]
    assert last < first - 0.1, f"no learning: {first} -> {last}"


def test_checkpoint_restart_matches_uninterrupted(tmp_path):
    """20 steps straight against 10 + a simulated preemption + a resume of
    10: the same losses (one process on the CPU replays them exactly)."""
    from repro_torch.launch.train import train
    kw = dict(steps=20, seq_len=16, global_batch=2, smoke=True,
              ckpt_every=10, log_every=100, device="cpu")
    full = train("stablelm_1_6b", ckpt_dir=str(tmp_path / "a"), **kw)
    first = train("stablelm_1_6b", ckpt_dir=str(tmp_path / "b"),
                  stop_after=10, **kw)
    resumed = train("stablelm_1_6b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(first["losses"]) == 10 and len(resumed["losses"]) == 10
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               full["losses"], rtol=1e-6)
    assert resumed["final_loss"] == pytest.approx(full["final_loss"],
                                                  rel=1e-6)


def test_train_losses_match_reference(monkeypatch, cpu_mesh, rules):
    """With both ``smoke_config``s patched to float32 and both
    ``build_params`` returning the reference's tree (the port's carried
    across), ``train()``'s 5 losses match the reference ``train()``'s
    within 1e-4 relative."""
    import repro.launch.train as ref_train_mod
    import repro_torch.launch.train as train_mod
    arch = "stablelm_1_6b"
    cfg = f32(ref_smoke_config(arch))
    monkeypatch.setattr(ref_train_mod, "smoke_config", lambda a: cfg)
    monkeypatch.setattr(train_mod, "smoke_config", lambda a: cfg)
    from repro.launch.steps import build_params as ref_build_params
    with cpu_mesh:
        tree, _ = ref_build_params(cfg, rules, abstract=False)
    tree = to_numpy(tree)
    monkeypatch.setattr(
        train_mod, "build_params",
        lambda c, seed=0, device=None, mesh=None: params_from_reference(
            tree, c, device=device))
    kw = dict(steps=5, seq_len=16, global_batch=2, smoke=True, log_every=100)
    ref = ref_train_mod.train(arch, mesh=cpu_mesh, **kw)
    got = train_mod.train(arch, device="cpu", **kw)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)


def test_training_entry_points_need_a_card_unless_asked_for_the_cpu(
        tmp_path):
    """``train``, ``make_train_step``, ``SyntheticLM.device_batch`` and
    ``prefetch``, and ``CheckpointManager.restore`` run on CUDA unless the
    caller names a device, and raise naming ``device='cpu'`` without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is taken")
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import train
    from repro_torch.models.config import ShapeConfig
    cfg = configs.smoke_config("qwen3_8b")
    data = SyntheticLM(cfg, ShapeConfig("t", "train", 8, 1))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)})
    for fn in (lambda: train("qwen3_8b", steps=1),
               lambda: make_train_step(cfg),
               lambda: data.device_batch(0),
               lambda: next(data.prefetch(0)),
               lambda: mgr.restore()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
