"""The training knobs against ``vsr_tpu``: the gradient chain
(``grad_accumulation``, ``grad_clip``, ``ema_decay``), quantization-aware
training, the eight optimizers held since this slice, and ``infer --ema`` /
``--gif``.

Four tests, each a group of cases (``tests/_torch_cases.run_cases``; the
count of collected tests matters to the Tier-1 command, ROADMAP queue 3):

- the chain: ``optim.GradientChain`` against the optax chain the JAX trainer
  builds (the EMA recursion, the clip below and above its bound, k = 2 and
  3, the whole chain's order, the learning rate through every wrapper);
  two epochs of a small EDSR and a small DRF (``fused_squeeze``, K1's CPU
  twin) with every knob set against the JAX trainers (logs within 2e-3,
  parameters and EMA within 3e-4), where three steps an epoch with k = 2
  carry an accumulation across the epoch boundary; a resume and a
  preemption in the middle of an accumulation, bit-exact; the device
  trainer run eagerly against JAX's from JAX's draws; the MoE trainer's
  two-epoch log;
- QAT: ``fake_quant``'s forward and gradient (the 0.5 at exactly +-127),
  the fake-quant forward and gradients with dynamic and static scales,
  the set of convs taken under ``min_channels``, ``kernels``,
  ``quantize_deconvs`` and ``fused_squeeze`` on and off, ``resolve_qat``'s
  refusals, two epochs of QAT training, and the interceptor under
  ``Volume4DSRNet``'s ``remat``;
- the optimizers: the eight held against ``vsr_tpu/optim.py``'s chains
  with and without ``weight_decay`` (``tests/test_optim_parity.py``'s
  tolerance), the capturable SGD and Adagrad steps, and the refusal of the
  arguments the JAX functions refuse;
- ``infer --ema`` from a port checkpoint and from a flax checkpoint of the
  JAX trainer against ``vsr_tpu``'s ``build_serving_net(..., ema=True)``,
  its two errors, and ``--gif``'s files against ``vsr_tpu``'s.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import vsr_tpu.infer as jinfer
import vsr_tpu.quantize as jquantize
from tests._torch_cases import run_cases, subdir
from tests._torch_parity import assert_gradients_match, init, randomize
from tests.synth import make_processed_tree
from tests.test_torch_device_trainer import _epoch_draws
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import models as jmodels
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.runner import device_trainer as jdt
from vsr_tpu.runner import trainers as jtrainers
from vsr_tpu_torch import infer, losses, metrics, models, optim, quantize
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import from_jax_tree, kernel_leaves, load_jax_params
from vsr_tpu_torch.io import nifti
from vsr_tpu_torch.models.common import intercept_convs
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.runner import device_trainer as dt
from vsr_tpu_torch.runner import trainers
from vsr_tpu_torch.utils.checkpoint import load_checkpoint

NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
AUG = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
       {"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 2}}]
EDSR_KW = dict(in_channels=1, out_channels=1, num_resblocks=2,
               num_features=8, upscale_factor=2)
TASKS = {
    "edsr": dict(dataset="AcdcSISRDataset", sub="imgs", ds={},
                 trainer="AcdcSISRTrainer", net="EDSRNet", net_kwargs=EDSR_KW),
    "drf": dict(dataset="AcdcVSRDataset", sub="videos",
                ds={"num_frames": 3, "temporal_order": "last"},
                trainer="AcdcVSRTrainer", net="DRFNet",
                net_kwargs=dict(in_channels=1, out_channels=1,
                                num_features=8, num_groups=2,
                                upscale_factor=2, fused_squeeze=True)),
    # Expert-choice MoE; SGD: its step is linear in the gradient.
    "moe": dict(dataset="AcdcSISRDataset", sub="imgs", ds={},
                trainer="AcdcSISRTrainer", net="MoEEDSRNet",
                net_kwargs=dict(EDSR_KW, num_experts=2, group_size=64,
                                moe_every=1),
                jax_kwargs={"router_impl": "rank"},
                port_kwargs={"router_impl": "rank"},
                optimizer=("SGD", {"lr": 0.05, "momentum": 0.9})),
}
# QAT: SGD, whose step is linear in the gradient. Rounding to the int8 grid
# makes a float32 difference of the two frameworks' sums a difference of a
# quantization step where a value sits on a rounding boundary, and Adam
# turns such noise into +-lr steps where a gradient is near 0 (measured:
# 1.6e-3 apart after 6 steps).
TASKS["qat"] = dict(TASKS["edsr"], optimizer=("SGD", {"lr": 0.02,
                                                      "momentum": 0.9}))
# Every knob: 3 train batches an epoch with k = 2 carries a micro-step
# across the epoch boundary; the clip's bound is below the gradients' norm.
KNOBS = dict(grad_accumulation=2, grad_clip=0.05, ema_decay=0.9)
BATCH, EPOCHS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 1 patient x 2 slices x 5 frames of 32 x 32: 10 SISR samples and 10
    # VSR windows a split (3 train batches, the last one partial).
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=32,
                               frames=5, patients_per_type=1, slices=2)


def _dataset(module, task, tree, type_):
    t = TASKS[task]
    return getattr(module, t["dataset"])(
        data_dir=tree / t["sub"], type=type_, downscale_factor=2,
        transforms=NORM, augments=AUG, **t["ds"])


def _monitor(cls, ckpt_dir):
    return cls(checkpoints_dir=ckpt_dir, mode="min", target="Loss",
               saved_freq=1, early_stop=0)


def _jax_run(task, tree, ckpt_dir, epochs=EPOCHS, **knobs):
    """The JAX trainer with ``knobs``: initial variables, per-epoch logs,
    final variables, the EMA tree, and the trainer."""
    t = TASKS[task]
    name, kw = t.get("optimizer", ("Adam", {"lr": 1e-3}))
    jt = getattr(jtrainers, t["trainer"])(
        train_dataloader=JaxDataloader(_dataset(jdatasets, task, tree,
                                                "train"),
                                       batch_size=BATCH, shuffle=True),
        valid_dataloader=JaxDataloader(_dataset(jdatasets, task, tree,
                                                "valid"), batch_size=1),
        net=getattr(jmodels, t["net"])(**t["net_kwargs"],
                                       **t.get("jax_kwargs", {})),
        loss_fns=[jlosses.L1Loss()], loss_weights=[1.0],
        metric_fns=[jmetrics.PSNR(), jmetrics.SSIM()],
        optimizer=getattr(joptim, name)(**kw), lr_scheduler=None,
        logger=None, monitor=_monitor(JaxMonitor, ckpt_dir),
        num_epochs=epochs, prefetch_to_device=False, **knobs)
    # The net's init under jit: eager, it runs op by op.
    kw = {"train": False} if jt._net_train_kwarg else {}
    jt.params = jax.jit(functools.partial(jt.net.init, **kw))(
        jt.rng_tree.jax_key("init"), jt._example_inputs())
    jt.opt_state = jt.tx.init(jt.params["params"])
    jt._ensure_initialized()  # nothing left to do: no mesh, no scheduler
    initial = jax.tree_util.tree_map(np.array, jt.params)
    logs = []
    for epoch in range(1, epochs + 1):
        train_log, _, _ = jt._run_epoch("training", epoch)
        valid_log, _, _ = jt._run_epoch("validation", epoch)
        logs.append({"train": train_log, "valid": valid_log})
    ema = (jax.tree_util.tree_map(np.asarray,
                                  joptim.get_ema_params(jt.opt_state))
           if knobs.get("ema_decay") else None)
    return dict(initial=initial, logs=logs, trainer=jt, ema=ema,
                final=jax.tree_util.tree_map(np.asarray, jt.params))


def _port_trainer(task, tree, saved_dir, weights, epochs=EPOCHS, **knobs):
    t = TASKS[task]
    name, kw = t.get("optimizer", ("Adam", {"lr": 1e-3}))
    net = getattr(models, t["net"])(**t["net_kwargs"],
                                    **t.get("port_kwargs", {}))
    load_jax_params(net, weights)
    return getattr(trainers, t["trainer"])(
        train_dataloader=Dataloader(_dataset(datasets, task, tree, "train"),
                                    batch_size=BATCH, shuffle=True),
        valid_dataloader=Dataloader(_dataset(datasets, task, tree, "valid"),
                                    batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR(), metrics.SSIM()],
        optimizer=getattr(optim, name)(**kw), lr_scheduler=None, logger=None,
        monitor=_monitor(Monitor, saved_dir / "checkpoints"),
        num_epochs=epochs, device="cpu", **knobs)


def _port_logs(trainer, epochs=EPOCHS):
    logs = []
    for epoch in range(1, epochs + 1):
        train_log, _, _ = trainer._run_epoch("training", epoch)
        valid_log, _, _ = trainer._run_epoch("validation", epoch)
        logs.append({"train": train_log, "valid": valid_log})
    return logs


def _hold_logs(got, want, atol=2e-4):
    for g, w in zip(got, want):
        for split in ("train", "valid"):
            assert sorted(g[split]) == sorted(w[split])
            for key, value in w[split].items():
                np.testing.assert_allclose(g[split][key], value, rtol=2e-3,
                                           atol=atol, err_msg=f"{split} {key}")


def _hold_tensors(named, want_tree, net, atol=3e-4):
    """``{name: tensor}`` against a flax tree of ``net``'s (parameters)."""
    want = from_jax_tree(net, want_tree)
    assert sorted(named) == sorted(k for k in want if k in named)
    for name, value in named.items():
        np.testing.assert_allclose(value.detach().numpy(), want[name],
                                   atol=atol, rtol=0, err_msg=name)


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}


# ------------------------------------------------------------------ chain


def _jax_chain(tx, k=1, clip=0.0, decay=None):
    """The JAX trainer's chain construction (trainers.py:135-159)."""
    if decay:
        tx = joptim.with_param_ema(tx, decay)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    return tx


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


def _unit_chain(rng, name, kw, steps, k=1, clip=0.0, decay=None,
                scale=1.0):
    """``steps`` micro-steps of seeded gradients through the port's chain
    and the JAX one; returns ``(port params, port EMA, JAX params, JAX
    EMA, JAX opt_state, port chain)``."""
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{n: (scale * rng.standard_normal(v.shape)).astype(np.float32)
              for n, v in params.items()} for _ in range(steps)]
    tx = _jax_chain(getattr(joptim, name)(**kw), k, clip, decay)
    p = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(p)
    update = jax.jit(tx.update)
    for g in grads:
        u, state = update({n: jnp.asarray(v) for n, v in g.items()}, state, p)
        p = optax.apply_updates(p, u)
    module = _Params(params)
    chain = optim.GradientChain(getattr(optim, name)(**kw).bind(
        module.parameters()), module, k, clip, decay)
    for g in grads:
        for n, v in g.items():
            getattr(module, n).grad = torch.from_numpy(v.copy())
        chain.step()
    got = {n: getattr(module, n).detach().numpy() for n in params}
    got_ema = ({n: e.numpy() for n, e in chain.ema_state().items()}
               if decay else None)
    want_ema = (jax.tree_util.tree_map(np.asarray,
                                       joptim.get_ema_params(state))
                if decay else None)
    return got, got_ema, {n: np.asarray(v) for n, v in p.items()}, \
        want_ema, state, chain


def _close(got, want, **tol):
    tol = tol or dict(rtol=1e-5, atol=1e-6)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **tol)


def _case_ema_recursion(rng):
    got, got_ema, want, want_ema, _, chain = _unit_chain(
        rng, "SGD", {"lr": 0.1}, 5, decay=0.8)
    _close(got, want)
    _close(got_ema, want_ema)
    assert not np.allclose(got_ema["w"], got["w"], atol=1e-3)
    with pytest.raises(ValueError, match=r"ema decay must be in \(0, 1\)"):
        optim.GradientChain(chain.optimizer, _Params({}), ema_decay=1.0)


def _case_clip_below_and_above_max_norm(rng):
    # SGD with lr 1: each step moves the parameters by minus the clipped
    # gradient; gradients of norm ~4 against bounds of 100 and 0.5.
    for clip in (100.0, 0.5):
        got, _, want, _, _, _ = _unit_chain(rng, "SGD", {"lr": 1.0}, 3,
                                            clip=clip)
        _close(got, want)
    g = {"a": np.full(4, 3.0, np.float32), "b": np.full(3, 4.0, np.float32)}
    want, _ = optax.clip_by_global_norm(2.0).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None)
    module = _Params({k: np.zeros_like(v) for k, v in g.items()})
    chain = optim.GradientChain(optim.SGD(lr=1.0).bind(module.parameters()),
                                module, grad_clip=2.0)
    for k, v in g.items():
        getattr(module, k).grad = torch.from_numpy(v.copy())
    chain.step()
    for k in g:  # not torch's clip_grad_norm_: no 1e-6 in the coefficient
        np.testing.assert_array_equal(-getattr(module, k).detach().numpy(),
                                      np.asarray(want[k]))


def _case_accumulation_k2_and_k3(rng):
    for k, steps in ((2, 5), (3, 7)):  # 5 and 7: a partial accumulation left
        got, _, want, _, state, chain = _unit_chain(
            rng, "Adam", {"lr": 1e-2}, steps, k=k)
        _close(got, want)
        assert chain.mini_step == int(state.mini_step) == steps % k
        np.testing.assert_allclose(
            dict(zip(chain.names, chain.acc))["b"].numpy(),
            np.asarray(state.acc_grads["b"]), rtol=1e-6, atol=1e-7)


def _case_the_whole_chain_in_the_jax_order(rng):
    got, got_ema, want, want_ema, _, _ = _unit_chain(
        rng, "Adam", {"lr": 1e-2, "weight_decay": 0.1}, 7, k=2, clip=0.3,
        decay=0.9, scale=2.0)
    _close(got, want)
    _close(got_ema, want_ema)


def _case_learning_rate_through_every_wrapper(rng):
    _, _, _, _, state, chain = _unit_chain(rng, "Adam", {"lr": 3e-3}, 2,
                                           k=2, clip=1.0, decay=0.9)
    assert optim.get_learning_rate(chain) == pytest.approx(
        joptim.get_learning_rate(state))
    optim.set_learning_rate(chain, 1e-4)
    joptim.set_learning_rate(state, 1e-4)
    assert optim.get_learning_rate(chain) == pytest.approx(
        joptim.get_learning_rate(state)) == pytest.approx(1e-4)
    assert chain.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)


def _case_two_epochs_with_every_knob_match_jax(tree, tmp_path):
    for task in ("edsr", "drf"):
        want = _jax_run(task, tree, subdir(tmp_path, f"jax_{task}"), **KNOBS)
        pt = _port_trainer(task, tree, subdir(tmp_path, task),
                           want["initial"], **KNOBS)
        _hold_logs(_port_logs(pt), want["logs"])
        net = pt.net
        _hold_tensors(dict(net.named_parameters()), want["final"], net)
        _hold_tensors(pt.chain.ema_state(), {"params": want["ema"]}, net)
        moved = from_jax_tree(net, want["initial"])
        assert sum(np.abs(want_v - moved[k]).max() > 1e-3 for k, want_v in
                   from_jax_tree(net, want["final"]).items()) > 3
        assert pt.chain.mini_step == 0  # 6 micro-steps, 3 updates


def _case_resume_and_preemption_mid_accumulation(tree, tmp_path):
    weights = init(jmodels.EDSRNet(**EDSR_KW), np.zeros((1, 8, 8, 1),
                                                        np.float32))
    straight = _port_trainer("edsr", tree, subdir(tmp_path, "straight"),
                             weights, **KNOBS)
    straight.train()
    # Epoch 1 ends after 3 micro-steps: its checkpoint holds one gradient.
    state, _ = load_checkpoint(tmp_path / "straight" / "checkpoints" /
                               "model_1.ckpt")
    assert state["chain"]["mini_step"] == 1
    assert sorted(state["chain"]["ema"]) == sorted(
        n for n, _ in straight.net.named_parameters())
    resumed = _port_trainer("edsr", tree, subdir(tmp_path, "resumed"),
                            weights, **KNOBS)
    resumed.load(tmp_path / "straight" / "checkpoints" / "model_1.ckpt")
    assert resumed.chain.mini_step == 1
    resumed.train()
    a, b = _state(resumed), _state(straight)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(resumed.chain.ema,
                                                 straight.chain.ema))
    # Preempted after the first micro-step of epoch 2 (mid-accumulation).
    cut = _port_trainer("edsr", tree, subdir(tmp_path, "cut"), weights,
                        **KNOBS)
    step = cut._train_step
    calls = []

    def stop_at_the_fourth(*args):
        calls.append(1)
        out = step(*args)
        cut._preempted = len(calls) == 4
        return out

    cut._train_step = stop_at_the_fourth
    cut.train()
    again = _port_trainer("edsr", tree, subdir(tmp_path, "again"), weights,
                          **KNOBS)
    again.load(tmp_path / "cut" / "checkpoints" / "model_preempt.ckpt")
    assert again.chain.mini_step == 0 and again._mid_epoch_resume
    again.train()
    a = _state(again)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # A checkpoint of another chain is refused.
    with pytest.raises(ValueError, match="gradient chain"):
        _port_trainer("edsr", tree, subdir(tmp_path, "other"), weights).load(
            tmp_path / "straight" / "checkpoints" / "model_1.ckpt")


def _case_device_trainer_eager_matches_jax(tree, tmp_path):
    kw = dict(in_channels=1, out_channels=1, num_resblocks=1, num_features=8,
              upscale_factor=2, fused_tail=True)
    knobs = dict(KNOBS, qat={"min_channels": 8})
    steps, batch, patch = 5, 2, 4

    def loaders(module):
        ds = [module.AcdcSISRDataset(data_dir=tree / "imgs", type=t,
                                     downscale_factor=2, transforms=NORM,
                                     augments=AUG[:2]) for t in
              ("train", "valid")]
        cls = JaxDataloader if module is jdatasets else Dataloader
        return dict(train_dataloader=cls(ds[0], batch_size=batch,
                                         shuffle=True),
                    valid_dataloader=cls(ds[1], batch_size=1))

    common = dict(loss_weights=[1.0], lr_scheduler=None, logger=None,
                  num_epochs=1, patch=patch, ratio=2, steps_per_epoch=steps,
                  **knobs)
    jt = jdt.AcdcSISRDeviceTrainer(
        net=jmodels.EDSRNet(**kw), loss_fns=[jlosses.L1Loss()],
        metric_fns=[jmetrics.PSNR()], optimizer=joptim.Adam(lr=1e-3),
        monitor=_monitor(JaxMonitor, subdir(tmp_path, "jdev")),
        prefetch_to_device=False, **loaders(jdatasets), **common)
    jt.params = randomize(init(jt.net, np.zeros(jt._example_inputs().shape,
                                                np.float32)),
                          np.random.default_rng(0))
    jt.opt_state = jt.tx.init(jt.params["params"])
    initial = jax.tree_util.tree_map(np.array, jt.params)
    jt._run_epoch("training", 1)
    net = models.EDSRNet(**kw)
    load_jax_params(net, initial)
    pt = get_class("trainer", "AcdcSISRDeviceTrainer")(
        net=net, loss_fns=[losses.L1Loss()], metric_fns=[metrics.PSNR()],
        optimizer=optim.Adam(lr=1e-3),
        monitor=_monitor(Monitor, subdir(tmp_path, "pdev")), device="cpu",
        **loaders(datasets), **common)
    pt._ensure_buffers()
    h, w = jt.lr_buf.shape[-3], jt.lr_buf.shape[-2]
    draws = _epoch_draws(jt.rng_tree.jax_key("device-epoch", 1), steps,
                         m=jt.m, batch=batch, h=h, w=w, patch=patch)
    pt.epoch_draws = lambda epoch: draws
    pt._run_epoch("training", 1)
    _hold_tensors(dict(net.named_parameters()),
                  jax.tree_util.tree_map(np.asarray, jt.params), net)
    _hold_tensors(pt.chain.ema_state(), {"params": jax.tree_util.tree_map(
        np.asarray, joptim.get_ema_params(jt.opt_state))}, net)
    assert pt.chain.mini_step == int(jt.opt_state.mini_step) == 1


def _case_moe_trainer_two_epoch_log(tree, tmp_path):
    want = _jax_run("moe", tree, subdir(tmp_path, "jax_moe"))
    pt = _port_trainer("moe", tree, subdir(tmp_path, "moe"), want["initial"])
    _hold_logs(_port_logs(pt), want["logs"])
    _hold_tensors(dict(pt.net.named_parameters()), want["final"], pt.net)


def test_gradient_chain_and_trainers_match_jax(tree, tmp_path, rng):
    run_cases([
        ("ema recursion", lambda: _case_ema_recursion(rng)),
        ("clip below and above max_norm",
         lambda: _case_clip_below_and_above_max_norm(rng)),
        ("accumulation k = 2 and 3",
         lambda: _case_accumulation_k2_and_k3(rng)),
        ("the whole chain",
         lambda: _case_the_whole_chain_in_the_jax_order(rng)),
        ("learning rate through the wrappers",
         lambda: _case_learning_rate_through_every_wrapper(rng)),
        ("two epochs, EDSR and DRF",
         lambda: _case_two_epochs_with_every_knob_match_jax(
             tree, subdir(tmp_path, "two"))),
        ("resume and preemption mid-accumulation",
         lambda: _case_resume_and_preemption_mid_accumulation(
             tree, subdir(tmp_path, "resume"))),
        ("device trainer, eager",
         lambda: _case_device_trainer_eager_matches_jax(
             tree, subdir(tmp_path, "device"))),
        ("MoE two-epoch log",
         lambda: _case_moe_trainer_two_epoch_log(
             tree, subdir(tmp_path, "moe"))),
    ])


# -------------------------------------------------------------------- QAT


def _case_fake_quant_forward_and_gradient():
    # 3.7 is the amax: 3.7 / (3.7 / 127) lands on exactly 127.
    x = np.array([3.7, -3.7, 1.0, -2.2, 0.0145, 9.0, -9.0],
                 np.float32)
    for scale in (np.float32(3.7) / np.float32(127.0),
                  np.float32(9.0) / np.float32(127.0), np.float32(0.02)):
        cot = np.linspace(0.3, 1.5, x.size).astype(np.float32)
        want, vjp = jax.vjp(lambda v: jquantize.fake_quant(v, scale),
                            jnp.asarray(x))
        t = torch.from_numpy(x.copy()).requires_grad_()
        got = quantize.fake_quant(t, torch.tensor(scale))
        got.backward(torch.from_numpy(cot))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(t.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(cot))[0]))
    t = torch.from_numpy(x.copy()).requires_grad_()
    scale = torch.tensor(np.float32(3.7) / 127)
    quantize.fake_quant(t, scale).sum().backward()
    assert t.grad[0] == t.grad[1] == 0.5 and t.grad[5] == 0.0
    # Dynamic scales as the jitted JAX step computes them, on a real
    # activation and a weight (whose channel maxima land on +-127, or just
    # past it, where XLA's reciprocal of 127 puts them).
    act = np.random.default_rng(1).standard_normal((2, 8, 5, 5)).astype(
        np.float32)

    def jax_dynamic(v, axes):
        amax = jax.lax.stop_gradient(jnp.max(jnp.abs(v), axis=axes,
                                             keepdims=True))
        return jquantize.fake_quant(v, jnp.where(
            amax > 0, jnp.maximum(amax, 1e-8) / 127.0, 1.0))

    for axes, scale_of in (
            (None, lambda t: torch.clamp_min(t.detach().abs().amax(), 1e-8)
             * quantize._INV_127),
            ((1, 2, 3), lambda t: quantize.channel_scale(t, 0, jitted=True))):
        want, vjp = jax.vjp(jax.jit(functools.partial(jax_dynamic,
                                                      axes=axes)),
                            jnp.asarray(act))
        t = torch.from_numpy(act.copy()).requires_grad_()
        got = quantize.fake_quant(t, scale_of(t))
        got.backward(torch.ones_like(got))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            t.grad.numpy(), np.asarray(vjp(jnp.ones_like(want))[0]))
        assert set(np.unique(t.grad.numpy())) <= {0.0, 0.5, 1.0}


def _edsr_pair(rng, features=16, seed=0):
    kw = dict(EDSR_KW, num_features=features)
    x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    jnet = jmodels.EDSRNet(**kw)
    variables = randomize(init(jnet, x, seed=seed), rng)
    net = models.EDSRNet(**kw)
    load_jax_params(net, variables)
    return jnet, net, variables, x


def _case_fake_quant_forward_and_gradients_dynamic_and_static(rng):
    jnet, net, variables, x = _edsr_pair(rng)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    static = quantize.calibrate_w8a8(net, [xt])
    assert len(static) == 6  # the 16 -> 16 convs and the up-sampler's
    target = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    for scales in ("dynamic", static):
        def loss(params):
            interceptor = jquantize.make_qat_interceptor(scales)
            import flax.linen as nn
            with nn.intercept_methods(interceptor):
                out = jnet.apply({**variables, "params": params},
                                 jnp.asarray(x))
            return jnp.mean(jnp.abs(out - target)), out

        (want_loss, want), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
        net.zero_grad()
        out = quantize.make_fake_quant_apply(net, act_scales=scales)(xt)
        got_loss = torch.mean(torch.abs(
            out - torch.from_numpy(np.moveaxis(target, -1, 1).copy())))
        got_loss.backward()
        np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)
        assert_gradients_match(net, got_loss.item(), float(want_loss),
                               grads)
        with torch.no_grad():
            plain = net(xt)
        assert (plain - out.detach()).abs().max() > 1e-4


def _jax_taken(monkeypatch, jnet, variables, x, qat):
    taken = []
    body = jquantize._fake_quant_conv

    def record(mod, xin, scale):
        taken.append("/".join(mod.path))
        return body(mod, xin, scale)

    monkeypatch.setattr(jquantize, "_fake_quant_conv", record)
    import flax.linen as nn
    with nn.intercept_methods(jquantize.resolve_qat(qat)):
        jnet.apply(variables, jnp.asarray(x))
    monkeypatch.setattr(jquantize, "_fake_quant_conv", body)
    return taken


def _port_taken(monkeypatch, net, xt, qat):
    taken = []
    paths = {id(leaf.module): leaf.path for leaf in kernel_leaves(net)}
    body = quantize.fake_quant_conv

    def record(mod, xin, scale, out_axis):
        taken.append(paths[id(mod)])
        return body(mod, xin, scale, out_axis)

    monkeypatch.setattr(quantize, "fake_quant_conv", record)
    with torch.no_grad(), intercept_convs(quantize.resolve_qat(qat, net)):
        net(xt)
    monkeypatch.setattr(quantize, "fake_quant_conv", body)
    return taken


def _case_the_convs_taken_match_jax(monkeypatch, rng):
    x = rng.standard_normal((1, 2, 6, 6, 1)).astype(np.float32)
    xt = torch.from_numpy(np.moveaxis(x, -1, 2).copy())
    options = [True, {"min_channels": 8}, {"min_channels": 8, "kernels": [1]},
               {"min_channels": 8, "kernels": [3, 6]},
               {"min_channels": 8, "quantize_deconvs": True}]
    sets = {}
    for fused in (True, False):
        kw = dict(in_channels=1, out_channels=1, num_features=8,
                  num_groups=2, upscale_factor=2, fused_squeeze=fused)
        jnet = jmodels.DRFNet(**kw)
        variables = randomize(init(jnet, x), rng)
        net = models.DRFNet(**kw)
        load_jax_params(net, variables)
        sets[fused] = []
        for qat in options:
            want = _jax_taken(monkeypatch, jnet, variables, x, qat)
            got = _port_taken(monkeypatch, net, xt, qat)
            assert sorted(got) == sorted(want), (fused, qat)
            sets[fused].append(set(got))
        assert not sets[fused][0] and sets[fused][1]
        assert sets[fused][4] > sets[fused][1]  # the deconvs join
    # K1's squeeze is no nn.Conv: with fused_squeeze on the squeezes stay
    # full precision; off, they are 1x1 convs like any other.
    assert len(sets[False][2]) > len(sets[True][2])


def _case_resolve_qat_refusals(tmp_path):
    net = models.EDSRNet(**EDSR_KW)
    with pytest.raises(ValueError, match="unknown qat option.*bogus"):
        quantize.resolve_qat({"bogus": 1}, net)
    with pytest.raises(ValueError, match="unknown qat option"):
        jquantize.resolve_qat({"bogus": 1})
    path = tmp_path / "scales.json"
    path.write_text(json.dumps({"ResBlock_0/Conv_0/Conv_0": 0.02}))
    quantize.resolve_qat({"act_scales": str(path)}, net)
    with pytest.raises(NotImplementedError, match="'pipe'"):
        trainers.BaseTrainer(None, None, net, [], [], [], optim.Adam(), None,
                             None, None, 1, device="cpu", qat=True,
                             mesh_axes={"pipe": 2})


def _case_two_epochs_of_qat_match_jax(tree, tmp_path):
    qat = {"min_channels": 8}
    want = _jax_run("qat", tree, subdir(tmp_path, "jax"), qat=qat)
    pt = _port_trainer("qat", tree, subdir(tmp_path, "port"),
                       want["initial"], qat=qat)
    _hold_logs(_port_logs(pt), want["logs"])
    _hold_tensors(dict(pt.net.named_parameters()), want["final"], pt.net)
    moved = from_jax_tree(pt.net, want["initial"])
    assert max(np.abs(v - moved[k]).max() for k, v in
               from_jax_tree(pt.net, want["final"]).items()) > 1e-3
    plain = _jax_run("qat", tree, subdir(tmp_path, "plain"), epochs=1)
    assert abs(plain["logs"][0]["train"]["Loss"]
               - want["logs"][0]["train"]["Loss"]) > 1e-6


def _case_interceptor_under_vol4d_remat(rng):
    kw = dict(in_channels=1, out_channels=1, num_features=8,
              num_resblocks=1, upscale_factor=2)
    x = torch.from_numpy(rng.standard_normal((1, 2, 1, 3, 6, 6)).astype(
        np.float32))
    grads = {}
    for remat in (False, True):
        net = models.Volume4DSRNet(**kw, remat=remat,
                                   generator=torch.Generator().manual_seed(2))
        interceptor = quantize.resolve_qat({"min_channels": 8}, net)
        calls = []

        def counted(mod, xin, plain, interceptor=interceptor):
            calls.append(1)
            return interceptor(mod, xin, plain)

        with intercept_convs(counted):
            out = net(x)
        out.abs().mean().backward()  # outside the block: the recompute
        grads[remat] = [p.grad.clone() for p in net.parameters()]
        # The recompute runs the step's convs again, intercepted.
        assert len(calls) > 0
        if remat:
            assert len(calls) > calls_plain
        calls_plain = len(calls)
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    net = models.Volume4DSRNet(
        **kw, generator=torch.Generator().manual_seed(2))
    net(x).abs().mean().backward()
    assert any((p.grad - g).abs().max() > 1e-6
               for p, g in zip(net.parameters(), grads[True]))


def test_qat_matches_jax(tree, tmp_path, rng, monkeypatch):
    run_cases([
        ("fake_quant forward and gradient",
         _case_fake_quant_forward_and_gradient),
        ("dynamic and static scales",
         lambda: _case_fake_quant_forward_and_gradients_dynamic_and_static(
             rng)),
        ("the convs taken", lambda: _case_the_convs_taken_match_jax(
            monkeypatch, rng)),
        ("resolve_qat refusals",
         lambda: _case_resolve_qat_refusals(subdir(tmp_path, "resolve"))),
        ("two epochs of QAT", lambda: _case_two_epochs_of_qat_match_jax(
            tree, subdir(tmp_path, "qat"))),
        ("remat", lambda: _case_interceptor_under_vol4d_remat(rng)),
    ])


# ------------------------------------------------------------- optimizers

EIGHT = [
    ("RMSprop", {"lr": 1e-2}), ("RMSprop", {"lr": 1e-2, "momentum": 0.9}),
    ("Adagrad", {"lr": 0.1}), ("Adadelta", {"lr": 1.0}),
    ("Adamax", {"lr": 2e-3}), ("NAdam", {"lr": 2e-3}),
    ("RAdam", {"lr": 1e-3}),
    ("ASGD", {"lr": 0.5, "lambd": 1e-2, "alpha": 0.6, "t0": 2}),
    ("Rprop", {"lr": 0.1, "etas": [0.4, 1.5], "step_sizes": [1e-4, 0.5]}),
]


def _run_jax_optimizer(name, kw, w0, grads):
    tx = getattr(joptim, name)(**kw)
    w = jnp.asarray(w0)
    state = tx.init(w)
    for g in grads:
        u, state = tx.update(jnp.asarray(g), state, w)
        w = w + u
    return np.asarray(w)


def _run_port_optimizer(opt, p, grads):
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    return p.detach().numpy()


def _case_the_eight_match_jax(rng):
    w0 = rng.standard_normal(32).astype(np.float32)
    grads = [rng.standard_normal(32).astype(np.float32) for _ in range(5)]
    for name, kw in EIGHT:
        decays = (0.0,) if name == "Rprop" else (0.0, 0.05)
        for wd in decays:
            kw_wd = dict(kw, weight_decay=wd) if wd else dict(kw)
            want = _run_jax_optimizer(name, kw_wd, w0, grads)
            p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
            got = _run_port_optimizer(getattr(optim, name)(**kw_wd).bind([p]),
                                      p, grads)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {kw_wd}")
            assert np.abs(got - w0).max() > 1e-4


def _case_capturable_sgd_and_adagrad(rng):
    w0 = rng.standard_normal(32).astype(np.float32)
    grads = [rng.standard_normal(32).astype(np.float32) for _ in range(5)]
    for name, kw in (("SGD", {"lr": 0.1}),
                     ("SGD", {"lr": 0.1, "momentum": 0.9}),
                     ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True,
                              "weight_decay": 0.01}),
                     ("Adagrad", {"lr": 0.1}),
                     ("Adagrad", {"lr": 0.1, "weight_decay": 0.05,
                                  "initial_accumulator_value": 0.1})):
        want = _run_jax_optimizer(name, kw, w0, grads)
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = dt.make_capturable(getattr(optim, name)(**kw).bind([p]),
                                 torch.device("cpu"))
        assert type(opt) is optim.CAPTURABLE[getattr(torch.optim, name)]
        assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
        got = _run_port_optimizer(opt, p, grads)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {kw}")
        # Its state dict is torch.optim's: the host-loop optimizer takes it.
        host = getattr(optim, name)(**kw).bind(
            [torch.nn.Parameter(torch.from_numpy(w0.copy()))])
        host.load_state_dict(dt.host_optimizer_state(opt.state_dict()))
    with pytest.raises(NotImplementedError, match="capturable"):
        dt.make_capturable(torch.optim.LBFGS([p]), torch.device("cpu"))


def _case_arguments_jax_refuses_are_refused():
    for name, kw in (("Adam", {"maximize": True}), ("Adam", {"foreach": True}),
                     ("SGD", {"dampening": 0.1}),
                     ("Adagrad", {"lr_decay": 0.1}),
                     ("Rprop", {"weight_decay": 0.1}),
                     ("NAdam", {"decoupled_weight_decay": True}),
                     ("AdamW", {"fused": True})):
        with pytest.raises(TypeError):
            getattr(joptim, name)(**kw)
        with pytest.raises(TypeError, match=list(kw)[0]):
            getattr(optim, name)(**kw)
    with pytest.raises(TypeError, match="amsgrad"):
        optim.Adam(amsgrad=True)
    optim.Adam(amsgrad=False).bind([torch.nn.Parameter(torch.zeros(1))])


def test_optimizers_match_jax(rng):
    run_cases([
        ("the eight against JAX", lambda: _case_the_eight_match_jax(rng)),
        ("capturable SGD and Adagrad",
         lambda: _case_capturable_sgd_and_adagrad(rng)),
        ("refused arguments", _case_arguments_jax_refuses_are_refused),
    ])


# ------------------------------------------------------- infer --ema, --gif


def _raw_tree(root, rng, side=24, d=2, t=3):
    vol = rng.integers(0, 1200, (side, side, d, t)).astype(np.int16)
    nifti.save_nifti(vol, root / "p" / "p_4d.nii.gz")
    return root


def _case_flax_ema_checkpoint_serves_like_jax(tree, tmp_path, rng):
    """A checkpoint of the JAX trainer with every knob (MultiSteps over the
    clip's chain over the EMA): the port's ``build_serving_net(ema=True)``
    against ``vsr_tpu``'s."""
    run = _jax_run("edsr", tree, subdir(tmp_path, "jax"), epochs=1, **KNOBS)
    ckpt = tmp_path / "model_1.ckpt"
    run["trainer"].save(ckpt)
    x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    for ema in (True, False):
        jnet, params, _ = jinfer.build_serving_net(
            "EDSRNet", EDSR_KW, str(ckpt), lr_hw=(8, 8), ema=ema)
        want = jnet.apply(params, jnp.asarray(x))
        net = infer.build_serving_net("EDSRNet", EDSR_KW, str(ckpt),
                                      device="cpu", ema=ema)
        with torch.no_grad():
            got = net(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
        np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    _hold_tensors(dict(net.named_parameters()), run["final"], net, atol=0)
    ema_net = infer.build_serving_net("EDSRNet", EDSR_KW, str(ckpt),
                                      device="cpu", ema=True)
    _hold_tensors(dict(ema_net.named_parameters()), {"params": run["ema"]},
                  ema_net, atol=0)


def _case_port_ema_checkpoint_serves_its_ema(tree, tmp_path, rng):
    weights = init(jmodels.EDSRNet(**EDSR_KW), np.zeros((1, 8, 8, 1),
                                                        np.float32))
    pt = _port_trainer("edsr", tree, subdir(tmp_path, "port"), weights,
                       epochs=1, ema_decay=0.5, grad_clip=1.0)
    pt.train()
    ckpt = tmp_path / "port" / "checkpoints" / "model_1.ckpt"
    net = infer.build_serving_net("EDSRNet", EDSR_KW, str(ckpt),
                                  device="cpu", ema=True)
    by_hand = models.EDSRNet(**EDSR_KW)
    by_hand.load_state_dict({**pt.net.state_dict(), **pt.chain.ema_state()})
    x = torch.randn(2, 1, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(net(x), by_hand.eval()(x))
        assert not torch.equal(net(x), pt.net.eval()(x))


def _case_ema_errors(tree, tmp_path, rng):
    weights = init(jmodels.EDSRNet(**EDSR_KW), np.zeros((1, 8, 8, 1),
                                                        np.float32))
    pt = _port_trainer("edsr", tree, subdir(tmp_path, "plain"), weights,
                       epochs=1)
    pt.train()
    ckpt = tmp_path / "plain" / "checkpoints" / "model_1.ckpt"
    jrun = _jax_run("edsr", tree, subdir(tmp_path, "jax"), epochs=1)
    jckpt = tmp_path / "jax.ckpt"
    jrun["trainer"].save(jckpt)
    for path in (ckpt, jckpt):
        with pytest.raises(ValueError,
                           match="carries no EMA params — train with "
                                 "trainer.kwargs.ema_decay"):
            infer.build_serving_net("EDSRNet", EDSR_KW, str(path),
                                    device="cpu", ema=True)
    with pytest.raises(ValueError, match="carries no EMA params"):
        jinfer.build_serving_net("EDSRNet", EDSR_KW, str(jckpt), lr_hw=(8, 8),
                                 ema=True)
    with pytest.raises(ValueError, match="--ema needs --checkpoint"):
        infer.build_serving_net("EDSRNet", EDSR_KW, device="cpu", ema=True)
    raw = _raw_tree(subdir(tmp_path, "raw"), rng)
    with pytest.raises(SystemExit, match="--ema needs --checkpoint"):
        infer.main([str(raw), str(tmp_path / "o"), "--device", "cpu",
                    "--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW),
                    "--ema"])


def _case_gif_files_match_jax(tmp_path, rng, monkeypatch):
    raw = _raw_tree(subdir(tmp_path, "raw"), rng)
    args = [str(raw), None, "--net", "Bicubic", "--net-kwargs",
            json.dumps({"upscale_factor": 2}), "--gif"]
    infer.main([args[0], str(tmp_path / "port"), *args[2:], "--device",
                "cpu"])
    monkeypatch.setattr("sys.argv", ["infer", args[0], str(tmp_path / "jax"),
                                     *args[2:]])
    jinfer.main()
    names = sorted(p.name for p in (tmp_path / "port" / "p").glob("*.gif"))
    assert names == sorted(p.name for p in
                           (tmp_path / "jax" / "p").glob("*.gif")) == [
        "p_4d_slice01.gif", "p_4d_slice02.gif"]
    sr = nifti.load_nifti(tmp_path / "port" / "p" / "p_4d_sr.nii.gz")
    for di, name in enumerate(names):
        frames = []
        with Image.open(tmp_path / "port" / "p" / name) as im:
            for ti in range(im.n_frames):
                im.seek(ti)
                frames.append(np.asarray(im.convert("L")))
        with Image.open(tmp_path / "jax" / "p" / name) as im:
            want = []
            for ti in range(im.n_frames):
                im.seek(ti)
                want.append(np.asarray(im.convert("L")))
        assert len(frames) == len(want) == 3
        for ti, (got, jf) in enumerate(zip(frames, want)):
            np.testing.assert_array_equal(got, sr[:, :, di, ti].astype(
                np.uint8))
            assert np.abs(got.astype(int) - jf.astype(int)).max() <= 1


def test_infer_ema_and_gif_match_jax(tree, tmp_path, rng, monkeypatch):
    run_cases([
        ("a flax EMA checkpoint",
         lambda: _case_flax_ema_checkpoint_serves_like_jax(
             tree, subdir(tmp_path, "flax"), rng)),
        ("a port EMA checkpoint",
         lambda: _case_port_ema_checkpoint_serves_its_ema(
             tree, subdir(tmp_path, "port"), rng)),
        ("the errors", lambda: _case_ema_errors(tree, subdir(tmp_path, "err"),
                                                rng)),
        ("--gif", lambda: _case_gif_files_match_jax(subdir(tmp_path, "gif"),
                                                    rng, monkeypatch)),
    ])
