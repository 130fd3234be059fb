"""The MISR and FRVSR training paths as a whole: ``AcdcMISRTrainer`` / DUFNet
and ``AcdcFRVSRTrainer`` / FRVSRNet (x4, ``FlowLoss`` + ``MSELoss``) against
``vsr_tpu``'s trainers on the same synthetic tree, seed and initial weights
(two epochs: every logged scalar within 2e-3, every final parameter within
3e-4, the BatchNorm running statistics with them); resume with the running
statistics; the loggers; and ``vsr_tpu_torch.main`` building and training
each of the seven MISR / FRVSR configs from its YAML."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from tests.synth import make_processed_tree
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import models as jmodels
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.runner import trainers as jtrainers
from vsr_tpu_torch import losses, metrics, models, optim
from vsr_tpu_torch import main as port_main
from vsr_tpu_torch.callbacks.logger import MISRLogger, VSRLogger
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.config import load_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.runner import trainers

TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]


def _augments(size, ratio):
    return [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
            {"name": "RandomCropPatch", "kwargs": {"size": [size, size],
                                                   "ratio": ratio}}]


TASKS = {
    "misr": dict(dataset="AcdcMISRDataset", factor=2, crop=6,
                 ds_kwargs={"num_frames": 7, "temporal_order": "middle"},
                 trainer="AcdcMISRTrainer", net="DUFNet", logger=MISRLogger,
                 losses=[("HuberLoss", {"delta": 0.01})],
                 # A BatchNorm follows every conv of DUF's dense blocks, so
                 # their biases (and some weights) have a gradient of 0 up
                 # to float32 noise. Adam's normalized step turns that noise
                 # into +-lr a step, and the two frameworks' noise differs:
                 # their parameters drifted apart by up to 3.6e-3 in 6 steps
                 # (measured; eps = 1e-6 or 1e-5 does not cure it). SGD's
                 # step is linear in the gradient: they agree to 1e-7.
                 optimizer=("SGD", {"lr": 10.0, "momentum": 0.9}),
                 net_kwargs=dict(in_channels=1, out_channels=1, num_frames=7,
                                 size_filter=3, upscale_factor=2)),
    "frvsr": dict(dataset="AcdcVSRDataset", factor=4, crop=4,
                  ds_kwargs={"num_frames": 3, "temporal_order": "last"},
                  trainer="AcdcFRVSRTrainer", net="FRVSRNet",
                  logger=VSRLogger,
                  losses=[("FlowLoss", {}), ("MSELoss", {})],
                  # eps 1e-5: the weights at FNet's 1 x 1 bottleneck have
                  # gradients near the float32 noise, which eps = 1e-8
                  # turns into +-lr steps (5e-4 apart after 6 steps).
                  optimizer=("Adam", {"lr": 1e-3, "eps": 1e-5}),
                  net_kwargs=dict(in_channels=1, out_channels=1,
                                  upscale_factor=4, num_resblocks=1)),
}
BATCH, EPOCHS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 1 patient x 2 slices x 6 frames of 16 x 16 (LR x2 and x4; DUF's
    # 7-frame windows wrap once): 12 train windows (3 batches), 12 MISR
    # validation windows, 2 validation sequences.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=16,
                               frames=6, patients_per_type=1, slices=2,
                               factors=(2, 4))


def _dataset(module, task, tree, type_):
    t = TASKS[task]
    return getattr(module, t["dataset"])(
        data_dir=tree / "videos", type=type_, downscale_factor=t["factor"],
        transforms=TRANSFORMS, augments=_augments(t["crop"], t["factor"]),
        **t["ds_kwargs"])


def _jax_trainer(task, tree, ckpt_dir):
    t = TASKS[task]
    return getattr(jtrainers, t["trainer"])(
        train_dataloader=JaxDataloader(_dataset(jdatasets, task, tree, "train"),
                                       batch_size=BATCH, shuffle=True),
        valid_dataloader=JaxDataloader(_dataset(jdatasets, task, tree, "valid"),
                                       batch_size=1),
        net=getattr(jmodels, t["net"])(**t["net_kwargs"]),
        loss_fns=[getattr(jlosses, n)(**kw) for n, kw in t["losses"]],
        loss_weights=[1.0] * len(t["losses"]),
        metric_fns=[jmetrics.PSNR(), jmetrics.SSIM()],
        optimizer=getattr(joptim, t["optimizer"][0])(**t["optimizer"][1]),
        lr_scheduler=None, logger=None,
        monitor=JaxMonitor(checkpoints_dir=ckpt_dir, mode="min", target="Loss",
                           saved_freq=1, early_stop=0),
        num_epochs=EPOCHS, prefetch_to_device=False)


def _port_trainer(task, tree, saved_dir, num_epochs=EPOCHS, weights=None,
                  with_logger=False):
    t = TASKS[task]
    net = getattr(models, t["net"])(
        **t["net_kwargs"], generator=torch.Generator().manual_seed(3))
    if weights is not None:
        load_jax_params(net, weights)
    return getattr(trainers, t["trainer"])(
        train_dataloader=Dataloader(_dataset(datasets, task, tree, "train"),
                                    batch_size=BATCH, shuffle=True),
        valid_dataloader=Dataloader(_dataset(datasets, task, tree, "valid"),
                                    batch_size=1),
        net=net, loss_fns=[getattr(losses, n)(**kw) for n, kw in t["losses"]],
        loss_weights=[1.0] * len(t["losses"]),
        metric_fns=[metrics.PSNR(), metrics.SSIM()],
        optimizer=getattr(optim, t["optimizer"][0])(**t["optimizer"][1]),
        lr_scheduler=None,
        logger=t["logger"](saved_dir / "log") if with_logger else None,
        monitor=Monitor(checkpoints_dir=saved_dir / "checkpoints", mode="min",
                        target="Loss", saved_freq=1, early_stop=0),
        num_epochs=num_epochs, device="cpu")


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}


def _logs(saved_dir):
    return [json.loads(line) for line in
            (saved_dir / "log" / "metrics.jsonl").read_text().splitlines()]


def _initialize_jitted(jt):
    """``_ensure_initialized`` with the net's init under ``jit``: eager, the
    init of DUF runs op by op and took most of this module's time."""
    kw = {"train": False} if jt._net_train_kwarg else {}
    jt.params = jax.jit(functools.partial(jt.net.init, **kw))(
        jt.rng_tree.jax_key("init"), jt._example_inputs())
    jt.opt_state = jt.tx.init(jt.params["params"])
    jt._ensure_initialized()  # nothing left to do: no mesh, no scheduler


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """Each task trained by the JAX package (initial variables, per-epoch
    logs, final variables) and by the port from the same initial ones."""
    out = {}
    for task in TASKS:
        jt = _jax_trainer(task, tree, tmp_path_factory.mktemp(f"jax_{task}"))
        _initialize_jitted(jt)
        initial = jax.tree_util.tree_map(np.array, jt.params)
        logs = []
        for epoch in range(1, EPOCHS + 1):
            train_log, _, _ = jt._run_epoch("training", epoch)
            valid_log, _, _ = jt._run_epoch("validation", epoch)
            logs.append({"train": train_log, "valid": valid_log})
        saved = tmp_path_factory.mktemp(f"port_{task}")
        pt = _port_trainer(task, tree, saved, weights=initial,
                           with_logger=True)
        pt.train()
        out[task] = dict(initial=initial, logs=logs, saved=saved, trainer=pt,
                         final=jax.tree_util.tree_map(np.asarray, jt.params))
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_trainer_logs_and_parameters_match_jax(task, runs):
    run = runs[task]
    logs = _logs(run["saved"])
    assert [r["epoch"] for r in logs] == [1, 2]
    names = sorted(["Loss", "PSNR", "SSIM",
                    *(n for n, _ in TASKS[task]["losses"])])
    for got, want in zip(logs, run["logs"]):
        for split in ("train", "valid"):
            assert sorted(got[split]) == sorted(want[split]) == names
            for key, value in want[split].items():
                np.testing.assert_allclose(got[split][key], value, rtol=2e-3,
                                           atol=2e-4, err_msg=f"{split} {key}")
    net = run["trainer"].net
    want = from_jax_tree(net, run["final"])
    moved = from_jax_tree(net, run["initial"])
    state = net.state_dict()
    assert sorted(want) == sorted(state)  # buffers too: the statistics
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), want[name], atol=3e-4,
                                   rtol=0, err_msg=name)
    # Training moved them: a quarter of the tensors by more than 1e-3.
    assert sum(np.abs(want[k] - moved[k]).max() > 1e-3 for k in want) > (
        len(want) // 4)


def test_misr_checkpoint_carries_the_running_statistics(tree, runs, tmp_path):
    straight = _port_trainer("misr", tree, tmp_path / "straight", num_epochs=3,
                             weights=runs["misr"]["initial"])
    straight.train()
    resumed = _port_trainer("misr", tree, tmp_path / "resumed", num_epochs=3)
    resumed.load(runs["misr"]["saved"] / "checkpoints" / "model_2.ckpt")
    norm = resumed.net.backbone.norm
    np.testing.assert_array_equal(
        norm.running_var.numpy(),
        runs["misr"]["trainer"].net.backbone.norm.running_var.numpy())
    resumed.train()
    a, b = _state(resumed), _state(straight)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("task", list(TASKS))
def test_trainer_writes_checkpoints_and_grids(task, runs):
    saved = runs[task]["saved"]
    assert sorted(p.name for p in (saved / "checkpoints").iterdir()) == [
        "model_1.ckpt", "model_2.ckpt", "model_best.ckpt"]
    grids = sorted((saved / "log" / "images").iterdir())
    assert [p.name for p in grids] == ["epoch_00001.png", "epoch_00002.png"]
    assert all(p.stat().st_size > 100 for p in grids)


def test_loggers_take_windows_and_tuples(tmp_path, rng):
    hr = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    grid = MISRLogger(tmp_path / "m")._make_grid(
        {"hr_img": hr, "lr_imgs": hr[:, None, ::2, ::2]}, hr)
    assert grid.shape == (12, 42, 3) and grid.dtype == np.uint8
    seq = rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
    lr = seq[:, :, ::2, ::2]
    a = VSRLogger(tmp_path / "v")._make_grid({"hr_imgs": seq}, (seq, lr))
    b = VSRLogger(tmp_path / "w")._make_grid({"hr_imgs": seq}, seq)
    np.testing.assert_array_equal(a, b)
    for name, cls in (("AcdcMISRLogger", MISRLogger),
                      ("Dsb15MISRLogger", MISRLogger),
                      ("Dsb15VSRLogger", VSRLogger)):
        assert get_class("logger", name) is cls


def test_frvsr_losses_split_flow_and_sr(rng):
    trainer = trainers.FRVSRTrainer.__new__(trainers.FRVSRTrainer)
    trainer.loss_fns = [losses.FlowLoss(), losses.L1Loss()]
    trainer.metric_fns = [metrics.PSNR()]
    lr = torch.from_numpy(rng.standard_normal((2, 3, 1, 4, 4)).astype(np.float32))
    hr = torch.from_numpy(rng.standard_normal((2, 3, 1, 8, 8)).astype(np.float32))
    warped, sr = lr + 0.5, hr - 0.25
    flow, sr_loss = trainer._compute_losses((sr, warped), (lr, hr))
    assert flow.item() == pytest.approx(0.25) and sr_loss.item() == 0.25
    assert trainer._compute_metrics((sr, warped), (lr, hr))[0].item() > 0


# ----------------------------------------------- the config-driven entry

CONFIGS = {
    "acdc_misr_duf_x2": {},
    "dsb15_misr_duf_x2": {},
    "acdc_misr_toflow_x2": {},
    "acdc_misr_rbpn_x2": dict(base_filter=8, feat=8, num_resblocks=1),
    "acdc_misr_edvr_x4": dict(nf=8, groups=2, front_RBs=1, back_RBs=1),
    "acdc_vsr_frvsr_x4": dict(num_resblocks=1),
    "dsb15_vsr_frvsr_x4": dict(num_resblocks=1),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_main_builds_and_trains_each_config(name, tree, tmp_path):
    cfg = load_config(f"configs/train/{name}.yaml")
    factor = cfg.dataset.kwargs.downscale_factor
    cfg.main.saved_dir = str(tmp_path / "run")
    cfg.dataset.kwargs.data_dir = str(tree / "videos")
    cfg.dataset.kwargs.augments = _augments(16 // factor, factor)  # HR 16
    cfg.dataloader.kwargs.update(train_batch_size=4, num_workers=0)
    cfg.net.kwargs.update(CONFIGS[name])
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs = {"num_epochs": 1, "device": "cpu"}
    trainer = port_main.run_train(cfg)
    assert type(trainer).__name__ == cfg.trainer.name
    assert type(trainer.net).__name__ == cfg.net.name
    log = _logs(tmp_path / "run")[0]
    assert np.isfinite(log["train"]["Loss"]) and np.isfinite(
        log["valid"]["PSNR"])
    assert (tmp_path / "run" / "checkpoints" / "model_best.ckpt").is_file()
