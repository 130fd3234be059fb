"""``AcdcSISRSRFBTrainer`` on ``SRFBNet`` (fused squeeze on) against
``vsr_tpu``'s trainer on the same synthetic tree, seed and initial weights:
per-epoch logs, final parameters, the logger's grid, and the config-driven
entry point."""

import json

import jax
import numpy as np
import pytest
import torch

from tests.synth import make_processed_tree
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.models.srfbn import SRFBNet as JaxSRFBNet
from vsr_tpu.runner import trainers as jtrainers
from vsr_tpu_torch import losses, metrics, optim
from vsr_tpu_torch import main as port_main
from vsr_tpu_torch.callbacks.logger import SISRSRFBLogger
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.config import load_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.models import SRFBNet
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.runner import trainers
from vsr_tpu_torch.utils.checkpoint import load_checkpoint

TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]
AUGMENTS = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
            {"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 2}}]
NET_KWARGS = dict(in_channels=1, out_channels=1, num_steps=2, num_features=8,
                  num_groups=2, upscale_factor=2, fused_squeeze=True)
BATCH, LR, EPOCHS = 4, 1e-3, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 1 patient x 2 slices x 5 frames of 24 x 24: 10 samples, 3 train batches.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=24,
                               frames=5, patients_per_type=1, slices=2)


def _dataset(module, tree, type_):
    return module.AcdcSISRDataset(data_dir=tree / "imgs", type=type_,
                                  downscale_factor=2, transforms=TRANSFORMS,
                                  augments=AUGMENTS)


@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    trainer = jtrainers.AcdcSISRSRFBTrainer(
        train_dataloader=JaxDataloader(_dataset(jdatasets, tree, "train"),
                                       batch_size=BATCH, shuffle=True),
        valid_dataloader=JaxDataloader(_dataset(jdatasets, tree, "valid"),
                                       batch_size=1),
        net=JaxSRFBNet(**NET_KWARGS), loss_fns=[jlosses.L1Loss()],
        loss_weights=[1.0], metric_fns=[jmetrics.PSNR(), jmetrics.SSIM()],
        optimizer=joptim.Adam(lr=LR), lr_scheduler=None, logger=None,
        monitor=JaxMonitor(checkpoints_dir=tmp_path_factory.mktemp("jax"),
                           mode="min", target="Loss", saved_freq=1, early_stop=0),
        num_epochs=EPOCHS, prefetch_to_device=False)
    trainer._ensure_initialized()
    initial = jax.tree_util.tree_map(np.array, trainer.params)
    logs = []
    for epoch in range(1, EPOCHS + 1):
        train_log, _, _ = trainer._run_epoch("training", epoch)
        valid_log, _, _ = trainer._run_epoch("validation", epoch)
        logs.append({"train": train_log, "valid": valid_log})
    return dict(initial=initial, logs=logs,
                final=jax.tree_util.tree_map(np.asarray, trainer.params))


@pytest.fixture(scope="module")
def port_run(tree, jax_run, tmp_path_factory):
    saved = tmp_path_factory.mktemp("port")
    net = SRFBNet(**NET_KWARGS, generator=torch.Generator().manual_seed(3))
    load_jax_params(net, jax_run["initial"])
    trainer = trainers.AcdcSISRSRFBTrainer(
        train_dataloader=Dataloader(_dataset(datasets, tree, "train"),
                                    batch_size=BATCH, shuffle=True),
        valid_dataloader=Dataloader(_dataset(datasets, tree, "valid"),
                                    batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR(), metrics.SSIM()],
        optimizer=optim.Adam(lr=LR), lr_scheduler=None,
        logger=SISRSRFBLogger(saved / "log"),
        monitor=Monitor(checkpoints_dir=saved / "checkpoints", mode="min",
                        target="Loss", saved_freq=1, early_stop=0),
        num_epochs=EPOCHS, device="cpu")
    trainer.train()
    return dict(saved=saved, trainer=trainer)


def _logs(saved):
    return [json.loads(line) for line in
            (saved / "log" / "metrics.jsonl").read_text().splitlines()]


def test_srfb_trainer_logs_match_jax(jax_run, port_run):
    logs = _logs(port_run["saved"])
    assert [r["epoch"] for r in logs] == [1, 2]
    for got, want in zip(logs, jax_run["logs"]):
        for split in ("train", "valid"):
            assert sorted(got[split]) == sorted(want[split]) == [
                "L1Loss", "Loss", "PSNR", "SSIM"]
            for key, value in want[split].items():
                # Two frameworks' float32 sums over 2 epochs of Adam steps.
                np.testing.assert_allclose(got[split][key], value, rtol=2e-3,
                                           atol=2e-4, err_msg=f"{split} {key}")


def test_srfb_trainer_final_parameters_match_jax(jax_run, port_run):
    net = port_run["trainer"].net
    want = from_jax_tree(net, jax_run["final"])
    moved = from_jax_tree(net, jax_run["initial"])
    for name, p in net.named_parameters():
        # 6 Adam steps of 1e-3: a parameter moves by up to 6e-3.
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=3e-4,
                                   rtol=0, err_msg=name)
    # ... and most tensors did move that far (a PReLU weight with a small
    # gradient may not).
    far = [np.abs(want[n] - moved[n]).max() > 1e-3 for n in want]
    assert sum(far) > 0.8 * len(far)


def test_srfb_trainer_writes_checkpoints_and_last_step_grids(port_run):
    saved = port_run["saved"]
    assert sorted(p.name for p in (saved / "checkpoints").iterdir()) == [
        "model_1.ckpt", "model_2.ckpt", "model_best.ckpt"]
    assert sorted(p.name for p in (saved / "log" / "images").iterdir()) == [
        "epoch_00001.png", "epoch_00002.png"]
    state, aux = load_checkpoint(saved / "checkpoints" / "model_2.ckpt")
    assert aux["epoch"] == 2
    assert all(torch.isfinite(v).all() for v in state["net"].values())


def test_srfb_loss_is_the_mean_over_steps_and_metrics_take_the_last(port_run):
    trainer = port_run["trainer"]
    outputs = torch.stack([torch.zeros(2, 1, 24, 24), torch.ones(2, 1, 24, 24)])
    targets = torch.ones(2, 1, 24, 24)
    (l1,) = trainer._compute_losses(outputs, targets)
    assert float(l1) == pytest.approx(0.5)
    psnr, ssim = trainer._compute_metrics(outputs, targets)
    assert float(psnr) > 90 and float(ssim) == pytest.approx(1.0)
    assert trainer._outputs_to_numpy(outputs).shape == (2, 2, 24, 24, 1)
    grid = SISRSRFBLogger._make_grid(None, {"hr_img": np.zeros((2, 24, 24, 1))},
                                     trainer._outputs_to_numpy(outputs))
    assert grid.shape[2] == 3 and grid.max() == 255  # the last step's ones


@pytest.mark.parametrize("name", ["AcdcSISRSRFBTrainer", "Dsb15SISRSRFBTrainer",
                                  "AcdcSISRSRFBLogger", "Dsb15SISRSRFBLogger"])
def test_srfb_twins_are_registered_under_the_jax_names(name):
    category = "trainer" if name.endswith("Trainer") else "logger"
    cls = get_class(category, name)
    if category == "trainer":
        assert issubclass(cls, trainers.SISRSRFBTrainer)
        assert cls.dataset_stats == ("dsb15" if name.startswith("Dsb15") else "acdc")
    else:
        assert cls is SISRSRFBLogger


def test_main_trains_srfbnet_from_the_repos_config(tree, tmp_path):
    cfg = load_config("configs/train/acdc_sisr_srfb_x2.yaml")
    assert cfg.trainer.name == "AcdcSISRSRFBTrainer" and cfg.net.name == "SRFBNet"
    cfg.main.saved_dir = str(tmp_path / "run")
    cfg.dataset.kwargs.data_dir = str(tree / "imgs")
    cfg.dataset.kwargs.augments = AUGMENTS
    cfg.dataloader.kwargs.update(train_batch_size=BATCH, num_workers=2)
    cfg.net.kwargs = NET_KWARGS
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs = {"num_epochs": 1, "device": "cpu"}
    trainer = port_main.run_train(cfg)
    assert isinstance(trainer, trainers.SISRSRFBTrainer)
    logs = _logs(tmp_path / "run")
    assert len(logs) == 1 and np.isfinite(logs[0]["valid"]["Loss"])
    assert (tmp_path / "run" / "checkpoints" / "model_best.ckpt").exists()
