"""The volumetric training and test paths as a whole: ``Acdc3DSRTrainer`` /
Volume3DSRNet (``fused_tail``) and ``Acdc4DSRTrainer`` / Volume4DSRNet
(``remat``, ``fused_tail``) against ``vsr_tpu``'s trainers on the same tiny
tree, seed and initial weights (two epochs: every logged scalar within
2e-3, every final parameter within 3e-4), the 3D and 4D predictors against
``vsr_tpu``'s on the same weights (rows of ``results.csv``, the log, the
NIfTI volumes and PNGs), and ``vsr_tpu_torch.main`` training each volume
config from its YAML and then testing the checkpoint with ``--test``."""

import csv
import json
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.synth import make_processed_tree
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import models as jmodels
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.io.nifti import load_nifti
from vsr_tpu.runner import predictors as jpredictors
from vsr_tpu.runner import trainers as jtrainers
from vsr_tpu_torch import losses, metrics, models, optim
from vsr_tpu_torch import main as port_main
from vsr_tpu_torch.callbacks.logger import Volume4DLogger, VolumeLogger
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.config import load_config, save_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.runner import predictors, trainers

TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]
AUGMENTS = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
            {"name": "RandomCropPatch", "kwargs": {"size": [4, 4, 2],
                                                   "ratio": 2}}]
HR, FRAMES, SLICES = 16, 4, 3
TASKS = {
    "3d": dict(dataset="AcdcVolumeDataset", ds_kwargs={},
               trainer="Acdc3DSRTrainer", predictor="Acdc3DSRPredictor",
               net="Volume3DSRNet", logger=VolumeLogger,
               net_kwargs=dict(in_channels=1, out_channels=1, num_resblocks=1,
                               num_features=4, upscale_factor=2,
                               fused_tail=True)),
    "4d": dict(dataset="AcdcVolumeVSRDataset",
               ds_kwargs={"num_frames": 3, "temporal_order": "last"},
               trainer="Acdc4DSRTrainer", predictor="Acdc4DSRPredictor",
               net="Volume4DSRNet", logger=Volume4DLogger,
               net_kwargs=dict(in_channels=1, out_channels=1, num_features=4,
                               num_resblocks=1, upscale_factor=2, remat=True,
                               fused_tail=True)),
}
BATCH, EPOCHS = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 1 patient x 3 slices x 4 frames of 16 x 16 per split: 4 train volumes
    # or windows (2 batches), 4 validation volumes or 1 sequence.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=HR,
                               frames=FRAMES, patients_per_type=1,
                               slices=SLICES, types=("train", "valid", "test"))


def _dataset(module, task, tree, type_):
    t = TASKS[task]
    return getattr(module, t["dataset"])(
        data_dir=tree / "videos", type=type_, downscale_factor=2,
        transforms=TRANSFORMS, augments=AUGMENTS, **t["ds_kwargs"])


def _jax_trainer(task, tree, ckpt_dir):
    t = TASKS[task]
    return getattr(jtrainers, t["trainer"])(
        train_dataloader=JaxDataloader(_dataset(jdatasets, task, tree, "train"),
                                       batch_size=BATCH, shuffle=True),
        valid_dataloader=JaxDataloader(_dataset(jdatasets, task, tree, "valid"),
                                       batch_size=1),
        net=getattr(jmodels, t["net"])(**t["net_kwargs"]),
        loss_fns=[jlosses.L1Loss()], loss_weights=[1.0],
        metric_fns=[jmetrics.PSNR()], optimizer=joptim.Adam(lr=1e-3),
        lr_scheduler=None, logger=None,
        monitor=JaxMonitor(checkpoints_dir=ckpt_dir, mode="min", target="Loss",
                           saved_freq=1, early_stop=0),
        num_epochs=EPOCHS, prefetch_to_device=False)


def _port_trainer(task, tree, saved_dir, weights):
    t = TASKS[task]
    net = getattr(models, t["net"])(**t["net_kwargs"])
    load_jax_params(net, weights)
    return getattr(trainers, t["trainer"])(
        train_dataloader=Dataloader(_dataset(datasets, task, tree, "train"),
                                    batch_size=BATCH, shuffle=True),
        valid_dataloader=Dataloader(_dataset(datasets, task, tree, "valid"),
                                    batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], optimizer=optim.Adam(lr=1e-3),
        lr_scheduler=None, logger=t["logger"](saved_dir / "log"),
        monitor=Monitor(checkpoints_dir=saved_dir / "checkpoints", mode="min",
                        target="Loss", saved_freq=1, early_stop=0),
        num_epochs=EPOCHS, device="cpu")


def _logs(saved_dir):
    return [json.loads(line) for line in
            (saved_dir / "log" / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """Each task trained by the JAX package (its init and train step under
    ``jit``) and by the port from the same initial variables."""
    out = {}
    for task in TASKS:
        jt = _jax_trainer(task, tree, tmp_path_factory.mktemp(f"jax_{task}"))
        jt.params = jax.jit(jt.net.init)(jt.rng_tree.jax_key("init"),
                                         jt._example_inputs())
        jt.opt_state = jt.tx.init(jt.params["params"])
        initial = jax.tree_util.tree_map(np.array, jt.params)
        logs = []
        for epoch in range(1, EPOCHS + 1):
            train_log, _, _ = jt._run_epoch("training", epoch)
            valid_log, _, _ = jt._run_epoch("validation", epoch)
            logs.append({"train": train_log, "valid": valid_log})
        saved = tmp_path_factory.mktemp(f"port_{task}")
        pt = _port_trainer(task, tree, saved, initial)
        pt.train()
        out[task] = dict(initial=initial, logs=logs, saved=saved, trainer=pt,
                         final=jax.tree_util.tree_map(np.asarray, jt.params))
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_trainer_logs_and_parameters_match_jax(task, runs):
    run = runs[task]
    logs = _logs(run["saved"])
    assert [r["epoch"] for r in logs] == [1, 2]
    for got, want in zip(logs, run["logs"]):
        for split in ("train", "valid"):
            assert sorted(got[split]) == sorted(want[split]) == [
                "L1Loss", "Loss", "PSNR"]
            for key, value in want[split].items():
                np.testing.assert_allclose(got[split][key], value, rtol=2e-3,
                                           atol=2e-4, err_msg=f"{split} {key}")
    net = run["trainer"].net
    want = from_jax_tree(net, run["final"])
    moved = from_jax_tree(net, run["initial"])
    state = net.state_dict()
    assert sorted(want) == sorted(state)
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), want[name], atol=3e-4,
                                   rtol=0, err_msg=name)
    # Training moved them: a quarter of the tensors by more than 1e-3.
    assert sum(np.abs(want[k] - moved[k]).max() > 1e-3 for k in want) > (
        len(want) // 4)


@pytest.mark.parametrize("task", list(TASKS))
def test_trainer_writes_checkpoints_and_grids(task, runs):
    saved = runs[task]["saved"]
    assert sorted(p.name for p in (saved / "checkpoints").iterdir()) == [
        "model_1.ckpt", "model_2.ckpt", "model_best.ckpt"]
    grids = sorted((saved / "log" / "images").iterdir())
    assert [p.name for p in grids] == ["epoch_00001.png", "epoch_00002.png"]
    # The validation grid: one HR | SR pair of 16 x 16 mid-depth slices.
    assert np.array(Image.open(grids[-1])).shape == (20, 38, 3)


def test_volume4d_trainer_weights_frames_and_averages_over_them(rng):
    trainer = trainers.Volume4DTrainer.__new__(trainers.Volume4DTrainer)
    trainer.loss_fns, trainer.metric_fns = [losses.L1Loss()], []
    out = torch.from_numpy(rng.standard_normal((2, 3, 1, 2, 4, 4)).astype(
        np.float32))
    hr = torch.zeros_like(out)
    (l1,) = trainer._compute_losses(out, hr)
    per_frame = [out[:, t].abs().mean() for t in range(3)]
    assert l1.item() == pytest.approx(float(torch.stack(per_frame).mean()))
    assert trainer._batch_weight({"lr_vols": np.zeros((2, 3, 4, 4, 2, 1))}) == 6


# ------------------------------------------------------------ predictors


@pytest.fixture(scope="module")
def coordinates(tmp_path_factory):
    path = tmp_path_factory.mktemp("cropped") / "coordinates.pkl"
    with open(path, "wb") as f:
        pickle.dump({"patient001": (2, 14, 3, 15)}, f)
    return str(path)


def _metric_fns(module, coordinates):
    return [module.PSNR(), module.SliceSSIM(), module.CardiacPSNR(coordinates)]


def _read(saved):
    """(csv rows, {NIfTI path: array}, {PNG path: grey array})."""
    with open(saved / "results.csv", newline="") as f:
        rows = list(csv.reader(f))
    vols = {str(p.relative_to(saved)): load_nifti(p)
            for p in sorted(saved.glob("volumes/**/*.nii.gz"))}
    pngs = {str(p.relative_to(saved)): np.array(Image.open(p).convert("L"))
            for p in sorted(saved.glob("volumes/**/*.png"))}
    return rows, vols, pngs


@pytest.fixture(scope="module")
def predicted(tree, coordinates, runs, tmp_path_factory):
    """Both families through the JAX predictor and the port's, on the
    weights the JAX trainer ended with."""
    out = {}
    for task, t in TASKS.items():
        variables = runs[task]["final"]
        kw = dict(loss_fns=None, loss_weights=[1.0, 0.5], exported=True)
        jsaved = tmp_path_factory.mktemp(f"jax_pred_{task}")
        jp = getattr(jpredictors, t["predictor"])(
            test_dataloader=JaxDataloader(
                _dataset(jdatasets, task, tree, "test"), batch_size=1),
            net=getattr(jmodels, t["net"])(**t["net_kwargs"]),
            **{**kw, "loss_fns": [jlosses.L1Loss(), jlosses.MSELoss()]},
            metric_fns=_metric_fns(jmetrics, coordinates),
            saved_dir=str(jsaved))
        jp.params = variables
        jlog = jp.predict()
        net = getattr(models, t["net"])(**t["net_kwargs"])
        load_jax_params(net, variables)
        saved = tmp_path_factory.mktemp(f"port_pred_{task}")
        pp = getattr(predictors, t["predictor"])(
            test_dataloader=Dataloader(_dataset(datasets, task, tree, "test"),
                                       batch_size=1),
            net=net, **{**kw, "loss_fns": [losses.L1Loss(),
                                           torch.nn.MSELoss()]},
            metric_fns=_metric_fns(metrics, coordinates), saved_dir=str(saved),
            device="cpu")
        log = pp.predict()
        out[task] = dict(log=log, jlog=jlog, files=_read(saved),
                         jfiles=_read(jsaved))
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_predictor_rows_and_log_match_jax(task, predicted):
    got_rows, _, _ = predicted[task]["files"]
    want_rows, _, _ = predicted[task]["jfiles"]
    assert got_rows[0] == want_rows[0] == [
        "name", "PSNR", "SliceSSIM", "CardiacPSNR", "L1Loss", "MSELoss"]
    # A row per (patient, frame): 3D names it from the sample, 4D from the
    # frame of the sequence.
    assert [r[0] for r in got_rows[1:]] == [r[0] for r in want_rows[1:]] == [
        f"patient001_frame{t:02d}" for t in range(1, FRAMES + 1)]
    got = np.array([[float(v) for v in r[1:]] for r in got_rows[1:]])
    want = np.array([[float(v) for v in r[1:]] for r in want_rows[1:]])
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.isfinite(got).all() and got[:, 0].std() > 0
    assert np.abs(got[:, 0] - got[:, 2]).max() > 1e-2  # the crop is scored
    log, jlog = predicted[task]["log"], predicted[task]["jlog"]
    assert list(log) == list(jlog)
    for key, value in jlog.items():
        assert log[key] == pytest.approx(value, abs=1e-3), key
    assert log["PSNR"] == pytest.approx(got[:, 0].mean(), abs=1e-4)


@pytest.mark.parametrize("task", list(TASKS))
def test_predictor_volumes_and_pngs_match_jax(task, predicted):
    _, got_vols, got_pngs = predicted[task]["files"]
    _, want_vols, want_pngs = predicted[task]["jfiles"]
    assert list(got_vols) == list(want_vols)
    if task == "3d":
        assert list(got_vols) == [f"volumes/patient001/frame{t:02d}_sr.nii.gz"
                                  for t in range(1, FRAMES + 1)]
        assert list(got_pngs) == list(want_pngs) == [
            f"volumes/patient001/frame{t:02d}_mid.png"
            for t in range(1, FRAMES + 1)]
        shape = (HR, HR, SLICES)
    else:
        assert list(got_vols) == ["volumes/patient001/sequence_sr.nii.gz"]
        assert got_pngs == want_pngs == {}
        shape = (HR, HR, SLICES, FRAMES)
    for name, vol in got_vols.items():
        assert vol.shape == want_vols[name].shape == shape
        diff = np.abs(vol.astype(int) - want_vols[name].astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        assert vol.std() > 1
    for name, png in got_pngs.items():  # the middle slice of its volume
        np.testing.assert_array_equal(
            png, got_vols[name.replace("_mid.png", "_sr.nii.gz")][
                :, :, SLICES // 2])
        assert np.abs(png.astype(int) - want_pngs[name]).max() <= 1


# ------------------------------------------- main and main --test, end to end


@pytest.fixture(scope="module")
def deep_tree(tmp_path_factory):
    # The test configs score SSIM with dim 3: depth >= 11; the 4D config's
    # windows are 5 frames. The test split is the validation split again.
    root = make_processed_tree(tmp_path_factory.mktemp("deep"), hr_size=HR,
                               frames=5, patients_per_type=1, slices=11)
    shutil.copytree(root / "videos" / "valid", root / "videos" / "test")
    return root


@pytest.mark.parametrize("name,task", [("acdc_3d_vol_x2", "3d"),
                                       ("acdc_4d_vol_x2", "4d")])
def test_main_trains_and_tests_each_volume_config(name, task, deep_tree,
                                                  tmp_path):
    cfg = load_config(f"configs/train/{name}.yaml")
    run = tmp_path / "run"
    cfg.main.saved_dir = str(run)
    cfg.dataset.kwargs.data_dir = str(deep_tree / "videos")
    cfg.dataset.kwargs.augments = AUGMENTS
    cfg.dataloader.kwargs.update(train_batch_size=2, num_workers=0)
    train_kwargs = dict(num_features=4, num_resblocks=1)
    cfg.net.kwargs.update(train_kwargs)
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs = {"num_epochs": 1, "device": "cpu"}
    trainer = port_main.run_train(cfg)
    assert type(trainer).__name__ == cfg.trainer.name
    assert type(trainer.net).__name__ == cfg.net.name
    assert cfg.net.kwargs.fused_tail and (task == "3d" or cfg.net.kwargs.remat)
    valid = _logs(run)[0]["valid"]
    test = load_config(f"configs/test/{name}.yaml")
    test.main.loaded_path = str(run / "checkpoints" / "model_best.ckpt")
    test.dataset.kwargs.data_dir = str(deep_tree / "videos")
    test.dataloader.kwargs.num_workers = 0
    test.net.kwargs.update(train_kwargs)  # no fused_tail: one checkpoint
    test.predictor.kwargs.saved_dir = str(run / "predictions")
    test.predictor.kwargs.device = "cpu"
    save_config(test, tmp_path / "test.yaml")
    port_main.main([str(tmp_path / "test.yaml"), "--test"])
    rows, vols, _ = _read(run / "predictions")
    assert rows[0] == ["name", "PSNR", "SSIM", "L1Loss"]
    assert len(rows) == 1 + 5  # a row per frame
    psnr = np.mean([float(r[1]) for r in rows[1:]])
    assert psnr == pytest.approx(valid["PSNR"], abs=1e-3)
    shapes = {v.shape for v in vols.values()}
    assert shapes == ({(HR, HR, 11)} if task == "3d" else {(HR, HR, 11, 5)})
