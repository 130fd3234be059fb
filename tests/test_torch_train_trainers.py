"""Training slice as a whole: ``AcdcSISRTrainer`` / EDSRNet and
``AcdcVSRTrainer`` / DRFNet (``fused_squeeze`` on) against ``vsr_tpu``'s
trainers on the same synthetic tree, seed and initial weights; determinism,
resume, preemption, the scheduler, the refusals, and the config-driven
entry point with ``infer --checkpoint`` serving what it trained."""

import json
import os
import signal

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
from vsr_tpu_torch import infer, losses, metrics, models, optim
from vsr_tpu_torch import main as port_main
from vsr_tpu_torch.callbacks.logger import SISRLogger, VSRLogger
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.config import Config, load_config, save_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
from vsr_tpu_torch.registry import build, get_class
from vsr_tpu_torch.runner import trainers
from vsr_tpu_torch.utils.checkpoint import load_checkpoint

TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]
AUGMENTS = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
            {"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 2}}]
TASKS = {
    "sisr": dict(dataset="AcdcSISRDataset", sub="imgs", ds_kwargs={},
                 trainer="AcdcSISRTrainer", net="EDSRNet", logger=SISRLogger,
                 net_kwargs=dict(in_channels=1, out_channels=1, num_resblocks=2,
                                 num_features=8, upscale_factor=2)),
    "vsr": dict(dataset="AcdcVSRDataset", sub="videos",
                ds_kwargs={"num_frames": 3, "temporal_order": "last"},
                trainer="AcdcVSRTrainer", net="DRFNet", logger=VSRLogger,
                net_kwargs=dict(in_channels=1, out_channels=1, num_features=8,
                                num_groups=2, upscale_factor=2,
                                fused_squeeze=True)),
}
BATCH, LR, EPOCHS = 4, 1e-3, 2


# Module-scoped, so the module's fixture runs and the tests' runs use one
# thread count: float32 sums depend on it in the last bit.
@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 1 patient x 2 slices x 5 frames of 32 x 32: 10 SISR samples (3 train
    # batches, the last one partial), 10 VSR windows, 2 validation sequences.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=32,
                               frames=5, patients_per_type=1, slices=2)


def _dataset(module, task, tree, type_):
    t = TASKS[task]
    return getattr(module, t["dataset"])(
        data_dir=tree / t["sub"], type=type_, downscale_factor=2,
        transforms=TRANSFORMS, augments=AUGMENTS, **t["ds_kwargs"])


def _jax_trainer(task, tree, ckpt_dir, num_epochs=EPOCHS, scheduler=None):
    t = TASKS[task]
    return getattr(jtrainers, t["trainer"])(
        train_dataloader=JaxDataloader(_dataset(jdatasets, task, tree, "train"),
                                       batch_size=BATCH, shuffle=True),
        valid_dataloader=JaxDataloader(_dataset(jdatasets, task, tree, "valid"),
                                       batch_size=1),
        net=getattr(jmodels, t["net"])(**t["net_kwargs"]),
        loss_fns=[jlosses.L1Loss()], loss_weights=[1.0],
        metric_fns=[jmetrics.PSNR(), jmetrics.SSIM()],
        optimizer=joptim.Adam(lr=LR), lr_scheduler=scheduler, logger=None,
        monitor=JaxMonitor(checkpoints_dir=ckpt_dir, mode="min", target="Loss",
                           saved_freq=1, early_stop=0),
        num_epochs=num_epochs, prefetch_to_device=False)


def _port_trainer(task, tree, saved_dir, num_epochs=EPOCHS, scheduler=None,
                  seed="vsr", weights=None, with_logger=False, **kwargs):
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
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR(), metrics.SSIM()],
        optimizer=optim.Adam(lr=LR), lr_scheduler=scheduler,
        logger=t["logger"](saved_dir / "log") if with_logger else None,
        monitor=Monitor(checkpoints_dir=saved_dir / "checkpoints", mode="min",
                        target="Loss", saved_freq=1, early_stop=0),
        num_epochs=num_epochs, random_seed=seed, device="cpu", **kwargs)


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _logs(saved_dir):
    return [json.loads(line) for line in
            (saved_dir / "log" / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_runs(tree, tmp_path_factory):
    """Each task trained by the JAX package: initial variables, the
    per-epoch logs and the final parameters."""
    runs = {}
    for task in TASKS:
        trainer = _jax_trainer(task, tree, tmp_path_factory.mktemp(f"jax_{task}"))
        trainer._ensure_initialized()
        initial = jax.tree_util.tree_map(np.array, trainer.params)
        logs = []
        for epoch in range(1, EPOCHS + 1):
            train_log, _, _ = trainer._run_epoch("training", epoch)
            valid_log, _, _ = trainer._run_epoch("validation", epoch)
            logs.append({"train": train_log, "valid": valid_log})
        runs[task] = dict(initial=initial, logs=logs, final=jax.tree_util.tree_map(
            np.asarray, trainer.params))
    return runs


@pytest.fixture(scope="module")
def port_runs(tree, jax_runs, tmp_path_factory):
    """The same runs by the port, from the JAX runs' initial weights."""
    runs = {}
    for task in TASKS:
        saved = tmp_path_factory.mktemp(f"port_{task}")
        trainer = _port_trainer(task, tree, saved, with_logger=True,
                                weights=jax_runs[task]["initial"])
        trainer.train()
        runs[task] = dict(saved=saved, trainer=trainer, final=_params(trainer))
    return runs


@pytest.mark.parametrize("task", list(TASKS))
def test_trainer_logs_and_parameters_match_jax(task, jax_runs, port_runs):
    logs = _logs(port_runs[task]["saved"])
    assert [r["epoch"] for r in logs] == [1, 2]
    for got, want in zip(logs, jax_runs[task]["logs"]):
        for split in ("train", "valid"):
            assert sorted(got[split]) == sorted(want[split]) == [
                "L1Loss", "Loss", "PSNR", "SSIM"]
            for key, value in want[split].items():
                # Two frameworks' float32 sums over 2 epochs of Adam steps.
                np.testing.assert_allclose(got[split][key], value, rtol=2e-3,
                                           atol=2e-4, err_msg=f"{split} {key}")
    net = port_runs[task]["trainer"].net
    want = from_jax_tree(net, jax_runs[task]["final"])
    moved = from_jax_tree(net, jax_runs[task]["initial"])
    for name, p in net.named_parameters():
        # 6 Adam steps of 1e-3 each: a parameter moves by up to 6e-3; the
        # two runs must agree to a small part of that.
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=3e-4,
                                   rtol=0, err_msg=name)
        assert np.abs(want[name] - moved[name]).max() > 1e-3, name


@pytest.mark.parametrize("task", list(TASKS))
def test_trainer_writes_checkpoints_logs_and_grids(task, port_runs):
    saved = port_runs[task]["saved"]
    names = sorted(p.name for p in (saved / "checkpoints").iterdir())
    assert names == ["model_1.ckpt", "model_2.ckpt", "model_best.ckpt"]
    assert sorted(p.name for p in (saved / "log" / "images").iterdir()) == [
        "epoch_00001.png", "epoch_00002.png"]
    state, aux = load_checkpoint(saved / "checkpoints" / "model_2.ckpt")
    assert aux["epoch"] == 2 and aux["random_seed"] == "vsr"
    assert sorted(aux) == ["epoch", "lr_scheduler", "monitor", "random_seed"]
    assert _same(state["net"], port_runs[task]["final"])
    assert all(torch.isfinite(v).all() for v in state["net"].values())


@pytest.mark.parametrize("task", list(TASKS))
def test_run_twice_is_bit_equal_and_another_seed_differs(task, tree, jax_runs,
                                                         port_runs, tmp_path):
    # Without the one-batch-ahead copy to the device: the same batches.
    again = _port_trainer(task, tree, tmp_path / "again",
                          weights=jax_runs[task]["initial"],
                          prefetch_to_device=False)
    again.train()
    assert _same(_params(again), port_runs[task]["final"])
    other = _port_trainer(task, tree, tmp_path / "other", seed="other",
                          weights=jax_runs[task]["initial"])
    other.train()
    assert not _same(_params(other), port_runs[task]["final"])


@pytest.mark.parametrize("task", list(TASKS))
def test_resume_from_a_checkpoint_equals_the_straight_run(task, tree, jax_runs,
                                                          port_runs, tmp_path):
    straight = _port_trainer(task, tree, tmp_path / "straight", num_epochs=3,
                             weights=jax_runs[task]["initial"])
    straight.train()
    resumed = _port_trainer(task, tree, tmp_path / "resumed", num_epochs=3)
    resumed.load(port_runs[task]["saved"] / "checkpoints" / "model_2.ckpt")
    assert resumed.epoch == 3
    resumed.train()
    assert _same(_params(resumed), _params(straight))


@pytest.mark.parametrize("task", list(TASKS))
def test_sigterm_mid_epoch_then_resume_equals_the_straight_run(
        task, tree, jax_runs, port_runs, tmp_path):
    interrupted = _port_trainer(task, tree, tmp_path / "int",
                                weights=jax_runs[task]["initial"])
    steps = []
    step = interrupted._train_step

    def counting_step(inputs, targets):
        out = step(inputs, targets)
        steps.append(1)
        if len(steps) == 4:  # the first step of epoch 2 (3 batches an epoch)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    interrupted._train_step = counting_step
    before = signal.getsignal(signal.SIGTERM)
    interrupted.train()
    assert signal.getsignal(signal.SIGTERM) is before  # handlers restored
    assert interrupted._preempted and len(steps) == 4
    path = tmp_path / "int" / "checkpoints" / "model_preempt.ckpt"
    _, aux = load_checkpoint(path)
    assert aux["epoch"] == 1
    assert aux["mid_epoch"]["steps_done"] == 1
    assert aux["mid_epoch"]["batches_total"] == 3
    assert sorted(aux["mid_epoch"]["acc"]) == ["L1Loss", "Loss", "PSNR", "SSIM"]

    resumed = _port_trainer(task, tree, tmp_path / "res", with_logger=True)
    resumed.load(path)
    assert resumed.epoch == 2 and resumed._mid_epoch_resume["steps_done"] == 1
    resumed.train()
    assert _same(_params(resumed), port_runs[task]["final"])
    # The resumed epoch's log equals the uninterrupted run's second epoch.
    assert _logs(tmp_path / "res")[-1] == _logs(port_runs[task]["saved"])[-1]


def test_preempt_at_the_last_batch_counts_the_epoch_as_done(tree, tmp_path):
    trainer = _port_trainer("sisr", tree, tmp_path)
    step, steps = trainer._train_step, []

    def counting_step(inputs, targets):
        steps.append(1)
        if len(steps) == 3:
            trainer._preempted = True
        return step(inputs, targets)

    trainer._train_step = counting_step
    trainer._train_loop()
    _, aux = load_checkpoint(tmp_path / "checkpoints" / "model_preempt.ckpt")
    assert aux["epoch"] == 1 and "mid_epoch" not in aux


def test_mid_epoch_resume_refuses_another_batch_partitioning(tree, tmp_path):
    trainer = _port_trainer("sisr", tree, tmp_path)
    trainer._mid_epoch_resume = {"steps_done": 1, "count": 4.0, "acc": {},
                                 "batches_total": 7}
    with pytest.raises(ValueError, match="7 train batches"):
        trainer._run_epoch("training", 1)


def test_step_lr_is_applied_like_the_jax_trainer(tree, tmp_path):
    ours = _port_trainer("sisr", tree, tmp_path / "port", num_epochs=3,
                         scheduler=optim.StepLR(step_size=1, gamma=0.5))
    theirs = _jax_trainer("sisr", tree, tmp_path / "jax", num_epochs=3,
                          scheduler=joptim.StepLR(step_size=1, gamma=0.5))
    ours.train()
    theirs.train()
    lr = optim.get_learning_rate(ours.optimizer)
    assert lr == LR * 0.5 ** 3
    assert lr == pytest.approx(joptim.get_learning_rate(theirs.opt_state),
                               rel=1e-6)
    _, aux = load_checkpoint(tmp_path / "port" / "checkpoints" / "model_3.ckpt")
    assert aux["lr_scheduler"] == ours.lr_scheduler.state_dict()
    resumed = _port_trainer("sisr", tree, tmp_path / "port2", num_epochs=4,
                            scheduler=optim.StepLR(step_size=1, gamma=0.5))
    resumed.load(tmp_path / "port" / "checkpoints" / "model_3.ckpt")
    assert optim.get_learning_rate(resumed.optimizer) == lr
    assert resumed.lr_scheduler.last_epoch == 3


def test_reduce_lr_on_plateau_steps_on_the_validation_loss(tree, tmp_path):
    trainer = _port_trainer(
        "sisr", tree, tmp_path, num_epochs=2,
        scheduler=optim.ReduceLROnPlateau(factor=0.1, patience=0,
                                          threshold=10.0))
    trainer.train()  # threshold 10: the second epoch cannot count as better
    assert optim.get_learning_rate(trainer.optimizer) == pytest.approx(LR * 0.1)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh_axes={"data": 2}), "mesh_axes"),
    (dict(pipe_microbatches=2), "pipe_microbatches"),
    (dict(zero_optim=True), "zero_optim"), (dict(fsdp=True), "fsdp"),
    (dict(qat=True, mesh_axes={"pipe": 2}), "qat"),
    (dict(sharded_ckpt=True), "sharded_ckpt")])
def test_refused_trainer_keywords_raise_by_name(tree, tmp_path, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        _port_trainer("sisr", tree, tmp_path, **kwargs)


@pytest.mark.parametrize("kwargs", [dict(t_bucket=16), dict(anything=1)])
def test_unknown_trainer_keywords_raise(tree, tmp_path, kwargs):
    with pytest.raises(TypeError, match=next(iter(kwargs))):
        _port_trainer("sisr", tree, tmp_path, **kwargs)


@pytest.mark.parametrize("name", [
    "AcdcSISRSRFBTrainer", "Dsb15SISRSRFBTrainer", "AcdcMISRTrainer",
    "AcdcFRVSRTrainer", "Acdc3DSRTrainer", "Dsb154DSRTrainer"])
def test_trainers_not_ported_raise_by_name(name):
    ported_since = {"SRFB": trainers.SISRSRFBTrainer,
                    "FRVSR": trainers.FRVSRTrainer,
                    "MISR": trainers.MISRTrainer,
                    "3DSR": trainers.VolumeTrainer,
                    "4DSR": trainers.Volume4DTrainer}
    for family, cls in ported_since.items():
        if family in name:
            assert issubclass(get_class("trainer", name), cls)
            return
    with pytest.raises(NotImplementedError, match=name):
        get_class("trainer", name)()


def test_dsb15_twins_denormalize_with_their_own_statistics():
    for name, stats in (("Dsb15SISRTrainer", "dsb15"),
                        ("Dsb15VSRTrainer", "dsb15"),
                        ("AcdcVSRTrainer", "acdc")):
        assert get_class("trainer", name).dataset_stats == stats


def test_a_net_that_is_not_float32_raises(tree, tmp_path):
    """A bf16-compute net keeps float32 parameters and is taken; a net whose
    parameters were cast to bf16 is refused."""
    trainer_kwargs = dict(TASKS["vsr"])

    def make(net):
        return trainers.AcdcVSRTrainer(
            train_dataloader=None, valid_dataloader=None, net=net,
            loss_fns=[], loss_weights=[], metric_fns=[],
            optimizer=optim.Adam(), lr_scheduler=None, logger=None,
            monitor=None, num_epochs=1, device="cpu")

    net = models.DRFNet(**trainer_kwargs["net_kwargs"], dtype="bfloat16")
    assert make(net).net is net
    with pytest.raises(ValueError, match="float32"):
        make(net.to(torch.bfloat16))


# ----------------------------------------------- the config-driven entry


def _config(task, tree, saved_dir, num_epochs=2, **main_kwargs):
    t = TASKS[task]
    cfg = load_config(f"configs/train/acdc_{task}_"
                      f"{'edsr' if task == 'sisr' else 'drf'}_x2.yaml")
    cfg.main.saved_dir = str(saved_dir)
    cfg.main.update(main_kwargs)
    cfg.dataset.kwargs.data_dir = str(tree / t["sub"])
    cfg.dataset.kwargs.augments = AUGMENTS
    cfg.dataset.kwargs.update(t["ds_kwargs"])
    cfg.dataloader.kwargs.update(train_batch_size=BATCH, num_workers=2)
    cfg.net.kwargs = t["net_kwargs"]
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs = {"num_epochs": num_epochs, "device": "cpu"}
    return cfg


@pytest.fixture(scope="module")
def cli_run(tree, tmp_path_factory):
    """``python -m vsr_tpu_torch.main <config>`` on the VSR task."""
    saved = tmp_path_factory.mktemp("cli")
    save_config(_config("vsr", tree, saved / "run"), saved / "cfg.yaml")
    port_main.main([str(saved / "cfg.yaml")])
    return saved


def test_main_trains_from_the_yaml_schema(cli_run, tree):
    run = cli_run / "run"
    assert load_config(run / "config.yaml") == load_config(cli_run / "cfg.yaml")
    assert len(_logs(run)) == 2
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "model_1.ckpt", "model_2.ckpt", "model_best.ckpt"]
    # The same config run through run_train gives the same weights: the
    # net's init comes from the config's seed.
    trainer = port_main.run_train(_config("vsr", tree, cli_run / "again"))
    state, _ = load_checkpoint(run / "checkpoints" / "model_2.ckpt")
    assert _same(state["net"], _params(trainer))


def test_main_resumes_from_loaded_path_and_auto_resume(cli_run, tree):
    straight = port_main.run_train(
        _config("vsr", tree, cli_run / "straight", num_epochs=3))
    loaded = port_main.run_train(_config(
        "vsr", tree, cli_run / "loaded", num_epochs=3,
        loaded_path=str(cli_run / "run" / "checkpoints" / "model_2.ckpt")))
    assert _same(_params(loaded), _params(straight))
    assert [r["epoch"] for r in _logs(cli_run / "loaded")] == [3]
    # auto_resume: the same directory, more epochs.
    auto = port_main.run_train(_config("vsr", tree, cli_run / "run",
                                       num_epochs=3, auto_resume=True))
    assert _same(_params(auto), _params(straight))
    assert [r["epoch"] for r in _logs(cli_run / "run")] == [1, 2, 3]


def test_main_device_flag_overrides_the_config(tree, tmp_path):
    cfg = _config("sisr", tree, tmp_path / "run", num_epochs=1)
    cfg.trainer.kwargs.device = "meta"  # would fail if it were used
    trainer = port_main.run_train(cfg, device="cpu")
    assert trainer.device.type == "cpu"
    assert next(trainer.net.parameters()).device.type == "cpu"


def test_main_default_device_is_cuda(tree, tmp_path):
    cfg = _config("sisr", tree, tmp_path / "run", num_epochs=1)
    del cfg.trainer.kwargs["device"]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        port_main.run_train(cfg)  # no fallback to the CPU


def test_main_refuses_test_mode_distributed_and_unknown_keywords(tree, tmp_path):
    save_config(_config("sisr", tree, tmp_path / "run"), tmp_path / "c.yaml")
    # --test is ported; a training config, which has no predictor section,
    # is refused by name.
    with pytest.raises(ValueError, match="predictor section"):
        port_main.main([str(tmp_path / "c.yaml"), "--test"])
    cfg = _config("sisr", tree, tmp_path / "run")
    cfg.main.distributed = {"coordinator_address": "x:1"}
    with pytest.raises(NotImplementedError, match="distributed"):
        port_main.run_train(cfg)
    cfg = _config("sisr", tree, tmp_path / "run")
    cfg.trainer.kwargs.t_bucket = 16
    with pytest.raises(TypeError, match="t_bucket"):
        port_main.run_train(cfg)
    cfg = _config("sisr", tree, tmp_path / "run")
    cfg.trainer.kwargs.sharded_ckpt = True
    with pytest.raises(NotImplementedError, match="sharded_ckpt"):
        port_main.run_train(cfg)


def test_infer_checkpoint_serves_the_trained_file_and_refuses_a_flax_one(
        cli_run, tree, rng, tmp_path):
    from flax import serialization

    src = tmp_path / "raw" / "patientA"
    vol = rng.integers(0, 1200, (24, 24, 1, 3)).astype(np.int16)
    save_nifti(vol, src / "patientA_4d.nii.gz")
    ckpt = cli_run / "run" / "checkpoints" / "model_best.ckpt"
    args = [str(tmp_path / "raw"), "--video", "--device", "cpu", "--psnr",
            "--net", "DRFNet", "--net-kwargs",
            json.dumps(TASKS["vsr"]["net_kwargs"])]
    trained = infer.main([args[0], str(tmp_path / "trained"), *args[1:],
                          "--checkpoint", str(ckpt)])
    seeded = infer.main([args[0], str(tmp_path / "seeded"), *args[1:]])
    assert np.isfinite(trained["psnr_mean"])
    a = load_nifti(tmp_path / "trained" / "patientA" / "patientA_4d_sr.nii.gz")
    b = load_nifti(tmp_path / "seeded" / "patientA" / "patientA_4d_sr.nii.gz")
    assert a.shape == (24, 24, 1, 3) and not np.array_equal(a, b)
    # The served frames are the trained net's own.
    state, _ = load_checkpoint(ckpt)
    net = models.DRFNet(**TASKS["vsr"]["net_kwargs"])
    net.load_state_dict(state["net"])
    from vsr_tpu_torch.preprocess.intensity import clip_outliers_minmax
    frames = torch.from_numpy(np.moveaxis(clip_outliers_minmax(
        load_nifti(src / "patientA_4d.nii.gz"))[:, :, 0], -1, 0).copy())
    _, sr = infer.make_pipeline(net, 2, "acdc", video_t=3)(frames)
    np.testing.assert_array_equal(np.moveaxis(sr.numpy(), 0, -1), a[:, :, 0])

    flax_file = tmp_path / "flax.ckpt"
    flax_file.write_bytes(serialization.msgpack_serialize(
        {"params": {"w": np.zeros((2, 2), np.float32)}}))
    with pytest.raises(SystemExit, match="flax msgpack"):
        infer.main([args[0], str(tmp_path / "o"), *args[1:],
                    "--checkpoint", str(flax_file)])
    wrong = dict(TASKS["vsr"]["net_kwargs"], num_groups=3)
    with pytest.raises(RuntimeError, match="state_dict"):  # strict
        infer.main([args[0], str(tmp_path / "o"), *args[1:4], "--net",
                    "DRFNet", "--net-kwargs", json.dumps(wrong),
                    "--checkpoint", str(ckpt)])
