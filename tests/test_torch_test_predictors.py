"""The test path as a whole: every predictor family of the port against
``vsr_tpu``'s predictor on the same tiny tree and weights (rows of
``results.csv``, the log, PNGs and GIF frames), both walks of the data, and
``python -m vsr_tpu_torch.main <config> --test`` on a checkpoint that the
port's trainer wrote."""

import csv
import pickle

import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from tests._torch_parity import init, randomize
from tests.synth import make_processed_tree
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import models as jmodels
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.ops import pallas_duf
from vsr_tpu.runner import predictors as jpredictors
from vsr_tpu_torch import losses, metrics, models
from vsr_tpu_torch import main as port_main
from vsr_tpu_torch.config import load_config, save_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.runner import predictors
from vsr_tpu_torch.utils.checkpoint import load_checkpoint

TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]
AUGMENTS = [{"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 2}}]
HR, FRAMES = 24, 6
FAMILIES = {
    "sisr": dict(dataset="AcdcSISRDataset", sub="imgs", ds_kwargs={},
                 predictor="AcdcSISRPredictor", net="EDSRNet",
                 net_kwargs=dict(in_channels=1, out_channels=1, num_resblocks=2,
                                 num_features=8, upscale_factor=2),
                 example=(1, 12, 12, 1)),
    "srfb": dict(dataset="AcdcSISRDataset", sub="imgs", ds_kwargs={},
                 predictor="AcdcSISRSRFBPredictor", net="SRFBNet",
                 net_kwargs=dict(in_channels=1, out_channels=1, num_steps=2,
                                 num_features=8, num_groups=2, upscale_factor=2,
                                 fused_squeeze=True),
                 example=(1, 12, 12, 1)),
    "misr": dict(dataset="AcdcMISRDataset", sub="videos",
                 ds_kwargs={"num_frames": 7},
                 predictor="AcdcMISRPredictor", net="DUFNet",
                 net_kwargs=dict(in_channels=1, out_channels=1, num_frames=7,
                                 size_filter=3, upscale_factor=2,
                                 use_pallas_filter=True),
                 example=(1, 7, 12, 12, 1)),
    "vsr": dict(dataset="AcdcVSRDataset", sub="videos",
                ds_kwargs={"num_frames": 3},
                predictor="AcdcVSRPredictor", net="DRFNet",
                net_kwargs=dict(in_channels=1, out_channels=1, num_features=8,
                                num_groups=2, upscale_factor=2,
                                fused_squeeze=True),
                example=(1, 3, 12, 12, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def interpret_mode():
    """Run ``duf_dynamic_filter_pallas`` in the Pallas interpreter, as the
    JAX package's own tests do on the CPU."""
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return original(*args, **kwargs)

    patch = pytest.MonkeyPatch()
    patch.setattr(pallas_duf.pl, "pallas_call", interp)
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()
    yield
    patch.undo()
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # test: 2 patients x 2 slices x 6 frames of 24 x 24 (24 SISR samples, 24
    # MISR windows, 4 sequences); train / valid for the end-to-end run.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=HR,
                               types=("train", "valid", "test"), frames=FRAMES,
                               patients_per_type=2, slices=2)


@pytest.fixture(scope="module")
def coordinates(tmp_path_factory):
    path = tmp_path_factory.mktemp("cropped") / "coordinates.pkl"
    with open(path, "wb") as f:
        pickle.dump({"patient001": (3, 20, 5, 24), "patient002": (0, 13, 8, 21)}, f)
    return str(path)


def _dataset(module, family, tree):
    f = FAMILIES[family]
    return getattr(module, f["dataset"])(
        data_dir=tree / f["sub"], type="test", downscale_factor=2,
        transforms=TRANSFORMS, **f["ds_kwargs"])


def _read(saved):
    """(csv rows, {png path: grey array}, {gif path: [grey frames]})."""
    with open(saved / "results.csv", newline="") as f:
        rows = list(csv.reader(f))
    pngs = {str(p.relative_to(saved)): np.array(Image.open(p).convert("L"))
            for p in sorted(saved.glob("imgs/**/*.png"))}
    gifs = {}
    for p in sorted(saved.glob("videos/**/*.gif")):
        with Image.open(p) as im:
            frames = []
            for i in range(im.n_frames):
                im.seek(i)
                frames.append(np.array(im.convert("L")))
        gifs[str(p.relative_to(saved))] = frames
    return rows, pngs, gifs


@pytest.fixture(scope="module")
def jax_results(tree, coordinates, interpret_mode, tmp_path_factory):
    """Every family through the JAX predictor, once: its weights, log and
    exported files."""
    results = {}
    for family, f in FAMILIES.items():
        saved = tmp_path_factory.mktemp(f"jax_{family}")
        net = getattr(jmodels, f["net"])(**f["net_kwargs"])
        init_kwargs = {"train": False} if family == "misr" else {}
        variables = randomize(init(net, np.zeros(f["example"], np.float32),
                                   seed=7, **init_kwargs),
                              np.random.default_rng(7))
        predictor = getattr(jpredictors, f["predictor"])(
            test_dataloader=JaxDataloader(_dataset(jdatasets, family, tree),
                                          batch_size=1),
            net=net, loss_fns=[jlosses.L1Loss(), jlosses.MSELoss()],
            loss_weights=[1.0, 0.5],
            metric_fns=[jmetrics.PSNR(), jmetrics.SSIM(),
                        jmetrics.CardiacPSNR(coordinates),
                        jmetrics.CardiacSSIM(coordinates)],
            saved_dir=str(saved), exported=True)
        predictor.params = variables
        log = predictor.predict()
        results[family] = dict(variables=variables, log=log, files=_read(saved))
    return results


def _port_predictor(family, tree, coordinates, variables, saved, **kwargs):
    f = FAMILIES[family]
    net = getattr(models, f["net"])(**f["net_kwargs"], device="cpu")
    load_jax_params(net, variables)
    return getattr(predictors, f["predictor"])(
        test_dataloader=Dataloader(_dataset(datasets, family, tree),
                                   batch_size=1, num_workers=2),
        net=net, loss_fns=[losses.L1Loss(), torch.nn.MSELoss()],
        loss_weights=[1.0, 0.5],
        metric_fns=[metrics.PSNR(), metrics.SSIM(),
                    metrics.CardiacPSNR(coordinates),
                    metrics.CardiacSSIM(coordinates)],
        saved_dir=str(saved), exported=True, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def port_results(tree, coordinates, jax_results, tmp_path_factory):
    results = {}
    for family in FAMILIES:
        saved = tmp_path_factory.mktemp(f"port_{family}")
        predictor = _port_predictor(family, tree, coordinates,
                                    jax_results[family]["variables"], saved)
        log = predictor.predict()
        results[family] = dict(saved=saved, log=log, files=_read(saved))
    return results


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predictor_rows_and_log_match_jax(family, jax_results, port_results):
    want_rows, _, _ = jax_results[family]["files"]
    got_rows, _, _ = port_results[family]["files"]
    assert got_rows[0] == want_rows[0] == [
        "name", "PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM", "L1Loss",
        "MSELoss"]
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
    assert len(got_rows) == 1 + 2 * 2 * FRAMES  # a row per frame
    first = "patient001_2d_slice01_frame01"
    assert got_rows[1][0] == first
    got = np.array([[float(v) for v in r[1:]] for r in got_rows[1:]])
    want = np.array([[float(v) for v in r[1:]] for r in want_rows[1:]])
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.isfinite(got).all() and got[:, 0].std() > 0
    # The Cardiac columns score the crop, not the frame.
    assert np.abs(got[:, 0] - got[:, 2]).max() > 1e-2
    log, want_log = port_results[family]["log"], jax_results[family]["log"]
    assert list(log) == list(want_log) == [
        "Loss", "L1Loss", "MSELoss", "PSNR", "SSIM", "CardiacPSNR",
        "CardiacSSIM"]
    for key, value in want_log.items():
        assert log[key] == pytest.approx(value, abs=1e-3), key
    assert log["Loss"] == pytest.approx(log["L1Loss"] + 0.5 * log["MSELoss"],
                                        abs=1e-5)
    assert log["PSNR"] == pytest.approx(got[:, 0].mean(), abs=1e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predictor_pngs_and_gifs_match_jax(family, jax_results, port_results):
    _, want_pngs, want_gifs = jax_results[family]["files"]
    _, got_pngs, got_gifs = port_results[family]["files"]
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == 2 * 2 * FRAMES
    assert "imgs/patient001/slice01_frame01.png" in got_pngs
    assert list(got_gifs) == list(want_gifs) == [
        f"videos/patient00{p}/sequence0{s}.gif" for p in (1, 2) for s in (1, 2)]
    got = np.stack(list(got_pngs.values())).astype(int)
    want = np.stack(list(want_pngs.values())).astype(int)
    assert got.shape[1:] == (HR, HR)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.999
    assert got.std() > 1  # images, not a constant
    for name, frames in got_gifs.items():
        assert len(frames) == len(want_gifs[name]) == FRAMES
        # A GIF holds the frames of its PNGs, in order.
        patient, seq = name.split("/")[1], name.split("sequence")[1][:2]
        for t, frame in enumerate(frames):
            np.testing.assert_array_equal(
                frame, got_pngs[f"imgs/{patient}/slice{seq}_frame{t + 1:02d}.png"])
            assert np.abs(frame.astype(int) - want_gifs[name][t]).max() <= 1


@pytest.mark.parametrize("family", ["sisr", "srfb", "misr"])
def test_both_walks_of_the_data_give_the_same_rows_and_files(
        family, tree, coordinates, jax_results, port_results, tmp_path):
    predictor = _port_predictor(family, tree, coordinates,
                                jax_results[family]["variables"], tmp_path,
                                sequence_batch=False)
    log = predictor.predict()
    assert log == port_results[family]["log"]
    saved = port_results[family]["saved"]
    files = sorted(str(p.relative_to(saved)) for p in saved.rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path))
                           for p in tmp_path.rglob("*") if p.is_file())
    for name in files:
        assert (tmp_path / name).read_bytes() == (saved / name).read_bytes(), name


def test_a_shuffling_loader_takes_the_frame_walk_and_nothing_exported_writes_nothing(
        tree, coordinates, jax_results, tmp_path):
    f = FAMILIES["sisr"]
    net = models.EDSRNet(**f["net_kwargs"], device="cpu")
    load_jax_params(net, jax_results["sisr"]["variables"])
    predictor = predictors.AcdcSISRPredictor(
        test_dataloader=Dataloader(_dataset(datasets, "sisr", tree),
                                   batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], saved_dir=str(tmp_path / "never"),
        device="cpu")
    log = predictor.predict()
    assert log["PSNR"] == pytest.approx(jax_results["sisr"]["log"]["PSNR"],
                                        abs=1e-3)
    assert not (tmp_path / "never").exists()
    assert not any(p.requires_grad and p.grad is not None
                   for p in net.parameters())


def test_vsr_predictor_scores_a_tuple_output_on_its_first_element(
        tree, coordinates, jax_results, port_results, tmp_path):
    predictor = _port_predictor("vsr", tree, coordinates,
                                jax_results["vsr"]["variables"], tmp_path)
    inner = predictor.net

    class Tupled(torch.nn.Module):
        def forward(self, x):
            return inner(x), torch.zeros(1)

    predictor.net = Tupled()
    assert predictor.predict() == port_results["vsr"]["log"]


@pytest.mark.parametrize("name", ["Acdc3DSRPredictor", "Dsb153DSRPredictor",
                                  "Acdc4DSRPredictor", "Dsb154DSRPredictor"])
def test_volume_predictors_raise_by_name(name):
    # Ported since the volumetric slice: each name resolves to its family,
    # with the JAX twin's statistics.
    cls = get_class("predictor", name)
    base = (predictors.VolumePredictor if "3DSR" in name
            else predictors.Volume4DPredictor)
    assert issubclass(cls, base)
    assert cls.dataset_stats == getattr(jpredictors, name).dataset_stats


@pytest.mark.parametrize("name,base,stats", [
    ("AcdcSISRPredictor", "SISRPredictor", "acdc"),
    ("Dsb15SISRPredictor", "SISRPredictor", "dsb15"),
    ("AcdcSISRSRFBPredictor", "SISRSRFBPredictor", "acdc"),
    ("Dsb15SISRSRFBPredictor", "SISRSRFBPredictor", "dsb15"),
    ("AcdcMISRPredictor", "MISRPredictor", "acdc"),
    ("Dsb15MISRPredictor", "MISRPredictor", "dsb15"),
    ("AcdcVSRPredictor", "VSRPredictor", "acdc"),
    ("Dsb15VSRPredictor", "VSRPredictor", "dsb15")])
def test_predictor_twins_carry_the_jax_registry_names(name, base, stats):
    cls = get_class("predictor", name)
    assert issubclass(cls, getattr(predictors, base))
    assert cls.dataset_stats == stats == getattr(jpredictors, name).dataset_stats


def test_predictor_refuses_batches_and_unknown_keywords(tree, coordinates):
    ds = _dataset(datasets, "sisr", tree)
    common = dict(net=models.Bicubic(2), loss_fns=[], loss_weights=[],
                  metric_fns=[], device="cpu")
    with pytest.raises(ValueError, match="batch size should be 1"):
        predictors.AcdcSISRPredictor(Dataloader(ds, batch_size=2), **common)
    with pytest.raises(TypeError, match="t_bucket"):
        predictors.AcdcVSRPredictor(Dataloader(ds, batch_size=1), t_bucket=16,
                                    **common)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        predictors.AcdcSISRPredictor(  # the default device: no fallback
            Dataloader(ds, batch_size=1), models.EDSRNet(
                **FAMILIES["sisr"]["net_kwargs"], device="cpu"), [], [], [])


# ------------------------------------------------- main --test, end to end


def _train_config(tree, saved_dir):
    cfg = load_config("configs/train/acdc_sisr_srfb_x2.yaml")
    cfg.main.saved_dir = str(saved_dir)
    cfg.dataset.kwargs.data_dir = str(tree / "imgs")
    cfg.dataset.kwargs.augments = AUGMENTS
    cfg.dataloader.kwargs.update(train_batch_size=8, num_workers=2)
    cfg.net.kwargs = FAMILIES["srfb"]["net_kwargs"]
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs = {"num_epochs": 2, "device": "cpu"}
    return cfg


def _test_config(name, tree, coordinates, run, sub="imgs"):
    cfg = load_config(f"configs/test/{name}.yaml")
    cfg.main.saved_dir = str(run / "predictions")
    cfg.main.loaded_path = str(run / "checkpoints" / "model_best.ckpt")
    cfg.dataset.kwargs.data_dir = str(tree / sub)
    cfg.dataloader.kwargs.num_workers = 2
    for spec in cfg.metrics:
        if "kwargs" in spec:
            spec.kwargs.coordinates_path = coordinates
    cfg.predictor.kwargs.saved_dir = str(run / "predictions")
    cfg.predictor.kwargs.device = "cpu"
    return cfg


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    run = tmp_path_factory.mktemp("e2e") / "run"
    trainer = port_main.run_train(_train_config(tree, run))
    return run, trainer


def test_main_test_mode_scores_the_checkpoint_the_trainer_wrote(
        trained, tree, coordinates):
    run, trainer = trained
    cfg = _test_config("acdc_sisr_srfb_x2", tree, coordinates, run)
    assert cfg.predictor.name == "AcdcSISRSRFBPredictor"
    cfg.net.kwargs = FAMILIES["srfb"]["net_kwargs"]
    save_config(cfg, run / "test.yaml")
    port_main.main([str(run / "test.yaml"), "--test"])
    rows, pngs, gifs = _read(run / "predictions")
    assert rows[0] == ["name", "PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM",
                       "L1Loss"]
    assert len(rows) == 1 + 24 and len(pngs) == 24 and len(gifs) == 4
    # The rows are the best checkpoint's: the same net scores the same.
    state, _ = load_checkpoint(run / "checkpoints" / "model_best.ckpt")
    net = models.SRFBNet(**FAMILIES["srfb"]["net_kwargs"], device="cpu")
    net.load_state_dict(state["net"])
    sample = _dataset(datasets, "srfb", tree)[0]
    with torch.no_grad():
        steps = net(torch.from_numpy(sample["lr_img"]).permute(2, 0, 1)[None])
    target = torch.from_numpy(sample["hr_img"]).permute(2, 0, 1)[None]
    l1 = torch.nn.functional.l1_loss
    assert float(rows[1][5]) == pytest.approx(  # the mean over the steps
        float(torch.stack([l1(o, target) for o in steps]).mean()), abs=1e-6)
    log = port_main.run_test(cfg, device="cpu")
    assert log["PSNR"] == pytest.approx(
        np.mean([float(r[1]) for r in rows[1:]]), abs=1e-4)


def test_main_test_mode_runs_bicubic_without_a_checkpoint(tree, coordinates,
                                                          tmp_path):
    cfg = _test_config("acdc_sisr_bicubic_x2", tree, coordinates, tmp_path)
    assert cfg.net.name == "Bicubic"
    assert not (tmp_path / "checkpoints").exists()
    log = port_main.run_test(cfg)
    assert np.isfinite(log["PSNR"]) and log["PSNR"] > 5
    assert len(list((tmp_path / "predictions").glob("imgs/**/*.png"))) == 24


def test_main_test_mode_refusals(trained, tree, coordinates, tmp_path):
    run, _ = trained
    cfg = _test_config("acdc_sisr_srfb_x2", tree, coordinates, run)
    cfg.net.kwargs = FAMILIES["srfb"]["net_kwargs"]
    flax_file = tmp_path / "flax.ckpt"
    flax_file.write_bytes(serialization.msgpack_serialize(
        {"params": {"w": np.zeros((2, 2), np.float32)}}))
    cfg.main.loaded_path = str(flax_file)
    with pytest.raises(ValueError, match="flax msgpack"):
        port_main.run_test(cfg)
    cfg = _test_config("acdc_sisr_srfb_x2", tree, coordinates, run)
    cfg.net.kwargs = dict(FAMILIES["srfb"]["net_kwargs"], num_groups=3)
    with pytest.raises(RuntimeError, match="state_dict"):  # strict
        port_main.run_test(cfg)
    cfg = _test_config("acdc_sisr_srfb_x2", tree, coordinates, run)
    cfg.predictor.kwargs.t_bucket = 16
    with pytest.raises(TypeError, match="t_bucket"):
        port_main.run_test(cfg)
    cfg.predictor.name = "Acdc3DSRPredictor"  # builds, then wants volumes
    del cfg.predictor.kwargs["t_bucket"]
    cfg.net.kwargs = FAMILIES["srfb"]["net_kwargs"]
    with pytest.raises(KeyError, match="lr_vol"):
        port_main.run_test(cfg)
    cfg = _test_config("acdc_sisr_srfb_x2", tree, coordinates, run)
    del cfg.predictor.kwargs["device"]
    cfg.net.kwargs = FAMILIES["srfb"]["net_kwargs"]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        port_main.run_test(cfg)  # the default device is the card
