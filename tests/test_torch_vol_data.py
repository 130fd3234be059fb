"""The volumetric slice, the data side: the four volume datasets against
``vsr_tpu``'s (every sample bit-equal, train with seeded augments and
valid; the loader's batches; the sample names), the heterogeneous-patient
refusal, and the four volume loggers' grids against the JAX loggers'."""

import numpy as np
import pytest

from tests.synth import make_processed_tree
from vsr_tpu.callbacks import logger as jlogger
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.io.nifti import save_nifti
from vsr_tpu.utils.rng import RngTree as JaxRngTree
from vsr_tpu_torch.callbacks import logger
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.utils.rng import RngTree

TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]
AUGMENTS = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
            {"name": "RandomCropPatch", "kwargs": {"size": [4, 4, 2],
                                                   "ratio": 2}}]
DATASETS = [
    ("AcdcVolumeDataset", {}),
    ("Dsb15VolumeDataset", {"cache_decoded": True}),
    ("AcdcVolumeVSRDataset", {"num_frames": 3}),
    ("Dsb15VolumeVSRDataset", {"num_frames": 4, "temporal_order": "middle"}),
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 2 patients x 3 slices x 5 frames of 16 x 16 per split.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=16,
                               frames=5, patients_per_type=2, slices=3)


def _pair(name, kwargs, tree, type_):
    kw = dict(data_dir=tree / "videos", type=type_, downscale_factor=2,
              transforms=TRANSFORMS, augments=AUGMENTS, **kwargs)
    return get_class("dataset", name)(**kw), getattr(jdatasets, name)(**kw)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name,kwargs", DATASETS)
@pytest.mark.parametrize("type_", ["train", "valid"])
def test_every_sample_equals_jax(tree, name, kwargs, type_):
    ours, theirs = _pair(name, kwargs, tree, type_)
    vsr = "VSR" in name
    # 3D: a sample per (patient, frame); 4D: per (patient, window end) in
    # train, per patient in valid.
    assert len(ours) == len(theirs) == (2 if vsr and type_ == "valid" else 10)
    for i in range(len(ours)):
        assert ours.sample_name(i) == theirs.sample_name(i)
        _assert_same(ours.__getitem__(i, rng=np.random.default_rng(i)),
                     theirs.__getitem__(i, rng=np.random.default_rng(i)))
    sample = ours.__getitem__(0, rng=np.random.default_rng(0))
    key = "lr_vols" if vsr else "lr_vol"
    frames = ((kwargs["num_frames"],) if type_ == "train" else (5,)) if vsr else ()
    lr = (4, 4, 2, 1) if type_ == "train" else (8, 8, 3, 1)
    assert sample[key].shape == (*frames, *lr)
    whole = vsr and type_ == "valid"  # sample 1: patient 2's sequence
    assert ours.sample_name(1) == (f"patient00{1 + whole}", "",
                                   "01" if whole else "02")


@pytest.mark.parametrize("name,kwargs", DATASETS[::3])
def test_loader_batches_equal_jax(tree, name, kwargs):
    ours_ds, theirs_ds = _pair(name, kwargs, tree, "train")
    kw = dict(batch_size=3, shuffle=True, num_workers=2)
    ours, theirs = Dataloader(ours_ds, **kw), JaxDataloader(theirs_ds, **kw)
    n = 0
    for a, b in zip(ours.epoch(RngTree("vsr"), 1),
                    theirs.epoch(JaxRngTree("vsr"), 1), strict=True):
        _assert_same(a, b)
        n += 1
    assert n == len(ours) == 4


def test_volume_datasets_refuse_a_heterogeneous_patient(tree, tmp_path):
    import shutil

    shutil.copytree(tree / "videos", tmp_path / "videos")
    odd = np.zeros((8, 8, 1, 4), np.float32)  # T = 4 beside T = 5
    save_nifti(odd, tmp_path / "videos" / "valid" / "LR" / "X2" / "patient002"
               / "patient002_2d+1d_sequence04.nii.gz")
    kw = dict(data_dir=tmp_path / "videos", type="valid", downscale_factor=2,
              transforms=TRANSFORMS)
    for module in (datasets, jdatasets):
        for name in ("AcdcVolumeDataset", "AcdcVolumeVSRDataset"):
            with pytest.raises(ValueError, match="Patient patient002 has "
                               "heterogeneous slice sequences"):
                getattr(module, name)(**kw)
    with pytest.raises(ValueError, match="temporal order"):
        datasets.AcdcVolumeVSRDataset(temporal_order="first", **{
            **kw, "data_dir": tree / "videos"})


def test_volume_dataset_twins_carry_the_jax_names():
    for name, base in (("Dsb15VolumeDataset", "AcdcVolumeDataset"),
                       ("Dsb15VolumeVSRDataset", "AcdcVolumeVSRDataset"),
                       ("AcdcVolumeVSRDataset", "AcdcVolumeDataset")):
        assert issubclass(get_class("dataset", name), getattr(datasets, base))


@pytest.mark.parametrize("name", ["Acdc3DSRLogger", "Dsb153DSRLogger",
                                  "Acdc4DSRLogger", "Dsb154DSRLogger"])
def test_volume_loggers_draw_the_jax_grids(tmp_path, rng, name):
    if "3DSR" in name:  # batch (N, H, W, D, C), outputs (N, D, H, W, C)
        hr = rng.standard_normal((3, 8, 8, 5, 1)).astype(np.float32)
        batch = {"hr_vol": hr}
        outputs = np.moveaxis(hr, 3, 1) + 0.1 * rng.standard_normal(
            (3, 5, 8, 8, 1)).astype(np.float32)
        want_cls = logger.VolumeLogger
    else:  # batch (N, T, H, W, D, C), outputs (N, T, D, H, W, C)
        hr = rng.standard_normal((2, 3, 8, 8, 4, 1)).astype(np.float32)
        batch = {"hr_vols": hr}
        outputs = np.moveaxis(hr, 4, 2) + 0.1 * rng.standard_normal(
            (2, 3, 4, 8, 8, 1)).astype(np.float32)
        want_cls = logger.Volume4DLogger
    cls = get_class("logger", name)
    assert cls is want_cls
    got = cls(tmp_path / "ours")._make_grid(batch, outputs)
    want = getattr(jlogger, want_cls.__name__)(
        tmp_path / "theirs")._make_grid(batch, outputs)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.std() > 1
    np.testing.assert_array_equal(got, want)
