"""The offline tools and the single-card trainer knobs of the port against
``vsr_tpu`` on the CPU, at small sizes, inputs made from a seed with numpy.

- DICOM (``io/dicom.py``): explicit and implicit VR, rescale, instance
  order, the majority shape, the refusal of a compressed transfer syntax,
  and ``convert_dsb15``'s NIfTI trees byte-equal to JAX's.
- imageops and cropping: the four image operations bit-equal, ``find_bbox``
  equal on moving blobs and on a sequence without motion,
  ``coordinates.pkl`` byte-equal (a merge included), the GIFs decoding to
  the cropped frames.
- Preprocessing: ``split_paths`` equal; the float64 frame downscale
  bit-equal (its matmul route and its einsum route); the ACDC and DSB15 trees of the
  numpy backend byte-equal to JAX's, statistics included, malformed series
  skipped, whatever the number of writer threads; the torch backend on the
  CPU against JAX's ``jax`` backend and against numpy at >= 98 % exact and
  <= 1 grey; ``--backend jax`` refused with exit 1; no silent fallback.
- Profiling: ``trace`` writes a trace and ``None`` nothing; ``StepTimer``'s
  summary has JAX's keys; a trainer of each family with ``profile_dir``
  traces epoch 2 only.
- Async checkpoints (``tests/test_async_ckpt.py``'s cases): the writer's
  file equals a sync file, a snapshot survives an in-place update, writes
  land in order, a worker's error surfaces, a trainer's async saves equal
  its sync saves (both families), ``load`` drains the writer.
- Native decode: the port's library built with g++, decoding bit-equal to
  ``io/nifti.load_nifti`` as float32, batch decode, a missing file raising,
  datasets giving the same samples with ``native_decode`` on and off.

Grouped tests through ``tests/_torch_cases.run_cases`` (ROADMAP.md, queue
3, says why the count of tests matters)."""

from __future__ import annotations

import logging
import pickle
import random
import struct
import subprocess
import sys
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from tests._torch_cases import run_cases, subdir
from tests.synth import make_processed_tree
from tests.test_dicom import write_dicom
from vsr_tpu.io import dicom as jdicom
from vsr_tpu.io import nifti as jnifti
from vsr_tpu.preprocess import acdc as jacdc
from vsr_tpu.preprocess import cropping as jcropping
from vsr_tpu.preprocess import dsb15 as jdsb15
from vsr_tpu.preprocess import imageops as jimageops
from vsr_tpu.preprocess import kspace as jkspace
from vsr_tpu.preprocess import pipeline as jpipeline
from vsr_tpu.utils import profiling as jprofiling
from vsr_tpu_torch import losses, metrics, models, optim
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.io import dicom, native, nifti
from vsr_tpu_torch.preprocess import (acdc, cropping, dsb15, imageops, kspace,
                                      pipeline)
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.utils import checkpoint as ckpt_module
from vsr_tpu_torch.utils import profiling
from vsr_tpu_torch.utils.checkpoint import (AsyncCheckpointWriter,
                                            load_checkpoint, save_checkpoint)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_tree(got: Path, want: Path) -> None:
    a, b = _tree_bytes(got), _tree_bytes(want)
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))[:8]
    differ = [k for k in a if a[k] != b[k]]
    assert not differ, differ[:8]


def _within_grey(got: np.ndarray, want: np.ndarray) -> None:
    """JAX's own bar between its two backends (tests/test_preprocess.py)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got == want).mean() >= 0.98
    assert np.abs(got.astype(np.float64) - want).max() <= 1.0


def _gif_frames(path: Path) -> list[np.ndarray]:
    with Image.open(path) as im:
        return [np.asarray(f.convert("L")) for f in ImageSequence.Iterator(im)]


# ------------------------------------------------------------------- DICOM


def _dicom_series(root: Path, rng, n: int, shape=(10, 12), explicit=True,
                  slope=None, intercept=None, odd_first: bool = False):
    """``n`` frames written under shuffled file names; returns the frames in
    InstanceNumber order."""
    root.mkdir(parents=True, exist_ok=True)
    frames = [(rng.random(shape) * 1000).astype(np.uint16) for _ in range(n)]
    if odd_first:  # instance 1 off the series' majority shape
        frames[0] = (rng.random((shape[0] - 2, shape[1])) * 1000).astype(np.uint16)
    order = rng.permutation(n)
    for name_i, k in enumerate(order):
        write_dicom(root / f"IM{name_i:03d}.dcm", frames[k], instance=int(k) + 1,
                    explicit=explicit, slope=slope, intercept=intercept)
    return frames


def _compressed(path: Path, rng) -> None:
    """A file whose transfer syntax is RLE Lossless (same length UID)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    write_dicom(path, (rng.random((4, 4)) * 9).astype(np.uint16), instance=1)
    raw = path.read_bytes()
    path.write_bytes(raw.replace(b"1.2.840.10008.1.2.1", b"1.2.840.10008.1.2.5"))


def test_dicom_reader_and_conversion_match_jax(tmp_path, rng):
    def series(explicit):
        d = subdir(tmp_path, f"series_{explicit}")
        frames = _dicom_series(d / "s", rng, 5, explicit=explicit)
        paths = sorted((d / "s").glob("*.dcm"))
        got, want = dicom.series_to_array(paths), jdicom.series_to_array(paths)
        assert got.shape == (10, 12, 1, 5)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, :, 0], np.stack(frames, -1))
        for p in paths:
            a, b = dicom.read_dicom(p), jdicom.read_dicom(p)
            assert (a.rows, a.cols, a.instance_number, a.pixel_spacing) == (
                b.rows, b.cols, b.instance_number, b.pixel_spacing)

    def rescale():
        d = subdir(tmp_path, "rescale")
        frames = _dicom_series(d, rng, 3, slope=2.5, intercept=-100)
        paths = sorted(d.glob("*.dcm"))
        got = dicom.series_to_array(paths)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jdicom.series_to_array(paths))
        np.testing.assert_array_equal(
            got[:, :, 0], np.stack(frames, -1).astype(np.float32) * 2.5 - 100)

    def majority_shape():
        d = subdir(tmp_path, "majority")
        frames = _dicom_series(d, rng, 4, odd_first=True)
        paths = sorted(d.glob("*.dcm"))
        got = dicom.series_to_array(paths)
        np.testing.assert_array_equal(got, jdicom.series_to_array(paths))
        np.testing.assert_array_equal(got[:, :, 0], np.stack(frames[1:], -1))

    def compressed_refused():
        path = subdir(tmp_path, "rle") / "f.dcm"
        _compressed(path, rng)
        for reader in (dicom.read_dicom, jdicom.read_dicom):
            with pytest.raises(ValueError, match=r"1\.2\.840\.10008\.1\.2\.5"):
                reader(path)

    def convert_tree():
        raw = subdir(tmp_path, "dsb15_raw")
        _dicom_series(raw / "train" / "1" / "study" / "sax_5", rng, 6)
        _dicom_series(raw / "train" / "1" / "study" / "sax_6", rng, 4,
                      slope=1.0, intercept=3)
        _dicom_series(raw / "validate" / "2" / "study" / "sax_7", rng, 6,
                      explicit=False)
        _dicom_series(raw / "test" / "3" / "study" / "sax_9", rng, 2,
                      odd_first=True, shape=(8, 6))
        _compressed(raw / "test" / "3" / "study" / "sax_10" / "a.dcm", rng)
        ours, theirs = subdir(tmp_path, "ours"), subdir(tmp_path, "theirs")
        dicom.convert_dsb15(raw, ours)
        jdicom.convert_dsb15(raw, theirs)
        _assert_same_tree(ours, theirs)
        assert (ours / "valid" / "2" / "sax_7" / "sax_7.nii.gz").exists()
        assert not (ours / "test" / "3" / "sax_10").exists()
        assert nifti.load_nifti(
            ours / "train" / "1" / "sax_5" / "sax_5.nii.gz").dtype == np.int16
        # The CLI writes the same tree.
        cli = subdir(tmp_path, "cli")
        dicom.main([str(raw), str(cli)])
        _assert_same_tree(cli, theirs)

    run_cases([("explicit", lambda: series(True)),
               ("implicit", lambda: series(False)),
               ("rescale", rescale), ("majority shape", majority_shape),
               ("compressed syntax", compressed_refused),
               ("convert_dsb15 tree", convert_tree)])


# ---------------------------------------------------- imageops and cropping


def _moving_blob_sequence(h=64, w=64, t=12, dy=6, dx=0, amp=250.0, width=60.0):
    """tests/test_preprocess.py's moving blob, with its motion as arguments."""
    data = np.zeros((h, w, 1, t), dtype=np.float32)
    yy, xx = np.mgrid[:h, :w]
    for i in range(t):
        cy = h // 2 + int(dy * np.cos(2 * np.pi * i / t))
        cx = w // 2 + int(dx * np.sin(2 * np.pi * i / t))
        data[..., 0, i] = amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / width)
    return data


def _blob_tree(root: Path, patients: dict[str, dict], sequences: int = 2) -> Path:
    """A ``videos/<type>/HR`` tree of moving blobs, one patient per entry."""
    for name, kw in patients.items():
        for s in range(1, sequences + 1):
            seq = np.round(_moving_blob_sequence(**kw, dy=kw.get("dy", 6) + s))
            nifti.save_nifti(seq, root / name / f"{name}_2d+1d_sequence{s:02d}.nii.gz")
    return root


def test_imageops_and_cropping_match_jax(tmp_path, rng):
    def ops():
        img = (rng.random((37, 29)) * 255).astype(np.float32)
        u8 = (rng.random((40, 33)) * 255).astype(np.uint8)
        bimodal = np.concatenate([rng.normal(60, 9, 500), rng.normal(190, 12, 700)])
        bimodal = np.clip(bimodal, 0, 255).astype(np.uint8).reshape(30, 40)
        mask = rng.random((31, 27)) > 0.6
        for x in (img, u8):
            got, want = imageops.gaussian_blur5(x), jimageops.gaussian_blur5(x)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for x in (u8, bimodal, np.zeros((5, 5), np.uint8)):
            assert imageops.otsu_threshold(x) == jimageops.otsu_threshold(x)
        for name in ("binary_close", "binary_open"):
            np.testing.assert_array_equal(getattr(imageops, name)(mask),
                                          getattr(jimageops, name)(mask))

    def bbox():
        cases = [dict(), dict(h=72, w=60, t=10, dy=8, dx=5),
                 dict(h=48, w=80, t=16, dy=3, dx=9, width=30.0),
                 dict(h=50, w=50, t=8, dy=0, dx=0)]  # no motion
        for kw in cases:
            data = _moving_blob_sequence(**kw)
            assert cropping.find_bbox(data) == jcropping.find_bbox(data)
        still = _moving_blob_sequence(h=50, w=50, dy=0)
        assert cropping.find_bbox(still) == (0, 50, 0, 50)

    def coordinates_and_gifs():
        patients = {"valid": {"patient004": dict(), "patient005": dict(dx=4)},
                    "test": {"patient101": dict(h=72, w=60, t=10)}}
        trees = {t: _blob_tree(subdir(tmp_path, f"hr_{t}"), p)
                 for t, p in patients.items()}
        ours, theirs = subdir(tmp_path, "crop_ours"), subdir(tmp_path, "crop_theirs")
        for t in ("valid", "test"):  # the second run merges into the map
            coords = cropping.run(trees[t], ours)
            assert coords == jcropping.run(trees[t], theirs)
        assert ((ours / "coordinates.pkl").read_bytes()
                == (theirs / "coordinates.pkl").read_bytes())
        with open(ours / "coordinates.pkl", "rb") as f:
            merged = pickle.load(f)
        assert sorted(merged) == ["patient004", "patient005", "patient101"]
        for t, pats in patients.items():
            for name in pats:
                h0, hn, w0, wn = merged[name]
                for src in sorted((trees[t] / name).glob("*.nii.gz")):
                    seq = nifti.load_nifti(src)[:, :, 0].astype(np.uint8)
                    gif = src.name.replace(".nii.gz", ".gif")
                    want = [seq[h0:hn, w0:wn, k] for k in range(seq.shape[-1])]
                    for root in (ours, theirs):
                        got = _gif_frames(root / name / gif)
                        assert len(got) == len(want)
                        for a, b in zip(got, want):
                            np.testing.assert_array_equal(a, b)
        # The CLI merges into the same map.
        cropping.main([str(trees["valid"]), str(ours)])
        assert (ours / "coordinates.pkl").read_bytes() == (
            theirs / "coordinates.pkl").read_bytes()

    run_cases([("imageops", ops), ("find_bbox", bbox),
               ("coordinates.pkl and GIFs", coordinates_and_gifs)])


# ------------------------------------------------------------ preprocessing


def _acdc_raw(root: Path, rng, patients: int = 5, shape=(30, 28, 2, 4)) -> Path:
    for i in range(1, patients + 1):
        vol = rng.integers(0, 900, shape).astype(np.int16)
        nifti.save_nifti(vol, root / "training" / f"patient{i:03d}"
                         / f"patient{i:03d}_4d.nii.gz")
    vol = rng.integers(0, 900, shape).astype(np.int16)
    nifti.save_nifti(vol, root / "testing" / "patient101" / "patient101_4d.nii.gz")
    return root


def _dsb15_nifti(root: Path, rng) -> Path:
    """Converted DSB15 sequences: good (H, W, 1, 30) series, a 20-frame one
    and a two-slice one (both skipped)."""
    good = (26, 25, 1, 30)
    series = {("train", "1", "sax_5"): good, ("train", "1", "sax_6"): (26, 25, 1, 20),
              ("train", "1", "sax_7"): good, ("valid", "2", "sax_3"): good,
              ("valid", "2", "sax_4"): (26, 25, 2, 30), ("test", "3", "sax_9"): good}
    for (type_, patient, sax), shape in series.items():
        vol = rng.integers(0, 700, shape).astype(np.int16)
        nifti.save_nifti(vol, root / type_ / patient / sax / f"{sax}.nii.gz")
    return root


def _stats_lines(caplog) -> list[str]:
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("The mean and the standard")]


def test_preprocessing_matches_jax(tmp_path, rng, caplog, monkeypatch):
    caplog.set_level(logging.INFO)

    def split():
        root = subdir(tmp_path, "split")
        for i in range(10):
            nifti.save_nifti(np.zeros((4, 4, 1, 2), np.float32),
                             root / "training" / f"patient{i:03d}"
                             / f"patient{i:03d}_4d.nii.gz")
        (root / "testing").mkdir()
        got = acdc.split_paths(root)
        assert got == jacdc.split_paths(root)
        assert [len(got[k]) for k in ("train", "valid", "test")] == [8, 2, 0]
        random.seed(0)  # the split does not depend on the caller's state
        assert acdc.split_paths(root) == got

    def numpy_downscale():
        # The float64 frame path: two matmuls where the factor divides the
        # frame, vsr_tpu's einsum elsewhere; the same bits either way.
        for shape in ((48, 60), (72, 36, 1), (25, 26), (30, 31, 1)):
            img = np.round(rng.random(shape) * 255)
            for f in (2, 3, 4):
                got = kspace.kspace_downscale(img, f)
                want = jkspace.kspace_downscale(img, f)
                assert got.shape == want.shape and got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)

    def acdc_numpy_tree():
        raw = _acdc_raw(subdir(tmp_path, "acdc_raw"), rng)
        theirs = subdir(tmp_path, "acdc_theirs")
        caplog.clear()
        jacdc.run(raw, theirs, backend="numpy")
        want_stats = _stats_lines(caplog)
        for threads in (1, 3):  # the bytes do not depend on the threads
            monkeypatch.setattr(nifti, "WRITER_THREADS", threads)
            ours = subdir(tmp_path, f"acdc_ours_{threads}")
            caplog.clear()
            stats = acdc.run(raw, ours, backend="numpy")
            assert _stats_lines(caplog) == want_stats
            assert list(stats) == ["train", "valid", "test"]
            _assert_same_tree(ours, theirs)
        assert len(want_stats) == 3
        names = {p.name for p in (theirs / "videos" / "test" / "LR" / "X3"
                                  / "patient101").iterdir()}
        assert names == {"patient101_2d+1d_sequence01.nii.gz",
                         "patient101_2d+1d_sequence02.nii.gz"}

    def dsb15_numpy_tree():
        raw = _dsb15_nifti(subdir(tmp_path, "dsb_raw"), rng)
        theirs, ours = subdir(tmp_path, "dsb_theirs"), subdir(tmp_path, "dsb_ours")
        caplog.clear()
        jdsb15.run(raw, theirs, backend="numpy")
        want_stats = _stats_lines(caplog)
        caplog.clear()
        monkeypatch.setattr(nifti, "WRITER_THREADS", 2)
        dsb15.run(raw, ours, backend="numpy")
        assert _stats_lines(caplog) == want_stats
        _assert_same_tree(ours, theirs)
        hr = sorted(p.name for p in (ours / "videos" / "train" / "HR" / "1").iterdir())
        # sax_6 (20 frames) is skipped but keeps its index: sequences 01, 03.
        assert hr == ["1_2d+1d_sequence01.nii.gz", "1_2d+1d_sequence03.nii.gz"]
        assert not (ours / "videos" / "valid").exists() or not any(
            (ours / "videos" / "valid").rglob("*sequence02*"))

    def torch_backend():
        data = np.round(rng.random((24, 24, 1, 4)) * 255).astype(np.float32)
        for f in (2, 3, 4):
            got = pipeline.downscale_sequence(data, f, backend="torch",
                                              device="cpu")
            _within_grey(got, jpipeline.downscale_sequence(data, f, backend="jax"))
            _within_grey(got, pipeline.downscale_sequence(data, f,
                                                          backend="numpy"))
            assert got.shape == (24 // f, 24 // f, 1, 4)
        raw = _acdc_raw(subdir(tmp_path, "acdc_raw_torch"), rng, patients=3)
        numpy_out = subdir(tmp_path, "acdc_numpy")
        acdc.run(raw, numpy_out, backend="numpy")
        torch_out = subdir(tmp_path, "acdc_torch")
        acdc.main([str(raw), str(torch_out), "--device", "cpu"])
        a, b = _tree_bytes(torch_out), _tree_bytes(numpy_out)
        assert sorted(a) == sorted(b)
        for name in a:
            if "/HR/" in name:
                assert a[name] == b[name], name
            else:
                _within_grey(nifti.load_nifti(torch_out / name),
                             nifti.load_nifti(numpy_out / name))
        with pytest.raises(ValueError, match="Unknown backend"):
            pipeline.downscale_sequence(data, 2, backend="jax")
        if not torch.cuda.is_available():  # no silent fallback to numpy
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pipeline.downscale_sequence(data, 2, backend="torch")
            # The default backend is torch on the card: refused before a
            # file is written.
            with pytest.raises(RuntimeError, match="no CUDA device"):
                acdc.run(raw, tmp_path / "no_card")
            assert not (tmp_path / "no_card").exists()

    def nifti_writer():
        monkeypatch.setattr(nifti, "WRITER_THREADS", 3)
        out, vol = subdir(tmp_path, "writer"), rng.random((5, 4, 3))
        with nifti.NiftiWriter() as writer:
            for i in range(4):
                writer.save(vol + i, out / f"v{i}.nii.gz")
        for i in range(4):
            np.testing.assert_array_equal(
                nifti.load_nifti(out / f"v{i}.nii.gz"), vol + i)
        # A write's error surfaces at close ...
        (out / "file").write_bytes(b"")
        writer = nifti.NiftiWriter()
        writer.save(vol, out / "file" / "under_a_file.nii.gz")
        with pytest.raises(OSError):
            writer.close()
        # ... but does not replace an error raised inside the block.
        with pytest.raises(KeyError, match="inside"):
            with nifti.NiftiWriter() as writer:
                writer.save(vol, out / "file" / "under_a_file.nii.gz")
                raise KeyError("inside")

    def jax_backend_refused():
        raw = subdir(tmp_path, "refused")
        proc = subprocess.run(
            [sys.executable, "-m", "vsr_tpu_torch.preprocess.acdc", str(raw),
             str(raw / "out"), "--backend", "jax"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 1, proc.stderr[-2000:]
        assert "use --backend torch" in proc.stderr
        with pytest.raises(SystemExit, match="use --backend torch"):
            dsb15.main([str(raw), str(raw / "out"), "--backend", "jax"])
        with pytest.raises(SystemExit, match="use --backend torch"):
            acdc.run(raw, raw / "out", backend="jax")
        assert not (raw / "out").exists()

    run_cases([("split_paths", split), ("numpy downscale", numpy_downscale),
               ("ACDC numpy tree", acdc_numpy_tree),
               ("DSB15 numpy tree", dsb15_numpy_tree),
               ("torch backend", torch_backend),
               ("NiftiWriter", nifti_writer),
               ("--backend jax", jax_backend_refused)])


# ------------------------------------------- trainers: profile and async


NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
CROP = [{"name": "RandomHorizontalFlip"},
        {"name": "RandomCropPatch", "kwargs": {"size": [4, 4], "ratio": 2}}]
NET_KWARGS = dict(in_channels=1, out_channels=1, num_resblocks=1,
                  num_features=4, upscale_factor=2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=16,
                               frames=4, patients_per_type=1, slices=2)


def _trainer(tree, saved: Path, family: str = "host", num_epochs: int = 2,
             **kwargs):
    """A small EDSR trainer on the CPU: the host-loop ``AcdcSISRTrainer``
    or the device-epoch ``AcdcSISRDeviceTrainer``."""
    device = family == "device"
    data = dict(data_dir=tree / "imgs", downscale_factor=2, transforms=NORM,
                augments=None if device else CROP)
    extra = dict(patch=4, ratio=2, steps_per_epoch=3) if device else {}
    name = "AcdcSISRDeviceTrainer" if device else "AcdcSISRTrainer"
    net = models.EDSRNet(**NET_KWARGS, generator=torch.Generator().manual_seed(3))
    return get_class("trainer", name)(
        train_dataloader=Dataloader(datasets.AcdcSISRDataset(type="train", **data),
                                    batch_size=2, shuffle=True),
        valid_dataloader=Dataloader(datasets.AcdcSISRDataset(type="valid", **data),
                                    batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], optimizer=optim.Adam(lr=1e-3),
        lr_scheduler=None, logger=None,
        monitor=Monitor(checkpoints_dir=saved, mode="min", target="Loss",
                        saved_freq=1, early_stop=0),
        num_epochs=num_epochs, device="cpu", **extra, **kwargs)


def _state(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}


def _assert_same_checkpoint(a: Path, b: Path) -> None:
    (sa, aux_a), (sb, aux_b) = load_checkpoint(a), load_checkpoint(b)
    assert aux_a == aux_b
    for part in ("net", "chain"):
        assert (sa[part] is None) == (sb[part] is None)
    for k, v in sa["net"].items():
        assert torch.equal(v, sb["net"][k]), k
    oa, ob = sa["optimizer"], sb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                ob["state"][i][k])), (i, k)


def test_profiling_trace_and_step_timer(tmp_path, tree):
    def trace_context():
        out = tmp_path / "trace"
        with profiling.trace(out):
            torch.randn(64, 64) @ torch.randn(64, 64)
        files = list(out.glob("trace_*.json"))
        assert len(files) == 1 and files[0].stat().st_size > 0
        assert profiling.kernel_events(files[0]) == []  # no card here
        before = set(tmp_path.rglob("*"))
        with profiling.trace(None):
            torch.ones(3).sum()
        assert set(tmp_path.rglob("*")) == before

    def step_timer():
        ours, theirs = profiling.StepTimer(), jprofiling.StepTimer()
        assert ours.summary() == theirs.summary() == {}
        for t in (ours, theirs):
            for _ in range(3):
                t.start()
                t.stop()
        ours.start()
        ours.stop({"x": (torch.ones(2), [torch.zeros(1)])})
        assert sorted(ours.summary()) == sorted(theirs.summary())
        assert ours.summary()["steps"] == 4

    def epoch_two_only(family):
        saved = subdir(tmp_path, f"profiled_{family}")
        trainer = _trainer(tree, saved / "ckpt", family, num_epochs=3,
                           profile_dir=str(saved / "trace"))
        seen, run_epoch = [], trainer._run_epoch

        def spy(mode, epoch):
            if mode == "validation":
                seen.append(sorted(p.name for p in (saved / "trace").glob("*"))
                            if (saved / "trace").exists() else [])
            return run_epoch(mode, epoch)

        trainer._run_epoch = spy
        trainer.train()
        assert seen[0] == [] and len(seen[1]) == 1 and seen[2] == seen[1]

    run_cases([("trace", trace_context), ("StepTimer", step_timer),
               ("host-loop trainer", lambda: epoch_two_only("host")),
               ("device trainer", lambda: epoch_two_only("device"))])


def test_async_checkpoints(tmp_path, tree, rng):
    def state(v=None):
        w = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)
                             if v is None else np.full((2,), v, np.float32))
        return {"net": {"w": w, "b16": torch.ones(4, dtype=torch.bfloat16) / 3},
                "optimizer": {"state": {0: {"step": torch.tensor(5.0)}},
                              "param_groups": [{"lr": 0.1, "params": [0]}]},
                "chain": None}

    def matches_sync_file():
        s, aux = state(), {"epoch": 3, "note": "x"}
        save_checkpoint(subdir(tmp_path, "sync") / "model.ckpt", s, aux)
        w = AsyncCheckpointWriter()
        w.submit(subdir(tmp_path, "async") / "model.ckpt", s, aux)
        w.wait()
        assert ((tmp_path / "sync" / "model.ckpt").read_bytes()
                == (tmp_path / "async" / "model.ckpt").read_bytes())
        assert w._queue.maxsize == 2

    def survives_update():
        s, aux = state(), {"tag": ["keep"]}
        want = s["net"]["w"].clone()
        w, release = AsyncCheckpointWriter(), threading.Event()

        def held_save(*args):  # the write waits until the state has moved
            release.wait(60)
            return save_checkpoint(*args)

        with mock.patch.object(ckpt_module, "save_checkpoint", held_save):
            w.submit(tmp_path / "snap.ckpt", s, aux)
            s["net"]["w"].add_(99)  # in place, as an optimizer updates
            aux["tag"].append("mutated")
            release.set()
            w.wait()
        got, got_aux = load_checkpoint(tmp_path / "snap.ckpt")
        assert torch.equal(got["net"]["w"], want) and got_aux["tag"] == ["keep"]

    def in_order():
        w = AsyncCheckpointWriter()
        for i in range(5):
            w.submit(tmp_path / "order.ckpt", state(float(i)))
        w.wait()
        got, _ = load_checkpoint(tmp_path / "order.ckpt")
        assert torch.equal(got["net"]["w"], torch.full((2,), 4.0))

    def error_surfaces():
        w = AsyncCheckpointWriter()
        blocker = subdir(tmp_path, "dir_in_the_way")
        w.submit(blocker, state())  # the target is a directory: an IO error
        with pytest.raises(RuntimeError, match="async checkpoint"):
            w.wait()
        w.submit(tmp_path / "ok.ckpt", state())  # the error is cleared
        w.wait()
        assert (tmp_path / "ok.ckpt").exists()
        w.submit(blocker, state())
        w._queue.join()
        with pytest.raises(RuntimeError, match="async checkpoint"):
            w.submit(tmp_path / "later.ckpt", state())  # at the next submit

    def trainer_saves(family):
        runs = {}
        for mode in ("sync", "async"):
            saved = subdir(tmp_path, f"{family}_{mode}")
            t = _trainer(tree, saved, family, async_ckpt=mode == "async")
            t.train()  # a save every epoch, drained at the end
            runs[mode] = saved
        names = sorted(p.name for p in runs["sync"].glob("*.ckpt"))
        assert names == sorted(p.name for p in runs["async"].glob("*.ckpt"))
        assert "model_2.ckpt" in names
        for name in names:
            _assert_same_checkpoint(runs["async"] / name, runs["sync"] / name)
            assert ((runs["async"] / name).read_bytes()
                    == (runs["sync"] / name).read_bytes()), name

    def load_drains():
        saved = subdir(tmp_path, "drain")
        t = _trainer(tree, saved, async_ckpt=True, num_epochs=1)
        t.train()
        want = _state(t)
        t.save(saved / "model.ckpt")
        with torch.no_grad():
            for p in t.net.parameters():
                p.add_(1.0)
        t.load(saved / "model.ckpt")
        got = _state(t)
        assert all(torch.equal(got[k], want[k]) for k in want)

    run_cases([("file equals a sync file", matches_sync_file),
               ("snapshot survives an in-place update", survives_update),
               ("writes land in order", in_order),
               ("errors surface", error_surfaces),
               ("host-loop trainer", lambda: trainer_saves("host")),
               ("device trainer", lambda: trainer_saves("device")),
               ("load drains", load_drains)])


# ------------------------------------------------------------ native decode


def test_native_decode(tmp_path, rng, tree):
    def library():
        assert native.available()
        assert native.library_path().exists()
        assert native.library_path().parent == REPO / "vsr_tpu_torch" / "_build"

    def bit_equal():
        arrays = {"f32.nii.gz": rng.standard_normal((17, 9, 3)).astype(np.float32),
                  "f32.nii": rng.standard_normal((5, 7)).astype(np.float32),
                  "i16.nii.gz": rng.integers(-900, 900, (6, 5, 2, 3)).astype(np.int16),
                  "u8.nii": rng.integers(0, 255, (4, 4)).astype(np.uint8),
                  "f64.nii.gz": rng.standard_normal((3, 3, 3))}
        for name, a in arrays.items():
            nifti.save_nifti(a, tmp_path / name)
            got = native.load_nifti_native(tmp_path / name)
            want = nifti.load_nifti(tmp_path / name).astype(np.float32)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert got.flags.f_contiguous  # the Python reader's order
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, jnifti.load_nifti(tmp_path / name).astype(np.float32))

    def scaled():
        a = rng.integers(-900, 900, (6, 5, 4)).astype(np.int16)
        for slope, inter in ((0.37, 12.5), (1.0, -3.25), (0.0, 7.0), (2.0, 0.0)):
            nifti.save_nifti(a, tmp_path / "s.nii")
            raw = bytearray((tmp_path / "s.nii").read_bytes())
            struct.pack_into("<2f", raw, 112, slope, inter)
            (tmp_path / "s.nii").write_bytes(bytes(raw))
            want = nifti.load_nifti(tmp_path / "s.nii").astype(np.float32)
            np.testing.assert_array_equal(
                native.load_nifti_native(tmp_path / "s.nii"), want)

    def batch_and_errors():
        paths = sorted((tree / "videos" / "train").rglob("*.nii.gz"))
        got = native.load_nifti_batch(paths, n_threads=3)
        for p, g in zip(paths, got):
            np.testing.assert_array_equal(g, nifti.load_nifti(p).astype(np.float32))
        missing = tmp_path / "missing.nii.gz"
        with pytest.raises(OSError, match="open/read"):
            native.load_nifti_native(missing)
        with pytest.raises(OSError, match="missing.nii.gz"):
            native.load_nifti_batch([paths[0], missing])
        (tmp_path / "short.nii").write_bytes(
            (tmp_path / "f32.nii").read_bytes()[:400])
        with pytest.raises(OSError, match="header or truncated"):
            native.load_nifti_native(tmp_path / "short.nii")
        (tmp_path / "tiny.nii").write_bytes(b"\0" * 100)  # no header at all
        with pytest.raises(OSError, match="header"):
            native.load_nifti_native(tmp_path / "tiny.nii")

    def datasets_agree():
        for cls, sub, kw in ((datasets.AcdcSISRDataset, "imgs", {}),
                             (datasets.AcdcVSRDataset, "videos",
                              {"num_frames": 3})):
            args = dict(data_dir=tree / sub, type="train", downscale_factor=2,
                        transforms=NORM, augments=CROP, **kw)
            on, off = cls(native_decode=True, **args), cls(**args)
            assert len(on) == len(off)
            for i in range(len(on)):
                a = on.__getitem__(i, rng=np.random.default_rng(i))
                b = off.__getitem__(i, rng=np.random.default_rng(i))
                for key in b:
                    np.testing.assert_array_equal(a[key], b[key])

    run_cases([("library", library), ("bit-equal", bit_equal),
               ("scaled", scaled), ("batch and errors", batch_and_errors),
               ("datasets", datasets_agree)])
