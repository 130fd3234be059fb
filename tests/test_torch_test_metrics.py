"""What the test path adds below the predictors: ``SliceSSIM`` and the
``Cardiac*`` metrics against ``vsr_tpu`` (channels-first here, channels-last
there), the GIF writer and the greyscale PNG writer decoded by PIL /
imageio."""

import pickle

import imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vsr_tpu import metrics as jmetrics
from vsr_tpu_torch import metrics
from vsr_tpu_torch.callbacks.logger import write_png
from vsr_tpu_torch.registry import build
from vsr_tpu_torch.utils.gif import lzw_encode, write_gif


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.fixture
def coordinates(tmp_path):
    path = tmp_path / "coordinates.pkl"
    with open(path, "wb") as f:
        pickle.dump({"patient001": (3, 20, 5, 24), "patient002": (0, 12, 8, 19)}, f)
    return str(path)


def _pair(rng, shape):
    a = np.round(rng.random(shape) * 255).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).round().astype(np.float32)
    return a, b


def _first(x):
    """channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("size_average", [True, False])
def test_slice_ssim_matches_jax(rng, size_average):
    out, tgt = _pair(rng, (2, 3, 16, 18, 1))  # (N, D, H, W, C)
    want = np.asarray(jmetrics.SliceSSIM(size_average=size_average)(
        jnp.asarray(out), jnp.asarray(tgt)))
    got = metrics.SliceSSIM(size_average=size_average)(_first(out), _first(tgt))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("patient", ["patient001", "patient002"])
@pytest.mark.parametrize("name,kwargs", [("CardiacPSNR", {}),
                                         ("CardiacSSIM", {}),
                                         ("CardiacPSNR", {"size_average": False})])
def test_cardiac_metrics_match_jax(rng, coordinates, name, kwargs, patient):
    out, tgt = _pair(rng, (2, 26, 28, 1))
    want = np.asarray(getattr(jmetrics, name)(coordinates, **kwargs)(
        jnp.asarray(out), jnp.asarray(tgt), patient))
    metric = build("metric", {"name": name, "kwargs": {
        "coordinates_path": coordinates, **kwargs}})
    got = metric(_first(out), _first(tgt), patient)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # The crop matters: the whole frame scores differently.
    whole = getattr(metrics, name[len("Cardiac"):])(**kwargs)(_first(out),
                                                             _first(tgt))
    assert not np.allclose(whole.numpy(), got.numpy(), atol=1e-4)


def test_cardiac_metrics_read_the_pickle_lazily_and_carry_the_jax_flags(coordinates):
    metric = metrics.CardiacPSNR("no/such/file.pkl")  # builds
    assert metric.host_only and metric.needs_name
    assert (metric.host_only, metric.needs_name) == (
        jmetrics.CardiacPSNR.host_only, jmetrics.CardiacPSNR.needs_name)
    with pytest.raises(FileNotFoundError):
        metric(torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8, 8), "patient001")
    known = metrics.CardiacSSIM(coordinates)
    with pytest.raises(KeyError, match="patient999"):
        known(torch.zeros(1, 1, 30, 30), torch.zeros(1, 1, 30, 30), "patient999")
    # A 5-D sequence tensor crops on its last two axes as well.
    psnr = metrics.CardiacPSNR(coordinates)
    x = torch.rand(1, 4, 1, 26, 28) * 255
    assert psnr._crop(x, x, "patient001")[0].shape == (1, 4, 1, 17, 19)


@pytest.mark.parametrize("shape", [(24, 24), (7, 5), (1, 1), (64, 96)])
def test_gif_frames_decode_to_the_same_greys(rng, tmp_path, shape):
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    frames = [rng.integers(0, 256, shape, dtype=np.uint8),
              ((yy * 3 + xx) % 256).astype(np.uint8),  # long LZW matches
              np.zeros(shape, np.uint8), np.full(shape, 255, np.uint8)]
    path = tmp_path / "a.gif"
    write_gif(path, frames)
    assert path.read_bytes()[:6] == b"GIF89a"
    with Image.open(path) as im:
        assert im.n_frames == 4 and im.size == (shape[1], shape[0])
        for i, frame in enumerate(frames):
            im.seek(i)
            np.testing.assert_array_equal(np.array(im.convert("L")), frame)
    decoded = imageio.mimread(path)
    assert len(decoded) == 4


def test_lzw_resets_a_full_table_and_gif_refuses_bad_frames(rng, tmp_path):
    # 300 x 300 noise fills the 4096-code table many times over.
    frame = rng.integers(0, 256, (300, 300), dtype=np.uint8)
    write_gif(tmp_path / "big.gif", [frame])
    with Image.open(tmp_path / "big.gif") as im:
        np.testing.assert_array_equal(np.array(im.convert("L")), frame)
    assert lzw_encode(b"") and len(lzw_encode(bytes(1000))) < 100
    with pytest.raises(ValueError, match="at least one"):
        write_gif(tmp_path / "x.gif", [])
    with pytest.raises(ValueError, match="uint8"):
        write_gif(tmp_path / "x.gif", [np.zeros((4, 4), np.float32)])
    with pytest.raises(ValueError, match="equal-sized"):
        write_gif(tmp_path / "x.gif", [np.zeros((4, 4), np.uint8),
                                       np.zeros((4, 5), np.uint8)])


def test_png_writer_takes_grey_and_rgb(rng, tmp_path):
    grey = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    write_png(tmp_path / "g.png", grey)
    with Image.open(tmp_path / "g.png") as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.array(im), grey)
    rgb = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    write_png(tmp_path / "c.png", rgb)
    with Image.open(tmp_path / "c.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.array(im), rgb)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", np.zeros((4, 4, 2), np.uint8))
