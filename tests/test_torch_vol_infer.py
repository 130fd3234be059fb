"""Infer's volume mode against the JAX package: the regrouping of the D*T
slice-major frames into volumes (``make_prep``), a tiny Volume3DSRNet and
Volume4DSRNet pipeline against JAX ``make_pipeline`` on the same weights
(>= 99.9 % exact grey, <= 1 grey; ``--fused-tail`` and ``--chunk`` on 3D),
the CLI serving both nets, and the refusals with JAX's messages."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vsr_tpu.infer as jinfer
from tests._torch_parity import init, randomize
from vsr_tpu.models import Volume3DSRNet as JaxVolume3DSRNet
from vsr_tpu.models import Volume4DSRNet as JaxVolume4DSRNet
from vsr_tpu_torch import infer
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.io import nifti
from vsr_tpu_torch.models import Volume3DSRNet, Volume4DSRNet

D, T, SIDE = 3, 4, 24
KW = {"3d": dict(in_channels=1, out_channels=1, num_resblocks=1,
                 num_features=4, upscale_factor=2),
      "4d": dict(in_channels=1, out_channels=1, num_resblocks=1,
                 num_features=4, upscale_factor=2)}
NETS = {"3d": (JaxVolume3DSRNet, Volume3DSRNet),
        "4d": (JaxVolume4DSRNet, Volume4DSRNet)}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frames(rng):
    return np.round(rng.random((D * T, SIDE, SIDE)) * 255).astype(np.float32)


@pytest.mark.parametrize("vmode", ["3d", "4d"])
def test_prep_regroups_the_frames_as_jax_does(rng, vmode):
    frames = _frames(rng)
    _, zj = jinfer.make_prep(2, "acdc", volume=(vmode, T))(jnp.asarray(frames))
    _, z = infer.make_prep(2, "acdc", volume=(vmode, T))(
        torch.from_numpy(frames))
    _, flat = infer.make_prep(2, "acdc")(torch.from_numpy(frames))
    zj = np.asarray(zj)  # (T, D, h, w, 1), "4d" with a leading 1
    if vmode == "4d":
        assert z.shape == (1, T, 1, D, SIDE // 2, SIDE // 2)
        z, zj = z[0], zj[0]
    assert z.shape == (T, 1, D, SIDE // 2, SIDE // 2)
    np.testing.assert_allclose(np.moveaxis(z.numpy(), 1, -1), zj, atol=1e-4)
    for t in range(T):  # frame d*T + t of slice d is depth d of volume t
        for d in range(D):
            assert torch.equal(z[t, 0, d], flat[d * T + t, 0])


def _pipelines(rng, vmode, fused_tail=False, chunk=0):
    jnet = NETS[vmode][0](**KW[vmode], fused_tail=fused_tail)
    example = (1, D, 12, 12, 1) if vmode == "3d" else (1, 2, D, 12, 12, 1)
    variables = randomize(init(jnet, np.zeros(example, np.float32)), rng,
                          zero_scale=0.5)
    net = NETS[vmode][1](**KW[vmode], fused_tail=fused_tail)
    load_jax_params(net, variables)
    jpipe = jax.jit(jinfer.make_pipeline(jnet, variables, 2, "acdc",
                                         volume=(vmode, T), chunk=chunk))
    pipe = infer.make_pipeline(net, 2, "acdc", volume=(vmode, T), chunk=chunk)
    return jpipe, pipe


def _agree(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert diff.max() <= 1.0, diff.max()


@pytest.mark.parametrize("vmode,fused_tail,chunk", [
    ("3d", False, 0), ("3d", True, 3), ("4d", True, 0), ("4d", False, 0)])
def test_volume_pipeline_matches_jax(rng, vmode, fused_tail, chunk):
    frames = _frames(rng)
    jpipe, pipe = _pipelines(rng, vmode, fused_tail, chunk)
    lr_j, sr_j = jpipe(jnp.asarray(frames))
    lr, sr = pipe(torch.from_numpy(frames))
    assert sr.shape == (D * T, SIDE, SIDE)
    _agree(lr.numpy(), np.asarray(lr_j))
    _agree(sr.numpy(), np.asarray(sr_j))
    assert np.asarray(sr_j).std() > 1.0


@pytest.mark.parametrize("vmode", ["3d", "4d"])
def test_cli_serves_the_volume_nets(tmp_path, rng, vmode):
    net = {"3d": "Volume3DSRNet", "4d": "Volume4DSRNet"}[vmode]
    vol = rng.integers(0, 1200, (SIDE, SIDE, D, T)).astype(np.int16)
    nifti.save_nifti(vol, tmp_path / "raw" / "patientA" / "patientA_4d.nii.gz")
    stats = infer.main([str(tmp_path / "raw"), str(tmp_path / "sr"), "--psnr",
                        "--fused-tail", "--device", "cpu", "--net", net,
                        "--net-kwargs", json.dumps(KW[vmode])])
    assert stats["volumes"] == 1 and stats["frames"] == D * T
    assert np.isfinite(stats["psnr_mean"])
    sr = nifti.load_nifti(tmp_path / "sr" / "patientA" / "patientA_4d_sr.nii.gz")
    assert sr.shape == (SIDE, SIDE, D, T) and 0 <= sr.min() <= sr.max() <= 255
    assert getattr(infer.get_class("net", net), "serving_mode") == "volume"
    assert infer.VOLUME_NETS[net] == vmode


@pytest.mark.parametrize("net,flags", [
    ("Volume3DSRNet", ["--video"]),
    ("Volume4DSRNet", ["--windows", "3"]),
    ("Volume4DSRNet", ["--chunk", "2"])])
def test_cli_refuses_volume_flags_with_jax_messages(tmp_path, net, flags):
    video, windows = "--video" in flags, 3 if "--windows" in flags else 0
    chunk = 2 if "--chunk" in flags else 0
    with pytest.raises(ValueError) as want:
        jinfer.resolve_volume(net, video=video, windows=windows, seq_t=T,
                              chunk=chunk)
    with pytest.raises(SystemExit) as got:
        infer.run(infer.parse_args([str(tmp_path), str(tmp_path / "o"),
                                    "--device", "cpu", "--net", net, *flags]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [
    dict(seq_t=0), dict(seq_t=T, n_frames=D * T + 1), dict(seq_t=T),
    dict(seq_t=T, chunk=4)])
@pytest.mark.parametrize("net", ["Volume3DSRNet", "Volume4DSRNet", "DRFNet"])
def test_resolve_volume_answers_as_jax(net, kwargs):
    outcome = []
    for fn in (jinfer.resolve_volume, infer.resolve_volume):
        try:
            outcome.append(("ok", fn(net, **kwargs)))
        except ValueError as err:
            outcome.append(("raised", str(err)))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("kw,match", [
    (dict(volume=("3d", T), video_t=T), "excludes video_t/window"),
    (dict(volume=("4d", T), chunk=2), "chunk has no effect on 4D")])
def test_pipeline_refuses_bad_volume_combinations(kw, match):
    with pytest.raises(ValueError, match=match):
        infer.make_pipeline(Volume4DSRNet(1, 1, 4, 1), 2, "acdc", **kw)
