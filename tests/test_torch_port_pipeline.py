"""The port's serving slices against the JAX package: the numpy helpers it
copies (bit-equal), the k-space LR simulation, the whole pipeline in video,
frame and window modes on the same weights, and the CLI running where jax,
flax and yaml cannot be imported."""

import ast
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vsr_tpu.infer as jinfer
from tests._torch_cases import run_cases
from tests._torch_parity import init, randomize
from vsr_tpu.data.datasets import misr_target_index as jax_misr_target_index
from vsr_tpu.io import nifti as jnifti
from vsr_tpu.models import DRFNet as JaxDRFNet
from vsr_tpu.models import DUFNet as JaxDUFNet
from vsr_tpu.models import MoEEDSRNet as JaxMoEEDSRNet
from vsr_tpu.preprocess import intensity as jintensity
from vsr_tpu.preprocess import kspace as jkspace
from vsr_tpu.preprocess import resize as jresize
from vsr_tpu.utils.normalize import DATASET_STATS as JAX_STATS
from vsr_tpu_torch import infer
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.io import nifti
from vsr_tpu_torch.models import DRFNet, DUFNet, MoEEDSRNet
from vsr_tpu_torch.models.duf import misr_target_index
from vsr_tpu_torch.preprocess import intensity, kspace, resize
from vsr_tpu_torch.utils.normalize import DATASET_STATS

REPO = Path(__file__).resolve().parents[1]


def _variables(jnet, shape, seed, **kw):
    """The net's variables drawn with numpy over its traced shapes
    (``tests/_torch_parity.init``: no flax init compiled), biases and other
    constant leaves randomized."""
    return randomize(init(jnet, np.zeros(shape, np.float32), seed=seed, **kw),
                     np.random.default_rng(seed))


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _agree(got, want, what):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff == 0).mean() >= 0.999, f"{what}: {(diff == 0).mean()} exact"
    assert diff.max() <= 1.0, f"{what}: max diff {diff.max()}"


# ------------------------------------------------------- copied helpers (d)


def test_nifti_copy_is_bit_equal(tmp_path, rng):
    vol = rng.integers(-500, 1500, (9, 7, 3, 2)).astype(np.int16)
    for ext in ("nii", "nii.gz"):
        a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        jnifti.save_nifti(vol, a)
        nifti.save_nifti(vol, b)
        assert a.read_bytes() == b.read_bytes()
        got, want = nifti.load_nifti(a), jnifti.load_nifti(a)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_intensity_copies_are_bit_equal(rng, dtype):
    vol = (rng.random((20, 18, 2, 3)) * 900).astype(dtype)
    np.testing.assert_array_equal(intensity.clip_outliers_minmax(vol),
                                  jintensity.clip_outliers_minmax(vol))
    for shape in [(20, 18), (25, 37), (192, 192), (13, 11)]:
        assert (intensity.center_crop_multiple(shape)
                == jintensity.center_crop_multiple(shape))


@pytest.mark.parametrize("n_in,n_out", [(48, 24), (96, 48), (192, 96),
                                        (37, 12)])
def test_matrix_copies_are_bit_equal(n_in, n_out):
    np.testing.assert_array_equal(resize.bicubic_resize_matrix(n_in, n_out),
                                  jresize.bicubic_resize_matrix(n_in, n_out))
    for factor in (2, 3, 4):
        np.testing.assert_array_equal(
            kspace.kspace_lowpass_matrix(n_in, factor),
            jkspace.kspace_lowpass_matrix(n_in, factor))
    assert DATASET_STATS == JAX_STATS


@pytest.mark.parametrize("nf", range(1, 10))
def test_misr_target_index_copy_is_equal(nf):
    assert misr_target_index(nf) == jax_misr_target_index(nf)


# ------------------------------------------------------------- k-space (c)


def test_resize_matches_jax(rng):
    img = (rng.random((3, 48, 40)) * 255).astype(np.float32)
    want = np.asarray(jresize.resize_bicubic_jax(jnp.asarray(img), 24, 20))
    got = resize.resize_bicubic_torch(torch.from_numpy(img), 24, 20).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_kspace_downscale_matches_jax_and_numpy(rng):
    imgs = np.round(rng.random((3, 48, 48)) * 255).astype(np.float32)
    got = kspace.kspace_downscale_torch(torch.from_numpy(imgs), 2).numpy()
    assert got.shape == (3, 24, 24) and got.dtype == np.float32
    want_jax = np.asarray(jax.jit(
        lambda x: jkspace.kspace_downscale_jax(x, 2))(imgs))
    _agree(got, want_jax, "vs kspace_downscale_jax")
    for i in range(3):
        want_np = jkspace.kspace_downscale(imgs[i][..., None], 2)[..., 0]
        _agree(got[i], want_np, "vs numpy kspace_downscale")


# ---------------------------------------------------------- whole slice (e)


@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_video_pipeline_matches_jax(rng, fused_squeeze):
    d, t, side = 2, 4, 48
    kw = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
              upscale_factor=2, fused_tail=True, fused_squeeze=fused_squeeze)
    jnet = JaxDRFNet(**kw)
    variables = _variables(jnet, (1, 2, side // 2, side // 2, 1), seed=0)
    frames = np.round(rng.random((d * t, side, side)) * 255).astype(np.float32)
    lr_j, sr_j = jinfer.make_pipeline(jnet, variables, 2, "acdc",
                                      video_t=t)(frames)

    net = DRFNet(**kw)
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, variables))
    lr_t, sr_t = infer.make_pipeline(net, 2, "acdc", video_t=t)(
        torch.from_numpy(frames))
    assert lr_t.shape == (d * t, side // 2, side // 2)
    assert sr_t.shape == (d * t, side, side)
    _agree(lr_t.numpy(), np.asarray(lr_j), "lr")
    _agree(sr_t.numpy(), np.asarray(sr_j), "sr")
    assert np.asarray(sr_j).std() > 1.0  # not a constant image


MOE_KW = dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=8,
              upscale_factor=2, num_experts=2, group_size=128, moe_every=1,
              fused_tail=True)


def _frame_nets(router_impl, dispatch_impl):
    kw = dict(MOE_KW, router_impl=router_impl, dispatch_impl=dispatch_impl)
    jnet = JaxMoEEDSRNet(**kw)
    variables = _variables(jnet, (1, 12, 12, 1), seed=1)
    net = MoEEDSRNet(**kw)
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, variables))
    return jnet, variables, net


@pytest.mark.parametrize("router_impl,dispatch_impl,chunk", [
    ("rank_pallas", "dense", 0), ("rank_pallas", "sparse", 4),
    ("rank", "sparse", 0), ("rank", "dense", 5)])
def test_frame_pipeline_matches_jax(rng, router_impl, dispatch_impl, chunk):
    d, t, side = 2, 5, 24  # N = 10 frames; chunk 4 does not divide it
    jnet, variables, net = _frame_nets(router_impl, dispatch_impl)
    frames = np.round(rng.random((d * t, side, side)) * 255).astype(np.float32)
    lr_j, sr_j = jinfer.make_pipeline(jnet, variables, 2, "acdc",
                                      chunk=chunk)(frames)
    lr_t, sr_t = infer.make_pipeline(net, 2, "acdc", chunk=chunk)(
        torch.from_numpy(frames))
    assert sr_t.shape == (d * t, side, side)
    _agree(lr_t.numpy(), np.asarray(lr_j), "lr")
    _agree(sr_t.numpy(), np.asarray(sr_j), "sr")
    assert np.asarray(sr_j).std() > 1.0
    whole = infer.make_pipeline(net, 2, "acdc")(torch.from_numpy(frames))[1]
    assert torch.equal(sr_t, whole)  # chunked == unchunked, exactly


def _window_nets(nf, use_pallas_filter, rng):
    kw = dict(in_channels=1, out_channels=1, num_frames=nf, size_filter=3,
              upscale_factor=2, use_pallas_filter=use_pallas_filter)
    jnet = JaxDUFNet(**kw)
    variables = _variables(jnet, (1, nf, 8, 8, 1), seed=2, train=False)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(0.5, 1.5, leaf.shape) if
                            path[-1].key == "var" else
                            0.2 * rng.standard_normal(leaf.shape)
                            ).astype(np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    net = DUFNet(**kw)
    load_jax_params(net, variables)
    return jnet, variables, net


@pytest.fixture
def duf_interpret_mode(monkeypatch):
    """``duf_dynamic_filter_pallas`` in the Pallas interpreter (CPU)."""
    import vsr_tpu.ops.pallas_duf as pallas_duf
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return original(*args, **kwargs)

    monkeypatch.setattr(pallas_duf.pl, "pallas_call", interp)
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()
    yield
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()


@pytest.mark.parametrize("nf,order,chunk,use_pallas_filter", [
    (7, "middle", 0, True), (7, "last", 4, False),
    (8, "middle", 5, False), (8, "last", 0, True)])
def test_window_pipeline_matches_jax(rng, duf_interpret_mode, nf, order,
                                     chunk, use_pallas_filter):
    d, t, side = 2, 9, 16  # N = 18 windows; chunks 4 and 5 do not divide it
    jnet, variables, net = _window_nets(nf, use_pallas_filter, rng)
    frames = np.round(rng.random((d * t, side, side)) * 255).astype(np.float32)
    lr_j, sr_j = jinfer.make_pipeline(
        jnet, variables, 2, "acdc", window=(nf, t, order), train_flag=True,
        chunk=chunk)(frames)
    lr_t, sr_t = infer.make_pipeline(
        net, 2, "acdc", window=(nf, t, order), chunk=chunk)(
        torch.from_numpy(frames))
    assert sr_t.shape == (d * t, side, side)
    _agree(lr_t.numpy(), np.asarray(lr_j), "lr")
    _agree(sr_t.numpy(), np.asarray(sr_j), "sr")
    assert np.asarray(sr_j).std() > 1.0
    whole = infer.make_pipeline(net, 2, "acdc", window=(nf, t, order))(
        torch.from_numpy(frames))[1]
    assert torch.equal(sr_t, whole)  # chunked == unchunked, exactly


@pytest.mark.parametrize("nf,order", [(5, "middle"), (5, "last"),
                                      (4, "middle"), (4, "last")])
def test_window_gather_matches_jax(rng, nf, order):
    frames = np.round(rng.random((2 * 6, 24, 24)) * 255).astype(np.float32)
    _, z_j = jinfer.make_prep(2, "acdc", window=(nf, 6, order))(
        jnp.asarray(frames))
    _, z_t = infer.make_prep(2, "acdc", window=(nf, 6, order))(
        torch.from_numpy(frames))
    assert z_t.shape == (12, nf, 1, 12, 12)
    np.testing.assert_allclose(z_t[:, :, 0].numpy(), np.asarray(z_j)[..., 0],
                               rtol=1e-4, atol=2e-3)
    # Output frame t sits at its window's target slot.
    slot = misr_target_index(nf) if order == "middle" else nf - 1
    _, z_f = infer.make_prep(2, "acdc")(torch.from_numpy(frames))
    assert torch.equal(z_t[:, slot], z_f)


def test_pipeline_refuses_bad_mode_combinations():
    # One grouped test (tests/_torch_cases.py; ROADMAP.md, queue 3, on the
    # count of collected tests).
    def refused(kw, match):
        with pytest.raises(ValueError, match=match):
            infer.make_pipeline(DRFNet(1, 1, 4, 2, 2), 2, "acdc", **kw)

    run_cases([(match, functools.partial(refused, kw, match))
               for kw, match in (
        (dict(video_t=3, chunk=2), "already sequence-batched"),
        (dict(chunk=-1), "chunk must be >= 0"),
        (dict(video_t=3, window=(3, 3, "middle")), "mutually exclusive"),
        (dict(window=(3, 3, "first")), "'middle' or 'last'"))])


@pytest.mark.parametrize("flag,match", [
    (["--checkpoint", "m.ckpt"], "--checkpoint: no such file"),
    (["--preset", "fast"], None),
    (["--mesh", "data=4,spatial=2"], "not yet ported"),
    (["--windows", "5"], "mutually exclusive"),
    (["--chunk", "4"], "already sequence-batched"),
    (["--preset", "tuned"], None)])
def test_cli_refuses_unported_flags(tmp_path, flag, match):
    argv = [str(tmp_path), str(tmp_path / "o"), "--video", "--device", "cpu",
            *flag]
    if match is None:
        # --preset is ported: main fills the knobs the user left at their
        # defaults from the card's table (a DRFNet entry: whole-sequence
        # serving), explicit flags win, and the volume is served.
        from vsr_tpu_torch.presets import SERVING_PRESETS, apply_cli_preset

        kw = {"in_channels": 1, "out_channels": 1, "num_features": 8,
              "num_groups": 2, "upscale_factor": 2}
        nifti.save_nifti(np.round(np.random.default_rng(0).random(
            (24, 24, 1, 3)) * 255).astype(np.float32),
            tmp_path / "p1" / "p1_4d.nii")
        argv += ["--net", "DRFNet", "--net-kwargs", json.dumps(kw)]
        args = infer.parse_args(argv)
        notes = apply_cli_preset(args)
        entry = SERVING_PRESETS["DRFNet"]
        assert json.loads(args.net_kwargs) == {**kw,
                                               **entry.get("net_kwargs", {})}
        assert args.video and args.chunk == 0
        if flag[1] == "fast" and entry.get("w8a8") == "scales":
            assert not args.w8a8 and any("w8a8 skipped" in n for n in notes)
        stats = infer.main(argv)
        assert stats["frames"] == 3
        return
    with pytest.raises(SystemExit, match=match):
        infer.run(infer.parse_args(argv))


def test_cli_requires_video(tmp_path):
    # ... for a sequence net: each net is served in its own mode.
    with pytest.raises(SystemExit, match="--video"):
        infer.run(infer.parse_args([str(tmp_path), str(tmp_path / "o"),
                                    "--device", "cpu", "--net", "DRFNet"]))


@pytest.mark.parametrize("args,match", [
    (["--net", "DUFNet"], "--windows N"),
    (["--net", "DUFNet", "--video"], "--windows N"),
    (["--net", "MoEEDSRNet", "--video"], "neither --video nor --windows"),
    (["--net", "EDSRNet", "--windows", "7"], "neither --video nor --windows"),
    (["--net", "EDSRNet", "--chunk", "-2"], "must be >= 0"),
    (["--net", "DUFNet", "--windows", "-7"], "must be >= 0"),
])
def test_cli_refuses_a_net_in_the_wrong_mode(tmp_path, args, match):
    with pytest.raises(SystemExit, match=match):
        infer.run(infer.parse_args([str(tmp_path), str(tmp_path / "o"),
                                    "--device", "cpu", *args]))


# ------------------------------------------------------- stands alone (f)

_BLOCKED_RUN = """
import json, sys
sys.modules['jax'] = sys.modules['flax'] = sys.modules['yaml'] = None
import torch
torch.set_num_threads(2)
from vsr_tpu_torch import infer
stats = infer.main(sys.argv[1:])
stats['leaked'] = sorted(m for m in sys.modules
                         if m.split('.')[0] in ('jax', 'flax', 'yaml', 'optax',
                                                'vsr_tpu')
                         and sys.modules[m] is not None)
print(json.dumps(stats))
"""


_CLI_MODES = {
    "video": (["--video", "--fused-tail", "--net", "DRFNet"],
              dict(in_channels=1, out_channels=1, num_features=8,
                   num_groups=2, upscale_factor=2, fused_squeeze=True)),
    "frame": (["--chunk", "4", "--fused-tail", "--net", "MoEEDSRNet"],
              dict(in_channels=1, out_channels=1, num_resblocks=2,
                   num_features=8, upscale_factor=2, num_experts=2,
                   group_size=64, moe_every=1, router_impl="rank_pallas",
                   dispatch_impl="dense")),
    "window": (["--windows", "7", "--chunk", "4", "--net", "DUFNet"],
               dict(in_channels=1, out_channels=1, num_frames=7,
                    size_filter=3, upscale_factor=2, use_pallas_filter=True)),
}


def _serve_blocked(tmp_path, rng, mode):
    src = tmp_path / "raw" / "patientA"
    vol = rng.integers(0, 1200, (48, 48, 2, 3)).astype(np.int16)
    nifti.save_nifti(vol, src / "patientA_4d.nii.gz")
    out = tmp_path / "sr"
    flags, kwargs = _CLI_MODES[mode]
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(tmp_path / "raw"), str(out),
         "--psnr", "--device", "cpu", *flags,
         "--net-kwargs", json.dumps(kwargs)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["leaked"] == []
    assert stats["volumes"] == 1 and stats["frames"] == 6
    assert np.isfinite(stats["psnr_mean"])
    sr = nifti.load_nifti(out / "patientA" / "patientA_4d_sr.nii.gz")
    assert sr.shape == (48, 48, 2, 3)
    assert sr.min() >= 0 and sr.max() <= 255
    assert (out / "metrics.csv").exists()


def test_cli_serves_without_jax_flax_yaml(tmp_path, rng):
    _serve_blocked(tmp_path, rng, "video")


@pytest.mark.parametrize("mode", ["frame", "window"])
def test_cli_serves_frame_and_window_modes_without_jax(tmp_path, rng, mode):
    _serve_blocked(tmp_path, rng, mode)


_FORBIDDEN_MODULES = ("jax", "flax", "optax", "yaml", "PIL", "imageio",
                      "msgpack", "tqdm", "vsr_tpu")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "vsr_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_port_sources_import_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    bad = sorted(m for m in imported if m.split(".")[0] in _FORBIDDEN_MODULES)
    assert not bad, f"{path} imports {bad}"
    assert "torch.compile" not in (REPO / path).read_text()
