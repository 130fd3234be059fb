"""The port's quantized serving entry points on the CPU: every refusal of
``make_pipeline``, ``infer``, ``export`` and the daemon's live backend held
against its ``vsr_tpu`` twin (the same exception type, the same phrase),
the refusals by name of what stays unported, and the artifacts: a W8A8
program (``torch.ops.vsr_tpu_torch.w8a8_conv`` nodes) and an int8 program
(int8 buffers) exported, saved, loaded and equal to the live pipeline, the
export CLI's ``--calib`` and ``--run``, and the daemon's live backend with
``--w8a8-scales`` answering a request.

Each test runs its cases through ``tests/_torch_cases.run_cases`` (ROADMAP.md,
queue 3, says why the count of tests matters)."""

from __future__ import annotations

import functools
import io
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import vsr_tpu.export as jexport
import vsr_tpu.infer as jinfer
import vsr_tpu.quantize as jq
import vsr_tpu.serve as jserve
from tests._torch_cases import run_cases, subdir
from tests._torch_parity import init
from vsr_tpu.models import EDSRNet as JaxEDSRNet
from vsr_tpu_torch import export, infer, quantize, serve
from vsr_tpu_torch.infer import build_serving_net
from vsr_tpu_torch.io import nifti

EDSR_KW = dict(in_channels=1, out_channels=1, num_resblocks=1,
               num_features=16, upscale_factor=2)
N, SIDE = 6, 24


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nets():
    jnet = JaxEDSRNet(**EDSR_KW)
    variables = init(jnet, np.zeros((1, 12, 12, 1), np.float32))
    return jnet, variables, build_serving_net("EDSRNet", EDSR_KW,
                                              device="cpu")


def _frames(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return np.round(rng.random((n, SIDE, SIDE)) * 255).astype(np.float32)


def _both_raise(exc, match, jax_call, port_call):
    """The JAX twin and the port refuse alike."""
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        port_call()


# ---------------------------------------------------------- refusals


def _case_pipeline_refusals():
    jnet, variables, net = _nets()
    frames = _frames()
    for kw, match in ((dict(int8=True, w8a8="dynamic"), "separate paths"),
                      (dict(w8a8_kernels={3}), "w8a8_kernels"),
                      (dict(w8a8="dynamic", w8a8_kernels={3}), "w8a8_kernels"),
                      (dict(w8a8={}), "empty"),
                      (dict(w8a8={"Ghost_0/Conv_0": 0.5}), "match no conv"),
                      (dict(w8a8={"Conv_1/Conv_0": 0.5}, w8a8_kernels={6}),
                       "filtered every")):
        _both_raise(ValueError, match,
                    lambda: jinfer.make_pipeline(jnet, variables, 2, "acdc",
                                                 **kw),
                    lambda: infer.make_pipeline(net, 2, "acdc", **kw))
    # Lazy calibration that keeps no conv raises at the first call.
    _both_raise(ValueError, "no quantizable conv",
                lambda: jinfer.make_pipeline(jnet, variables, 2, "acdc",
                                             w8a8=True,
                                             w8a8_kernels={6})(frames),
                lambda: infer.make_pipeline(net, 2, "acdc", w8a8=True,
                                            w8a8_kernels={6})(
                    torch.from_numpy(frames)))
    # quantize_deconvs is ported (tests/test_torch_presets_tune.py holds
    # it against JAX): no refusal; on no sample, no scale, as in JAX.
    assert quantize.calibrate_w8a8(net, [], quantize_deconvs=True) == {} \
        == jq.calibrate_w8a8(jnet, variables, [], quantize_deconvs=True)
    assert callable(quantize.make_w8a8_apply(net, quantize_deconvs=True))


def _volume_tree(root, shape=(SIDE, SIDE, 2, 3), seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 1200, shape).astype(np.int16)
    nifti.save_nifti(vol, root / "p1" / "p1_4d.nii.gz")
    return root


def _case_cli_refusals(tmp_path, monkeypatch):
    src = _volume_tree(tmp_path / "raw")
    scales = tmp_path / "scales.json"
    scales.write_text(json.dumps({"Conv_1/Conv_0": 0.05}))
    kw = ["--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW)]

    def jax_main(module, argv):
        monkeypatch.setattr(sys, "argv", ["prog", *argv])
        return module.main()

    # infer
    out = str(tmp_path / "o")
    _both_raise(SystemExit, "--w8a8-kernels needs --w8a8",
                lambda: jax_main(jinfer, [str(src), out, *kw,
                                          "--w8a8-kernels", "3"]),
                lambda: infer.main([str(src), out, *kw, "--device", "cpu",
                                    "--w8a8-kernels", "3"]))
    _both_raise(ValueError, "separate paths",
                lambda: jax_main(jinfer, [str(src), out, *kw, "--int8",
                                          "--w8a8"]),
                lambda: infer.main([str(src), out, *kw, "--device", "cpu",
                                    "--int8", "--w8a8"]))
    # export
    art = ["--shape", f"{N},{SIDE},{SIDE}", "--out", str(tmp_path / "a")]
    for flags, exc, match in (
            (["--w8a8"], SystemExit, "needs static activation scales"),
            (["--int8", "--w8a8-scales", str(scales)], SystemExit,
             "separate paths"),
            (["--w8a8-kernels", "3"], SystemExit,
             "--w8a8-kernels needs W8A8 scales"),
            (["--w8a8", "--calib", str(subdir(tmp_path, "empty"))],
             SystemExit, "--calib: no NIfTI volume")):
        _both_raise(exc, match,
                    lambda: jax_main(jexport, [*kw, *art, *flags]),
                    lambda: export.main([*kw, *art, "--device", "cpu",
                                         *flags]))
    vol = ["--net", "Volume3DSRNet", "--net-kwargs", json.dumps(dict(
        in_channels=1, out_channels=1, num_features=4, num_resblocks=1,
        upscale_factor=2)), "--seq-t", "3", *art]
    _both_raise(SystemExit, "volumetric nets' 3D convs",
                lambda: jax_main(jexport, [*vol, "--w8a8-scales",
                                           str(scales)]),
                lambda: export.main([*vol, "--device", "cpu",
                                     "--w8a8-scales", str(scales)]))
    jnet, variables, net = _nets()
    _both_raise(ValueError, "lazy first-batch calibration",
                lambda: jexport.make_serving_fn(jnet, variables, 2, "acdc",
                                                w8a8=True),
                lambda: export.make_serving_fn(net, 2, "acdc", w8a8=True))
    # the daemon's live backend
    live = dict(net_name="EDSRNet", net_kwargs=EDSR_KW, checkpoint="",
                frames_shape=(N, SIDE, SIDE), factor=2)
    _both_raise(ValueError, "lazy",
                lambda: jserve.LivePipeline(**live, w8a8=True),
                lambda: serve.LivePipeline(**live, w8a8=True, device="cpu"))
    _both_raise(ValueError, "w8a8_kernels",
                lambda: jserve.LivePipeline(**live, w8a8_kernels={3}),
                lambda: serve.LivePipeline(**live, w8a8_kernels={3},
                                           device="cpu"))


def test_quantized_refusals_match_jax(tmp_path, monkeypatch):
    run_cases([
        ("_case_pipeline_refusals", _case_pipeline_refusals),
        ("_case_cli_refusals",
         lambda: _case_cli_refusals(subdir(tmp_path, "cli"), monkeypatch))])


# --------------------------------------------------------- artifacts


def _calibration(net):
    _, z = infer.make_prep(2, "acdc")(torch.from_numpy(_frames(1)))
    return quantize.calibrate_w8a8(net, [z])


def _case_w8a8_artifact(tmp_path):
    net = build_serving_net("EDSRNet", EDSR_KW, device="cpu")
    scales = _calibration(net)
    assert len(scales) == 4  # the 16-channel convs; the 1-channel head not
    program, meta = export.export_serving(net, (N, SIDE, SIDE), 2,
                                          w8a8=scales)
    nodes = [n for n in program.graph.nodes
             if str(n.target) == "vsr_tpu_torch.w8a8_conv.default"]
    assert len(nodes) == len(scales) and meta["w8a8_convs"] == len(scales)
    path = tmp_path / "w8a8.pt2.zip"
    export.save_artifact(path, program, {**meta, "net": "EDSRNet"})
    served = export.ExportedServing(path, device="cpu")
    frames = _frames(2)
    want = infer.make_pipeline(build_serving_net("EDSRNet", EDSR_KW,
                                                 device="cpu"), 2, "acdc",
                               w8a8=scales)(torch.from_numpy(frames))[1]
    assert torch.equal(served(frames)[1], want)
    plain = infer.make_pipeline(build_serving_net("EDSRNet", EDSR_KW,
                                                  device="cpu"), 2, "acdc")(
        torch.from_numpy(frames))[1]
    assert not torch.equal(plain, want)


def _case_int8_artifact(tmp_path):
    net = build_serving_net("EDSRNet", EDSR_KW, device="cpu")
    kernels = len(quantize.kernel_shapes(net))
    program, meta = export.export_serving(net, (N, SIDE, SIDE), 2, int8=True)
    assert meta["int8"] is True and meta["w8a8_convs"] == 0
    int8 = [k for k, v in program.state_dict.items() if v.dtype == torch.int8]
    assert len(int8) == kernels == 6
    # The dense kernels are not in the program: freed to 0 elements.
    assert sum(v.numel() for k, v in program.state_dict.items()
               if k.endswith("weight")) == 0
    path = tmp_path / "int8.pt2.zip"
    export.save_artifact(path, program, {**meta, "net": "EDSRNet"})
    served = export.ExportedServing(path, device="cpu")
    frames = _frames(3)
    want = infer.make_pipeline(build_serving_net("EDSRNet", EDSR_KW,
                                                 device="cpu"), 2, "acdc",
                               int8=True)(torch.from_numpy(frames))[1]
    assert torch.equal(served(frames)[1], want)


def _case_export_cli_calib_and_run(tmp_path):
    src = _volume_tree(tmp_path / "raw")
    art = tmp_path / "calib.pt2.zip"
    export.main(["--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW),
                 "--shape", f"{N},{SIDE},{SIDE}", "--device", "cpu",
                 "--w8a8", "--calib", str(src), "--w8a8-kernels", "3",
                 "--out", str(art)])
    served = export.ExportedServing(art, device="cpu")
    assert served.meta["w8a8_convs"] == 4
    export.main(["--run", str(art), str(src), str(tmp_path / "sr"),
                 "--device", "cpu"])
    sr = nifti.load_nifti(tmp_path / "sr" / "p1" / "p1_4d_sr.nii.gz")
    assert sr.shape == (SIDE, SIDE, 2, 3) and 0 <= sr.min() <= sr.max() <= 255


def _case_daemon_live_w8a8(tmp_path):
    net = build_serving_net("EDSRNet", EDSR_KW, device="cpu")
    scales = tmp_path / "scales.json"
    scales.write_text(json.dumps(_calibration(net)))
    args = serve.parse_args([
        "--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW),
        "--frames-shape", f"{N},{SIDE},{SIDE}", "--w8a8-scales",
        str(scales), "--device", "cpu"])
    (live,) = serve.live_from_args(args)
    assert live.meta["w8a8_convs"] == 4
    srv = serve.make_server([], port=0, warmup=True, live=[live],
                            device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        frames = _frames(4)
        buf = io.BytesIO()
        np.save(buf, frames)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/sr",
            data=buf.getvalue(), headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req) as resp:
            got = np.load(io.BytesIO(resp.read()))
        np.testing.assert_array_equal(got, live(frames)[1].numpy())
    finally:
        srv.shutdown()
        srv.server_close()


def test_quantized_artifacts_and_daemon(tmp_path):
    run_cases([(c.__name__, functools.partial(c, subdir(tmp_path, c.__name__)))
               for c in (_case_w8a8_artifact, _case_int8_artifact,
                         _case_export_cli_calib_and_run,
                         _case_daemon_live_w8a8)])
