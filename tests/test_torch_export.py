"""The port's serving artifacts (``vsr_tpu_torch/export.py``) on the CPU:
tiny DRFNet (fused squeeze, K1's op), DUFNet (filter op, K2), MoE-EDSR
(rank op, K3) and EDSR programs saved, loaded and run, bit-equal to
``infer.make_pipeline``'s output on the same input; the graph holds each
kernel's custom op node (not ``torch.cat`` + conv); the refusals (a JAX
``.vsrx``, ``--w8a8`` without scales, ``--w8a8-kernels`` without W8A8,
``--platforms``, a device other than the traced one); the CLI's export and ``--run``; the
JAX CLI flags that ``infer`` and ``export`` refuse by name, and ``infer``'s
default net (``EDSRNet``, as ``vsr_tpu.infer``'s); and an
artifact's SR against ``vsr_tpu.export.ExportedServing``'s on the same
weights (>= 99.9 % exact grey, <= 1 grey)."""

import json
import zipfile

import jax
import numpy as np
import pytest
import torch

import vsr_tpu.export as jexport
import vsr_tpu.models as jmodels
from tests._torch_cases import run_cases, subdir
from tests._torch_parity import init, randomize
from vsr_tpu_torch import export, infer
from vsr_tpu_torch.infer import build_serving_net, make_pipeline
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.io import nifti

DRF_KW = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
              upscale_factor=2, fused_squeeze=True, fused_tail=True)
EDSR_KW = dict(in_channels=1, out_channels=1, num_resblocks=1, num_features=4,
               upscale_factor=2)
# name -> (net, kwargs, frames shape, pipeline mode, op the graph holds,
# op calls per program call)
CASES = {
    "drf": ("DRFNet", DRF_KW, (6, 24, 24), dict(video_t=3),
            "concat_conv1x1", 3 * 4),  # T = 3 frame steps x 4 squeezes
    "duf": ("DUFNet", dict(in_channels=1, out_channels=1, num_frames=7,
                           size_filter=3, upscale_factor=2,
                           use_pallas_filter=True),
            (14, 24, 24), dict(window=(7, 7, "middle"), chunk=4),
            "duf_dynamic_filter", 4),  # 14 windows in 4 chunks
    "moe": ("MoEEDSRNet", dict(in_channels=1, out_channels=1, num_resblocks=2,
                               num_features=8, upscale_factor=2,
                               num_experts=2, group_size=36, moe_every=1,
                               router_impl="rank_pallas"),
            (4, 24, 24), {}, "pairwise_rank", 2),  # 2 MoE layers
    "edsr": ("EDSRNet", EDSR_KW, (6, 24, 24), {}, None, 0),
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ops(program) -> dict:
    counts: dict = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function":
            counts[target] = counts.get(target, 0) + 1
    return counts


def _case_artifact_roundtrip_is_bit_equal_and_holds_the_op(tmp_path, rng, key):
    name, kw, shape, mode, op, calls = CASES[key]
    net = build_serving_net(name, kw, device="cpu")
    program, meta = export.export_serving(net, shape, 2, **mode)
    counts = _ops(program)
    ours = {k: v for k, v in counts.items() if k.startswith("vsr_tpu_torch")}
    assert ours == ({f"vsr_tpu_torch.{op}.default": calls} if op else {})
    path = tmp_path / f"{key}.pt2.zip"
    export.save_artifact(path, program, {**meta, "net": name})
    served = export.ExportedServing(path, device="cpu")
    assert served.meta["frames_shape"] == list(shape)
    assert served.meta["device"] == "cpu" and served.meta["net"] == name
    frames = np.round(rng.random(shape) * 255).astype(np.float32)
    lr, sr = served(frames)
    want_lr, want = make_pipeline(net, 2, "acdc", **mode)(
        torch.from_numpy(frames))
    assert torch.equal(sr, want) and torch.equal(lr, want_lr)
    assert want.std() > 1.0


def _case_unfused_drf_graph_has_cat_and_conv_instead(rng):
    net = build_serving_net("DRFNet", dict(DRF_KW, fused_squeeze=False),
                            device="cpu")
    counts = _ops(export.export_serving(net, (6, 24, 24), 2, video_t=3)[0])
    assert not any(k.startswith("vsr_tpu_torch") for k in counts)
    assert counts.get("aten.cat.default", 0) >= 12


def _case_refusals(tmp_path, rng):
    net = build_serving_net("EDSRNet", EDSR_KW, device="cpu")
    program, meta = export.export_serving(net, (2, 24, 24), 2)
    path = tmp_path / "a.pt2.zip"
    export.save_artifact(path, program, meta)
    with pytest.raises(ValueError, match="traced for device 'cpu'"):
        export.ExportedServing(path, device="cuda")
    forged = tmp_path / "forged.pt2.zip"  # the same program, meta says cuda
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(forged, "w") as dst:
        dst.writestr("program.pt2", src.read("program.pt2"))
        dst.writestr("meta.json", json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="cannot serve on 'cpu'"):
        export.ExportedServing(forged, device="cpu")
    newer = tmp_path / "newer.pt2.zip"
    with zipfile.ZipFile(newer, "w") as dst:
        dst.writestr("program.pt2", b"")
        dst.writestr("meta.json", json.dumps({**meta, "format_version": 99}))
    with pytest.raises(ValueError, match="newer"):
        export.ExportedServing(newer, device="cpu")

    # A JAX .vsrx is refused by name.
    jnet = jmodels.EDSRNet(**EDSR_KW)
    variables = init(jnet, np.zeros((1, 12, 12, 1), np.float32))
    blob, jmeta = jexport.export_serving(jnet, variables, (2, 24, 24), 2)
    vsrx = tmp_path / "m.vsrx"
    jexport.save_artifact(vsrx, blob, jmeta)
    with pytest.raises(ValueError, match="JAX .vsrx"):
        export.ExportedServing(vsrx, device="cpu")

    for flags in (["--w8a8"], ["--w8a8-kernels", "3"],
                  ["--platforms", "tpu"]):
        with pytest.raises(SystemExit, match=flags[0]):
            export.main(["--net", "EDSRNet", "--net-kwargs",
                         json.dumps(EDSR_KW), "--device", "cpu", *flags,
                         "--out", str(tmp_path / "x.zip")])


def _case_cli_export_and_run(tmp_path, rng):
    src = tmp_path / "raw"
    vol = rng.integers(0, 1200, (24, 24, 2, 3)).astype(np.int16)
    nifti.save_nifti(vol, src / "p1" / "p1_4d.nii.gz")
    nifti.save_nifti(vol[:, :, :1], src / "p2" / "p2_4d.nii.gz")  # skipped
    art = tmp_path / "drf.pt2.zip"
    export.main(["--net", "DRFNet", "--net-kwargs", json.dumps(DRF_KW),
                 "--shape", "6,24,24", "--video-t", "3", "--device", "cpu",
                 "--out", str(art)])
    meta = export.ExportedServing(art, device="cpu").meta
    assert meta["net"] == "DRFNet" and meta["video_t"] == 3
    export.main(["--run", str(art), str(src), str(tmp_path / "out"),
                 "--device", "cpu"])
    sr = nifti.load_nifti(tmp_path / "out" / "p1" / "p1_4d_sr.nii.gz")
    assert sr.shape == (24, 24, 2, 3)
    assert not (tmp_path / "out" / "p2").exists()
    with pytest.raises(SystemExit, match="--windows needs --seq-t"):
        export.main(["--net", "DUFNet", "--windows", "7", "--shape",
                     "14,24,24", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--seq-t"):
        export.main(["--net", "Volume3DSRNet", "--shape", "6,24,24",
                     "--device", "cpu"])


# The JAX package's CLI flags the port refuses by name: (module, flags,
# what the message says).
_REFUSED_FLAGS = [
    (infer, ["--ema"], "--ema needs --checkpoint"),
    (infer, ["--bucket-t", "8"],
     "--bucket-t is refused by vsr_tpu_torch.*runs eagerly"),
    # A preset file naming a knob the port refuses for good.
    (infer, ["--preset-file", "volumes.json"],
     "--preset-file: .*EDSRNet.volumes_per_call is refused.*one volume"),
    (export, ["--preset-file", "unroll.json"],
     "--preset-file: .*EDSRNet.net_kwargs.unroll is refused.*lax.scan"),
]


def _case_cli_refuses_jax_flags_by_name(tmp_path, rng):
    """Each flag parses, then stops the CLI with its reason: a message
    exit (status 1), not argparse's usage error (status 2)."""
    (tmp_path / "volumes.json").write_text(json.dumps(
        {"presets": {"EDSRNet": {"volumes_per_call": 4}}}))
    (tmp_path / "unroll.json").write_text(json.dumps(
        {"EDSRNet": {"net_kwargs": {"unroll": 2}}}))
    for module, flags, match in _REFUSED_FLAGS:
        flags = [str(tmp_path / f) if f.endswith(".json") else f
                 for f in flags]
        argv = ([str(tmp_path), str(tmp_path / "o"), "--device", "cpu"]
                if module is infer else
                ["--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW),
                 "--device", "cpu", "--out", str(tmp_path / "x.zip")])
        with pytest.raises(SystemExit, match=match) as err:
            module.main([*argv, *flags])
        assert isinstance(err.value.code, str), (flags, err.value.code)
    assert not (tmp_path / "x.zip").exists()


def _case_cli_takes_presets(tmp_path, rng):
    """``export --preset`` and ``--preset-file`` (a file written as the
    tuner writes one; alone it implies ``--preset tuned``) bake the knobs
    into the artifact, explicit flags winning; ``infer --preset-file``
    serves with the file's knobs."""
    from vsr_tpu_torch.presets import SERVING_PRESETS

    tuned = tmp_path / "tuned.json"
    tuned.write_text(json.dumps({"presets": {"EDSRNet": {
        "chunk": 4, "net_kwargs": {"fused_tail": True}}}, "measured": []}))
    argv = ["--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW),
            "--shape", "6,24,24", "--device", "cpu"]
    for name, flags, chunk, fused in (
            ("file", ["--preset-file", str(tuned)], 4, True),
            ("file_and_flag", ["--preset-file", str(tuned), "--chunk", "2"],
             2, True),
            ("fast", ["--preset", "fast"],
             SERVING_PRESETS["EDSRNet"].get("chunk", 0),
             SERVING_PRESETS["EDSRNet"].get("net_kwargs", {}).get(
                 "fused_tail"))):
        art = tmp_path / f"{name}.pt2.zip"
        export.main([*argv, *flags, "--out", str(art)])
        meta = export.ExportedServing(art, device="cpu").meta
        assert meta["chunk"] == chunk, (name, meta["chunk"])
        assert meta["net_kwargs"].get("fused_tail") == fused, name
        # Without --calib the fast level's W8A8 is skipped with a note.
        assert meta["w8a8_convs"] == 0, name
    src = tmp_path / "in"
    nifti.save_nifti(np.round(rng.random((24, 24, 1, 3)) * 255).astype(
        np.float32), src / "p1" / "p1_4d.nii")
    stats = infer.main([str(src), str(tmp_path / "out"), "--device", "cpu",
                        "--net", "EDSRNet", "--net-kwargs",
                        json.dumps(EDSR_KW), "--preset-file", str(tuned)])
    assert stats["frames"] == 3
    args = infer.parse_args([str(src), "o", "--net", "EDSRNet",
                             "--preset-file", str(tuned)])
    from vsr_tpu_torch.presets import apply_cli_preset

    apply_cli_preset(args)
    assert (args.preset, args.chunk) == ("tuned", 4)
    assert json.loads(args.net_kwargs) == {"fused_tail": True}


def _case_cli_defaults_to_edsr(tmp_path, rng):
    """``python -m vsr_tpu_torch.infer in out`` builds EDSRNet, as
    ``vsr_tpu.infer`` does (``vsr_tpu/infer.py:718``); so does export."""
    assert infer.parse_args([str(tmp_path), str(tmp_path / "o")]).net == \
        "EDSRNet"
    assert export.parse_args([]).net == "EDSRNet"


def _case_artifact_matches_vsr_tpu_artifact(tmp_path, rng):
    """The same DRFNet weights through both packages' artifacts."""
    kw = dict(DRF_KW)
    jnet = jmodels.DRFNet(**kw)
    variables = randomize(init(jnet, np.zeros((1, 2, 12, 12, 1), np.float32)),
                          np.random.default_rng(5))
    blob, jmeta = jexport.export_serving(jnet, variables, (6, 24, 24), 2,
                                         video_t=3)
    jexport.save_artifact(tmp_path / "m.vsrx", blob, jmeta)
    net = build_serving_net("DRFNet", kw, device="cpu")
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, variables))
    program, meta = export.export_serving(net, (6, 24, 24), 2, video_t=3)
    export.save_artifact(tmp_path / "m.pt2.zip", program, meta)
    frames = np.round(rng.random((6, 24, 24)) * 255).astype(np.float32)
    _, want = jexport.ExportedServing(tmp_path / "m.vsrx")(frames)
    _, got = export.ExportedServing(tmp_path / "m.pt2.zip", device="cpu")(
        frames)
    diff = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1.0
    assert np.asarray(want).std() > 1.0


# The cases run inside two tests, every case run and each failure named
# (see tests/test_torch_serve.py for why).


def test_artifacts_hold_their_ops_and_match_pipelines(tmp_path, rng):
    cases = [(key, lambda key=key:
              _case_artifact_roundtrip_is_bit_equal_and_holds_the_op(
                  subdir(tmp_path, key), rng, key)) for key in sorted(CASES)]
    cases += [("_case_unfused_drf_graph_has_cat_and_conv_instead",
               lambda: _case_unfused_drf_graph_has_cat_and_conv_instead(rng)),
              ("_case_artifact_matches_vsr_tpu_artifact",
               lambda: _case_artifact_matches_vsr_tpu_artifact(
                   subdir(tmp_path, "jax"), rng))]
    run_cases(cases)


def test_refusals_and_cli(tmp_path, rng):
    run_cases([(c.__name__, lambda c=c: c(subdir(tmp_path, c.__name__), rng))
               for c in (_case_refusals, _case_cli_export_and_run,
                         _case_cli_refuses_jax_flags_by_name,
                         _case_cli_takes_presets,
                         _case_cli_defaults_to_edsr)])
