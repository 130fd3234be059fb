"""The serving presets, the tuner, bf16 training of the nets moved onto the
precision policy and W8A8 transposed convs, against ``vsr_tpu`` on the CPU
(numpy-seeded weights from ``tests/_torch_parity.init``, JAX under
``jit``).

- Preset logic: with the port's ``SERVING_PRESETS`` replaced by a copy of
  JAX's table, ``serving_config`` and ``apply_preset_to_args`` equal
  ``vsr_tpu.presets``' for every net, level and namespace of the port's
  ``infer``, ``export`` and ``serve`` (with and without the user's flags,
  scales, ``--calib``, ``--mesh``), and ``load_preset_file`` refuses the
  same junk; the port's own table names every registered net with
  constructor kwargs and refuses the knobs it never takes.
- The tuner: ``vsr_tpu_torch.tune`` writes the JSON keys of
  ``vsr_tpu.tune`` on the same arguments, its rows serve identical
  outputs, each package's file loads in the other; ``--train`` on a small
  ``Volume4DSRNet`` gives every dtype row without an error.
- bf16 training: one train step of each of ``MoEEDSRNet``, ``DUFNet``,
  ``EDVRNet``, ``FRVSRNet`` (``carry_f32``), ``RBPNet``, ``TOFlowNet`` and
  ``Volume4DSRNet`` (plain and ``carry_f32``) within twice JAX's own bf16
  error of its float32 reference, outputs and gradients of a squared-error
  loss, parameters float32 (``tests/test_torch_precision.py``'s bar).
  TOFlow runs at 16 x 16: its coarsest SpyNet level then normalizes 32
  values a channel (at 8 x 8 it would be 4, where bf16 rounding of nearly
  equal values decides the gradient in either framework).
- ``quantize_deconvs``: the W8A8 twin on ``nn.ConvTranspose`` at k6 s2 p2
  and k8 s4 p2 against JAX's ``_w8a8_conv``, int32 accumulators and
  outputs bit-equal, the banks' kernel plan the patch kernel at the
  zoo's shapes; a small DRFNet through ``make_w8a8_apply(quantize_deconvs=
  True)`` at the grey bar of JAX's.

Two tests, each running its cases through ``tests/_torch_cases.run_cases``
(ROADMAP.md, queue 3, says why the count of tests matters)."""

from __future__ import annotations

import argparse
import copy
import functools
import inspect
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vsr_tpu.models as jm
import vsr_tpu.presets as jpresets
import vsr_tpu.quantize as jq
import vsr_tpu.tune as jtune
from tests._torch_cases import run_cases, subdir
from tests._torch_parity import first, init, last, randomize, window
from vsr_tpu.models.common import ConvTranspose as JaxConvTranspose
from vsr_tpu_torch import export, infer, presets, quantize, serve, tune
from vsr_tpu_torch import models as pm
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.models.common import ConvTranspose
from vsr_tpu_torch.ops import w8a8_conv as wc
from vsr_tpu_torch.registry import get_class

BF16 = jnp.bfloat16


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------ presets and tune

# The user flags of each serving CLI's namespace the preset must respect.
_VARIANTS = {
    "infer": ([], ["--chunk", "7"], ["--video"], ["--windows", "3"],
              ["--w8a8-scales", "s.json"], ["--mesh", "data=2"], ["--int8"],
              ["--w8a8"], ["--w8a8-kernels", "3"]),
    "export": ([], ["--chunk", "7"], ["--video-t", "5"],
               ["--windows", "3", "--seq-t", "5"], ["--seq-t", "5"],
               ["--calib", "d"], ["--calib", "d", "--calib-method",
                                  "callback"], ["--w8a8-scales", "s.json"]),
    "serve": ([], ["--chunk", "7"], ["--video-t", "5"], ["--windows", "3"],
              ["--seq-t", "5"], ["--w8a8-scales", "s.json"],
              ["--mesh", "data=2"]),
}
_USER_KWARGS = ("", '{"fused_tail": false, "num_frames": 3, "nframes": 3}')


def _namespace(cli: str, net: str, net_kwargs: str, flags: list):
    argv = ["--net", net, "--net-kwargs", net_kwargs, *flags]
    if cli == "infer":
        return infer.parse_args(["in", "out", *argv])
    return {"export": export, "serve": serve}[cli].parse_args(argv)


def _knobs(notes: list[str]) -> list[str]:
    """A note's knob and verdict, without the reason (which names the
    package's own tools)."""
    return [n.split(" (")[0] for n in notes]


def _case_preset_logic(monkeypatch):
    table = copy.deepcopy(jpresets.SERVING_PRESETS)
    with monkeypatch.context() as patch:
        patch.setattr(presets, "SERVING_PRESETS", table)
        _hold_preset_logic(table)


def _hold_preset_logic(table):
    for net in table:
        for level in presets.LEVELS:
            for scales in (False, True):
                for user in (None, {"num_frames": 3, "nframes": 3}):
                    assert presets.serving_config(
                        net, level, user, scales) == jpresets.serving_config(
                        net, level, user, scales), (net, level, scales, user)
            for cli, variants in _VARIANTS.items():
                for flags in variants:
                    for kw in _USER_KWARGS:
                        ns = _namespace(cli, net, kw, flags)
                        jns = copy.deepcopy(ns)
                        notes = presets.apply_preset_to_args(ns, level)
                        jnotes = jpresets.apply_preset_to_args(jns, level)
                        what = (net, level, cli, flags, kw)
                        assert vars(ns) == vars(jns), what
                        assert _knobs(notes) == _knobs(jnotes), what
    with pytest.raises(ValueError, match="Unknown preset level"):
        presets.serving_config("EDSRNet", "fastest")
    with pytest.raises(SystemExit, match="No serving preset"):
        presets.apply_preset_to_args(_namespace("infer", "Nope", "", []),
                                     "tuned")


def _case_preset_files(tmp_path):
    for i, junk in enumerate(([1, 2], {"presets": 3}, {"EDSRNet": 3},
                              {"presets": {"EDSRNet": []}})):
        path = tmp_path / f"junk{i}.json"
        path.write_text(json.dumps(junk))
        for load in (presets.load_preset_file, jpresets.load_preset_file):
            with pytest.raises(ValueError, match="expected"):
                load(str(path))
    # Knobs JAX takes and the port refuses for good, by name.
    for i, (entry, knob) in enumerate((
            ({"net_kwargs": {"unroll": 4}}, "unroll"),
            ({"volumes_per_call": 4}, "volumes_per_call"),
            ({"volumes_per_call_w8a8": 8}, "volumes_per_call_w8a8"))):
        path = tmp_path / f"refused{i}.json"
        path.write_text(json.dumps({"SRFBNet": entry}))
        assert jpresets.load_preset_file(str(path)) == {"SRFBNet": entry}
        with pytest.raises(ValueError, match=f"SRFBNet.*{knob} is refused"):
            presets.load_preset_file(str(path))


def _case_port_table():
    """Every registered net of the port has an entry of knobs the port
    takes: constructor kwargs (no net built), its own serving mode, no
    refused knob."""
    from vsr_tpu_torch import registry

    get_class("net", "EDSRNet")  # registers the nets
    nets = set(registry._REGISTRIES["net"])
    assert set(presets.SERVING_PRESETS) == nets
    for name, entry in presets.SERVING_PRESETS.items():
        cls = get_class("net", name)
        params = inspect.signature(cls).parameters
        assert set(entry.get("net_kwargs", {})) <= set(params), name
        assert not set(entry) & set(presets.REFUSED_KNOBS), name
        assert set(entry) <= {"net_kwargs", "chunk", "video", "windows",
                              "w8a8", "w8a8_kernels"}, name
        assert entry.get("w8a8", "lazy") in ("lazy", "scales"), name
        mode = cls.serving_mode
        assert "video" not in entry or mode == "video", name
        assert "windows" not in entry or mode == "window", name


def _tune_args(out, **kw):
    args = dict(net="EDSRNet",
                net_kwargs=json.dumps(dict(
                    in_channels=1, out_channels=1, num_resblocks=2,
                    num_features=8, upscale_factor=2)),
                checkpoint="", shape="4,16,16", factor=2, dataset="acdc",
                video_t=0, windows=0, seq_t=0, window_order="middle",
                bf16=False, chunk_grid="0,2", repeats=1, out=str(out))
    args.update(kw)
    return argparse.Namespace(**args)


def _case_tune_serving(tmp_path):
    ours = tune.run(_tune_args(tmp_path / "port.json", device="cpu"))
    theirs = jtune.run(_tune_args(tmp_path / "jax.json"))
    assert sorted(ours) == sorted(theirs) and ours["backend"] == "cpu"
    assert [{k: v for k, v in r.items() if k != "volumes_per_sec"}
            for r in ours["measured"]] == [
        {k: v for k, v in r.items() if k != "volumes_per_sec"}
        for r in theirs["measured"]]
    assert sorted(ours["presets"]["EDSRNet"]) == sorted(
        theirs["presets"]["EDSRNet"])
    # Each package's file loads in the other.
    assert presets.load_preset_file(str(tmp_path / "jax.json")) == \
        theirs["presets"]
    assert jpresets.load_preset_file(str(tmp_path / "port.json")) == \
        ours["presets"]
    # The sweep's rows serve the same volume identically.
    frames = torch.from_numpy(np.round(np.random.default_rng(1).random(
        (4, 16, 16)) * 255).astype(np.float32))
    kw = json.loads(_tune_args(None).net_kwargs)
    outs = []
    for row in ours["measured"]:
        net = infer.build_serving_net("EDSRNet", dict(
            kw, fused_tail=row["fused_tail"]), device="cpu")
        outs.append(infer.make_pipeline(net, 2, "acdc",
                                        chunk=row["chunk"])(frames)[1])
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def _case_tune_train(tmp_path):
    args = argparse.Namespace(
        net="Volume4DSRNet",
        net_kwargs=json.dumps(dict(in_channels=1, out_channels=1,
                                   num_features=4, num_resblocks=1,
                                   upscale_factor=2)),
        factor=2, train_shape="8,3,4,16,16", batch=2, patch=8, steps=2,
        ga_grid="1,2", repeats=1, out=str(tmp_path / "train.json"),
        device="cpu")
    out = tune.run_train(args)
    rows = out["measured"]
    assert [(r["dtype"], r["grad_accumulation"]) for r in rows] == [
        (d, g) for d in ("float32", "bfloat16", "bfloat16+carry_f32")
        for g in (1, 2)]
    assert not [r for r in rows if "error" in r]
    assert all(r["scan_unroll"] == 1 and np.isfinite(r["steps_per_sec"])
               for r in rows)
    assert set(out) == {"train_presets", "train_presets_exact", "measured",
                        "best_steps_per_sec", "geometry", "batch", "patch",
                        "factor", "backend", "created"}


def test_presets_and_tune_match_jax(tmp_path, monkeypatch):
    run_cases([
        ("preset_logic", lambda: _case_preset_logic(monkeypatch)),
        ("preset_files", lambda: _case_preset_files(
            subdir(tmp_path, "files"))),
        ("port_table", _case_port_table),
        ("tune_serving", lambda: _case_tune_serving(
            subdir(tmp_path, "tune"))),
        ("tune_train", lambda: _case_tune_train(subdir(tmp_path, "train"))),
    ])


# ------------------------------------------- bf16 nets, W8A8 transposed convs


def _vol_in(x):
    """(N, T, D, h, w, C) -> the port's (N, T, C, D, h, w)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2)))


# name -> (kwargs, JAX input shape, to the port's layout, JAX BatchNorm
# nets take ``train``, the bf16 variants held)
BF16_NETS = {
    "MoEEDSRNet": (dict(in_channels=1, out_channels=1, num_resblocks=2,
                        num_features=8, upscale_factor=2, num_experts=2,
                        group_size=16, moe_every=1), (2, 8, 8, 1), first,
                   False, ({},)),
    "DUFNet": (dict(in_channels=1, out_channels=1, num_frames=7,
                    size_filter=3, upscale_factor=2), (2, 7, 6, 6, 1),
               window, True, ({},)),
    "EDVRNet": (dict(in_channels=1, out_channels=1, nf=8, nframes=2,
                     groups=2, front_RBs=0, back_RBs=1), (1, 2, 8, 8, 1),
                window, False, ({},)),
    "FRVSRNet": (dict(in_channels=1, out_channels=1, upscale_factor=2,
                      num_resblocks=1, is_prediction=True), (1, 3, 8, 8, 1),
                 window, False, ({"carry_f32": True},)),
    "RBPNet": (dict(in_channels=1, out_channels=1, base_filter=8, feat=8,
                    num_stages=3, num_resblocks=1, num_frames=3,
                    upscale_factor=2), (1, 3, 6, 6, 1), window, False,
               ({},)),
    "TOFlowNet": (dict(in_channels=1, out_channels=1, num_frames=2,
                       upscale_factor=2), (2, 2, 16, 16, 1), window, True,
                  ({},)),
    "Volume4DSRNet": (dict(in_channels=1, out_channels=1, num_features=4,
                           num_resblocks=1, upscale_factor=2),
                      (1, 2, 2, 6, 6, 1), _vol_in, False,
                      ({}, {"carry_f32": True})),
}


def _jax_run(jnet, variables, x, target, bn):
    """Jitted: the output and the parameter gradients of a squared-error
    loss (train-mode BatchNorm for the nets that have one)."""
    def loss(p):
        full = {**variables, "params": p}
        if bn:
            y, _ = jnet.apply(full, x, train=True, mutable=["batch_stats"])
        else:
            y = jnet.apply(full, x)
        return jnp.mean(jnp.square(y.astype(jnp.float32) - target)), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return np.asarray(y, np.float32), jax.tree_util.tree_map(np.asarray, g)


def _flat(named: dict) -> np.ndarray:
    return np.concatenate([np.asarray(named[k], np.float32).ravel()
                           for k in sorted(named)])


def _case_bf16_net(name, extra):
    kw, shape, to_port, bn, _ = BF16_NETS[name]
    jcls, pcls = getattr(jm, name), getattr(pm, name)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    akw = {"train": False} if bn else {}
    variables = randomize(init(jcls(**kw), x, **akw), rng)
    y_shape = jax.eval_shape(lambda v, z: jcls(**kw).apply(v, z, **akw),
                             variables, jnp.asarray(x)).shape
    target = rng.standard_normal(y_shape).astype(np.float32)
    y32, g32 = _jax_run(jcls(**kw), variables, jnp.asarray(x), target, bn)
    y16, g16 = _jax_run(jcls(**kw, dtype=BF16, **extra), variables,
                        jnp.asarray(x), target, bn)
    net = pcls(**kw, dtype="bfloat16", **extra)
    load_jax_params(net, variables)
    net.train()
    y = net(to_port(x))
    y_last = torch.movedim(y.float(), 1 if y.dim() == 4 else 2, -1)
    torch.mean(torch.square(y_last - torch.from_numpy(target))).backward()
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    got = {k: (np.zeros(p.shape, np.float32) if p.grad is None
               else p.grad.numpy()) for k, p in net.named_parameters()}
    for what, port, want, ref in (
            ("outputs", y_last.detach().numpy(), y16, y32),
            ("gradients", _flat(got), _flat(from_jax_tree(net, g16)),
             _flat(from_jax_tree(net, g32)))):
        envelope = float(np.abs(want - ref).max())
        assert envelope > 0, what
        err = float(np.abs(port - want).max())
        assert err <= 2 * envelope, (what, err, envelope)


def _deconv_pair(k, s, p, rng, cin=16, cout=16, side=(7, 9)):
    """A flax ``ConvTranspose`` (torch geometry, ``nn.ConvTranspose``
    inside) and the port's with its weights, on one numpy input."""
    class One(nn.Module):
        @nn.compact
        def __call__(self, z):
            return JaxConvTranspose(cout, k, s, p)(z)

    x = rng.standard_normal((2, *side, cin)).astype(np.float32)
    jnet = One()
    variables = randomize(init(jnet, x), rng)
    leaf = variables["params"]["ConvTranspose_0"]["ConvTranspose_0"]
    mod = ConvTranspose(cin, cout, k, s, p)
    load_jax_params(mod, {"params": {"ConvTranspose_0": leaf}})
    return jnet, variables, mod, x


def _case_deconv_twin(k, s, p, rng):
    jnet, variables, mod, x = _deconv_pair(k, s, p, rng)
    captured = []
    dispatch = jq._dispatch_conv

    def capture(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        captured.append(np.asarray(out))
        return out

    jq._dispatch_conv = capture
    try:
        with jax.disable_jit():
            want = np.asarray(jq.make_w8a8_apply(
                jnet, variables, quantize_deconvs=True)(jnp.asarray(x)))
    finally:
        jq._dispatch_conv = dispatch
    with torch.no_grad():
        acc = quantize._w8a8_deconv(mod, first(x), None, torch.int32)
        got = quantize._w8a8_deconv(mod, first(x), None)
        served = quantize.make_w8a8_apply(mod, quantize_deconvs=True)(
            first(x))
    assert len(captured) == 1 and captured[0].dtype == np.int32
    np.testing.assert_array_equal(last(acc), captured[0])
    np.testing.assert_array_equal(last(got), want)
    np.testing.assert_array_equal(last(served), want)
    # The kernel's plan at the zoo's shape of this bank (10 slices, 64 ->
    # 64, LR 96 / 48): the patch kernel.
    side = 96 if s == 2 else 48
    bank = quantize.deconv_bank(ConvTranspose(64, 64, k, s, p))
    plan = wc.kernel_plan((10, 64, side, side), bank["weight"].shape,
                          (1, 1), (1, 1), 1)
    assert plan["kernel"] == "patch" and bank["padding"] == (1, 1), plan


def _quantize_deconvs_pair(name, kw, x, rng):
    jnet = getattr(jm, name)(**kw)
    variables = jax.tree_util.tree_map(np.asarray,
                                       randomize(init(jnet, x), rng))
    net = getattr(pm, name)(**kw).eval()
    load_jax_params(net, variables)
    return jnet, variables, net


def _served_with_deconvs(jnet, variables, net, x):
    """JAX's and the port's W8A8 nets with ``quantize_deconvs`` (dynamic
    scales) on one input; the port's quantized deconvs counted."""
    want = np.asarray(jax.jit(lambda z: jq.make_w8a8_apply(
        jnet, variables, quantize_deconvs=True)(z))(jnp.asarray(x)))
    calls = []
    body = quantize._w8a8_deconv

    def count(*args, **kwargs):
        calls.append(1)
        return body(*args, **kwargs)

    quantize._w8a8_deconv = count
    try:
        with torch.no_grad():
            got = quantize.make_w8a8_apply(net, quantize_deconvs=True)(
                window(x))
    finally:
        quantize._w8a8_deconv = body
    return got, want, len(calls)


def _grey_bar(got, want):
    grey = lambda y: np.clip(np.round(y * 60.0 + 80.0), 0, 255)  # noqa: E731
    diff = np.abs(grey(got) - grey(want))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, (
        (diff == 0).mean(), diff.max())


def _case_frvsr_quantize_deconvs(rng):
    """FRVSR's x2 deconv (k3 s2 p1 with an output padding of 1: the bank
    pads its input asymmetrically) served W8A8 against JAX's."""
    kw = dict(in_channels=1, out_channels=1, upscale_factor=2,
              num_resblocks=1, is_prediction=True)
    x = rng.uniform(-1.5, 1.5, (1, 2, 8, 8, 1)).astype(np.float32)
    jnet, variables, net = _quantize_deconvs_pair("FRVSRNet", kw, x, rng)
    got, want, calls = _served_with_deconvs(jnet, variables, net, x)
    assert calls == 2  # one deconv a frame
    _grey_bar(np.moveaxis(got.numpy(), 2, -1), want)


def _case_drf_quantize_deconvs(rng):
    """A small DRFNet served W8A8 with its transposed convs quantized
    (dynamic scales) against JAX's, in grey levels."""
    kw = dict(in_channels=1, out_channels=1, num_features=16, num_groups=2,
              upscale_factor=2)
    x = rng.uniform(-1.5, 1.5, (1, 3, 8, 8, 1)).astype(np.float32)
    jnet, variables, net = _quantize_deconvs_pair("DRFNet", kw, x, rng)
    got, want, calls = _served_with_deconvs(jnet, variables, net, x)
    assert calls  # the feedback blocks' deconvs ran quantized
    with torch.no_grad():
        plain = quantize.make_w8a8_apply(net)(window(x))
    got = np.moveaxis(got.numpy(), 2, -1)
    _grey_bar(got, want)
    assert np.abs(np.moveaxis(plain.numpy(), 2, -1) - got).max() > 0
    # Static scales with the transposed convs (callback calibration: the
    # step's convs too) equal JAX's, and serve through an artifact.
    want_scales = jq.calibrate_w8a8(jnet, variables, [jnp.asarray(x)],
                                    method="callback", quantize_deconvs=True)
    scales = quantize.calibrate_w8a8(net, [window(x)], method="callback",
                                     quantize_deconvs=True)
    assert sorted(scales) == sorted(want_scales)
    assert any("ConvTranspose" in k for k in scales)
    for key, value in scales.items():
        np.testing.assert_allclose(value, want_scales[key], rtol=1e-5)
    frames = np.round(rng.random((6, 24, 24)) * 255).astype(np.float32)
    live = infer.make_pipeline(net, 2, "acdc", video_t=3, w8a8=scales,
                               quantize_deconvs=True)
    program, meta = export.export_serving(net, frames.shape, 2, video_t=3,
                                          w8a8=scales, quantize_deconvs=True)
    assert meta["w8a8_convs"] == len(scales)
    served = program.module()(torch.from_numpy(frames))[1]
    want = live(torch.from_numpy(frames))[1]
    assert torch.equal(served, want)


def test_bf16_nets_and_w8a8_deconvs_match_jax(rng):
    cases = [(f"bf16_{name}{'_' + '_'.join(extra) if extra else ''}",
              functools.partial(_case_bf16_net, name, extra))
             for name, spec in BF16_NETS.items() for extra in spec[4]]
    cases += [(f"deconv_k{k}s{s}p{p}",
               functools.partial(_case_deconv_twin, k, s, p, rng))
              for k, s, p in ((6, 2, 2), (8, 4, 2))]
    cases.append(("drf_quantize_deconvs",
                  functools.partial(_case_drf_quantize_deconvs, rng)))
    cases.append(("frvsr_quantize_deconvs",
                  functools.partial(_case_frvsr_quantize_deconvs, rng)))
    run_cases(cases)
