"""The port's quantized serving (``vsr_tpu_torch/quantize.py``,
``ops/w8a8_conv.py``) against ``vsr_tpu.quantize`` on the CPU, the cases of
``tests/test_quantize.py`` on the same numpy-seeded weights (flax variables
from ``tests/_torch_parity.init``, JAX under ``jit``):

- weight-only int8: the int8 tensors and scales bit-equal to
  ``quantize_params`` through the interop layouts, ``kernel_shapes`` and
  ``quantized_nbytes`` equal, the int8 apply at the forward bar, for every
  net of the port's registry at small width;
- the set of quantized convs: the ``outputs`` and ``callback`` calibration
  key sets equal JAX's, their values at rtol 1e-5 (DRFNet with the fused
  squeeze on and off, Conv3D folded through the shuffle);
- the W8A8 twin against ``make_w8a8_apply`` on each geometry of
  ``tests/test_quantize.py`` plus k6 s2 and a 3D conv: the int32
  accumulators exact, the outputs within 1e-6 of the output's largest entry
  in float32 and within one bf16 ulp in bf16; and the CUDA kernels' weight
  layout on every geometry of the card test (``tests/_torch_w8a8.py``): the
  int8 activations unfolded in the kernels' ``(kz, ky, kx, c)`` order times
  ``repack_weight``'s rows, in float64, equal the twin's int32
  accumulators, and ``kernel_plan`` gives the patch kernel wherever its
  shared memory fits;
- the pipelines (``--int8``, ``--w8a8`` dynamic, static and lazy) of
  EDSRNet, DRFNet, MoEEDSRNet and Volume3DSRNet against JAX's at the grey
  bar (>= 99.9 % exact, <= 1 grey), and a DRF ``carry_f32`` bf16 conv's
  W8A8 output dtype.

Each test runs its cases through ``tests/_torch_cases.run_cases`` (ROADMAP.md,
queue 3, says why the count of tests matters)."""

from __future__ import annotations

import functools
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vsr_tpu.infer as jinfer
import vsr_tpu.models as jm
import vsr_tpu.quantize as jq
from tests._torch_cases import run_cases
from tests._torch_w8a8 import W8A8_CASES
from tests._torch_parity import FORWARD_TOL, first, init, randomize, window
from vsr_tpu.models.common import Conv as JaxConv
from vsr_tpu.models.common import Conv3D as JaxConv3D
from vsr_tpu_torch import infer, quantize
from vsr_tpu_torch import models as pm
from vsr_tpu_torch.interop import from_jax_tree, kernel_leaves, load_jax_params
from vsr_tpu_torch.ops import w8a8_conv as wc

F = 16  # features: the wide convs reach the default min_channels


def _vol(a):
    return first(a, 3)


# name -> (JAX class, port class, kwargs, JAX input shape, to the port's
# layout, JAX apply kwargs)
NETS = {
    "EDSRNet": (jm.EDSRNet, pm.EDSRNet, dict(
        in_channels=1, out_channels=1, num_resblocks=1, num_features=F,
        upscale_factor=2), (1, 8, 8, 1), first, {}),
    "MoEEDSRNet": (jm.MoEEDSRNet, pm.MoEEDSRNet, dict(
        in_channels=1, out_channels=1, num_resblocks=2, num_features=F,
        upscale_factor=2, num_experts=2, group_size=16, moe_every=1,
        router_impl="rank", dispatch_impl="dense"), (1, 8, 8, 1), first, {}),
    "DRFNet_fused_squeeze": (jm.DRFNet, pm.DRFNet, dict(
        in_channels=1, out_channels=1, num_features=F, num_groups=2,
        upscale_factor=2, fused_squeeze=True), (1, 2, 8, 8, 1), window, {}),
    "DRFNet_plain_squeeze": (jm.DRFNet, pm.DRFNet, dict(
        in_channels=1, out_channels=1, num_features=F, num_groups=2,
        upscale_factor=2, fused_squeeze=False), (1, 2, 8, 8, 1), window, {}),
    "SRFBNet": (jm.SRFBNet, pm.SRFBNet, dict(
        in_channels=1, out_channels=1, num_steps=2, num_features=F,
        num_groups=2, upscale_factor=2), (1, 8, 8, 1), first, {}),
    "DUFNet": (jm.DUFNet, pm.DUFNet, dict(
        in_channels=1, out_channels=1, num_frames=7, size_filter=3,
        upscale_factor=2), (1, 7, 8, 8, 1), window, {"train": False}),
    "TOFlowNet": (jm.TOFlowNet, pm.TOFlowNet, dict(
        in_channels=1, out_channels=1, num_frames=3, upscale_factor=2),
        (1, 3, 6, 10, 1), window, {"train": False}),
    "RBPNet": (jm.RBPNet, pm.RBPNet, dict(
        in_channels=1, out_channels=1, base_filter=F, feat=F, num_stages=2,
        num_resblocks=1, num_frames=3, upscale_factor=2), (1, 3, 6, 6, 1),
        window, {}),
    "EDVRNet": (jm.EDVRNet, pm.EDVRNet, dict(
        in_channels=1, out_channels=1, nf=F, nframes=3, groups=2,
        front_RBs=1, back_RBs=1), (1, 3, 8, 8, 1), window, {}),
    "FRVSRNet": (jm.FRVSRNet, pm.FRVSRNet, dict(
        in_channels=1, out_channels=1, upscale_factor=2, num_resblocks=1),
        (1, 2, 8, 8, 1), window, {}),
    "Volume3DSRNet_folded": (jm.Volume3DSRNet, pm.Volume3DSRNet, dict(
        in_channels=1, out_channels=1, num_resblocks=1, num_features=F,
        upscale_factor=2, fused_tail=True), (1, 3, 8, 8, 1), _vol, {}),
    "Volume4DSRNet": (jm.Volume4DSRNet, pm.Volume4DSRNet, dict(
        in_channels=1, out_channels=1, num_features=F, num_resblocks=1,
        upscale_factor=2), (1, 2, 3, 8, 8, 1), _vol, {}),
}

# RBPN's last neighbour feeds its hidden state through ``_ResChain_2`` and
# ``_ConvP_3`` into nothing: XLA drops that branch from the forward, but
# JAX's calibration interceptor still records its input, and the port never
# runs it (``models/rbpn.py``). Those convs' port scales are maxima over a
# subset of JAX's calls: at most JAX's, each at least one of its calls.
_RBPN_DEAD_BRANCH = ("_ResChain_2/", "_ConvP_3/")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(name, seed=0):
    """(jnet, variables, net, x, to_port, apply kwargs) on one numpy draw."""
    jcls, pcls, kw, shape, to_port, akw = NETS[name]
    rng = np.random.default_rng(seed)
    jnet = jcls(**kw)
    x = rng.standard_normal(shape).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, randomize(init(jnet, x, **akw), rng))
    net = pcls(**kw).eval()
    load_jax_params(net, variables)
    return jnet, variables, net, x, to_port, akw


def _channel_axis(out, like):
    """The port output's channel axis: the one whose move to the end gives
    the JAX output's shape."""
    for axis in range(out.ndim):
        if np.moveaxis(out, axis, -1).shape == like.shape:
            return axis
    raise AssertionError(f"port {out.shape} vs JAX {like.shape}")


def _assert_scales(name, want, got):
    assert set(got) == set(want), (sorted(set(want) - set(got)),
                                   sorted(set(got) - set(want)))
    for path, value in want.items():
        if name == "RBPNet" and path.startswith(_RBPN_DEAD_BRANCH):
            assert got[path] <= value * (1 + 1e-5), path
            continue
        np.testing.assert_allclose(got[path], value, rtol=1e-5, err_msg=path)


def _case_net(name):
    jnet, variables, net, x, to_port, akw = _pair(name)
    # Weight-only int8: the tensors and scales, bit for bit.
    jq8, js = jq.quantize_params(variables)
    q8, scales = quantize.quantize_params(net)
    want_q, want_s = from_jax_tree(net, jq8), from_jax_tree(net, js)
    assert q8 and all(t.dtype == torch.int8 for t in q8.values())
    for pname, tensor in q8.items():
        np.testing.assert_array_equal(tensor.numpy().astype(np.float32),
                                      want_q[pname], err_msg=pname)
        np.testing.assert_array_equal(scales[pname].numpy(), want_s[pname],
                                      err_msg=pname)
    assert quantize.kernel_shapes(net) == jq.kernel_shapes(variables)
    assert quantize.quantized_nbytes(net, q8) == jq.quantized_nbytes(jq8)
    want = np.asarray(jax.jit(jq.make_quantized_apply(jnet, jq8, js,
                                                      **akw))(x)[0]
                      if name == "FRVSRNet" else
                      jax.jit(jq.make_quantized_apply(jnet, jq8, js,
                                                      **akw))(x))
    with torch.no_grad():
        got = quantize.make_quantized_apply(net, q8, scales)(to_port(x))
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    np.testing.assert_allclose(np.moveaxis(got, _channel_axis(got, want), -1),
                               want, **FORWARD_TOL)
    # The dense kernels are freed.
    assert all(net.get_parameter(n).numel() == 0 for n in q8)

    # The quantized convs: both calibration methods' key sets and values.
    jnet, variables, net, x, to_port, akw = _pair(name)
    if name == "EDVRNet":
        # JAX's calibration raises inside vsr_tpu (the offset convs'
        # ``_PermutedOutConv.param``, models/edvr.py:79, under
        # nn.intercept_methods): the port's set is held to the exact-type
        # convs of the tree instead (residual blocks, the wrapped convs).
        with pytest.raises(jax.errors.TracerArrayConversionError):
            jq.calibrate_w8a8(jnet, variables, [x])
        got = quantize.calibrate_w8a8(net, [to_port(x)], min_channels=1)
        shapes = quantize.kernel_shapes(net)
        assert set(got) == {p for p in shapes if not (
            "ModulatedDeformConvPack" in p or "FoldableConv" in p)}
        return
    for method in ("outputs", "callback"):
        want = jq.calibrate_w8a8(jnet, variables, [x], method=method, **akw)
        got = quantize.calibrate_w8a8(net, [to_port(x)], method=method)
        _assert_scales(name, want, got)
    assert want, f"{name}: no conv calibrated by the callback method"


def _case_kernel_size_filters():
    """``conv_filter=kernel_size_filter`` (the interceptor's selection) and
    ``filter_scales_by_kernel`` (a calibration's) pick JAX's convs; the
    filtered W8A8 apply matches JAX's."""
    jnet, variables, net, x, to_port, _ = _pair("DRFNet_plain_squeeze")
    for sizes in ({6}, {1, 3}):
        want = jq.calibrate_w8a8(jnet, variables, [x], method="callback",
                                 conv_filter=jq.kernel_size_filter(sizes))
        got = quantize.calibrate_w8a8(
            net, [to_port(x)], method="callback",
            conv_filter=quantize.kernel_size_filter(sizes))
        _assert_scales("DRFNet", want, got)
        everything = jq.calibrate_w8a8(jnet, variables, [x],
                                       method="callback")
        assert (set(quantize.filter_scales_by_kernel(net, everything, sizes))
                == set(jq.filter_scales_by_kernel(variables, everything,
                                                  sizes)) == set(want))
    want = np.asarray(jax.jit(jq.make_w8a8_apply(
        jnet, variables, conv_filter=jq.kernel_size_filter({6})))(x))
    with torch.no_grad():
        got = quantize.make_w8a8_apply(
            net, conv_filter=quantize.kernel_size_filter({6}))(to_port(x))
    got = np.moveaxis(got.numpy(), 2, -1)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_int8_weights_and_quantized_convs_match_jax():
    run_cases([(name, functools.partial(_case_net, name)) for name in NETS]
              + [("kernel_size_filters", _case_kernel_size_filters)])


# --------------------------------------------------------- the W8A8 twin

GEOMETRIES = {
    "k3s1": dict(kernel_size=3, strides=1, padding=1),
    "k3s2": dict(kernel_size=3, strides=2, padding=1),
    "k5s1": dict(kernel_size=5, strides=1, padding=2),
    "k1s1": dict(kernel_size=1, strides=1, padding=0),
    "k3_groups4": dict(kernel_size=3, strides=1, padding=1,
                       feature_group_count=4),
    "k6s2": dict(kernel_size=6, strides=2, padding=2),
    "conv3d": None,
}


def _snap(kernel):
    """A kernel at exact multiples of its per-channel int8 step
    (``tests/test_quantize.py``'s ``_snap_kernels``)."""
    amax = np.abs(kernel).max(axis=tuple(range(kernel.ndim - 1)),
                              keepdims=True)
    s = np.where(amax > 0, amax / 127.0, 1.0)
    return (np.round(kernel / s) * s).astype(np.float32)


def _case_twin(geom_name, dtype, static, rng):
    geom = GEOMETRIES[geom_name]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if geom is None:
        make = functools.partial(JaxConv3D, 32, (3, 3, 3), padding=(1, 1, 1),
                                 dtype=jdtype)
        x = rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32)
        path, geom = "Conv3D_0/Conv_0", dict(strides=1, padding=1)
    else:
        make = functools.partial(JaxConv, 32, dtype=jdtype, **geom)
        x = rng.standard_normal((2, 12, 12, 16)).astype(np.float32)
        path = "Conv_0/Conv_0"

    class One(nn.Module):
        @nn.compact
        def __call__(self, z):
            return make()(z)

    jnet = One()
    variables = randomize(init(jnet, x), rng)
    params = variables["params"][path.split("/")[0]]["Conv_0"]
    params["kernel"] = _snap(np.asarray(params["kernel"]))
    scale = 0.0173 if static else None
    xj = jnp.asarray(x, jdtype)
    acts = {path: scale} if static else "dynamic"

    # JAX's int32 accumulators: its own _dispatch_conv, run eagerly.
    captured = []
    dispatch = jq._dispatch_conv

    def capture(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        captured.append(np.asarray(out))
        return out

    jq._dispatch_conv = capture
    try:
        with jax.disable_jit():
            jq.make_w8a8_apply(jnet, variables, act_scales=acts)(xj)
    finally:
        jq._dispatch_conv = dispatch
    want_out = np.asarray(jax.jit(jq.make_w8a8_apply(
        jnet, variables, act_scales=acts))(xj)).astype(np.float32)

    rank = x.ndim - 2
    kernel = np.asarray(params["kernel"])
    w = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(kernel, (-1, -2), (0, 1))))
    b = torch.from_numpy(np.asarray(params["bias"]))
    xt = first(x, rank).to(dtype)
    args = (xt, w, b, scale, (geom["strides"],) * rank,
            (geom["padding"],) * rank, geom.get("feature_group_count", 1))
    acc = wc.w8a8_conv_reference(*args, out_dtype=torch.int32)
    out = wc.w8a8_conv_reference(*args, out_dtype=dtype)
    assert captured and captured[0].dtype == np.int32
    np.testing.assert_array_equal(np.moveaxis(acc.numpy(), 1, -1),
                                  captured[0])
    got = np.moveaxis(out.float().numpy(), 1, -1)
    assert got.shape == want_out.shape
    if dtype == torch.float32:
        assert np.abs(got - want_out).max() <= 1e-6 * np.abs(want_out).max()
    else:  # one bf16 ulp of the larger of the two
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(
            np.abs(got), np.abs(want_out)) + 1e-30)) - 7)
        assert (np.abs(got - want_out) <= ulp).all()


def _case_kernel_layout(case, rng):
    """The kernels' K order on the CPU, where they cannot run: activations
    unfolded as ``(kz, ky, kx, c)`` with the channels padded like the
    repacked weights, times those rows in float64, against the twin's
    int32 accumulators; and the plan each geometry takes."""
    xshape, wshape, stride, padding, groups = W8A8_CASES[case]
    rank = len(wshape) - 2
    x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal(wshape)).astype(
        np.float32))
    xs = wc.dynamic_scale(x)
    wq, _ = wc.quantize_weight(w)
    packed = wc.repack_weight(wq)
    f, cg, kernel = wshape[0], wshape[1], wshape[2:]
    cpad = packed.shape[-1]
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (f, *kernel, cpad) and cpad % 32 == 0 and cpad >= cg
    assert not packed[..., cg:].any()
    xq = wc.quantize_activations(x, xs).double()
    if rank == 2:  # as 3D of depth 1
        xq, packed = xq[:, :, None], packed[:, None]
        kernel, stride, padding = (1, *kernel), (1, *stride), (0, *padding)
    fg = f // groups
    accs = []
    for g in range(groups):
        cols = torch.nn.functional.pad(
            xq[:, g * cg:(g + 1) * cg],
            (padding[2], padding[2], padding[1], padding[1], padding[0],
             padding[0]))
        cols = torch.nn.functional.pad(cols, (0, 0) * 3 + (0, cpad - cg))
        for d in range(3):
            cols = cols.unfold(2 + d, kernel[d], stride[d])
        # (N, cpad, od, oh, ow, kd, kh, kw) -> rows x (kd, kh, kw, c)
        out = cols.shape[2:5]
        rows = cols.permute(0, 2, 3, 4, 5, 6, 7, 1).reshape(
            -1, math.prod(kernel) * cpad)
        wrows = packed[g * fg:(g + 1) * fg].reshape(fg, -1).double()
        accs.append((rows @ wrows.T).reshape(xshape[0], *out, fg))
    got = torch.cat(accs, dim=-1).permute(0, 4, 1, 2, 3)
    want = wc.w8a8_conv_reference(x, w, None, None, W8A8_CASES[case][2],
                                  W8A8_CASES[case][3], groups,
                                  out_dtype=torch.int32)
    got = got.reshape(want.shape)
    assert torch.equal(got, want.double())
    plan = wc.kernel_plan(xshape, wshape, W8A8_CASES[case][2],
                          W8A8_CASES[case][3], groups)
    if case in ("k5_ragged", "gather_k16s8"):
        assert plan == {"kernel": "gather"}
    else:
        assert plan["kernel"] == "patch" and plan["smem"] <= wc.SMEM_LIMIT
        assert math.prod(plan["tile"]) == wc.TILE_M
        assert plan["bn"] == (32 if fg <= 32 else 64 if fg <= 64 else 128)
        assert plan["resident"] != case.startswith("stream")


def test_w8a8_twin_matches_jax_on_each_geometry(rng):
    run_cases([(f"{g}_{str(d).split('.')[1]}_{'static' if s else 'dynamic'}",
                functools.partial(_case_twin, g, d, s, rng))
               for g in GEOMETRIES for d in (torch.float32, torch.bfloat16)
               for s in (True, False)]
              + [(f"kernel_layout_{case}",
                  functools.partial(_case_kernel_layout, case, rng))
                 for case in W8A8_CASES])


# ------------------------------------------------------ the pipelines


def _agree(got, want, what):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff == 0).mean() >= 0.999, f"{what}: {(diff == 0).mean()} exact"
    assert diff.max() <= 1.0, f"{what}: max diff {diff.max()}"


def _frames(rng, n, side=24):
    """Low-passed grey frames, uint8 values (a learnable image, not noise)."""
    yy, xx = np.mgrid[:side, :side]
    out = np.zeros((n, side, side), np.float32)
    for i in range(n):
        for _ in range(3):
            cy, cx = rng.uniform(2, side - 2, 2)
            out[i] += rng.uniform(60, 200) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(8, 40))
    return np.clip(out, 0, 255).round().astype(np.float32)


def _pipelines(name, mode, jkw, kw, frames):
    jnet, variables, net, _, _, _ = _pair(name, seed=3)
    _, want = jinfer.make_pipeline(jnet, variables, 2, "acdc", **mode,
                                   **jkw)(frames)
    _, got = infer.make_pipeline(net, 2, "acdc", **mode, **kw)(
        torch.from_numpy(frames))
    return got.numpy(), np.asarray(want)


def _flips(name, mode, frames, scales):
    """The int8 activations of JAX's W8A8 net and of the port's, each on its
    own pipeline's net input (JAX's k-space chain and the port's agree to
    float32 ulps): ``(flips, largest step, distance of the first flip's
    ``x / xs`` from a half-integer)``."""
    jnet, variables, net, _, _, _ = _pair(name, seed=3)
    zj = jax.jit(lambda h: jinfer.make_prep(2, "acdc", **mode)(h)[1])(
        jnp.asarray(frames))
    _, zt = infer.make_prep(2, "acdc", **mode)(torch.from_numpy(frames))
    want, got = [], []
    dispatch, twin = jq._dispatch_conv, wc.w8a8_conv_reference

    def capture(mod, x, *args, **kwargs):
        want.append(np.asarray(x).astype(np.int64))
        return dispatch(mod, x, *args, **kwargs)

    def record(x, w, b, scale, *args, **kwargs):
        xs = wc.activation_scale(x, scale)
        got.append(np.moveaxis((x.float() / xs).numpy(), 1, -1))
        return twin(x, w, b, scale, *args, **kwargs)

    jq._dispatch_conv, wc.w8a8_conv_reference = capture, record
    try:
        with jax.disable_jit():
            jq.make_w8a8_apply(jnet, variables, act_scales=scales)(zj)
        with torch.no_grad():
            quantize.make_w8a8_apply(net, scales)(zt)
    finally:
        jq._dispatch_conv, wc.w8a8_conv_reference = dispatch, twin
    assert len(want) == len(got) > 0
    flips, step, first_gap = 0, 0, None
    for q, raw in zip(want, got):
        diff = q - np.clip(np.round(raw), -127, 127)
        flips += int((diff != 0).sum())
        step = max(step, int(np.abs(diff).max()))
        if first_gap is None and flips:
            first_gap = float(np.abs(np.abs(raw[diff != 0] % 1) - 0.5).min())
    return flips, step, first_gap


def _agree_w8a8(got, want, what, flips):
    """The grey bar. Where it fails, int8 rounding flips explain it or the
    case fails: the first flip sits within 1e-4 of a half-integer (float32
    ulps of the net input pushed ``x / xs`` across it), every flip is one
    step, and each moves a few output pixels by one grey: then >= 99.5 %
    exact and <= 1 grey, a tolerance stated for flipped cases alone."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if (diff == 0).mean() >= 0.999 and diff.max() <= 1.0:
        return
    count, step, first_gap = flips()
    assert count > 0, f"{what}: off the grey bar with no int8 flip"
    assert step == 1 and first_gap <= 1e-4, (what, count, step, first_gap)
    assert (diff == 0).mean() >= 0.995 and diff.max() <= 1.0, (
        what, count, (diff == 0).mean(), diff.max())


def _case_pipeline(name, form, rng):
    mode = {"DRFNet_fused_squeeze": dict(video_t=3),
            "Volume3DSRNet_folded": dict(volume=("3d", 3))}.get(name, {})
    frames = _frames(rng, 6)
    scales = "dynamic"
    if form == "static":
        # JAX's calibration serves the port unchanged (one dict for both);
        # the recurrent net's scan-body convs through the callback method.
        jnet, variables, _, _, _, _ = _pair(name, seed=3)
        zj = jax.jit(lambda h: jinfer.make_prep(2, "acdc", **mode)(h)[1])(
            jnp.asarray(frames))
        method = "callback" if "DRF" in name else "outputs"
        scales = jq.calibrate_w8a8(jnet, variables, [zj], method=method)
        kw = dict(w8a8=scales)
    else:
        kw = {"int8": dict(int8=True), "dynamic": dict(w8a8="dynamic"),
              "lazy": dict(w8a8=True, chunk=0 if mode else 4)}[form]
    got, want = _pipelines(name, mode, kw, kw, frames)
    if form in ("dynamic", "static"):
        _agree_w8a8(got, want, f"{name} {form}",
                    lambda: _flips(name, mode, frames, scales))
    else:
        _agree(got, want, f"{name} {form}")
    base = _pipelines(name, mode, {}, {}, frames)[1]
    assert np.abs(base - want).max() > 0, "quantization changed nothing"


def _case_carry_f32_bf16_out_dtype(rng):
    """Under W8A8 a ``carry_f32`` conv (``out_dtype=float32``) returns its
    module dtype, bf16, as ``canonicalize_dtype`` does in JAX."""
    kw = dict(in_channels=1, out_channels=1, num_features=F, num_groups=2,
              upscale_factor=2, dtype="bfloat16", carry_f32=True)
    x = rng.standard_normal((1, 2, 8, 8, 1)).astype(np.float32)
    jnet = jm.DRFNet(**dict(kw, dtype=jnp.bfloat16))
    variables = jax.tree_util.tree_map(np.asarray,
                                       randomize(init(jnet, x), rng))
    net = pm.DRFNet(**kw).eval()
    load_jax_params(net, variables)
    jtypes, types = {}, {}
    jconv, conv = jq._w8a8_conv, quantize._w8a8_conv

    def jrecord(mod, z, scale):
        out = jconv(mod, z, scale)
        jtypes["/".join(mod.path)] = jnp.dtype(out.dtype).name
        return out

    def record(mod, z, scale):
        out = conv(mod, z, scale)
        types[paths[id(mod)]] = str(out.dtype).split(".")[1]
        return out

    paths = {id(leaf.module): leaf.path for leaf in kernel_leaves(net)}
    jq._w8a8_conv, quantize._w8a8_conv = jrecord, record
    try:
        with jax.disable_jit():
            want = jq.make_w8a8_apply(jnet, variables)(jnp.asarray(x))
        with torch.no_grad():
            got = quantize.make_w8a8_apply(net)(window(x))
    finally:
        jq._w8a8_conv, quantize._w8a8_conv = jconv, conv
    assert types == jtypes and "bfloat16" in types.values()
    assert got.dtype == torch.bfloat16
    want = np.asarray(want).astype(np.float32)
    got = np.moveaxis(got.float().numpy(), 2, -1)
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_w8a8_and_int8_pipelines_match_jax(rng):
    cases = [(f"{name}_{form}",
              functools.partial(_case_pipeline, name, form, rng))
             for name in ("EDSRNet", "DRFNet_fused_squeeze", "MoEEDSRNet",
                          "Volume3DSRNet_folded")
             for form in ("dynamic", "static", "lazy", "int8")]
    cases.append(("carry_f32_bf16_out_dtype",
                  functools.partial(_case_carry_f32_bf16_out_dtype, rng)))
    run_cases(cases)
