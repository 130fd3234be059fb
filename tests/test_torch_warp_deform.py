"""The port's BatchNorm, warp and deformable conv against ``vsr_tpu``'s, on
the same numpy-seeded inputs: train-mode outputs and running statistics
against flax's ``mutable=['batch_stats']``; ``flow_warp`` /
``grid_sample_*`` / FRVSR's ``stn_warp`` and ``deform_conv2d`` (v1, v2)
forward and gradients, at integer sample coordinates (zero flow, zero
offsets, the exact border) where the gradient conventions decide, and at
several widths; and the DCN pack's offset-channel layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from vsr_tpu.models import duf as jduf
from vsr_tpu.models import edvr as jedvr
from vsr_tpu.models import frvsr as jfrvsr
from vsr_tpu.ops import deform_conv as jdcn
from vsr_tpu.ops import warp as jwarp
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.models import duf, edvr, frvsr
from vsr_tpu_torch.models.common import BatchNorm
from vsr_tpu_torch.ops import deform_conv, warp

TOL = dict(rtol=1e-5, atol=1e-5)


def _first(x, spatial=2):
    """Channels-last numpy -> channel-first torch."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, -spatial - 1)))


def _last(t, spatial=2):
    return np.moveaxis(t.detach().numpy(), -spatial - 1, -1)


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("shape", [(4, 3, 3, 5), (2, 3, 4, 4, 6)])
def test_batchnorm_train_step_matches_flax(rng, shape):
    # Channels last in flax, axis 1 in the port; 36 or 96 values a channel.
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    c = shape[-1]
    bn = linen.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        use_running_average=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["params"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    variables["params"]["bias"] = rng.standard_normal(c).astype(np.float32)
    variables["batch_stats"]["mean"] = rng.standard_normal(c).astype(np.float32)
    variables["batch_stats"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    want, state = bn.apply(variables, jnp.asarray(x),
                           use_running_average=False, mutable=["batch_stats"])

    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        port.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        port.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    got = port(_first(x, len(shape) - 2))
    np.testing.assert_allclose(_last(got, len(shape) - 2), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    new = jax.tree_util.tree_map(np.asarray, state["batch_stats"])
    np.testing.assert_allclose(port.running_mean.numpy(), new["mean"],
                               rtol=1e-6, atol=1e-6)
    # The biased batch variance: torch's own BatchNorm*d folds in the
    # unbiased one and lands 0.9 + 0.1 * var * n / (n - 1) here.
    np.testing.assert_allclose(port.running_var.numpy(), new["var"],
                               rtol=1e-6, atol=1e-6)
    assert sorted(dict(port.named_buffers())) == ["running_mean",
                                                  "running_var"]
    port.eval()
    want_eval = bn.apply({"params": variables["params"], "batch_stats": new},
                         jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(
        _last(port(_first(x, len(shape) - 2)), len(shape) - 2),
        np.asarray(want_eval), rtol=1e-5, atol=1e-5)


def test_duf_dense_block_train_step_updates_statistics_like_flax(rng):
    x = rng.standard_normal((2, 3, 4, 4, 8)).astype(np.float32)
    jblock = jduf._DenseBlock(4, pad_t=1)
    variables = jax.tree_util.tree_map(np.asarray, jblock.init(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    want, state = jblock.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    block = duf._DenseBlock(8, 4, pad_t=1).train()
    load_jax_params(block, variables)
    got = block(_first(x, 3))
    np.testing.assert_allclose(_last(got, 3), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    new = from_jax_tree(block, {"params": {}, **jax.tree_util.tree_map(
        np.asarray, state)})
    buffers = dict(block.named_buffers())
    assert sorted(new) == sorted(buffers)
    for name, value in new.items():
        np.testing.assert_allclose(buffers[name].numpy(), value, rtol=1e-6,
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------------------ warp


def _warp_grads(jfn, pfn, img, flow, cot):
    """Outputs and (d img, d flow) of ``sum(out * cot)`` on both sides;
    ``img``, ``flow``, ``cot`` channels-last numpy."""
    def loss(i, f):
        return jnp.sum(jfn(i, f) * cot)

    # Jitted, as the JAX trainer runs the nets: the grid's arithmetic (and
    # with it which pixel an integer sample lands on) is XLA's compiled one.
    want = np.asarray(jax.jit(jfn)(jnp.asarray(img), jnp.asarray(flow)))
    wi, wf = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(img),
                                                     jnp.asarray(flow))
    ti = _first(img).requires_grad_(True)
    tf = _first(flow).requires_grad_(True)
    out = pfn(ti, tf)
    (out * _first(cot)).sum().backward()
    return ((_last(out), want), (_last(ti.grad), np.asarray(wi)),
            (_last(tf.grad), np.asarray(wf)))


def _close(got, want, what):
    """1e-5 of the largest entry: the flow gradients of a normalized grid
    carry the factor (size - 1) / 2, and both sides sum in float32."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _flows(rng, n, h, w):
    return {
        "zero": np.zeros((n, h, w, 2), np.float32),
        # Integer displacements: every sample on a pixel, many exactly on
        # or beyond the border.
        "integer": rng.integers(-2, 3, (n, h, w, 2)).astype(np.float32),
        "fractional": (1.5 * rng.standard_normal((n, h, w, 2))).astype(
            np.float32),
    }


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("w", [17, 31, 64, 96])
def test_flow_warp_forward_and_gradients(rng, w, padding_mode):
    n, h, c = 2, 5, 2
    img = rng.standard_normal((n, h, w, c)).astype(np.float32)
    cot = rng.standard_normal((n, h, w, c)).astype(np.float32)
    for name, flow in _flows(rng, n, h, w).items():
        pairs = _warp_grads(
            lambda i, f: jwarp.flow_warp(i, f, padding_mode=padding_mode),
            lambda i, f: warp.flow_warp(i, f, padding_mode=padding_mode),
            img, flow, cot)
        for what, (got, want) in zip(("out", "d img", "d flow"), pairs):
            _close(got, want, f"{name} {what}")


@pytest.mark.parametrize("w", [17, 31, 64, 96])
def test_linspace_is_jitted_jax_value_for_value(w):
    want = jax.jit(lambda: jnp.linspace(-1.0, 1.0, w))()
    np.testing.assert_array_equal(warp.linspace(-1.0, 1.0, w).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("w", [17, 31, 64, 96])
def test_stn_warp_and_normalized_grid_at_zero_flow(rng, w, padding_mode):
    # Zero flow on a normalized mesh: every sample on a pixel only if the
    # unnormalization returns integers, and the gradient convention then
    # decides the flow's gradient.
    n, h, c = 1, 6, 1
    img = rng.standard_normal((n, h, w, c)).astype(np.float32)
    cot = rng.standard_normal((n, h, w, c)).astype(np.float32)
    for name, flow in (("zero", np.zeros((n, h, w, 2), np.float32)),
                       ("small", (0.05 * rng.standard_normal((n, h, w, 2)))
                        .astype(np.float32))):
        pairs = _warp_grads(
            lambda i, f: jfrvsr.stn_warp(i, f, padding_mode=padding_mode),
            lambda i, f: frvsr.stn_warp(i, f, padding_mode=padding_mode),
            img, flow, cot)
        for what, (got, want) in zip(("out", "d img", "d flow"), pairs):
            _close(got, want, f"{name} {what}")
    grid = np.stack(np.meshgrid(warp.linspace(-1.0, 1.0, w).numpy(),
                                warp.linspace(-1.0, 1.0, h).numpy()),
                    -1)[None].astype(np.float32)
    want = jax.jit(lambda i, g: jwarp.grid_sample_normalized(
        i, g, padding_mode=padding_mode))(jnp.asarray(img), jnp.asarray(grid))
    got = warp.grid_sample_normalized(_first(img), torch.from_numpy(grid),
                                      padding_mode=padding_mode)
    np.testing.assert_allclose(_last(got), np.asarray(want), **TOL)


def test_both_sampler_names_take_one_implementation_and_typos_raise(rng):
    img = torch.from_numpy(rng.standard_normal((1, 2, 5, 6)).astype(np.float32))
    gy = torch.from_numpy(rng.uniform(-1, 6, (1, 3, 4)).astype(np.float32))
    gx = torch.from_numpy(rng.uniform(-1, 7, (1, 3, 4)).astype(np.float32))
    a = warp.grid_sample_bilinear(img, gy, gx, method="matmul")
    b = warp.grid_sample_bilinear(img, gy, gx, method="gather")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="method"):
        warp.grid_sample_bilinear(img, gy, gx, method="hat")
    with pytest.raises(ValueError, match="padding_mode"):
        warp.grid_sample_bilinear(img, gy, gx, padding_mode="reflection")


# ------------------------------------------------------- deformable conv


def _dcn_case(rng, kind, n=2, c=4, h=6, w=7, dg=2, k=3, cout=3):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    if kind == "zero":
        off = np.zeros((n, h, w, dg, k * k, 2), np.float32)
    elif kind == "integer":
        off = rng.integers(-2, 3, (n, h, w, dg, k * k, 2)).astype(np.float32)
    else:
        off = (1.3 * rng.standard_normal((n, h, w, dg, k * k, 2))).astype(
            np.float32)
    wt = (0.3 * rng.standard_normal((k, k, c, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, dg, k * k)).astype(np.float32)
    cot = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return x, off, wt, b, mask, cot


@pytest.mark.parametrize("kind", ["zero", "integer", "fractional"])
@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_forward_and_gradients(rng, modulated, kind):
    x, off, wt, b, mask, cot = _dcn_case(rng, kind)

    def jloss(*args):
        xx, oo, ww, bb, mm = args
        out = jdcn.deform_conv2d(xx, oo, ww, bb, mm if modulated else None)
        return jnp.sum(out * cot), out

    args = [jnp.asarray(a) for a in (x, off, wt, b, mask)]
    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                          has_aux=True)(*args)
    to_port = (lambda a: _first(a),
               lambda a: torch.from_numpy(np.ascontiguousarray(
                   a.transpose(0, 5, 3, 4, 1, 2))),
               lambda a: torch.from_numpy(np.ascontiguousarray(
                   a.transpose(3, 2, 0, 1))),
               torch.from_numpy,
               lambda a: torch.from_numpy(np.ascontiguousarray(
                   a.transpose(0, 3, 4, 1, 2))))
    leaves = [f(a).requires_grad_(True)
              for f, a in zip(to_port, (x, off, wt, b, mask))]
    out = deform_conv.deform_conv2d(leaves[0], leaves[1], leaves[2],
                                    leaves[3], leaves[4] if modulated else None)
    (out * _first(cot)).sum().backward()
    np.testing.assert_allclose(_last(out), np.asarray(want), **TOL)
    for name, leaf, want_g, f in zip(("x", "offsets", "weight", "bias", "mask"),
                                     leaves, grads, to_port):
        if name == "mask" and not modulated:
            assert leaf.grad is None
            continue
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   f(np.asarray(want_g)).numpy(),
                                   err_msg=name, rtol=1e-5, atol=2e-5)


def test_deform_conv2d_stride_chunks_and_refusals(rng, monkeypatch):
    x, off, wt, b, mask, _ = _dcn_case(rng, "fractional", n=3, h=8, w=8)
    off = off[:, ::2, ::2]  # stride 2, padding 1: 4 x 4 outputs
    mask = mask[:, ::2, ::2]
    want = jdcn.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                              jnp.asarray(wt), jnp.asarray(b),
                              jnp.asarray(mask), stride=2)
    args = (_first(x), torch.from_numpy(np.ascontiguousarray(
        off.transpose(0, 5, 3, 4, 1, 2))), torch.from_numpy(
        np.ascontiguousarray(wt.transpose(3, 2, 0, 1))), torch.from_numpy(b),
        torch.from_numpy(np.ascontiguousarray(mask.transpose(0, 3, 4, 1, 2))))
    whole = deform_conv.deform_conv2d(*args, stride=2)
    np.testing.assert_allclose(_last(whole), np.asarray(want), **TOL)
    # A budget of one sample's taps: three chunks, the same result.
    monkeypatch.setattr(deform_conv, "COL_BUDGET_BYTES", 1)
    assert torch.equal(deform_conv.deform_conv2d(*args, stride=2), whole)
    with pytest.raises(NotImplementedError, match="scan_major"):
        deform_conv.deform_conv2d(*args, stride=2, scan_major=True)
    with pytest.raises(ValueError, match="method"):
        deform_conv.deform_conv2d(*args, stride=2, method="pallas")


def test_dcn_pack_offset_channel_layout_matches_jax(rng):
    """One channel of the offset conv's stored output moves one tap's dx of
    one deformable group, in both packages: (chunk, group, tap) order."""
    n, h, w, c, dg, k2 = 1, 6, 6, 4, 2, 9
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    extra = rng.standard_normal((n, h, w, c)).astype(np.float32)
    jpack = jedvr.ModulatedDeformConvPack(3, deformable_groups=dg)
    variables = jax.tree_util.tree_map(np.asarray, jpack.init(
        jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(extra)))
    pack = edvr.ModulatedDeformConvPack(c, 3, dg)
    chunk, group, tap = 1, 1, 5  # dx of group 1, tap (1, 2)
    channel = chunk * dg * k2 + group * k2 + tap
    outs = {}
    for moved in (False, True):
        v = jax.tree_util.tree_map(np.copy, variables)
        if moved:
            v["params"]["Conv_0"]["bias"][channel] = 0.7
        load_jax_params(pack, v)
        want = jpack.apply(v, jnp.asarray(x), jnp.asarray(extra))
        with torch.no_grad():
            got = pack(_first(x), _first(extra))
            raw = pack.offset_conv(_first(extra))
        np.testing.assert_allclose(_last(got), np.asarray(want), **TOL)
        outs[moved] = (_last(got), raw)
    offsets = outs[True][1][:, :2 * dg * k2].reshape(n, 2, dg, k2, h, w)
    moved_taps = [idx[:3] for idx in np.argwhere(offsets.numpy() != 0)[:, 1:4]]
    assert {tuple(t) for t in moved_taps} == {(chunk, group, tap)}
    assert np.abs(outs[True][0] - outs[False][0]).max() > 1e-3
