"""Shared helpers of the port's net parity tests: one jitted JAX train-mode
forward and gradient against the port's, weight for weight."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen

from vsr_tpu_torch.interop import from_jax_tree, load_jax_params

FORWARD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_SHARE = 1e-3  # of the largest entry of each parameter's gradient


def first(x, spatial=2):
    """Channels-last numpy -> channel-first torch (``spatial`` axes)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, -spatial - 1)))


def last(t, spatial=2):
    return np.moveaxis(t.detach().numpy(), -spatial - 1, -1)


def window(x):
    """A (N, T, h, w, C) numpy window -> the port's (N, T, C, h, w)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2)))


def init(module, *xs, seed=0, **kw):
    """Variables of the module's structure, drawn with numpy: only the
    shapes are traced (``jax.eval_shape``), so no init is compiled, which
    took most of these tests' time. Kernels and DCN weights are uniform
    over +-1/sqrt(fan-in), as flax's torch-style initializers draw them;
    BatchNorm scales and variances are one, every other leaf zero, for
    ``randomize`` to fill."""
    # Unbound: flax's feedback PReLU has a field named ``init``.
    shapes = jax.eval_shape(functools.partial(linen.Module.init, module, **kw),
                            jax.random.PRNGKey(seed),
                            *[jnp.asarray(x) for x in xs])
    draw = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key in ("kernel", "weight") and len(leaf.shape) > 1:
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return draw.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if path[-1].key in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def randomize(variables, rng, zero_scale=0.05):
    """Non-trivial values for the leaves that start at a constant: running
    statistics, BatchNorm scales, zero biases, and the zero-initialized DCN
    offset convs (small: offsets of a few tenths of a pixel)."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape).astype(np.float32)
        if np.all(leaf == leaf.flat[0]) and leaf.size > 1 or name in (
                "mean", "bias"):
            return (zero_scale * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


def jax_train_step(jnet, variables, x, loss_of, train_kwarg):
    """Jitted: outputs, loss, parameter gradients and the updated
    ``batch_stats`` of one train-mode forward (flax ``mutable``)."""
    stats = [k for k in variables if k != "params"]
    kw = {"train": True} if train_kwarg else {}

    def loss(params):
        full = {**variables, "params": params}
        if stats:
            out, new = jnet.apply(full, x, mutable=stats, **kw)
        else:
            out, new = jnet.apply(full, x, **kw), {}
        return loss_of(out), (out, new)

    (value, (out, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(out), float(value), to_np(grads), to_np(new)


def assert_gradients_match(net, got_loss, want_loss, jax_grads):
    """Loss at 1e-5 relative; every parameter's gradient within
    ``GRAD_SHARE`` of its largest JAX entry (a parameter autograd did not
    reach has a zero gradient in JAX)."""
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    want = from_jax_tree(net, jax_grads)
    params = dict(net.named_parameters())
    assert sorted(want) == sorted(params)
    reached = 0
    for name, p in params.items():
        got = (np.zeros_like(want[name]) if p.grad is None
               else p.grad.numpy())
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(got - want[name]).max())
        # (+ 1e-8: a conv bias feeding a BatchNorm has a gradient of 0, up
        # to float32 rounding, on both sides.)
        assert err <= GRAD_SHARE * scale + 1e-8, (name, err, scale)
        reached += scale > 1e-7
    assert reached > len(params) // 2


def assert_stats_match(net, new_stats):
    """The port's running statistics after the step against flax's."""
    if not new_stats:
        return
    want = from_jax_tree(net, {"params": {}, **new_stats})
    buffers = dict(net.named_buffers())
    assert sorted(want) == sorted(buffers)
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value,
                                   **FORWARD_TOL, err_msg=name)


def hold_train_step(jnet, net, x, target, rng, *, train_kwarg=False,
                    seed=0, variables=None, to_port=window,
                    out_of=lambda o: o, loss_of=None, port_loss_of=None,
                    spatial_out=2):
    """One train-mode step of ``jnet`` and ``net`` from the same weights
    (``variables``, else randomized ones) on the channels-last input ``x``
    (a window (N, T, h, w, C) unless ``to_port`` says otherwise): outputs,
    loss, gradients and running statistics. Returns the JAX variables."""
    if variables is None:
        kw = {"train": False} if train_kwarg else {}
        variables = randomize(init(jnet, x, seed=seed, **kw), rng)
    loss_of = loss_of or (lambda o: jnp.mean(jnp.abs(out_of(o) - target)))
    out, want_loss, grads, new = jax_train_step(
        jnet, variables, jnp.asarray(x), loss_of, train_kwarg)
    load_jax_params(net, variables)
    net.train()
    got = net(to_port(x))
    if port_loss_of is None:
        got_loss = torch.mean(torch.abs(
            out_of(got) - first(target, spatial_out)))
    else:
        got_loss = port_loss_of(got)
    got_loss.backward()
    np.testing.assert_allclose(last(out_of(got), spatial_out),
                               out_of(out), **FORWARD_TOL)
    assert_gradients_match(net, got_loss.item(), want_loss, grads)
    assert_stats_match(net, new.get("batch_stats") and new)
    return variables
