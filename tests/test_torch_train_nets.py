"""Training slice: the gradient of an L1 loss with respect to every
parameter of ``FBlock``, ``DRFNet`` (``fused_squeeze`` on and off) and
``EDSRNet`` against ``jax.grad`` on the same numpy-seeded inputs and
transplanted weights, mapped onto the port's parameters by
``interop.from_jax_tree``. JAX runs the Pallas fused squeeze in interpret
mode, as its own tests do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import init, randomize
from vsr_tpu.models import DRFNet as JaxDRFNet
from vsr_tpu.models import EDSRNet as JaxEDSRNet
from vsr_tpu.models import feedback as jfeedback
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.models import DRFNet, EDSRNet, feedback

# Gradients are float32 sums over a few thousand pixels of O(1e-2..1)
# terms; both sides sum in another order.
TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _compare(jax_module, torch_module, inputs, target, alpha=None):
    """L1 loss of the module's output against ``target`` on both sides;
    every parameter's gradient must agree."""
    args = [jnp.asarray(x) for x in inputs]
    # Drawn with numpy over the traced shapes (no flax init compiled); the
    # PReLU weights: flax's default 0.2 unless the case sets one.
    variables = randomize(init(jax_module, *inputs), np.random.default_rng(0))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full_like(v, 0.2 if alpha is None else alpha)
        if path[-1].key == "alpha" else v, variables)

    def loss(params):
        out = jax_module.apply({"params": params}, *args)
        return jnp.mean(jnp.abs(out - jnp.asarray(target)))

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    load_jax_params(torch_module, jax.tree_util.tree_map(np.asarray, variables))
    out = torch_module(*[_first(x) for x in inputs])
    got_loss = torch.mean(torch.abs(out - _first(target)))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = from_jax_tree(torch_module, jax.tree_util.tree_map(np.asarray, grads))
    params = dict(torch_module.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **TOL)
    assert sum(float(np.abs(w).max()) > 1e-6 for w in want.values()) > len(want) // 2


@pytest.mark.parametrize("alpha", [0.2, 0.0, -0.3])
@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_fblock_gradients_match_jax(rng, fused_squeeze, alpha):
    f = 8
    x = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    target = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    _compare(jfeedback.FBlock(f, 2, 2, fused_squeeze=fused_squeeze),
             feedback.FBlock(f, 2, 2, fused_squeeze=fused_squeeze),
             [x, h], target, alpha)


@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_drfnet_gradients_match_jax(rng, fused_squeeze):
    kw = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
              upscale_factor=2, fused_squeeze=fused_squeeze)
    x = rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
    target = rng.standard_normal((2, 3, 16, 16, 1)).astype(np.float32)
    _compare(JaxDRFNet(**kw), DRFNet(**kw), [x], target)


def test_edsrnet_gradients_match_jax(rng):
    kw = dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=8,
              upscale_factor=2)
    x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    target = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    _compare(JaxEDSRNet(**kw), EDSRNet(**kw), [x], target)


def test_from_jax_tree_is_the_inverse_of_load_jax_params(rng):
    kw = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
              upscale_factor=2, fused_squeeze=True)
    x = np.zeros((1, 2, 8, 8, 1), np.float32)
    variables = randomize(init(JaxDRFNet(**kw), x, seed=1),
                          np.random.default_rng(1))
    net = DRFNet(**kw)
    load_jax_params(net, variables)
    laid = from_jax_tree(net, variables)  # with the "params" level ...
    bare = from_jax_tree(net, variables["params"])  # ... and without it
    for name, p in net.named_parameters():
        np.testing.assert_array_equal(laid[name], p.detach().numpy())
        np.testing.assert_array_equal(bare[name], laid[name])
