"""The port's MISR flow and back-projection nets against ``vsr_tpu``'s, weight
for weight (``load_jax_params``), in train mode: ``TOFlowNet`` and
its ``SpyNet`` (BatchNorm with batch statistics, its running statistics
updated once per neighbour) and ``RBPNet`` / ``DBPNet``: outputs at 2e-4,
every parameter's gradient of an L1 loss within 1e-3 of its largest JAX
entry, and the running statistics after the step; eval mode from the
updated statistics; interop and refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (FORWARD_TOL, first, hold_train_step, init,
                                 last, randomize, window)
from vsr_tpu.models import RBPNet as JaxRBPNet
from vsr_tpu.models import TOFlowNet as JaxTOFlowNet
from vsr_tpu.models import rbpn as jrbpn
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import RBPNet, TOFlowNet, rbpn
from vsr_tpu_torch.registry import get_class


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clear_of_the_kink(jnet, x, margin=2.5e-6):
    """Randomized variables of the first seed whose SpyNet puts no
    BatchNorm output (a ReLU input) within ``margin`` of 0 in a train-mode
    forward on ``x``. Such an input can fall on the other side of the kink
    in each framework and then moves a SpyNet gradient by O(1e-2) of its
    largest entry (seeds 0 and 1 put one within 3e-7); the margin is about
    the two frameworks' float32 difference there."""
    for seed in range(16):
        variables = randomize(init(jnet, x, seed=seed, train=False),
                              np.random.default_rng(seed))
        net = TOFlowNet(1, 1, x.shape[1], 2).train()
        load_jax_params(net, variables)
        nearest = []
        for block in net.spynet.blocks:
            for norm in block.norms:
                norm.register_forward_hook(lambda m, args, out: nearest.append(
                    out.abs().min().item()))
        with torch.no_grad():
            net(window(x))
        if min(nearest) > margin:
            return variables
    raise AssertionError("no seed clear of the ReLU kink")


def test_toflow_train_step_matches_jax(rng):
    # 6 x 10 LR -> 12 x 20 HR: padded to 16 x 32 with the batch minimum. The
    # step holds SpyNet with it: its flows feed the output, its parameters
    # have gradients, and each of its 16 BatchNorms is updated twice (two
    # neighbours) in the statistics compared.
    n, t = 2, 3
    x = rng.standard_normal((n, t, 6, 10, 1)).astype(np.float32)
    target = rng.standard_normal((n, 12, 20, 1)).astype(np.float32)
    net = TOFlowNet(1, 1, t, 2)
    variables = hold_train_step(
        JaxTOFlowNet(1, 1, t, 2), net, x, target, rng, train_kwarg=True,
        variables=_clear_of_the_kink(JaxTOFlowNet(1, 1, t, 2), x))
    # Eval mode, from the running statistics the step left, against flax
    # with the same statistics.
    stats = {"params": variables["params"], "batch_stats": {
        "SpyNet_0": {f"_SpyNetBlock_{i}": {f"BatchNorm_{j}": {
            "mean": norm.running_mean.numpy(), "var": norm.running_var.numpy()}
            for j, norm in enumerate(block.norms)}
            for i, block in enumerate(net.spynet.blocks)}}}
    want = JaxTOFlowNet(1, 1, t, 2).apply(stats, jnp.asarray(x), train=False)
    net.eval()
    with torch.no_grad():
        got = net(window(x))
    np.testing.assert_allclose(last(got), np.asarray(want), **FORWARD_TOL)


def test_toflow_refuses_another_window_and_is_registered():
    net = TOFlowNet(1, 1, 5, 2).eval()
    with pytest.raises(ValueError, match="windows of 5"):
        net(torch.zeros(1, 3, 1, 8, 8))
    assert net.serving_mode == "window"
    assert get_class("net", "TOFlowNet") is TOFlowNet


@pytest.mark.parametrize("factor", [2, 4])
def test_rbpn_train_step_matches_jax(rng, factor):
    kw = dict(in_channels=1, out_channels=1, base_filter=8, feat=8,
              num_stages=3, num_resblocks=1, num_frames=3,
              upscale_factor=factor)
    x = rng.standard_normal((2, 3, 6, 6, 1)).astype(np.float32)
    target = rng.standard_normal((2, 6 * factor, 6 * factor, 1)).astype(
        np.float32)
    net = RBPNet(**kw)
    hold_train_step(JaxRBPNet(**kw), net, x, target, rng)
    # One PReLU module at both sites of a resnet block: one alpha.
    block = net.res1_chain[0]
    assert sum(p is block.act.weight for p in block.parameters()) == 1


def test_dbpnet_matches_jax(rng):
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    jnet = jrbpn.DBPNet(8, 3, 2)
    variables = randomize(init(jnet, x), rng)
    want = jnet.apply(variables, jnp.asarray(x))
    net = rbpn.DBPNet(8, 8, 3, 2)
    load_jax_params(net, variables)
    with torch.no_grad():
        got = net(first(x))
    np.testing.assert_allclose(last(got), np.asarray(want), **FORWARD_TOL)


def test_rbpn_refusals():
    kw = dict(in_channels=1, out_channels=1, base_filter=8, feat=8,
              num_stages=3, num_resblocks=1, num_frames=3, upscale_factor=2)
    with pytest.raises(ValueError, match="upscale factor"):
        RBPNet(**dict(kw, upscale_factor=5))
    with pytest.raises(ValueError, match="windows of 3"):
        RBPNet(**kw)(torch.zeros(1, 5, 1, 6, 6))
    assert RBPNet.serving_mode == "window"
