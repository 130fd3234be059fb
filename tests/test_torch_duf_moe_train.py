"""Training of the two served nets whose paths hold a kernel, against
``vsr_tpu``: ``DUFNet`` in train mode (BatchNorm on batch statistics, the
running statistics written back; the filter's route under autograd) and
``MoEEDSRNet``'s gradients (expert-choice routing compared mask first: a
token whose selection differs must lie within 1e-6 of the cap-th affinity,
and on this seed none does, so every gradient is held)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (first, hold_train_step, init,
                                 randomize, window)
from vsr_tpu.models import DUFNet as JaxDUFNet
from vsr_tpu.models import MoEEDSRNet as JaxMoEEDSRNet
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import DUFNet, MoEEDSRNet
from vsr_tpu_torch.models import duf as duf_module
from vsr_tpu_torch.models import moe

DUF_KW = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=3,
              upscale_factor=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("use_pallas_filter", [False, True])
def test_dufnet_train_step_matches_jax(rng, use_pallas_filter):
    # The JAX package trains DUF through XLA (its Pallas kernel has no
    # backward); the port's net takes the plain route under autograd
    # whatever use_pallas_filter says.
    x = rng.standard_normal((2, 7, 6, 6, 1)).astype(np.float32)
    target = rng.standard_normal((2, 12, 12, 1)).astype(np.float32)
    net = DUFNet(**DUF_KW, use_pallas_filter=use_pallas_filter)
    hold_train_step(JaxDUFNet(**DUF_KW), net, x, target, rng,
                    train_kwarg=True)


def test_dufnet_filter_route_is_picked_by_autograd(rng, monkeypatch):
    calls = []
    wrapper = duf_module.duf_dynamic_filter

    def counting(*args):
        calls.append(1)
        return wrapper(*args)

    monkeypatch.setattr(duf_module, "duf_dynamic_filter", counting)
    net = DUFNet(**DUF_KW, use_pallas_filter=True).eval()
    x = window(rng.standard_normal((1, 7, 6, 6, 1)).astype(np.float32))
    net(x).sum().backward()  # autograd records: the plain route
    assert calls == []
    with torch.no_grad():
        served = net(x)
    assert calls == [1]  # no gradient: the wrapper (K2 on a CUDA tensor)
    for p in net.parameters():
        p.requires_grad_(False)
    assert torch.equal(net(x), served) and calls == [1, 1]
    with torch.no_grad():
        plain = DUFNet(**DUF_KW).eval()
        plain.load_state_dict(net.state_dict())
        torch.testing.assert_close(plain(x), served, rtol=1e-5, atol=1e-5)


MOE_KW = dict(in_channels=1, out_channels=1, num_resblocks=2,
              num_features=8, upscale_factor=2, num_experts=2,
              group_size=64, moe_every=1)


def _selection(af, cap):
    """(G, e, gs) affinities -> the selection mask, the JAX rank's rule."""
    gs = af.shape[-1]
    a_i, a_j = af[..., :, None], af[..., None, :]
    j_lt_i = np.arange(gs)[None, :] < np.arange(gs)[:, None]
    rank = ((a_j > a_i) | ((a_j == a_i) & j_lt_i)).sum(-1)
    return rank < cap


@pytest.mark.parametrize("router_impl", ["rank", "rank_pallas"])
def test_moe_gradients_match_jax_mask_first(rng, router_impl):
    x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    target = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    # JAX runs the XLA rank (the same selection as its Pallas kernel).
    jnet = JaxMoEEDSRNet(**MOE_KW, router_impl="rank")
    variables = randomize(init(jnet, x, seed=4), rng)
    net = MoEEDSRNet(**MOE_KW, router_impl=router_impl)
    load_jax_params(net, variables)

    # Mask first: each MoE layer's input in both frameworks, its
    # affinities and its selection.
    _, state = jnet.apply(variables, jnp.asarray(x),
                          capture_intermediates=True)
    inputs = []
    hooks = [layer.register_forward_pre_hook(
        lambda m, args: inputs.append(args[0].detach()))
        for layer in net.moes.values()]
    with torch.no_grad():
        net(first(x))
    for h in hooks:
        h.remove()
    for i, (layer, got_in) in enumerate(zip(net.moes.values(), inputs)):
        want_in = np.asarray(state["intermediates"][f"_ResBlock_{i}"][
            "__call__"][0])
        np.testing.assert_allclose(np.moveaxis(got_in.numpy(), 1, -1),
                                   want_in, rtol=2e-5, atol=2e-5)
        with torch.no_grad():
            af_t, gs = layer.affinities(got_in)
            af_j = layer.affinities(first(want_in))[0].numpy()
        cap = layer.capacity(gs)
        sel_t = moe.route(af_t, router_impl).numpy() < cap
        sel_j = _selection(af_j, cap)
        flipped = sel_t != sel_j
        kth = np.sort(af_j, axis=-1)[..., -cap][..., None]
        assert np.all(np.abs(af_j - kth)[flipped] <= 1e-6)
        assert not flipped.any()  # this seed: every gradient is comparable

    hold_train_step(jnet, net, x, target, rng, variables=variables,
                    to_port=first)
