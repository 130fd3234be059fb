"""The port's EDVR net against ``vsr_tpu``'s, weight for weight
(``load_jax_params``): a train step (outputs at 2e-4, every parameter's
gradient of a Charbonnier loss within 1e-3 of its largest JAX entry), the
pre-deblur / TSA-less / ``HR_in`` / ``fused_tail`` variants, the DCN packs,
and the refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (FORWARD_TOL, first, hold_train_step, init,
                                 last, randomize, window)
from vsr_tpu.models import EDVRNet as JaxEDVRNet
from vsr_tpu.models import edvr as jedvr
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import EDVRNet, edvr


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


EDVR_KW = dict(in_channels=1, out_channels=1, nf=8, nframes=3, groups=2,
               front_RBs=1, back_RBs=1)


def test_edvr_train_step_matches_jax(rng):
    # 6 x 10 LR: padded to 8 x 12 with the batch minimum, cropped after.
    x = rng.standard_normal((2, 3, 6, 10, 1)).astype(np.float32)
    target = rng.standard_normal((2, 24, 40, 1)).astype(np.float32)
    hold_train_step(JaxEDVRNet(**EDVR_KW), EDVRNet(**EDVR_KW), x, target,
                    rng, loss_of=lambda o: jnp.mean(
                        jnp.sqrt((o - target) ** 2 + 1e-6)),
                    port_loss_of=lambda o: torch.mean(torch.sqrt(
                        (o - first(target)) ** 2 + 1e-6)))


@pytest.mark.parametrize("variant", [
    dict(predeblur=True, w_TSA=False, fused_tail=True),
    dict(HR_in=True), dict(predeblur=True, HR_in=True, center=0)])
def test_edvr_variants_match_jax(rng, variant):
    kw = dict(EDVR_KW, **variant)
    size = 16 if kw.get("HR_in") else 8
    x = rng.standard_normal((1, 3, size, size, 1)).astype(np.float32)
    jnet = JaxEDVRNet(**kw)
    variables = randomize(init(jnet, x), rng)
    want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    net = EDVRNet(**kw)
    load_jax_params(net, variables)
    with torch.no_grad():
        got = net(window(x))
    np.testing.assert_allclose(last(got), np.asarray(want), **FORWARD_TOL)


def test_deform_conv_pack_v1_matches_jax(rng):
    x = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    jpack = jedvr.DeformConvPack(5, deformable_groups=2)
    variables = randomize(init(jpack, x), rng)
    want = jpack.apply(variables, jnp.asarray(x))
    pack = edvr.DeformConvPack(4, 5, 2)
    load_jax_params(pack, variables)
    with torch.no_grad():
        got = pack(first(x))
    np.testing.assert_allclose(last(got), np.asarray(want), **FORWARD_TOL)


def test_edvr_refuses_another_window():
    net = EDVRNet(**EDVR_KW)
    with pytest.raises(ValueError, match="windows of 3"):
        net(torch.zeros(1, 5, 1, 8, 8))
    assert net.serving_mode == "window"
    # The DCN offset / mask convs start at zero, as in the reference.
    for pack in net.pcd.dcns:
        assert not pack.offset_conv.weight.any()
