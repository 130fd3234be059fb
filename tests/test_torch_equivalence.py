"""Weight-for-weight forward equivalence vs torch.

Loads the SAME weights into this framework's EDSR and a torch restatement of
the reference architecture (edsr_net.py:8-67) and compares outputs — proving
conv semantics, padding, residual scaling, and pixel-shuffle channel order
all match the reference's building blocks exactly (not just shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_parity import init, randomize
from vsr_tpu.models import EDSRNet

F_, B_ = 8, 2  # features, resblocks


def _build_torch_edsr():
    import torch.nn as nn

    class TorchEDSR(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = nn.Conv2d(1, F_, 3, padding=1)
            self.blocks = nn.ModuleList(
                [
                    nn.Sequential(
                        nn.Conv2d(F_, F_, 3, padding=1), nn.ReLU(),
                        nn.Conv2d(F_, F_, 3, padding=1),
                    )
                    for _ in range(B_)
                ]
            )
            self.body_conv = nn.Conv2d(F_, F_, 3, padding=1)
            self.up = nn.Conv2d(F_, 4 * F_, 3, padding=1)
            self.shuffle = nn.PixelShuffle(2)
            self.tail = nn.Conv2d(F_, 1, 3, padding=1)

        def forward(self, x):
            head = self.head(x)
            b = head
            for blk in self.blocks:
                b = b + 0.1 * blk(b)
            b = self.body_conv(b) + head
            return self.tail(self.shuffle(self.up(b)))

    return TorchEDSR()


def _copy_params_to_torch(params, tnet):
    """Copy flax conv params (HWIO) into the torch net (OIHW)."""
    import torch

    p = params["params"]

    def set_conv(tconv, tree):
        kernel = np.asarray(tree["kernel"])  # (kh, kw, cin, cout)
        bias = np.asarray(tree["bias"])
        with torch.no_grad():
            tconv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
            tconv.bias.copy_(torch.from_numpy(bias))

    set_conv(tnet.head, p["Conv_0"]["Conv_0"])
    for i in range(B_):
        rb = p[f"_ResBlock_{i}"]
        set_conv(tnet.blocks[i][0], rb["Conv_0"]["Conv_0"])
        set_conv(tnet.blocks[i][2], rb["Conv_1"]["Conv_0"])
    set_conv(tnet.body_conv, p["Conv_1"]["Conv_0"])
    set_conv(tnet.up, p["_UpBlock_0"]["Conv_0"]["Conv_0"])
    set_conv(tnet.tail, p["ShuffleConv_0"]["FoldableConv_0"])


def test_edsr_forward_matches_torch_with_shared_weights(rng):
    import torch

    net = EDSRNet(in_channels=1, out_channels=1, num_resblocks=B_,
                  num_features=F_, upscale_factor=2)
    x = rng.random((2, 12, 12, 1)).astype(np.float32)
    # Drawn with numpy over the traced shapes (no flax init compiled).
    params = randomize(init(net, x), np.random.default_rng(0))

    tnet = _build_torch_edsr().eval()
    _copy_params_to_torch(params, tnet)

    ours = np.asarray(jax.jit(net.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        golden = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    golden = golden.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, golden, atol=2e-5)


def test_conv_transpose_matches_torch_with_shared_weights(rng):
    """The projection deconv geometry+values used by SRFBN/DBPN/FRVSR."""
    import torch
    import torch.nn as nn

    from vsr_tpu.models.common import ConvTranspose

    k, s, p = 6, 2, 2
    m = ConvTranspose(features=3, kernel_size=k, strides=s, padding=p)
    x = rng.random((1, 8, 8, 2)).astype(np.float32)
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["ConvTranspose_0"]["kernel"])
    bias = np.asarray(variables["params"]["ConvTranspose_0"]["bias"])

    t = nn.ConvTranspose2d(2, 3, k, s, p)
    with torch.no_grad():
        # flax ConvTranspose kernel: (kh, kw, in, out); torch: (in, out, kh, kw)
        # and torch's transposed conv correlates with a flipped kernel
        # relative to flax's definition.
        t.weight.copy_(
            torch.from_numpy(kernel.transpose(2, 3, 0, 1)).flip(-1).flip(-2)
        )
        t.bias.copy_(torch.from_numpy(bias))
        golden = t(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()

    ours = np.asarray(m.apply(variables, jnp.asarray(x)))
    # The flip IS the convention (flax ConvTranspose correlates, torch
    # convolves); tests/_transplant.py:_copy_deconv depends on it, so this
    # must fail hard if it ever changes — no fallback.
    np.testing.assert_allclose(ours, golden.transpose(0, 2, 3, 1), atol=2e-5)
