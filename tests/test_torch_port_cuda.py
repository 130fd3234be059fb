"""The hand-written CUDA fused squeeze on the card, against its plain twin.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided in the fixture, never at import). On a machine with an H100:
``python -m pytest tests/test_torch_port_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from vsr_tpu_torch.ops import fused_squeeze as fs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the f32 twin in full f32
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = prev


def _operands(rng, dev, channels, f, n=2, h=9, w=13):
    xs = [torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)
                           ).to(dev) for c in channels]
    bound = sum(channels) ** -0.5
    wt = torch.from_numpy(
        rng.uniform(-bound, bound, (f, sum(channels))).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(-bound, bound, f).astype(np.float32)).to(dev)
    return xs, wt, b


# Ragged shapes on purpose: channel counts off the 16-channel K step, F off
# the 64-channel tile, pixel counts off the 256-pixel tile.
@pytest.mark.parametrize("channels,f", [((64, 64), 64), ((3, 17, 40), 70),
                                        ((64,) * 8, 64), ((5,), 1)])
def test_kernel_matches_twin_f32(rng, dev, channels, f):
    xs, w, b = _operands(rng, dev, channels, f)
    before = fs.concat_conv1x1.launches
    with torch.inference_mode():
        got = fs.concat_conv1x1(xs, w, b)
        want = fs.concat_conv1x1_reference(xs, w, b)
    torch.cuda.synchronize()
    assert fs.concat_conv1x1.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("channels,f", [((64, 64, 64), 64), ((7, 33), 20)])
def test_kernel_matches_twin_bf16(rng, dev, channels, f):
    xs, w, b = _operands(rng, dev, channels, f)
    xs16 = [x.bfloat16() for x in xs]
    with torch.inference_mode():
        got = fs.concat_conv1x1(xs16, w, b)  # weights rounded to bf16 inside
        want = fs.concat_conv1x1_reference(
            [x.float() for x in xs16], w.bfloat16().float(),
            b.bfloat16().float())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=1e-4)


def test_kernel_refuses_grad_and_strided_inputs(rng, dev):
    xs, w, b = _operands(rng, dev, (4, 4), 8)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fs.concat_conv1x1(xs, w, b)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            fs.concat_conv1x1(
                [xs[0], xs[1].contiguous(memory_format=torch.channels_last)],
                w, b)
