"""The port's streams (``vsr_tpu_torch/stream.py``) against ``vsr_tpu``'s
(``vsr_tpu.stream.make_stream``) on the same weights (``interop``) and
against the port's own batch pipeline, for every stream family: recurrent
(DRFNet with the fused squeeze, FRVSRNet, Volume4DSRNet), per-frame
(EDSRNet, MoE-EDSR with the rank op), volumetric (Volume3DSRNet) and
windowed (DUFNet with the filter op, both window orders). Bar: >= 99.9 %
exact grey, <= 1 grey (the port's and JAX's convolutions round apart; on
the CPU the port's stream equals its batch pipeline exactly, which is also
asserted). Then fork isolation, the geometry guards, ``reset``, and
``WindowStream.flush``'s order and its ``T < nf`` refusal."""

import jax
import numpy as np
import pytest
import torch

import vsr_tpu.models as jmodels
from tests._torch_cases import run_cases
from tests._torch_parity import init, randomize
from vsr_tpu.stream import make_stream as jax_make_stream
from vsr_tpu_torch import models
from vsr_tpu_torch.infer import make_pipeline
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.stream import (FrameStream, RecurrentStream, WindowStream,
                                  make_stream)

D, T, H, W = 2, 8, 24, 24
LH, LW = H // 2, W // 2

# name -> (net class, kwargs, example input (flax layout), batch pipeline
# mode, windows, port family, kwargs on the JAX side only)
FAMILIES = {
    "drf": ("DRFNet", dict(in_channels=1, out_channels=1, num_features=8,
                           num_groups=2, upscale_factor=2, fused_squeeze=True,
                           fused_tail=True),
            (1, 2, LH, LW, 1), dict(video_t=T), 0, "RecurrentStream", {}),
    "frvsr": ("FRVSRNet", dict(in_channels=1, out_channels=1,
                               upscale_factor=2, num_resblocks=2,
                               is_prediction=True),
              (1, 2, LH, LW, 1), dict(video_t=T), 0, "RecurrentStream", {}),
    "vol4d": ("Volume4DSRNet", dict(in_channels=1, out_channels=1,
                                    num_features=4, num_resblocks=1,
                                    upscale_factor=2),
              (1, 2, 2, LH, LW, 1), dict(volume=("4d", T)), 0,
              "RecurrentStream", {}),
    "vol3d": ("Volume3DSRNet", dict(in_channels=1, out_channels=1,
                                    num_features=4, num_resblocks=1,
                                    upscale_factor=2),
              (1, 2, LH, LW, 1), dict(volume=("3d", T)), 0, "Volume3DStream",
              {}),
    "edsr": ("EDSRNet", dict(in_channels=1, out_channels=1, num_resblocks=1,
                             num_features=4, upscale_factor=2),
             (1, LH, LW, 1), {}, 0, "FrameStream", {}),
    "moe": ("MoEEDSRNet", dict(in_channels=1, out_channels=1,
                               num_resblocks=2, num_features=8,
                               upscale_factor=2, num_experts=2,
                               group_size=36, moe_every=1,
                               router_impl="rank_pallas"),
            (1, LH, LW, 1), {}, 0, "FrameStream", {}),
    "duf-middle": ("DUFNet", dict(in_channels=1, out_channels=1,
                                  num_frames=7, size_filter=3,
                                  upscale_factor=2, use_pallas_filter=True),
                   (1, 7, LH, LW, 1), dict(window=(7, T, "middle")), 7,
                   "WindowStream", {"use_pallas_filter": False}),
}


@pytest.fixture(scope="module")
def hr():
    rng = np.random.default_rng(0)
    return np.round(rng.random((D * T, H, W)) * 255).astype(np.float32)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nets(key, seed=0):
    name, kw, example, _, _, _, jax_only = FAMILIES[key]
    jnet = getattr(jmodels, name)(**{**kw, **jax_only})
    extra = {"train": False} if name == "DUFNet" else {}
    rng = np.random.default_rng(seed)
    variables = randomize(init(jnet, np.zeros(example, np.float32), seed=seed,
                               **extra), rng)
    net = getattr(models, name)(**kw).eval()
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, variables))
    return jnet, variables, net


def _drive(stream, hr_frames, to_numpy):
    """Push the sequence's T time points (each a (D, H, W) stack), flush;
    the SR frames reassembled slice-major (D*T, H, W)."""
    seq = hr_frames.reshape(D, T, H, W)
    out = {}
    for t in range(T):
        got = stream.push(seq[:, t])
        if got is None:
            continue
        t_out, sr = (got[0], got[2]) if len(got) == 3 else (t, got[1])
        out[t_out] = to_numpy(sr)
    for t_out, _lr, sr in stream.flush():
        out[t_out] = to_numpy(sr)
    assert sorted(out) == list(range(T))
    return np.stack([out[t] for t in range(T)], axis=1).reshape(D * T, H, W)


def _agree(got, want, what):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff == 0).mean() >= 0.999, f"{what}: {(diff == 0).mean()} exact"
    assert diff.max() <= 1.0, f"{what}: max diff {diff.max()}"


def _case_stream_matches_vsr_tpu_and_the_batch_pipeline(hr, key):
    _, _, _, mode, windows, family, _ = FAMILIES[key]
    jnet, variables, net = _nets(key)
    want = _drive(jax_make_stream(jnet, variables, factor=2, windows=windows),
                  hr, np.asarray)
    stream = make_stream(net, factor=2, windows=windows)
    assert type(stream).__name__ == family
    got = _drive(stream, hr, lambda t: t.numpy())
    _agree(got, want, f"{key}: port stream vs vsr_tpu stream")
    _, batch = make_pipeline(net, 2, "acdc", **mode)(torch.from_numpy(hr))
    np.testing.assert_array_equal(got, batch.numpy())
    assert want.std() > 1.0


def _case_window_stream_last_order_and_flush(hr):
    """order='last': every output waits for nothing (e = 0), flush emits
    the nf - 1 head wraps in order; T < nf is refused."""
    _, _, net = _nets("duf-middle")
    stream = make_stream(net, factor=2, windows=7, order="last")
    assert (stream.shift, stream.e) == (6, 0)
    seq = hr.reshape(D, T, H, W)
    emitted = [stream.push(seq[:, t]) for t in range(T)]
    assert [e is None for e in emitted] == [True] * 6 + [False] * 2
    assert [e[0] for e in emitted[6:]] == [6, 7]
    flushed = stream.flush()
    assert [t for t, _, _ in flushed] == list(range(6))
    got = np.stack([x.numpy() for x in (
        [sr for _, _, sr in flushed] + [e[2] for e in emitted[6:]])], axis=1)
    _, batch = make_pipeline(net, 2, "acdc", window=(7, T, "last"))(
        torch.from_numpy(hr))
    np.testing.assert_array_equal(got.reshape(D * T, H, W), batch.numpy())
    # flush reset the stream: a short sequence is refused at its end.
    for t in range(3):
        assert stream.push(seq[:, t]) is None
    with pytest.raises(ValueError, match="shorter than the window"):
        stream.flush()


def _case_forks_are_isolated_and_share_the_net(hr):
    _, _, net = _nets("drf")
    template = make_stream(net, factor=2)
    a, b = template.fork(), template.fork()
    assert a.net is b.net is net
    seq = hr.reshape(D, T, H, W)
    outs_a, outs_b = [], []
    for t in range(3):  # interleave the same sequence on both
        outs_a.append(a.push(seq[:, t])[1])
        outs_b.append(b.push(seq[:, t])[1])
    assert all(torch.equal(x, y) for x, y in zip(outs_a, outs_b))
    # A third fork starts afresh: its first output is frame 0's again.
    c = template.fork()
    assert torch.equal(c.push(seq[:, 0])[1], outs_a[0])
    assert template._state is None


def _case_geometry_guards_and_reset(hr):
    _, _, net = _nets("drf")
    stream = make_stream(net, factor=2)
    with pytest.raises(ValueError, match=r"\(N, H, W\)"):
        stream.push(hr[0])
    first = stream.push(hr[:2])[1]
    with pytest.raises(ValueError, match="geometry changed"):
        stream.push(hr[:2, :, :12])
    second = stream.push(hr[:2])[1]
    assert not torch.equal(first, second)  # the carry moved on
    stream.reset()
    assert torch.equal(stream.push(hr[:2])[1], first)  # a new sequence
    stream.reset()
    assert stream.push(hr[:3, :12, :12])[1].shape == (3, 12, 12)
    with pytest.raises(ValueError, match="upscale_factor"):
        RecurrentStream(net, 4, "acdc", lambda n: None)
    with pytest.raises(ValueError, match="circular windows do not apply"):
        make_stream(_nets("vol4d")[2], factor=2, windows=7)
    with pytest.raises(ValueError, match="order"):
        WindowStream(net, 2, "acdc", 7, order="first")
    assert isinstance(make_stream(_nets("edsr")[2], factor=2), FrameStream)


# The cases run inside two tests, every case run and each failure named
# (see tests/test_torch_serve.py for why).


def test_every_family_matches_vsr_tpu_and_the_batch_pipeline(hr):
    run_cases([(key, lambda key=key:
                _case_stream_matches_vsr_tpu_and_the_batch_pipeline(hr, key))
               for key in sorted(FAMILIES)])


def test_flush_forks_and_guards(hr):
    run_cases([(c.__name__, lambda c=c: c(hr)) for c in (
        _case_window_stream_last_order_and_flush,
        _case_forks_are_isolated_and_share_the_net,
        _case_geometry_guards_and_reset)])
