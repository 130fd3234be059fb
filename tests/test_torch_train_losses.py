"""Training slice: every ported loss and metric against its JAX twin on the
same numpy-seeded inputs (the port is channels-first, the JAX package
channels-last), the JAX package's eleven ``torch.nn``-named losses (both
channels-last) and the ``HuberLoss`` lookup trap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu_torch import losses, metrics
from vsr_tpu_torch.registry import build, get_class
from tests._torch_cases import run_cases


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _first(x):
    """channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


LOSSES = [("L1Loss", {}), ("MSELoss", {}), ("SmoothL1Loss", {}),
          ("HuberLoss", {"delta": 0.01}), ("HuberLoss", {"delta": 0.7}),
          ("CharbonnierLoss", {"epsilon": 1e-3}), ("FlowLoss", {})]


@pytest.mark.parametrize("name,kwargs", LOSSES)
def test_loss_matches_jax(rng, name, kwargs):
    out = (rng.standard_normal((3, 9, 11, 2)) * 1.5).astype(np.float32)
    tgt = rng.standard_normal((3, 9, 11, 2)).astype(np.float32)
    want = float(getattr(jlosses, name)(**kwargs)(jnp.asarray(out),
                                                  jnp.asarray(tgt)))
    fn = build("loss", {"name": name, "kwargs": kwargs})
    assert type(fn).__name__ == name and type(fn).__module__ == losses.__name__
    got = float(fn(_first(out), _first(tgt)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,kwargs", LOSSES)
def test_loss_gradient_matches_jax(rng, name, kwargs):
    import jax

    out = (rng.standard_normal((2, 5, 6, 1)) * 1.5).astype(np.float32)
    tgt = rng.standard_normal((2, 5, 6, 1)).astype(np.float32)
    jfn = getattr(jlosses, name)(**kwargs)
    want = np.asarray(jax.grad(lambda o: jfn(o, jnp.asarray(tgt)))(
        jnp.asarray(out)))
    t = _first(out).requires_grad_(True)
    build("loss", {"name": name, "kwargs": kwargs})(t, _first(tgt)).backward()
    np.testing.assert_allclose(np.moveaxis(t.grad.numpy(), 1, -1), want,
                               rtol=1e-5, atol=1e-8)


def test_huber_loss_lookup_trap():
    """``torch.nn.HuberLoss`` exists and is another function; the project's
    own delta-split flavor (delta required) wins the lookup. A ``torch.nn``
    name resolves to the port's own class where the JAX package defines
    one, and raises where it does not (no fallback to ``torch.nn``)."""
    assert get_class("loss", "HuberLoss") is losses.HuberLoss
    assert get_class("loss", "HuberLoss") is not torch.nn.HuberLoss
    with pytest.raises(TypeError):
        build("loss", {"name": "HuberLoss"})  # delta has no default here
    e, d = torch.tensor([3.0]), 0.5
    ours = float(losses.HuberLoss(d)(e, torch.zeros(1)))
    assert ours == pytest.approx(0.5 * d * d + d * (3.0 - d))
    assert get_class("loss", "BCEWithLogitsLoss") is losses.BCEWithLogitsLoss
    assert get_class("loss", "L1Loss") is losses.L1Loss
    with pytest.raises(KeyError):
        get_class("loss", "NoSuchLoss")
    with pytest.raises(KeyError):
        get_class("loss", "Conv2d")  # torch.nn, but not a *Loss
    with pytest.raises(KeyError):
        get_class("loss", "TripletMarginLoss")  # torch.nn's, not vsr_tpu's


def _jax_losses_cases(rng):
    """``(name, kwargs, output, target)`` of the eleven losses, each on the
    inputs its convention takes (numpy, float32 scores)."""
    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def log_softmax(x):
        x = x - x.max(axis=-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(
            np.float32)

    probs = rng.uniform(0.02, 0.98, (3, 7, 5)).astype(np.float32)
    probs[0, 0, :2] = (0.0, 1.0)  # torch's -100 log clamp
    binary = (rng.random((3, 7, 5)) > 0.5).astype(np.float32)
    dist = rng.random((4, 6)).astype(np.float32)
    dist[:, :2] = 0.0  # target 0 contributes nothing
    dist /= dist.sum(axis=-1, keepdims=True)
    signs = np.where(rng.random((3, 7, 5)) > 0.5, 1.0, -1.0).astype(
        np.float32)
    labels = rng.integers(0, 5, (4, 6)).astype(np.int32)
    multi = rng.integers(0, 6, (5, 6)).astype(np.int32)
    multi[:, 3] = -1  # the prefix ends at the first -1
    multi[0, 0] = -1  # an empty prefix
    cases = [
        ("BCELoss", {}, probs, binary),
        ("BCEWithLogitsLoss", {}, normal(3, 7, 5, scale=3.0), binary),
        ("KLDivLoss", {}, log_softmax(normal(4, 6)), dist),
        ("PoissonNLLLoss", {}, normal(3, 7, 5), np.abs(normal(3, 7, 5))),
        ("PoissonNLLLoss", {"log_input": False},
         np.abs(normal(3, 7, 5)) + 0.1, np.abs(normal(3, 7, 5))),
        ("SoftMarginLoss", {}, normal(3, 7, 5, scale=3.0), signs),
        # Channels-last scores (4, 6, 5): the class axis is the last.
        ("NLLLoss", {}, log_softmax(normal(4, 6, 5)), labels),
        ("CrossEntropyLoss", {}, normal(4, 6, 5, scale=2.0), labels),
        ("CrossEntropyLoss", {}, normal(6, 5), labels[0]),
        ("MultiMarginLoss", {}, normal(6, 5), labels[0]),
        ("MultiMarginLoss", {"p": 2, "margin": 0.5}, normal(6, 5),
         labels[1]),
        ("MultiLabelMarginLoss", {}, normal(5, 6), multi),
        ("MultiLabelSoftMarginLoss", {}, normal(5, 6, scale=2.0),
         (rng.random((5, 6)) > 0.5).astype(np.float32)),
        ("HingeEmbeddingLoss", {"margin": 0.7}, normal(3, 7, 5), signs),
    ]
    return cases


def test_jax_package_losses_match_jax(rng):
    """The JAX package's eleven ``torch.nn``-named losses
    (``vsr_tpu/losses.py:94-251``) against the port's, both in the JAX
    convention (no layout change), float32 at rtol 1e-6 / atol 1e-6."""
    def case(name, kwargs, out, tgt):
        want = float(getattr(jlosses, name)(**kwargs)(jnp.asarray(out),
                                                      jnp.asarray(tgt)))
        fn = build("loss", {"name": name, "kwargs": kwargs})
        assert type(fn).__module__ == losses.__name__
        got = float(fn(torch.from_numpy(out), torch.from_numpy(tgt)))
        assert np.isfinite(want)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    cases = _jax_losses_cases(rng)
    assert len({name for name, *_ in cases}) == 11
    run_cases([(f"{name}{kwargs or ''}{out.shape}",
                lambda args=(name, kwargs, out, tgt): case(*args))
               for name, kwargs, out, tgt in cases])


@pytest.mark.parametrize("size_average", [True, False])
def test_psnr_matches_jax(rng, size_average):
    out = np.round(rng.random((3, 16, 12, 1)) * 255).astype(np.float32)
    tgt = np.round(rng.random((3, 16, 12, 1)) * 255).astype(np.float32)
    tgt[1] = out[1]  # an exact sample: the 1e-10 floor
    want = np.asarray(jmetrics.PSNR(size_average=size_average)(
        jnp.asarray(out), jnp.asarray(tgt)))
    got = metrics.PSNR(size_average=size_average)(_first(out), _first(tgt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dim,shape", [(2, (2, 24, 19, 1)), (2, (2, 16, 16, 3)),
                                       (3, (2, 12, 14, 13, 1))])
@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(rng, dim, shape, size_average):
    out = np.round(rng.random(shape) * 255).astype(np.float32)
    tgt = np.clip(out + rng.standard_normal(shape) * 20, 0, 255).astype(
        np.float32)
    kw = dict(dim=dim, channels=shape[-1], size_average=size_average)
    want = np.asarray(jmetrics.SSIM(**kw)(jnp.asarray(out), jnp.asarray(tgt)))
    got = metrics.SSIM(**kw)(_first(out), _first(tgt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_ssim_kernel_is_the_reference_gaussian():
    for dim in (2, 3):
        np.testing.assert_array_equal(
            metrics._reference_gaussian_kernel(dim),
            jmetrics._reference_gaussian_kernel(dim))
    x = np.arange(11, dtype=np.float64)
    g = np.exp(-(((x - 5) / (2 * 1.5)) ** 2))
    np.testing.assert_allclose(metrics._reference_gaussian_kernel(2),
                               np.outer(g, g) / np.outer(g, g).sum(),
                               rtol=1e-6)


def test_ssim_refuses_small_inputs_and_bad_dim():
    with pytest.raises(ValueError, match=">= 11"):
        metrics.SSIM()(torch.zeros(1, 1, 10, 16), torch.zeros(1, 1, 10, 16))
    with pytest.raises(ValueError, match="dim=2, 3"):
        metrics.SSIM(dim=1)


def test_ssim_turns_tf32_off_and_leaves_cudnn_on(monkeypatch):
    """Inside the metric cuDNN runs in full float32 whatever the global flag
    says, cuDNN itself stays enabled, and the flag is restored after."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.enabled,
                     torch.backends.cudnn.allow_tf32))
        return conv2d(*args, **kwargs)

    metric = metrics.SSIM()
    monkeypatch.setattr(metric, "_conv", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    metric(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 16))
    assert seen == [(True, False)] * 5
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize("name", ["SliceSSIM", "CardiacPSNR", "CardiacSSIM"])
def test_metrics_not_ported_raise_by_name(name):
    # These three were refused until the test path was ported; they build
    # now (the coordinates pickle is read at the first call, not here), and
    # a name that no metric of the port carries still raises by name.
    kwargs = {} if name == "SliceSSIM" else {"coordinates_path": "absent.pkl"}
    metric = build("metric", {"name": name, "kwargs": kwargs})
    assert type(metric).__name__ == name
    with pytest.raises(KeyError, match=f"Not{name}"):
        build("metric", {"name": f"Not{name}", "kwargs": {}})
