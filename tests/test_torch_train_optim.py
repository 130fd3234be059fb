"""Training slice: the optimizers held against optax on a seeded parameter /
gradient sequence, and every scheduler's LR curve against the JAX class."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsr_tpu import optim as joptim
from vsr_tpu_torch import optim
from vsr_tpu_torch.registry import build, get_class

STEPS = 6


def _run_jax(name, kwargs, params, grads):
    tx = getattr(joptim, name)(**kwargs)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_torch(name, kwargs, params, grads):
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}
    opt = build("optimizer", {"name": name, "kwargs": kwargs}).bind(p.values())
    for g in grads:
        for k, v in g.items():
            p[k].grad = torch.from_numpy(v.copy())
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}


# Adam's first steps are sign-like where a gradient is near 0, so gradients
# are bounded away from 0: |g| in [0.1, 1.1].
@pytest.mark.parametrize("name,kwargs", [
    ("Adam", dict(lr=1e-2)),
    ("Adam", dict(learning_rate=1e-2, weight_decay=0.1, betas=[0.8, 0.9])),
    ("AdamW", dict(lr=1e-2, weight_decay=0.05)),
    ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
])
def test_optimizer_matches_optax(rng, name, kwargs):
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: ((rng.random(v.shape) + 0.1)
                  * rng.choice([-1.0, 1.0], v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    want = _run_jax(name, kwargs, params, grads)
    got = _run_torch(name, kwargs, params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-6)
        assert np.abs(got[k] - params[k]).max() > 1e-3  # it moved


@pytest.mark.parametrize("name", sorted(optim._OPTIMIZERS))
def test_every_optimizer_name_resolves_with_the_jax_default_lr(name):
    factory = build("optimizer", {"name": name})
    jax_default = inspect.signature(getattr(joptim, name)).parameters[
        "learning_rate"].default
    assert factory.lr == jax_default
    opt = factory.bind([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, getattr(torch.optim, name))
    assert build("optimizer", {"name": name, "kwargs": {"lr": 0.5}}).lr == 0.5
    assert build("optimizer", {"name": name,
                               "kwargs": {"learning_rate": 0.25}}).lr == 0.25


def test_unknown_optimizer_and_keyword_raise():
    with pytest.raises(KeyError):
        get_class("optimizer", "Lion")
    with pytest.raises(TypeError):
        build("optimizer", {"name": "Adam", "kwargs": {"lrr": 1.0}}).bind(
            [torch.nn.Parameter(torch.zeros(1))])


SCHEDULERS = [
    ("StepLR", dict(step_size=3, gamma=0.5)),
    ("MultiStepLR", dict(milestones=[2, 5], gamma=0.1)),
    ("ExponentialLR", dict(gamma=0.9)),
    ("ConstantLR", dict(factor=0.25, total_iters=4)),
    ("LinearLR", dict(start_factor=0.1, end_factor=1.0, total_iters=5)),
    ("PolynomialLR", dict(total_iters=8, power=2.0)),
    ("CosineAnnealingLR", dict(T_max=7, eta_min=1e-5)),
    ("CosineAnnealingWarmRestarts", dict(T_0=3, T_mult=2, eta_min=1e-6)),
    ("CyclicLR", dict(base_lr=1e-4, max_lr=1e-2, step_size_up=3,
                      step_size_down=2, mode="triangular2",
                      cycle_momentum=False)),
    ("CyclicLR", dict(base_lr=1e-4, max_lr=1e-2, step_size_up=2,
                      mode="exp_range", gamma=0.95, cycle_momentum=False)),
    ("OneCycleLR", dict(max_lr=1e-2, total_steps=12, cycle_momentum=False)),
    ("OneCycleLR", dict(max_lr=1e-2, epochs=4, steps_per_epoch=3,
                        anneal_strategy="linear", three_phase=True,
                        cycle_momentum=False)),
    ("ReduceLROnPlateau", dict(factor=0.5, patience=1, cooldown=1,
                               min_lr=1e-5)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULERS)
def test_scheduler_curve_equals_jax_exactly(rng, name, kwargs):
    ours = build("lr_scheduler", {"name": name, "kwargs": kwargs})
    theirs = getattr(joptim, name)(**kwargs)
    ours.bind(3e-3)
    theirs.bind(3e-3)
    metrics = (1.0 + 0.3 * np.sin(np.arange(11))).tolist()
    for i, m in enumerate(metrics):
        metric = m if ours.needs_metric else None
        assert ours.step(metric) == theirs.step(metric), (name, i)
        assert ours.state_dict() == theirs.state_dict()
    # Resume: a fresh scheduler with the loaded state continues the curve.
    resumed = build("lr_scheduler", {"name": name, "kwargs": kwargs})
    resumed.load_state_dict(ours.state_dict())
    metric = 0.9 if ours.needs_metric else None
    assert resumed.step(metric) == theirs.step(metric)


def test_scheduler_names_are_the_jax_ones():
    from vsr_tpu import registry as jregistry

    for name in jregistry.names("lr_scheduler"):
        assert issubclass(get_class("lr_scheduler", name), optim.Scheduler)


@pytest.mark.parametrize("name,kwargs,match", [
    ("StepLR", dict(step_size=2, step_size_dwon=3), "unsupported kwargs"),
    ("StepLR", dict(step_size=2, last_epoch=4), "last_epoch"),
    ("CyclicLR", dict(base_lr=1e-4, max_lr=1e-2), "momentum cycling"),
    ("OneCycleLR", dict(max_lr=1e-2, total_steps=5), "momentum cycling"),
])
def test_scheduler_refusals(name, kwargs, match):
    with pytest.raises(ValueError, match=match):
        build("lr_scheduler", {"name": name, "kwargs": kwargs})


def test_set_learning_rate_writes_every_param_group():
    a, b = (torch.nn.Parameter(torch.zeros(1)) for _ in range(2))
    opt = torch.optim.SGD([{"params": [a]}, {"params": [b], "lr": 0.5}], lr=0.1)
    optim.set_learning_rate(opt, 0.02)
    assert [g["lr"] for g in opt.param_groups] == [0.02, 0.02]
    assert optim.get_learning_rate(opt) == 0.02
