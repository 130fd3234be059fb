"""Name -> class registries of the port (counterpart of
``vsr_tpu/registry.py``).

Kept apart from ``vsr_tpu.registry``: that one raises on a duplicate name
(``DRFNet`` exists in both packages) and populates itself by importing the
flax model modules. ``build`` reproduces the ``cls(*args, **cfg.kwargs)``
call convention of the YAML configs, including the "kwargs may be absent"
case.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Mapping

# category -> {name -> class}
_REGISTRIES: dict[str, dict[str, type]] = {}

# category -> the module (or modules) whose import registers its members.
_MODULES = {
    "net": "vsr_tpu_torch.models",
    "dataset": "vsr_tpu_torch.data.datasets",
    "transform": "vsr_tpu_torch.data.transforms",
    "loader": "vsr_tpu_torch.data.loader",
    "loss": "vsr_tpu_torch.losses",
    "metric": "vsr_tpu_torch.metrics",
    "optimizer": "vsr_tpu_torch.optim",
    "lr_scheduler": "vsr_tpu_torch.optim",
    "logger": "vsr_tpu_torch.callbacks.logger",
    "monitor": "vsr_tpu_torch.callbacks.monitor",
    "trainer": ("vsr_tpu_torch.runner.trainers",
                "vsr_tpu_torch.runner.device_trainer"),
    "predictor": "vsr_tpu_torch.runner.predictors",
}


def register(category: str, name: str | None = None) -> Callable[[type], type]:
    """Class decorator: ``@register('net')`` registers under the class name,
    ``@register('logger', 'AcdcVSRLogger')`` under the given one."""

    def deco(cls: type) -> type:
        key = name or cls.__name__
        bucket = _REGISTRIES.setdefault(category, {})
        if key in bucket and bucket[key] is not cls:
            raise ValueError(f"Duplicate registration {category}/{key}")
        bucket[key] = cls
        return cls

    return deco


def get_class(category: str, name: str) -> type:
    modules = _MODULES.get(category, ())
    for module in (modules,) if isinstance(modules, str) else modules:
        importlib.import_module(module)  # importing it registers the members
    bucket = _REGISTRIES.get(category, {})
    if name not in bucket:
        raise KeyError(f"No {category!r} named {name!r} is registered in the "
                       f"port. Available: {sorted(bucket)}")
    return bucket[name]


def build(category: str, spec: Mapping[str, Any], *args: Any,
          **extra_kwargs: Any) -> Any:
    """Instantiate ``spec = {name, kwargs?}``: positional ``args`` first, then
    the spec's ``kwargs`` merged with ``extra_kwargs`` (which win)."""
    cls = get_class(category, spec["name"])
    kwargs = dict(spec.get("kwargs") or {})
    kwargs.update(extra_kwargs)
    return cls(*args, **kwargs)
