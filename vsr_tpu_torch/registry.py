"""Name -> class registry of the port's nets.

Kept apart from ``vsr_tpu.registry``: that one raises on a duplicate name
(``DRFNet`` exists in both packages) and populates itself by importing the
flax model modules.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

# category -> {name -> class}
_REGISTRIES: dict[str, dict[str, type]] = {}


def register(category: str) -> Callable[[type], type]:
    """Class decorator: ``@register('net')`` registers under the class name."""

    def deco(cls: type) -> type:
        key = cls.__name__
        bucket = _REGISTRIES.setdefault(category, {})
        if key in bucket and bucket[key] is not cls:
            raise ValueError(f"Duplicate registration {category}/{key}")
        bucket[key] = cls
        return cls

    return deco


def get_class(category: str, name: str) -> type:
    import vsr_tpu_torch.models  # noqa: F401 — registers the nets

    bucket = _REGISTRIES.get(category, {})
    if name not in bucket:
        raise KeyError(f"No {category!r} named {name!r} is registered in the "
                       f"port. Available: {sorted(bucket)}")
    return bucket[name]


def build(category: str, spec: Mapping[str, Any], **extra_kwargs: Any) -> Any:
    """Instantiate ``spec = {name, kwargs?}``; ``extra_kwargs`` win."""
    cls = get_class(category, spec["name"])
    kwargs = dict(spec.get("kwargs") or {})
    kwargs.update(extra_kwargs)
    return cls(**kwargs)
