"""Component registry and declarative config instantiation (counterpart of
v3d_tpu/core/registry.py; sgm.util.instantiate_from_config).

Configs name components by the JAX package's short names
(``@register("edm_discretization")``); a dotted ``target`` is imported only
from this package, so a config can never load the JAX package.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Mapping, Optional

_REGISTRY: Dict[str, Any] = {}

_ALLOWED_IMPORT_PREFIXES = ("v3d_tpu_torch.",)


def register(name: Optional[str] = None) -> Callable:
    """Class / function decorator: ``@register("edm_discretization")``."""

    def deco(obj):
        key = name or obj.__name__
        if key in _REGISTRY and _REGISTRY[key] is not obj:
            raise ValueError(f"registry name collision: {key!r}")
        _REGISTRY[key] = obj
        return obj

    return deco


def resolve(target: str) -> Any:
    """A registry short name, or a dotted path within v3d_tpu_torch."""
    if target in _REGISTRY:
        return _REGISTRY[target]
    if "." in target:
        if not target.startswith(_ALLOWED_IMPORT_PREFIXES):
            raise ValueError(
                f"target {target!r} is neither a registered name nor an "
                f"import path under {_ALLOWED_IMPORT_PREFIXES}")
        module, _, attr = target.rpartition(".")
        return getattr(importlib.import_module(module), attr)
    raise KeyError(f"unknown component {target!r}; known: {sorted(_REGISTRY)}")


def instantiate(cfg: Mapping[str, Any], **extra_kwargs) -> Any:
    """Build a component from ``{"target": name, "params": {...}}``; nested
    mappings with a ``target`` are instantiated first."""
    if not isinstance(cfg, Mapping) or "target" not in cfg:
        raise TypeError(f"expected mapping with 'target', got {cfg!r}")
    cls = resolve(cfg["target"])
    params = dict(cfg.get("params", {}) or {})
    params.update(extra_kwargs)
    params = {k: _maybe_instantiate(v) for k, v in params.items()}
    return cls(**params)


def _maybe_instantiate(v):
    if isinstance(v, Mapping) and "target" in v:
        return instantiate(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_maybe_instantiate(x) for x in v)
    return v


def names() -> list:
    return sorted(_REGISTRY)


def check_fixed(owner: str, given: Mapping[str, Any], fixed: Mapping[str, Any]) -> None:
    """Fields of a JAX module that the port builds at one value only (V3D's):
    each field a config passes must be one of ``fixed`` and equal its value
    (a YAML list compares as a tuple); anything else raises."""
    for k, v in given.items():
        if k not in fixed:
            raise TypeError(f"{owner}: unexpected argument {k!r}")
        if (tuple(v) if isinstance(v, list) else v) != fixed[k]:
            raise ValueError(f"{owner}: {k}={v!r} is not built; the port builds "
                             f"only {k}={fixed[k]!r}")
