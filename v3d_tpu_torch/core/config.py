"""YAML config loading with dotted-key overrides (counterpart of
v3d_tpu/core/config.py, a copy kept here so that the port imports nothing
of the JAX package).

Load a YAML file, apply ``a.b.c=value`` overrides (values parsed as YAML)
and expose attribute-style access.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, Mapping

import yaml


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested mappings."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(o):
            if isinstance(o, Mapping):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def load_config(path: str, overrides: Iterable[str] = ()) -> ConfigDict:
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return make_config(cfg, overrides)


def make_config(cfg: Mapping[str, Any], overrides: Iterable[str] = ()) -> ConfigDict:
    cfg = copy.deepcopy(dict(cfg))
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        set_by_path(cfg, key.strip(), _parse_scalar(raw))
    return ConfigDict.wrap(cfg)


def _parse_scalar(raw: str) -> Any:
    val = yaml.safe_load(raw)
    if isinstance(val, str):
        # YAML 1.1 misses floats like "3e-5" (no dot); recover them.
        try:
            return float(val)
        except ValueError:
            return val
    return val


def set_by_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k) if isinstance(node, dict) else None
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


def save_config(cfg: Mapping[str, Any], path: str) -> None:
    data = cfg.to_dict() if isinstance(cfg, ConfigDict) else dict(cfg)
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
