"""Declarative configuration registry (counterpart of panst3r_tpu/core/config.py).

Configs are frozen dataclasses registered by class name so that a config
tree round-trips through plain dicts.  The file helpers (YAML/JSON) of the
JAX package wait for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Type, TypeVar

_REGISTRY: dict[str, type] = {}

T = TypeVar("T")


def register(cls: Type[T]) -> Type[T]:
    """Class decorator: make a (dataclass) config serializable by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        d = {f.name: to_dict(getattr(cfg, f.name))
             for f in dataclasses.fields(cfg)}
        d["_type_"] = type(cfg).__name__
        return d
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def from_dict(d: Any) -> Any:
    if isinstance(d, dict) and "_type_" in d:
        cls = _REGISTRY[d["_type_"]]
        kwargs = {k: from_dict(v) for k, v in d.items() if k != "_type_"}
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kwargs) - field_names
        if unknown:
            raise ValueError(f"unknown fields for {cls.__name__}: {unknown}")
        # tuples serialize as lists; restore them where the default is one
        for f in dataclasses.fields(cls):
            if isinstance(f.default, tuple) and isinstance(kwargs.get(f.name),
                                                           list):
                kwargs[f.name] = tuple(kwargs[f.name])
        return cls(**kwargs)
    if isinstance(d, list):
        return [from_dict(v) for v in d]
    if isinstance(d, dict):
        return {k: from_dict(v) for k, v in d.items()}
    return d

