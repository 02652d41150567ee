"""Declarative configuration registry (counterpart of panst3r_tpu/core/config.py).

Configs are frozen dataclasses registered by class name so that a config
tree round-trips through plain dicts, YAML and JSON files.  PyYAML is
imported only inside the YAML helpers: nothing on the card's path needs it.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
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


def save_yaml(cfg: Any, path: str | Path) -> None:
    import yaml
    Path(path).write_text(yaml.safe_dump(to_dict(cfg), sort_keys=False))


def load_yaml(path: str | Path) -> Any:
    import yaml
    return from_dict(yaml.safe_load(Path(path).read_text()))


def save_json(cfg: Any, path: str | Path) -> None:
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2))


def load_json(path: str | Path) -> Any:
    return from_dict(json.loads(Path(path).read_text()))
