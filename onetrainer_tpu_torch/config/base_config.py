"""Declarative typed config base (the port's copy of
onetrainer_tpu/config/base_config.py).

JSON contract is shared with the reference (reference:
modules/util/config/BaseConfig.py): fields serialize by name, enums by
value-name string, +/-inf floats as strings, a top-level ``__version``
integer drives a chain of migration functions on load. The implementation
here is fresh: fields are declared as ``Field`` entries, unknown keys are
ignored, bad values fall back to defaults with a warning.
"""

from __future__ import annotations

import copy
from collections.abc import Callable
from dataclasses import dataclass
from enum import Enum
from typing import Any, get_args, get_origin


@dataclass(frozen=True)
class Field:
    name: str
    default: Any
    type: type
    nullable: bool = False


def _is_config_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, BaseConfig)


def _list_elem_type(t):
    if get_origin(t) is list and get_args(t):
        return get_args(t)[0]
    return None


def _dict_value_type(t):
    if get_origin(t) is dict and len(get_args(t)) == 2:
        return get_args(t)[1]
    return None


class BaseConfig:
    # subclasses override
    config_version: int = 0
    config_migrations: dict[int, Callable[[dict], dict]] = {}

    def __init__(self, fields: list[Field]):
        self._fields: dict[str, Field] = {f.name: f for f in fields}
        for f in fields:
            setattr(self, f.name, copy.deepcopy(f.default))

    # -- construction ------------------------------------------------------

    @classmethod
    def default_values(cls) -> "BaseConfig":
        return cls()

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        data: dict[str, Any] = {'__version': self.config_version}
        for name, f in self._fields.items():
            value = getattr(self, name)
            data[name] = self._encode(value, f.type)
        return data

    @staticmethod
    def _encode(value, t):
        if value is None:
            return None
        if _is_config_type(t):
            return value.to_dict()
        elem = _list_elem_type(t)
        if t is list or elem is not None:
            if elem is not None and _is_config_type(elem):
                return [v.to_dict() for v in value]
            return value
        dval = _dict_value_type(t)
        if t is dict or dval is not None:
            if dval is not None and _is_config_type(dval):
                return {k: v.to_dict() for k, v in value.items()}
            return value
        if isinstance(t, type) and issubclass(t, Enum):
            return str(value)
        if t is float and value in (float('inf'), float('-inf')):
            return str(value)
        return value

    def from_dict(self, data: dict) -> "BaseConfig":
        version = data.get('__version', 0)
        while version in self.config_migrations:
            data = self.config_migrations[version](data)
            # a migration may fast-forward by writing a higher __version
            # (used to skip the chain for version-less but modern files)
            version = max(version + 1, data.get('__version', 0))

        for name, f in self._fields.items():
            if _is_config_type(f.type):
                if name in data and data[name] is not None:
                    getattr(self, name).from_dict(data[name])
                continue
            if name not in data:
                continue
            try:
                setattr(self, name, self._decode(data[name], f))
            except Exception:
                print(f"Could not set {name} as {data[name]!r}")
        return self

    def _decode(self, value, f: Field):
        t = f.type
        if value is None:
            if f.nullable:
                return None
            # non-nullable with null in file: keep current value
            return getattr(self, f.name)
        elem = _list_elem_type(t)
        if t is list or elem is not None:
            if elem is not None and _is_config_type(elem):
                return [elem.default_values().from_dict(v) for v in value]
            return value
        dval = _dict_value_type(t)
        if t is dict or dval is not None:
            if dval is not None and _is_config_type(dval):
                return {k: dval.default_values().from_dict(v) for k, v in value.items()}
            return value
        if isinstance(t, type) and issubclass(t, Enum):
            return t[value] if isinstance(value, str) else value
        if t is str:
            return str(value)
        if t is bool:
            return bool(value)
        if t is int:
            return int(value)
        if t is float:
            if value in ('inf', '-inf'):
                return float(value)
            return float(value)
        return value

    # -- misc ---------------------------------------------------------------

    def clone(self):
        return copy.deepcopy(self)

    def __repr__(self) -> str:
        inner = ', '.join(f"{n}={getattr(self, n)!r}" for n in list(self._fields)[:8])
        return f"{type(self).__name__}({inner}, ...)"
