"""YAML <-> nested dataclasses, for the configs under config/.

Keys may be kebab-case or snake-case; unknown keys are ignored (e.g. the
`position_learning_rateo` typo in config/tat_truck_every_8_test.yaml), and
scalars are coerced to the field's type, so the same YAML files load in
this package and in the JAX package. PyYAML is imported only by the
functions that read or write YAML.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _loader():
    """SafeLoader that also accepts the `!!python/tuple` tag (written by
    some config generators for a tuple-typed default) as a plain list; no
    arbitrary Python object construction is enabled."""
    import yaml

    class _TolerantLoader(yaml.SafeLoader):
        pass

    _TolerantLoader.add_constructor(
        "tag:yaml.org,2002:python/tuple",
        lambda loader, node: loader.construct_sequence(node))
    return _TolerantLoader


def _normalize_key(key: str) -> str:
    return key.replace("-", "_")


def _coerce(field_type: Any, value: Any) -> Any:
    """Best-effort scalar coercion (YAML may give '1e3' as str, 1000.0 for an
    int interval, etc.); nested dataclasses recurse."""
    import typing
    origin = typing.get_origin(field_type)
    # effective scalar target after unwrapping Optional[...]
    scalar_target = field_type
    if origin is typing.Union:
        non_none = [a for a in typing.get_args(field_type)
                    if a is not type(None)]
        if len(non_none) == 1:
            scalar_target = non_none[0]
    if (isinstance(value, (list, tuple)) and len(value) == 1
            and scalar_target in (float, int, bool, str, type(None))):
        # `!!python/tuple [null]` style singleton wrapping
        # (config/config_template.yaml) collapses to its element - but ONLY onto
        # (optionally Optional) scalar fields, so a future List[...] / Any
        # field can never have a legitimate [x] silently become x. An empty
        # [] deliberately falls through so a malformed `field: []` raises on
        # non-Optional scalar fields instead of silently becoming None
        value = value[0]
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        if value is None:
            return None
        return _coerce(args[0], value) if len(args) == 1 else value
    if dataclasses.is_dataclass(field_type):
        return from_dict(field_type, value or {})
    if field_type is float:
        return float(value)
    if field_type is int:
        return int(float(value))
    if field_type is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if field_type is str:
        return str(value)
    return value


def from_dict(cls: Type[T], data: dict) -> T:
    """Build a dataclass from a dict, tolerating kebab-case and unknown keys."""
    assert dataclasses.is_dataclass(cls), cls
    data = {(_normalize_key(k) if isinstance(k, str) else k): v
            for k, v in (data or {}).items()}
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name in data:
            kwargs[field.name] = _coerce(field.type_resolved
                                         if hasattr(field, "type_resolved")
                                         else _resolve_type(cls, field),
                                         data[field.name])
    return cls(**kwargs)


def _resolve_type(cls, field):
    """Resolve string annotations (from __future__ annotations) to types."""
    import typing
    hints = typing.get_type_hints(cls)
    return hints.get(field.name, field.type)


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def from_yaml_file(cls: Type[T], path: str) -> T:
    import yaml
    with open(path) as f:
        data = yaml.load(f, Loader=_loader()) or {}
    return from_dict(cls, data)


def to_yaml_file(obj: Any, path: str):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(obj), f, sort_keys=False)


def to_yaml(obj: Any) -> str:
    import yaml
    return yaml.safe_dump(to_dict(obj), sort_keys=False)
