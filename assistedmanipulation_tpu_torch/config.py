"""Configuration system: nested dataclasses with JSON round-trip and RFC-7386
merge-patch semantics (the port's own copy of assistedmanipulation_tpu/config.py,
which imports no JAX; the port imports nothing of that package).

Mirrors the reference's nlohmann-json configuration conventions
(reference: src/controller/json.hpp:16-83, src/test/case/base.cpp:4-27):

- every component has a ``Configuration`` dataclass with defaults;
- configs serialize to/from plain JSON trees (numpy arrays <-> nested lists,
  ``None`` <-> ``{}`` for optionals is relaxed here to plain ``null``);
- overrides compose by JSON merge-patch onto the defaults, exactly like the
  reference applies ``--config`` patches onto ``DEFAULT_CONFIGURATION``;
- the reference spells horizon as "horison" in its JSON; we accept that
  spelling on input for config-file compatibility.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Optional, Type, TypeVar, Union, get_args, get_origin

import numpy as np

T = TypeVar("T")

# Input key aliases (reference spelling -> canonical field name).
_KEY_ALIASES = {"horison": "horizon"}


def merge_patch(target: Any, patch: Any) -> Any:
    """RFC-7386 JSON merge-patch: dicts merge recursively, ``None`` deletes,
    everything else replaces. Matches nlohmann::json::merge_patch used at
    reference src/test/case/base.cpp:12-24."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    result = dict(target)
    for key, value in patch.items():
        if value is None:
            result.pop(key, None)
        else:
            result[key] = merge_patch(result.get(key), value)
    return result


def to_json(obj: Any) -> Any:
    """Convert a (possibly nested) config dataclass into a JSON-able tree."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            field.name: to_json(getattr(obj, field.name))
            for field in dataclasses.fields(obj)
        }
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {key: to_json(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_json(value) for value in obj]
    if hasattr(obj, "tolist"):  # tensors
        return obj.tolist()
    return obj


def _unwrap_optional(annotation: Any) -> tuple[Any, bool]:
    """Return (inner_type, is_optional) for Optional[T] annotations."""
    if get_origin(annotation) is Union:
        args = [a for a in get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return annotation, False


def _coerce(value: Any, annotation: Any) -> Any:
    """Coerce a JSON value into the annotated type (recursively)."""
    if value is None:
        return None
    annotation, _ = _unwrap_optional(annotation)

    if annotation is Any:
        return value
    if dataclasses.is_dataclass(annotation):
        return from_json(annotation, value)
    if annotation is np.ndarray:
        return np.asarray(value, dtype=np.float64)
    origin = get_origin(annotation)
    if origin in (list, tuple):
        inner = get_args(annotation)
        if origin is tuple and inner and inner[-1] is not Ellipsis:
            return tuple(
                _coerce(item, tp) for item, tp in zip(value, inner)
            )
        item_type = inner[0] if inner else Any
        seq = [_coerce(item, item_type) for item in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        key_type, val_type = (get_args(annotation) + (Any, Any))[:2]
        return {key: _coerce(val, val_type) for key, val in value.items()}
    if annotation is float:
        return float(value)
    if annotation is int:
        return int(value)
    if annotation is bool:
        return bool(value)
    if annotation is str:
        return str(value)
    return value


def from_json(cls: Type[T], tree: Any) -> T:
    """Build a config dataclass from a JSON tree, applying key aliases."""
    if dataclasses.is_dataclass(tree):
        return tree  # already constructed
    if tree is None:
        tree = {}
    if not isinstance(tree, dict):
        raise TypeError(f"cannot build {cls.__name__} from {type(tree)}")

    hints = typing.get_type_hints(cls)
    kwargs = {}
    fields = {field.name: field for field in dataclasses.fields(cls)}
    for key, value in tree.items():
        key = _KEY_ALIASES.get(key, key)
        if key not in fields:
            continue  # ignore unknown keys (forward compatibility)
        kwargs[key] = _coerce(value, hints[fields[key].name])
    return cls(**kwargs)


def patched(defaults: T, patch: Optional[dict] = None) -> T:
    """Apply a JSON merge-patch onto a default configuration dataclass.

    This is the reference's ``json defaults = DEFAULT_CONFIGURATION;
    defaults.merge_patch(patch)`` composition (src/test/case/base.cpp:12-24).
    """
    if not patch:
        return defaults
    tree = merge_patch(to_json(defaults), patch)
    return from_json(type(defaults), tree)


def dump(obj: Any, path: str) -> None:
    """Write the fully-resolved configuration next to run artifacts, like the
    reference's configuration.json dump (src/test/case/base.cpp:88-96)."""
    with open(path, "w") as handle:
        json.dump(to_json(obj), handle, indent=2)


def loads(cls: Type[T], text: str) -> T:
    return from_json(cls, json.loads(text))
