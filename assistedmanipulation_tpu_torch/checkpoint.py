"""Checkpoint / resume for controller and experiment state (port of
assistedmanipulation_tpu/checkpoint.py).

The reference has no state serialization: its only warm state is in memory
(the shifted optimal control and kept rollout noise, mppi.cpp:194-253, and
the forecast filter estimate). Any tree of tensors — ``PlannerState``, the
Kalman forecast state, a PID state, a dict of them — round-trips through
one ``.npz`` file keyed by tree path, so long experiments resume exactly
(the same optimal control, planner key, elite noise, filter covariance).

The file layout is the JAX package's: a ``__manifest__`` JSON string
(``version``, the leaves' ``paths``, ``metadata``) and one ``leaf_{i}``
array per leaf, written to ``<path>.tmp`` and renamed over ``path``. Paths
are spelled as JAX's ``keystr`` spells them (``['key']`` for a dict key,
``.field`` for a NamedTuple field, ``[i]`` for a sequence index), so a file
the JAX package wrote for a dict of arrays restores here.

The flattener is explicit: dicts (keys in sorted order, as JAX flattens
them), NamedTuples, tuples and lists are nodes; tensors, numpy arrays and
Python numbers are leaves; None is an empty node.

Restore is template-driven: the caller supplies a tree of the right
structure (e.g. ``planner.init()``) and gets back the saved values in the
template's types — a tensor at the template tensor's dtype and device (the
planner's key stays on the host, its state on the card), an array at its
dtype, a Python number as its type. A mismatch of structure or shape
(configuration drift between save and load) raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

FORMAT_VERSION = 1

_SCALARS = (bool, int, float, np.generic)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree, path: str = "") -> list:
    """[(path, leaf)] in a stable order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in _flatten(tree[key], f"{path}[{key!r}]")]
    if _is_namedtuple(tree):
        return [item for name in tree._fields for item in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [item for i, node in enumerate(tree) for item in _flatten(node, f"{path}[{i}]")]
    if isinstance(tree, (torch.Tensor, np.ndarray, *_SCALARS)):
        return [(path, tree)]
    raise TypeError(f"checkpoint: {path or 'the tree'} is a {type(tree).__name__}, not a tensor, array or number")


def _rebuild(tree, leaf: Callable):
    """``tree`` with each leaf replaced by ``leaf(old)``, in ``_flatten``'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaf) for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, name), leaf) for name in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(node, leaf) for node in tree)
    return leaf(tree)


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_checkpoint(path: str, tree: Any, metadata: Optional[dict] = None):
    """Serialize a tree of tensors, arrays and numbers to ``path`` (.npz).
    ``metadata`` is any JSON-serializable dict stored alongside (time,
    tick, update count, ...)."""
    leaves = _flatten(tree)
    arrays = {f"leaf_{index}": _to_numpy(value) for index, (_, value) in enumerate(leaves)}
    manifest = {"version": FORMAT_VERSION, "paths": [p for p, _ in leaves], "metadata": metadata or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # Write-then-rename so a crash mid-save never leaves a torn checkpoint.
    temporary = path + ".tmp"
    with open(temporary, "wb") as handle:
        np.savez(handle, __manifest__=json.dumps(manifest), **arrays)
    os.replace(temporary, path)


def load_metadata(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__manifest__"]))["metadata"]


def restore_checkpoint(path: str, template: Any) -> Any:
    """Load a checkpoint into the structure of ``template``: each leaf in
    the template leaf's type, dtype and device; paths and shapes must
    match exactly."""
    leaves = _flatten(template)
    template_paths = [p for p, _ in leaves]
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        if manifest["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {manifest['version']} != {FORMAT_VERSION}")
        saved_paths = manifest["paths"]
        if saved_paths != template_paths:
            differing = set(saved_paths) ^ set(template_paths)
            raise ValueError(
                f"checkpoint structure does not match template (differing leaves: {sorted(differing)[:8]})"
            )
        values = iter([data[f"leaf_{index}"] for index in range(len(leaves))])

    paths = iter(template_paths)

    def restore(leaf):
        value, where = next(values), next(paths)
        shape = tuple(leaf.shape) if isinstance(leaf, (torch.Tensor, np.ndarray)) else ()
        if value.shape != shape:
            raise ValueError(f"leaf {where} shape {value.shape} != template {shape}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(value)).to(dtype=leaf.dtype, device=leaf.device)
        if isinstance(leaf, np.ndarray):
            return value.astype(leaf.dtype)
        if isinstance(leaf, np.generic):
            return type(leaf)(value)
        return type(leaf)(value.item())

    return _rebuild(template, restore)
