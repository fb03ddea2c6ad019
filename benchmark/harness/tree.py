"""Trees of tensors shared by the program and the reference: their leaves,
and a tree of one package's dataclasses rebuilt as the other's."""

from __future__ import annotations

import dataclasses

import torch


def leaves(tree) -> list:
    """The tensor leaves of a tree of dataclasses, tuples and tensors, in
    field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in leaves(v)]
    return []


def named_leaves(tree, prefix: str = "") -> dict:
    """``{dotted field path: tensor}`` of a tree of dataclasses."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out.update(named_leaves(getattr(tree, f.name), f"{prefix}.{f.name}".lstrip(".")))
    return out


def classes(*modules) -> dict:
    """``{name: dataclass}`` of the dataclasses that ``modules`` define or
    import."""
    return {name: obj for m in modules for name, obj in vars(m).items()
            if isinstance(obj, type) and dataclasses.is_dataclass(obj)}


def rebuild(tree, registry: dict):
    """``tree`` (dataclasses of one package) rebuilt, field for field, from
    the classes of the same names in ``registry`` (the other package's),
    its tensors cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = registry[type(tree).__name__]
        return cls(**{f.name: rebuild(getattr(tree, f.name), registry)
                      for f in dataclasses.fields(tree)})
    return tree
