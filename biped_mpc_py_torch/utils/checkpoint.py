"""Checkpoint and resume: the counterpart of
``biped_mpc_py_tpu/utils/checkpoint.py`` (``save_pytree`` /
``load_pytree``).

A world (sim state, controller warm start, metrics) is a nest of
:class:`~biped_mpc_py_torch.utils.struct.TensorStruct` dataclasses and
every tick is a pure function of it, so a checkpoint is its leaves in an
npz file, keyed by field path (``sim.q``, ``ctrl.qp.controls``), beside a
record of the structure, and resume is bit-exact. The multi-host orbax
pair of the JAX module waits for the port's multi-device work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_STRUCTURE = "__structure__"


def _walk(obj, prefix=""):
    """(structure string, [(path, leaf)]) of a dataclass nest; leaves are
    tensors and Python numbers, ``None`` fields are part of the structure."""
    parts, leaves = [], []
    for f in dataclasses.fields(obj):
        v, path = getattr(obj, f.name), prefix + f.name
        if dataclasses.is_dataclass(v):
            s, sub = _walk(v, path + ".")
            parts.append(f"{f.name}={s}")
            leaves += sub
        elif v is None:
            parts.append(f"{f.name}=None")
        elif isinstance(v, (torch.Tensor, bool, int, float)):
            parts.append(f.name)
            leaves.append((path, v))
        else:
            raise TypeError(f"{path}: cannot checkpoint a {type(v).__name__}")
    return f"{type(obj).__name__}({','.join(parts)})", leaves


def _array(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_pytree(path: str, tree) -> None:
    """Save a TensorStruct nest to an npz file (``checkpoint.py:18``): one
    array per leaf, keyed by its field path, and the structure, so that
    :func:`load_pytree` can reject a mismatched one."""
    structure, leaves = _walk(tree)
    arrays = {p: _array(v) for p, v in leaves}
    arrays[_STRUCTURE] = np.asarray(structure)
    np.savez(path, **arrays)


def load_pytree(path: str, like):
    """Load a nest saved by :func:`save_pytree` into the structure of
    ``like``, each tensor on ``like``'s device with its dtype
    (``checkpoint.py:27``).

    Raises ``ValueError`` if the recorded structure, the leaf count or any
    leaf's shape differs from ``like``'s: a restore into a mismatched
    structure would otherwise produce garbage silently.
    """
    structure, leaves = _walk(like)
    with np.load(path, allow_pickle=False) as data:
        saved = str(data[_STRUCTURE]) if _STRUCTURE in data.files else None
        if saved is not None and saved != structure:
            raise ValueError(
                f"checkpoint structure mismatch:\n  saved: {saved}\n  expected: {structure}"
            )
        n_saved = sum(1 for k in data.files if k != _STRUCTURE)
        if n_saved != len(leaves):
            raise ValueError(
                f"checkpoint has {n_saved} leaves, structure expects {len(leaves)}"
            )
        values = {}
        for p, want in leaves:
            if p not in data.files:
                raise ValueError(f"checkpoint has no leaf {p}")
            arr = data[p]
            shape = tuple(want.shape) if isinstance(want, torch.Tensor) else ()
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {p} shape {arr.shape} != expected {shape}")
            if isinstance(want, torch.Tensor):
                values[p] = torch.from_numpy(arr).to(device=want.device, dtype=want.dtype)
            else:
                values[p] = type(want)(arr.item())
    return _rebuild(like, values)


def _rebuild(obj, values, prefix=""):
    changes = {}
    for f in dataclasses.fields(obj):
        v, path = getattr(obj, f.name), prefix + f.name
        if dataclasses.is_dataclass(v):
            changes[f.name] = _rebuild(v, values, path + ".")
        elif v is not None:
            changes[f.name] = values[path]
    return dataclasses.replace(obj, **changes)
