"""Checkpoint and resume: the counterpart of
``biped_mpc_py_tpu/utils/checkpoint.py``.

A world (sim state, controller warm start, metrics) is a nest of
:class:`~biped_mpc_py_torch.utils.struct.TensorStruct` dataclasses and
every tick is a pure function of it, so a checkpoint is its leaves keyed by
field path (``sim.q``, ``ctrl.qp.controls``) beside a record of the
structure, and resume is bit-exact. :func:`save_pytree` / :func:`load_pytree`
write one npz file (``save_pytree`` / ``load_pytree``);
:func:`save_pytree_dcp` / :func:`load_pytree_dcp` write a
``torch.distributed.checkpoint`` directory, the sharding-aware form
(``save_pytree_orbax`` / ``load_pytree_orbax``): with ``DTensor`` leaves
each rank writes only its shards, and a load into a mesh of another size
reshards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

_STRUCTURE = "__structure__"
_DCP_RECORD = "structure.json"


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


def _whole(v):
    """A ``DTensor`` gathered whole from the ranks of its 1-D mesh, by the
    list form of ``all_gather``: gloo dies in ``full_tensor``'s gather of
    CUDA tensors (a segfault, torch 2.11 on an H100)."""
    group = v.device_mesh.get_group()
    rows = v.to_local()
    parts = [torch.empty_like(rows) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, rows, group=group)
    return torch.cat(parts)


def save_pytree(path: str, tree) -> None:
    """Save a TensorStruct nest to an npz file (``checkpoint.py:18``): one
    array per leaf, keyed by its field path, and the structure, so that
    :func:`load_pytree` can reject a mismatched one.

    A sharded nest (``DTensor`` leaves) is gathered whole, as JAX's
    ``np.asarray`` gathers a sharded array: every rank of its mesh calls
    this, the mesh's first rank writes the file, and all return once it is
    written.
    """
    # a DTensor leaf cannot exist before its module is loaded: an unsharded
    # nest does not pay for that import
    DTensor = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", ())
    structure, leaves = _walk(tree)
    arrays = {p: _array(_whole(v) if isinstance(v, DTensor) else v) for p, v in leaves}
    arrays[_STRUCTURE] = np.asarray(structure)
    mesh = next((v.device_mesh for _, v in leaves if isinstance(v, DTensor)), None)
    if mesh is None or mesh.get_local_rank() == 0:
        np.savez(path, **arrays)
    if mesh is not None:
        dist.barrier(group=mesh.get_group())


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


def _dcp(call, state, path):
    """``dcp.save`` or ``dcp.load`` of ``state`` at ``path``: collective over
    the default group where there is one, else in this process alone
    (whose warning says just that, and is dropped)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        call(state, checkpoint_id=path, no_dist=not _grouped())


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def save_pytree_dcp(path: str, tree) -> None:
    """Save a TensorStruct nest as a ``torch.distributed.checkpoint``
    directory (``checkpoint.py:62``): its tensors keyed by field path, and
    beside them the structure and the Python-number leaves, so that
    :func:`load_pytree_dcp` can reject a mismatched one.

    With ``DTensor`` leaves every rank of the group calls this and writes
    only its own shards; without a process group it writes plain tensors
    from this one process.
    """
    import torch.distributed.checkpoint as dcp

    structure, leaves = _walk(tree)
    tensors = {p: v for p, v in leaves if isinstance(v, torch.Tensor)}
    numbers = {p: v for p, v in leaves if not isinstance(v, torch.Tensor)}
    if not _grouped() or dist.get_rank() == 0:
        # written before the collective save, which no rank leaves before
        # the first has entered it
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _DCP_RECORD), "w") as f:
            json.dump({"structure": structure, "numbers": numbers}, f)
    _dcp(dcp.save, tensors, path)


def load_pytree_dcp(path: str, like):
    """Load a directory saved by :func:`save_pytree_dcp` into the structure
    of ``like`` (``checkpoint.py:74``): each tensor with the dtype, device
    and placement of ``like``'s leaf. With ``DTensor`` leaves each rank
    reads its own rows, whatever mesh wrote them: a load into a mesh of
    another size reshards. ``like`` itself is left as it was.

    Raises ``ValueError`` if the recorded structure, the leaf count or any
    leaf's shape differs from ``like``'s, as :func:`load_pytree` does.
    """
    import torch.distributed.checkpoint as dcp

    structure, leaves = _walk(like)
    try:
        with open(os.path.join(path, _DCP_RECORD)) as f:
            record = json.load(f)
    except FileNotFoundError:
        raise ValueError(f"{path} holds no checkpoint saved by save_pytree_dcp") from None
    if record["structure"] != structure:
        raise ValueError(
            f"checkpoint structure mismatch:\n  saved: {record['structure']}\n"
            f"  expected: {structure}"
        )
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    numbers = record["numbers"]
    if len(saved) + len(numbers) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(saved) + len(numbers)} leaves, structure expects {len(leaves)}"
        )
    state, values = {}, {}
    for p, want in leaves:
        if isinstance(want, torch.Tensor):
            if p not in saved:
                raise ValueError(f"checkpoint has no leaf {p}")
            shape = tuple(saved[p].size)
            if shape != tuple(want.shape):
                raise ValueError(
                    f"checkpoint leaf {p} shape {shape} != expected {tuple(want.shape)}")
            state[p] = torch.empty_like(want)
        elif p not in numbers:
            raise ValueError(f"checkpoint has no leaf {p}")
        else:
            values[p] = type(want)(numbers[p])
    _dcp(dcp.load, state, path)
    return _rebuild(like, {**values, **state})
