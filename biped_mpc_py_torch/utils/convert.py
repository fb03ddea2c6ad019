"""Carry objects across between the JAX package and the port.

The JAX side hands its objects over as nested field dicts of numpy arrays
and Python scalars, e.g. ``dataclasses.asdict(jax.tree.map(np.asarray,
obj))``, so this module never imports JAX. :func:`from_numpy` builds the
port's object of a given class from such a dict, matching fields by name and
raising on a missing or extra field so that drift between the two packages
fails loudly. :func:`to_numpy` goes back.

Batched JAX objects map one to one: every leaf keeps its leading env axis.
Fields annotated ``float`` (the scalar parameters of ``ArticulatedModel``,
``Terrain.extent``) stay Python floats. A vmapped JAX ``Terrain``
(``Terrain.rough_batch``) carries its ``extent`` broadcast along the env
axis; the port's ``Terrain`` has one extent for all envs, so
:func:`from_numpy` folds an array of equal entries into that float and
raises where envs differ, and :func:`to_numpy` broadcasts it again for a
``Terrain`` with a field per env.

A config sweep carries across with :func:`config_batch_from_numpy`: JAX's
``stack_configs`` returns a batched ``MpcConfig`` and its vmap axes, and the
port's counterpart is one config with the batched fields beside it as
tensors (``parallel/sweep.py::stack_configs``).
"""

from __future__ import annotations

import dataclasses
import types
import typing

import numpy as np
import torch

from biped_mpc_py_torch.config import (
    _VECTOR_FIELDS,
    MPC_PER_ENV_FIELDS,
    PER_ENV_FIELDS,
    STATIC_FIELDS,
    GaitConfig,
    MpcConfig,
)
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.utils.struct import TensorStruct

_CONFIGS = (MpcConfig, GaitConfig)


def _struct_class(hint):
    """The TensorStruct class named by a field's type hint, if any."""
    if isinstance(hint, type) and issubclass(hint, TensorStruct):
        return hint
    if typing.get_origin(hint) in (typing.Union, types.UnionType):
        for arg in typing.get_args(hint):
            if isinstance(arg, type) and issubclass(arg, TensorStruct):
                return arg
    return None


def _check_fields(cls, fields: dict) -> None:
    names = {f.name for f in dataclasses.fields(cls)}
    missing, extra = names - fields.keys(), fields.keys() - names
    if missing or extra:
        raise ValueError(
            f"{cls.__name__}: missing fields {sorted(missing)}, "
            f"extra fields {sorted(extra)}"
        )


def _config_value(name, value):
    if name in _VECTOR_FIELDS:
        return value  # MpcConfig.__post_init__ makes it an f32-exact tuple
    if isinstance(value, np.ndarray):
        if value.ndim != 0:
            raise ValueError(f"config field {name} must be a scalar, got {value.shape}")
        return value.item()
    if isinstance(value, np.generic):
        return value.item()
    return value


def _fold_equal(name, value):
    """A scalar parameter that arrives with an env axis (a vmapped JAX
    object broadcasts it): its one value, or raise where envs differ."""
    if isinstance(value, np.ndarray) and value.ndim > 0:
        if value.size == 0 or not np.all(value == value.flat[0]):
            raise ValueError(f"field {name} differs between envs; the port keeps one value")
        return value.flat[0]
    return value


def from_numpy(cls, fields: dict, device=None):
    """Build a port object of class ``cls`` (an ``MpcConfig``,
    ``GaitConfig`` or TensorStruct dataclass) from a nested field dict."""
    _check_fields(cls, fields)
    if cls in _CONFIGS:
        return cls(**{k: _config_value(k, v) for k, v in fields.items()})
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, value in fields.items():
        sub = _struct_class(hints[name])
        if value is None:
            kwargs[name] = None
        elif sub is not None:
            kwargs[name] = from_numpy(sub, value, device)
        elif hints[name] is float:  # a scalar parameter (ArticulatedModel, Terrain)
            kwargs[name] = _config_value(name, _fold_equal(name, value))
        else:
            kwargs[name] = torch.as_tensor(np.array(value), device=device)  # a copy
    return cls(**kwargs)


def to_numpy(obj) -> dict:
    """The nested field dict of a port object: numpy arrays for tensors and
    config vectors, Python scalars for config scalars."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif isinstance(v, TensorStruct):
            out[f.name] = to_numpy(v)
        elif isinstance(obj, MpcConfig) and f.name in _VECTOR_FIELDS:
            out[f.name] = np.asarray(v, np.float32)
        elif isinstance(obj, Terrain) and f.name == "extent" and obj.batched:
            out[f.name] = np.full(obj.heights.shape[0], v, np.float32)
        else:
            out[f.name] = v
    return out


def config_batch_from_numpy(fields: dict, axes: dict, device=None):
    """The port's ``(mpc, per_env)`` from JAX's ``stack_configs`` output:
    ``fields`` the field dict of its batched ``MpcConfig`` (as numpy) and
    ``axes`` that of its ``in_axes`` (``dataclasses.asdict(in_axes)``: 0 or
    None per dynamic field). A field with axis None goes into the config; a
    field with axis 0 becomes an f32 tensor in ``per_env`` on ``device``
    ((N,), or (N, 12) / (N, 13) for the vectors) and its first row goes
    into the config, as the port's ``stack_configs`` keeps the first
    config. Raises ``ValueError`` where the two disagree: a static field
    batched, an axis other than 0 or None, a batched field the port does
    not take per env, or batched fields of different lengths."""
    _check_fields(MpcConfig, fields)
    _check_fields(MpcConfig, axes)
    per_env_names = set(PER_ENV_FIELDS) | set(MPC_PER_ENV_FIELDS) | {"x_cmd"}
    base, per_env, n = {}, {}, None
    for name, value in fields.items():
        axis = None if name in STATIC_FIELDS else axes[name]
        if name in STATIC_FIELDS and np.ndim(value) > 0:
            raise ValueError(f"static field {name} arrives batched; JAX compiles one "
                             "program per static value")
        if axis is None:
            base[name] = value
            continue
        if axis != 0 or name not in per_env_names:
            raise ValueError(f"field {name} is batched on axis {axis}; the port takes "
                             "per-env values on axis 0 of its per-env fields only")
        value = np.asarray(value, np.float32)
        if n is None:
            n = value.shape[0]
        if value.ndim == 0 or value.shape[0] != n:
            raise ValueError(f"field {name} has shape {value.shape}, the batch has {n} envs")
        base[name] = value[0]
        per_env[name] = torch.tensor(value, device=device)  # a copy
    return from_numpy(MpcConfig, base), per_env
