"""Dataclasses of tensors: the port's counterpart of ``flax.struct`` pytrees.

Every state and parameter object of the port (``BipedParams``,
``SrbState``, ``ControllerState``, ``QpSolution``, ``RolloutMetrics``,
``World``, ``CondensedQp``) is a frozen dataclass whose tensor fields carry
a leading env axis. :class:`TensorStruct` gives them the few tree operations
the loop needs: map over the tensor leaves, move to a device, and a per-env
select between two structs (the fall reset).
"""

from __future__ import annotations

import dataclasses

import torch


class TensorStruct:
    """Mixin for frozen dataclasses whose leaves are tensors, nested
    TensorStructs, ``None`` or plain Python values (left untouched)."""

    def map(self, fn):
        """A copy with ``fn`` applied to every tensor leaf."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                changes[f.name] = fn(v)
            elif isinstance(v, TensorStruct):
                changes[f.name] = v.map(fn)
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return self.map(lambda t: t.to(device))

    def where(self, mask: torch.Tensor, other: "TensorStruct"):
        """Per env: ``other`` where ``mask`` (N,) is true, else ``self``.

        The counterpart of ``jax.tree.map(lambda r, s: jnp.where(fell, r,
        s), reset, state)``; every leaf's leading axis is the env axis.
        """
        changes = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, torch.Tensor):
                m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
                changes[f.name] = torch.where(m, b, a)
            elif isinstance(a, TensorStruct):
                changes[f.name] = a.where(mask, b)
        return dataclasses.replace(self, **changes)
