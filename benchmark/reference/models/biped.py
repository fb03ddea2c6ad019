"""HECTOR biped parameters (L0): the counterpart of
``biped_mpc_py_tpu/models/biped.py``.

Every field is a tensor with a leading env axis, so a domain-randomized
population of robots is one ``BipedParams`` whose rows differ
(``parallel/rollout.py::randomize_params``). The defaults hold one env
(axis length 1); :meth:`BipedParams.expand` makes ``n`` copies. The two leg
geometry presets mirror the JAX ones (see that module for why there are
two).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.utils.struct import TensorStruct


def _per_env(*values):
    """Field default: one env's value, shape (1,) or (1, k)."""
    if len(values) == 1:
        return dataclasses.field(
            default_factory=lambda: torch.tensor(values, dtype=torch.float32)
        )
    return dataclasses.field(
        default_factory=lambda: torch.tensor([values], dtype=torch.float32)
    )


@dataclasses.dataclass(frozen=True)
class LegGeometry(TensorStruct):
    """Constants of the 5-DoF HECTOR leg chain (``models/biped.py:42``),
    each (N,)."""

    hip_x: torch.Tensor = _per_env(-0.015)
    hip_y: torch.Tensor = _per_env(0.020)
    hip_z: torch.Tensor = _per_env(-0.060)
    abd_y: torch.Tensor = _per_env(0.023)
    abd_y_const: torch.Tensor = _per_env(0.0)
    l_thigh: torch.Tensor = _per_env(0.22)
    l_shank: torch.Tensor = _per_env(0.22)
    l_foot: torch.Tensor = _per_env(0.036)


def _leg(**values) -> LegGeometry:
    return LegGeometry(**{
        k: torch.tensor([v], dtype=torch.float32) for k, v in values.items()
    })


# Reproduces reference getFootPositionBody (bipedalLocomotionMPC.py:367-404).
HECTOR_LEG_FK = LegGeometry()

# Makes the Jacobian of the FK reproduce reference getLegKinematics Jm
# (bipedalLocomotionMPC.py:306-365).
HECTOR_LEG_JAC = _leg(
    hip_x=-0.0135, hip_y=-0.015, hip_z=-0.060, abd_y=-0.018,
    abd_y_const=-0.0025, l_thigh=0.22, l_shank=0.22, l_foot=0.040,
)


@dataclasses.dataclass(frozen=True)
class BipedParams(TensorStruct):
    """SRB and contact-geometry parameters (``models/biped.py:85``).

    Shapes: scalars (N,), vectors (N, 3).
    """

    m: torch.Tensor = _per_env(12.0)
    I_diag: torch.Tensor = _per_env(0.932, 0.9420, 0.0711)
    lt: torch.Tensor = _per_env(0.09)
    lh: torch.Tensor = _per_env(0.05)
    g: torch.Tensor = _per_env(9.81)
    hip_offset: torch.Tensor = _per_env(-0.005, 0.047, -0.126)
    mu: torch.Tensor = _per_env(0.5)
    f_max: torch.Tensor = _per_env(500.0, 500.0, 500.0)
    f_min: torch.Tensor = _per_env(0.0, 0.0, 0.0)
    tau_max: torch.Tensor = _per_env(0.0, 67.0, 33.5)
    leg: LegGeometry = dataclasses.field(default_factory=LegGeometry)
    leg_jac: LegGeometry | None = None

    @property
    def jac_geometry(self) -> LegGeometry:
        return self.leg if self.leg_jac is None else self.leg_jac

    @property
    def I_body(self) -> torch.Tensor:
        """Body-frame inertia tensors (N, 3, 3)."""
        return torch.diag_embed(self.I_diag)

    def expand(self, n: int) -> "BipedParams":
        """``n`` envs, each a copy of env 0 (contiguous, owns its memory)."""
        return self.map(
            lambda t: t[:1].expand((n,) + t.shape[1:]).contiguous()
        )
