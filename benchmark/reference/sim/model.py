"""The articulated HECTOR model: the counterpart of
``biped_mpc_py_tpu/sim/model.py``.

An 11-body tree (torso + two 5-link legs) whose per-leg joints are hip yaw
(z), hip roll (x) and three pitch joints (y). The tree's topology and joint
axes are module constants; :class:`ArticulatedModel` holds the inertial and
contact leaves as tensors without an env axis (one model for the whole
batch, as in the JAX rollouts) and the scalar parameters as Python floats.
See the JAX module for where each framework-defined value comes from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.models.biped import BipedParams
from benchmark.reference.utils.device import DEFAULT_DEVICE, entry_device
from benchmark.reference.utils.struct import TensorStruct

N_BODIES = 11  # torso + 5 per leg
N_JOINTS = 10
NV = 16  # 6 base + 10 joints
NQ = 17  # 3 pos + 4 quat + 10 joints

TORSO = 0
LEFT = (1, 2, 3, 4, 5)  # per leg: yaw link, roll link, thigh, shank, foot
RIGHT = (6, 7, 8, 9, 10)
FOOT_BODIES = (5, 10)

PARENT = np.array([-1, 0, 1, 2, 3, 4, 0, 6, 7, 8, 9])
# joint axes in the child body frame (joint j moves body j+1)
_AXES = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}
JOINT_AXES = np.array(
    [_AXES[a] for a in ("z", "x", "y", "y", "y")] * 2, dtype=np.float32
)


def _joint_limits():
    return torch.tensor(
        [[-0.8, 0.8], [-0.8, 0.8], [-2.0, 1.5], [0.15, 2.6], [-1.6, 1.6]] * 2,
        dtype=torch.float32,
    )


@dataclasses.dataclass(frozen=True)
class ArticulatedModel(TensorStruct):
    """Static tree + inertial, contact and joint-limit leaves
    (``sim/model.py:64``).

    Shapes: joint_offset (10,3), mass (11,), com (11,3), inertia (11,3,3),
    contact_points (4,3) (left toe, left heel, right toe, right heel, in the
    foot frame), joint_limits (10,2) [min, max].
    """

    joint_offset: torch.Tensor
    mass: torch.Tensor
    com: torch.Tensor
    inertia: torch.Tensor
    contact_points: torch.Tensor
    contact_stiffness: float = 8000.0  # N/m normal spring
    contact_damping: float = 150.0  # N s/m normal damper
    contact_mu: float = 0.5
    contact_vslip: float = 0.05  # m/s friction smoothing velocity
    joint_damping: float = 0.08  # N m s/rad viscous joint damping
    armature: float = 0.01  # reflected actuator inertia on the joint diagonal
    joint_limits: torch.Tensor = dataclasses.field(default_factory=_joint_limits)
    joint_limit_stiffness: float = 80.0  # N m / rad beyond the limit
    joint_limit_damping: float = 2.0


def _rod_inertia(m, length, axis):
    """Inertia of a thin rod of given length along ``axis`` about its CoM."""
    i = m * length**2 / 12.0
    full = np.array([i, i, i])
    full["xyz".index(axis)] = m * length**2 * 0.005  # thin: small axial term
    return np.diag(full)


def _value(t: torch.Tensor, i: int | None = None) -> float:
    """Env 0's value of a per-env parameter, as the decimal it was written
    from: the shortest decimal that rounds to the stored f32. The JAX model
    is built in f64 from the Python constants, and this recovers them."""
    v = t.detach().cpu().reshape(t.shape[0], -1)[0]
    return float(str(np.float32(v[0 if i is None else i].item())))


def hector_model(biped: BipedParams | None = None,
                 device=DEFAULT_DEVICE) -> ArticulatedModel:
    """The HECTOR articulated model from env 0 of ``biped``'s leg geometry,
    mass, foot levers and friction (``sim/model.py:105``), on the card
    unless ``device`` names another (raises without a card)."""
    device = entry_device(device)
    biped = biped or BipedParams()
    g = {f.name: _value(getattr(biped.leg, f.name))
         for f in dataclasses.fields(biped.leg)}
    hip = np.array([_value(biped.hip_offset, i) for i in range(3)])
    lt, lh = _value(biped.lt), _value(biped.lh)

    def leg_offsets(side):
        return [
            np.array([hip[0], side * hip[1], hip[2]]),  # torso -> hip yaw
            np.array([g["hip_x"], side * g["hip_y"], g["hip_z"]]),  # yaw -> roll
            np.array([0.0, side * g["abd_y"] + g["abd_y_const"], 0.0]),  # roll -> pitch
            np.array([0.0, 0.0, -g["l_thigh"]]),  # pitch -> knee
            np.array([0.0, 0.0, -g["l_shank"]]),  # knee -> ankle
        ]

    joint_offset = np.stack(leg_offsets(+1.0) + leg_offsets(-1.0))

    m_yaw, m_roll, m_thigh, m_shank, m_foot = 0.25, 0.75, 1.0, 0.5, 0.1
    m_leg = m_yaw + m_roll + m_thigh + m_shank + m_foot
    m_torso = _value(biped.m) - 2 * m_leg
    mass = np.array([m_torso] + [m_yaw, m_roll, m_thigh, m_shank, m_foot] * 2)

    com = np.zeros((N_BODIES, 3))
    com[TORSO] = [0.0, 0.0, 0.08]
    for feet, s in ((LEFT, 1.0), (RIGHT, -1.0)):
        yaw_b, roll_b, thigh_b, shank_b, foot_b = feet
        com[yaw_b] = [g["hip_x"] / 2, s * g["hip_y"] / 2, g["hip_z"] / 2]
        com[roll_b] = [0.0, s * g["abd_y"] / 2, 0.0]
        com[thigh_b] = [0.0, 0.0, -g["l_thigh"] / 2]
        com[shank_b] = [0.0, 0.0, -g["l_shank"] / 2]
        com[foot_b] = [0.01, 0.0, -g["l_foot"]]

    inertia = np.zeros((N_BODIES, 3, 3))
    # ~1.3x the reference SRB inertia in composite; see the JAX module
    inertia[TORSO] = np.diag([0.70, 0.72, 0.04])
    for feet in (LEFT, RIGHT):
        yaw_b, roll_b, thigh_b, shank_b, foot_b = feet
        inertia[yaw_b] = _rod_inertia(m_yaw, 0.13, "z")
        inertia[roll_b] = _rod_inertia(m_roll, 0.05, "y")
        inertia[thigh_b] = _rod_inertia(m_thigh, g["l_thigh"], "z")
        inertia[shank_b] = _rod_inertia(m_shank, g["l_shank"], "z")
        inertia[foot_b] = _rod_inertia(m_foot, lt + lh, "x")

    contact_points = np.array(
        [[lt, 0.0, -g["l_foot"]], [-lh, 0.0, -g["l_foot"]]] * 2
    )

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ArticulatedModel(
        joint_offset=f32(joint_offset),
        mass=f32(mass),
        com=f32(com),
        inertia=f32(inertia),
        contact_points=f32(contact_points),
        contact_mu=_value(biped.mu),
        joint_limits=_joint_limits().to(device),
    )
