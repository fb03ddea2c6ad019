"""MJCF export of the articulated HECTOR model: the port's own copy of
``biped_mpc_py_tpu/sim/mjcf.py``.

A MuJoCo XML string mirroring ``sim/model.py`` exactly (same tree, offsets,
axes, inertials), string-equal to the JAX module's for the same model and
terrain. It is the oracle of the engine's dynamics (MuJoCo CPU forward
dynamics on the same model), the plant of ``sim/mj_driver.py``, and the
replay artifact of ``sim/replay.py``. The model's and the terrain's tensors
are read through numpy, from any device.
"""

from __future__ import annotations

import numpy as np
import torch

from biped_mpc_py_torch.sim.model import (
    FOOT_BODIES,
    JOINT_AXES,
    LEFT,
    PARENT,
    RIGHT,
    TORSO,
    ArticulatedModel,
)

CONTACT_SPHERE_R = 0.005  # [m] radius of the toe/heel contact spheres

_BODY_NAMES = [
    "torso",
    "l_hip_yaw", "l_hip_roll", "l_thigh", "l_shank", "l_foot",
    "r_hip_yaw", "r_hip_roll", "r_thigh", "r_shank", "r_foot",
]


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fmt(v) -> str:
    return " ".join(f"{float(x):.9g}" for x in _np(v).reshape(-1))


def penalty_matched_solref(model: ArticulatedModel, m_eff: float = 3.0) -> str:
    """MuJoCo (timeconst, dampratio) solref equivalent of the framework's
    explicit spring-damper point contact (sim/contact.py): for a contact
    carrying effective mass ``m_eff`` (≈ one leg's share of the robot),
    omega = sqrt(k/m_eff) gives timeconst = 1/omega and dampratio =
    d / (2 sqrt(k m_eff)). With the default k=8000, d=150, m_eff=3 this is
    ("0.0194 0.484"); closed-loop walking under the same controller then
    produces per-foot stance forces matching the framework engine to a few
    percent (tests/test_mj_contact.py)."""
    k = float(model.contact_stiffness)
    d = float(model.contact_damping)
    omega = (k / m_eff) ** 0.5
    return f"{1.0 / omega:.6g} {d / (2.0 * (k * m_eff) ** 0.5):.6g}"


def set_hfield_data(m, terrain) -> None:
    """Fill a loaded MjModel's hfield with a Terrain's grid.

    MuJoCo's hfield storage is (nrow, ncol) row-major with row -> y
    bottom-up and col -> x — the SAME indexing as
    :class:`~biped_mpc_py_torch.sim.contact.Terrain.heights` (verified by
    ray-probing a single-bump field). Data is normalized to [0, 1];
    ``to_mjcf`` sets hfield size_z = hmax - hmin and the floor geom
    z = hmin - CONTACT_SPHERE_R so the MuJoCo surface reproduces
    ``terrain.height(x, y)`` at the same activation offset as the flat
    plane. (MuJoCo triangulates the grid; the engine samples it
    bilinearly — identical at nodes, sub-cell interpolation differs.)
    """
    h = _np(terrain.heights).astype(np.float64)
    hmin, hmax = float(h.min()), float(h.max())
    sz = max(hmax - hmin, 1e-9)
    m.hfield_data[:] = ((h - hmin) / sz).ravel()


def to_mjcf(
    model: ArticulatedModel,
    timestep: float = 1e-4,
    contact: bool = False,
    solref: str = "",
    terrain=None,
    sphere_r: float = CONTACT_SPHERE_R,
) -> str:
    """MJCF XML string of the model.

    contact=False: no collision geoms (flight-dynamics oracle).
    contact=True: a ground plane + one sphere per toe/heel contact point
    (the framework's 4-point line-foot contact geometry,
    sim/model.py::contact_points), friction = model.contact_mu. The plane
    sits at z = -CONTACT_SPHERE_R so a sphere CENTER crossing z=0 is first
    touch — the same activation surface as the framework's point contacts.
    MuJoCo's constraint-stabilized contact is a different law than the
    framework's explicit spring-damper, so MuJoCo keeps its stock stiff
    solver parameters and the fidelity comparison is behavioral (forces and
    trajectories of the SAME controller closed-loop in both simulators,
    tests/test_sim.py) rather than parameter-matched.

    terrain: optional :class:`~biped_mpc_py_torch.sim.contact.Terrain` (one
    (H, W) field) —
    the floor becomes a height-field geom reproducing the engine's rough
    ground (BASELINE config 4 cross-sim); call :func:`set_hfield_data`
    on the loaded MjModel to fill the grid (inline MJCF elevation data
    is re-ordered/re-normalized by the compiler, so the data rides the
    model, not the XML).

    sphere_r: contact-sphere radius. The default 5 mm matches the plane
    oracle geometry; on HEIGHT FIELDS it MUST exceed the contact law's
    maximum penetration (the penalty-matched softness reaches 6-15 mm
    at touchdown/stance): a sphere center passing below the triangulated
    top surface wedges in MuJoCo's prism collider (measured: 1.7 kN
    garbage side-contacts with dist clamped at -r). The floor offset
    rides the same radius, so the activation surface is unchanged.
    """
    mass = _np(model.mass)
    com = _np(model.com)
    inertia = _np(model.inertia)
    offs = _np(model.joint_offset)
    cpts = _np(model.contact_points)
    mu = float(model.contact_mu)

    def body_xml(i: int, indent: str) -> str:
        name = _BODY_NAMES[i]
        diag = np.diag(inertia[i])
        pos = offs[i - 1] if i != TORSO else np.zeros(3)
        lines = [f'{indent}<body name="{name}" pos="{_fmt(pos)}">']
        if i == TORSO:
            lines.append(f'{indent}  <freejoint name="root"/>')
        else:
            axis = JOINT_AXES[i - 1]
            # contact=True is the closed-loop oracle: include the engine's
            # viscous joint damping; contact=False keeps damping=0 (the
            # flight oracle strips it on the engine side too)
            damping = float(model.joint_damping) if contact else 0.0
            # Closed-loop oracle also carries the model's joint limits.
            # MuJoCo's stock limit constraint (default solref/solimp) is
            # near-rigid where the engine's penalty (sim/engine.py) is a
            # soft 80 N m/rad — a deliberate behavioral, not parametric,
            # match (same stance as the contact law above): a torque-
            # stiffness penalty has no faithful solref encoding because
            # solref stiffness is in acceleration units (measured: the
            # "direct" (-k,-b) form yields ~1/80 of the intended torque on
            # the light hip-yaw DOF). Without any limit the two physics
            # models diverge wildly in a DOF that rides its limit
            # (measured: hip yaw wound up 8+ rad in MuJoCo while the
            # engine pinned at 0.8).
            lim = ""
            if contact:
                lo, hi = _np(model.joint_limits)[i - 1]
                lim = f' limited="true" range="{lo:.9g} {hi:.9g}"'
            lines.append(
                f'{indent}  <joint name="j_{name}" type="hinge" '
                f'axis="{_fmt(axis)}" damping="{damping:.9g}" '
                f'armature="{float(model.armature):.9g}"{lim}/>'
            )
        lines.append(
            f'{indent}  <inertial pos="{_fmt(com[i])}" mass="{mass[i]:.9g}" '
            f'diaginertia="{_fmt(diag)}"/>'
        )
        if contact and i in FOOT_BODIES:
            foot_idx = FOOT_BODIES.index(i)
            sr = f' solref="{solref}"' if solref else ""
            for k, label in enumerate(("toe", "heel")):
                p = cpts[2 * foot_idx + k]
                lines.append(
                    f'{indent}  <geom name="{name}_{label}" type="sphere" '
                    f'size="{sphere_r:.9g}" pos="{_fmt(p)}" '
                    f'friction="{mu:.9g} 0.005 0.0001" '
                    f'contype="1" conaffinity="1"{sr}/>'
                )
        for child in range(len(PARENT)):
            if PARENT[child] == i:
                lines.append(body_xml(child, indent + "  "))
        lines.append(f"{indent}</body>")
        return "\n".join(lines)

    asset = ""
    if not contact:
        floor = ""
    elif terrain is None:
        floor = (
            f'    <geom name="floor" type="plane" size="20 20 0.1" '
            f'pos="0 0 {-sphere_r:.9g}" '
            f'friction="{mu:.9g} 0.005 0.0001" '
            f'contype="1" conaffinity="1"/>\n'
        )
    else:
        h = _np(terrain.heights).astype(np.float64)
        nrow, ncol = h.shape
        ext = float(terrain.extent)
        hmin = float(h.min())
        sz = max(float(h.max()) - hmin, 1e-9)
        asset = (
            f'  <asset>\n    <hfield name="terrain" nrow="{nrow}" '
            f'ncol="{ncol}" size="{ext / 2:.9g} {ext / 2:.9g} {sz:.9g} '
            f'0.5"/>\n  </asset>\n'
        )
        floor = (
            f'    <geom name="floor" type="hfield" hfield="terrain" '
            f'pos="0 0 {hmin - sphere_r:.9g}" '
            f'friction="{mu:.9g} 0.005 0.0001" '
            f'contype="1" conaffinity="1"/>\n'
        )
    return f"""<mujoco model="hector_tpu">
  <option timestep="{timestep}" gravity="0 0 -9.81"/>
  <compiler inertiafromgeom="false" angle="radian"/>
{asset}  <worldbody>
{floor}{body_xml(TORSO, "    ")}
  </worldbody>
</mujoco>
"""
