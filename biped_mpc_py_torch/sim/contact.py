"""Soft ground contact for the articulated engine: the counterpart of
``biped_mpc_py_tpu/sim/contact.py`` on flat ground.

  phi = p_z (penetration depth when negative)
  f_n = max(k pen - d phi_dot sign(pen), 0) (pen > 0),   pen = max(-phi, 0)
  f_t = -mu f_n v_t / sqrt(|v_t|^2 + v_slip^2)

A regularized Coulomb cone: exact stiction is approximated by a viscous
band of width ``v_slip``. Height-field terrain waits for the terrain slice:
a non-None ``terrain`` raises.
"""

from __future__ import annotations

import torch

from biped_mpc_py_torch.sim.model import ArticulatedModel


def no_terrain(terrain) -> None:
    """Raise on a height field: the port runs on the z = 0 plane only."""
    if terrain is not None:
        raise NotImplementedError(
            "height-field terrain is not ported yet; the torch port runs on "
            "flat ground (terrain=None)"
        )


def contact_force_world(model: ArticulatedModel, p_w: torch.Tensor,
                        v_w: torch.Tensor, terrain=None) -> torch.Tensor:
    """World-frame contact force (...,3) at points p_w (...,3) moving with
    v_w (...,3); zero above the plane z = 0."""
    no_terrain(terrain)
    n = torch.zeros_like(p_w)
    n[..., 2] = 1.0
    phi = (p_w[..., 2] - 0.0) * n[..., 2]
    phi_dot = torch.sum(v_w * n, -1)  # normal approach rate
    pen = torch.clamp(-phi, min=0.0)
    f_n = torch.clamp(
        model.contact_stiffness * pen
        - model.contact_damping * phi_dot * torch.sign(pen),
        min=0.0,
    ) * (pen > 0)
    v_t = v_w - phi_dot[..., None] * n  # tangent-plane slip velocity
    speed = torch.sqrt(torch.sum(v_t * v_t, -1) + model.contact_vslip**2)
    f_t = -model.contact_mu * f_n[..., None] * v_t / speed[..., None]
    return f_n[..., None] * n + f_t
