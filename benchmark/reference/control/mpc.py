"""MPC hot path (L4): references -> linearization -> condensed QP -> solve.
The counterpart of ``biped_mpc_py_tpu/control/mpc.py``, batched over a
leading env axis."""

from __future__ import annotations

import torch

from benchmark.reference.config import GaitConfig, MpcConfig
from benchmark.reference.control.reference import com_reference, foot_reference
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.models.srb import linearize_horizon
from benchmark.reference.ops.qp import CondensedQp, QpSolution, condense, solve_qp


def build_mpc_qp(
    x_fb: torch.Tensor,
    t: torch.Tensor,
    foot: torch.Tensor,
    mpc: MpcConfig,
    biped: BipedParams,
    contact: torch.Tensor,
    gait: GaitConfig | None = None,
    cmd_ref: torch.Tensor | None = None,
    foot_yaw: torch.Tensor | None = None,
    terrain=None,
    v_int: torch.Tensor | None = None,
    pitch_ref: torch.Tensor | None = None,
    x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> CondensedQp:
    """Assemble every env's condensed MPC QP for one tick (no solve).

    Args:
      x_fb: (N,12) feedback states; t: (N,) times; foot: (N,6) world feet;
      contact: (N,h,2); cmd_ref: (N,3); foot_yaw: (N,2); v_int: (N,2);
      pitch_ref: (N,); terrain: the ``sim.contact.Terrain`` the references
      ride on (the commanded CoM height counts from the mean height under
      the two feet); x_cmd: (12,) or (N,12) overriding ``mpc.x_cmd``;
      per_env: the config fields given per env (``config.py``), for the
      references, the linearization and the condensed QP.
    """
    if terrain is None:
        z_ground = 0.0
    else:
        z_ground = 0.5 * torch.sum(terrain.height(foot[:, 0::3], foot[:, 1::3]), -1)
    x_ref = com_reference(x_fb, mpc, cmd_ref, z_ground=z_ground, v_int=v_int,
                          pitch_ref=pitch_ref, x_cmd=x_cmd, per_env=per_env)
    foot_ref = foot_reference(x_fb, t, foot, mpc, contact, gait, terrain, v_int=v_int,
                              x_cmd=x_cmd, per_env=per_env)
    A, B = linearize_horizon(mpc, biped, x_ref, foot_ref, per_env)
    return condense(mpc, biped, x_fb, x_ref, A, B, contact, foot_yaw, per_env)


def solve_mpc(
    x_fb: torch.Tensor,
    t: torch.Tensor,
    foot: torch.Tensor,
    mpc: MpcConfig,
    biped: BipedParams,
    contact: torch.Tensor,
    warm: QpSolution | None = None,
    gait: GaitConfig | None = None,
    cmd_ref: torch.Tensor | None = None,
    foot_yaw: torch.Tensor | None = None,
    terrain=None,
    v_int: torch.Tensor | None = None,
    pitch_ref: torch.Tensor | None = None,
    x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> QpSolution:
    """One MPC solve per env -> :class:`QpSolution` with (N,h,13) states,
    (N,h,12) controls, the ADMM iterates (next tick's warm start) and the
    primal/dual residuals. ``per_env`` (``config.py``) reaches the
    references, the linearization, the condensed QP and the solver's
    numerics."""
    qp = build_mpc_qp(
        x_fb, t, foot, mpc, biped, contact, gait, cmd_ref, foot_yaw, terrain,
        v_int, pitch_ref, x_cmd, per_env,
    )
    return solve_qp(qp, mpc, warm, per_env)
