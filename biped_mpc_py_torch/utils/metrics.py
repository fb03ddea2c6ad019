"""Rollout metric accumulators: the counterpart of
``biped_mpc_py_tpu/utils/metrics.py``, one running sum per env."""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import config_tensor
from biped_mpc_py_torch.utils.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class RolloutMetrics(TensorStruct):
    """Running sums over a rollout, each (N,) (divide by n_steps at the
    end)."""

    n_steps: torch.Tensor
    height_err_sq: torch.Tensor  # sum of (z - z_cmd)^2
    attitude_err_sq: torch.Tensor  # sum of ||[roll, pitch]||^2
    vel_err_sq: torch.Tensor  # sum of ||v - v_cmd||^2
    fz_total: torch.Tensor  # sum of total vertical contact force
    res_prim_max: torch.Tensor  # max ADMM primal residual seen
    falls: torch.Tensor  # number of fall/reset events
    energy: torch.Tensor  # positive joint work [J] (0 for SRB rollouts)

    @classmethod
    def zeros(cls, n: int = 1, device=None, dtype=torch.float32) -> "RolloutMetrics":
        return cls(**{
            f.name: torch.zeros(n, dtype=dtype, device=device)
            for f in dataclasses.fields(cls)
        })

    def update(self, x_fb: torch.Tensor, x_cmd, u0: torch.Tensor,
               res_prim: torch.Tensor, fell: torch.Tensor,
               energy=0.0) -> "RolloutMetrics":
        """Add one tick: x_fb (N,12), u0 (N,12), res_prim (N,), fell (N,).
        ``x_cmd`` is a config's tuple of 12 floats or a (12,) or (N,12)
        tensor of per-env commands."""
        if isinstance(x_cmd, torch.Tensor):
            v_cmd, z_cmd = x_cmd[..., 9:12], x_cmd[..., 5]
        else:
            v_cmd, z_cmd = config_tensor(x_cmd[9:12], x_fb), x_cmd[5]
        return RolloutMetrics(
            n_steps=self.n_steps + 1,
            height_err_sq=self.height_err_sq + (x_fb[:, 5] - z_cmd) ** 2,
            attitude_err_sq=self.attitude_err_sq
            + torch.sum(x_fb[:, 0:2] ** 2, dim=1),
            vel_err_sq=self.vel_err_sq
            + torch.sum((x_fb[:, 9:12] - v_cmd) ** 2, dim=1),
            fz_total=self.fz_total + u0[:, 2] + u0[:, 5],
            res_prim_max=torch.maximum(self.res_prim_max, res_prim),
            falls=self.falls + fell,
            energy=self.energy + energy,
        )

    def keep(self, mask: torch.Tensor, old: "RolloutMetrics") -> "RolloutMetrics":
        """``old``'s running sums where ``mask`` (N,) is true, this tick's
        step and fall counts: an env reset for a non-finite state takes
        nothing else from its tick. The sums go through one ``where`` (three
        kernels, not one a sum)."""
        names = [f.name for f in dataclasses.fields(self) if f.name not in ("n_steps", "falls")]
        sums = torch.where(mask, torch.stack([getattr(old, k) for k in names]),
                           torch.stack([getattr(self, k) for k in names]))
        return dataclasses.replace(self, **dict(zip(names, sums.unbind(0))))



def cost_of_transport(energy_j, mass_kg, distance_m, g: float = 9.81):
    """Dimensionless mechanical cost of transport E / (m g d)
    (``metrics.py:57``) from a rollout's positive joint work [J], the
    robot's mass [kg] and the distance covered [m]; tensors of one shape or
    floats. The distance may be signed (its magnitude is used) and is
    floored at 1e-9 m."""
    if isinstance(distance_m, torch.Tensor):
        d = torch.clamp(torch.abs(distance_m), min=1e-9)
    else:
        d = max(abs(distance_m), 1e-9)
    return energy_j / (mass_kg * g * d)
