"""Soft ground contact for the articulated engine: the counterpart of
``biped_mpc_py_tpu/sim/contact.py``.

  phi = (p_z - ground) n_z (penetration depth when negative)
  f_n = max(k pen - d phi_dot sign(pen), 0) (pen > 0),   pen = max(-phi, 0)
  f_t = -mu f_n v_t / sqrt(|v_t|^2 + v_slip^2)

A regularized Coulomb cone: exact stiction is approximated by a viscous
band of width ``v_slip``. The ground is the plane z = 0 (``terrain=None``)
or a height field (:class:`Terrain`), shared by every env or one per env.
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.sim.model import ArticulatedModel
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.profiling import count_ground_contacts
from biped_mpc_py_torch.utils.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class Terrain(TensorStruct):
    """Height-field terrain z = h(x, y) on a regular grid, sampled
    bilinearly (``contact.py:26``).

    ``heights`` is (H, W), one field under every env, or (N, H, W), a field
    per env (the JAX package batches a Terrain by vmap; the port by this
    leading axis). The grid spans ``extent`` meters centered on the origin;
    outside it the ground is flat at the edge value. Contact acts along the
    surface normal of :meth:`normal`.
    """

    heights: torch.Tensor  # (H, W) or (N, H, W)
    extent: float = 8.0  # grid side length [m]

    @property
    def batched(self) -> bool:
        """True where every env has its own field."""
        return self.heights.dim() == 3

    @classmethod
    def flat(cls, res: int = 2, n: int | None = None, device=DEFAULT_DEVICE,
             dtype=torch.float32) -> "Terrain":
        """The z = 0 plane; with ``n``, one (equal) field per env."""
        shape = (res, res) if n is None else (n, res, res)
        return cls(heights=torch.zeros(shape, dtype=dtype, device=entry_device(device)))

    @classmethod
    def rough(cls, generator: torch.Generator, amplitude: float = 0.03,
              res: int = 64, smooth: int = 2, device=DEFAULT_DEVICE,
              dtype=torch.float32) -> "Terrain":
        """Random smooth bumps: ``amplitude`` [m] times unit normals, box
        filtered over (2 smooth + 1)² cells with zero padding. Draws on
        ``generator``'s device, returns on ``device``."""
        return cls(heights=_rough_heights(generator, 1, amplitude, res, smooth,
                                          entry_device(device), dtype)[0])

    @classmethod
    def rough_batch(cls, generator: torch.Generator, n: int,
                    amplitude: float = 0.03, res: int = 64, smooth: int = 2,
                    device=DEFAULT_DEVICE, dtype=torch.float32) -> "Terrain":
        """``n`` independent rough fields (leading env axis): pair with
        ``randomize_params`` for domain-randomized rollouts."""
        return cls(heights=_rough_heights(generator, n, amplitude, res, smooth,
                                          entry_device(device), dtype))

    def height(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Bilinear height sample at world (x, y), of their broadcast
        shape. With a field per env the queries' leading axis is the env
        axis: (N,), (N, k), (N, k, l), ... A NaN query reads NaN."""
        x, y = torch.broadcast_tensors(x, y)
        H, W = self.heights.shape[-2:]
        # clipped below W - 1, so that x0 + 1 stays on the grid
        gx = torch.clamp((x / self.extent + 0.5) * (W - 1), 0.0, W - 1.001)
        gy = torch.clamp((y / self.extent + 0.5) * (H - 1), 0.0, H - 1.001)
        x0f, y0f = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - x0f, gy - y0f
        # a query that is not a number (an env whose state diverged) converts to no
        # index on the grid: clamped onto it, as JAX's gathers clamp, its height is
        # NaN through fx, fy; a finite query's indices are on the grid already
        x0 = x0f.to(torch.int64).clamp_(0, W - 2)
        y0 = y0f.to(torch.int64).clamp_(0, H - 2)
        x1, y1 = x0 + 1, y0 + 1
        if self.batched:
            n = self.heights.shape[0]
            if x.dim() == 0 or x.shape[0] != n:
                raise ValueError(
                    f"queries of shape {tuple(x.shape)} do not lead with the "
                    f"{n} envs of this terrain"
                )
            env = torch.arange(n, device=x.device).reshape((n,) + (1,) * (x.dim() - 1))
            h00 = self.heights[env, y0, x0]
            h01 = self.heights[env, y0, x1]
            h10 = self.heights[env, y1, x0]
            h11 = self.heights[env, y1, x1]
        else:
            h00 = self.heights[y0, x0]
            h01 = self.heights[y0, x1]
            h10 = self.heights[y1, x0]
            h11 = self.heights[y1, x1]
        # each weight made once (a kernel apiece on the card)
        wx, wy = 1 - fx, 1 - fy
        return h00 * wx * wy + h01 * fx * wy + h10 * wx * fy + h11 * fx * fy

    def height_and_normal(self, x: torch.Tensor, y: torch.Tensor):
        """(height (...), unit outward surface normal (..., 3)) at world
        (x, y): n ∝ [-∂h/∂x, -∂h/∂y, 1], the gradient by central differences
        of :meth:`height` at a half-cell step; exactly e_z on a flat field.
        The five samples go through one :meth:`height` call on a trailing
        axis (the same values as five calls, a fifth of their launches)."""
        H, W = self.heights.shape[-2:]
        eps_x = 0.5 * self.extent / (W - 1)
        eps_y = 0.5 * self.extent / (H - 1)
        x, y = torch.broadcast_tensors(x, y)
        h, hxp, hxm, hyp, hym = self.height(
            torch.stack([x, x + eps_x, x - eps_x, x, x], -1),
            torch.stack([y, y, y, y + eps_y, y - eps_y], -1),
        ).unbind(-1)
        dhdx = (hxp - hxm) / (2 * eps_x)
        dhdy = (hyp - hym) / (2 * eps_y)
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], -1)
        return h, n / torch.linalg.norm(n, dim=-1, keepdim=True)

    def normal(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Unit outward surface normal (..., 3) at world (x, y)
        (:meth:`height_and_normal`)."""
        return self.height_and_normal(x, y)[1]


def _rough_heights(generator, n, amplitude, res, smooth, device, dtype):
    """(n, res, res) box-filtered normal draws (``Terrain.rough``)."""
    draws = torch.randn((n, res, res), generator=generator,
                        device=generator.device, dtype=dtype).to(device)
    # the mean over the window with the zero padding counted in: the "same"
    # convolution with a constant kernel of weight 1/(2 smooth + 1)²
    return torch.nn.functional.avg_pool2d(
        (amplitude * draws)[:, None], 2 * smooth + 1, stride=1, padding=smooth,
        count_include_pad=True,
    )[:, 0]


def contact_force_world(model: ArticulatedModel, p_w: torch.Tensor,
                        v_w: torch.Tensor, terrain: Terrain | None = None) -> torch.Tensor:
    """World-frame contact force (...,3) at points p_w (...,3) moving with
    v_w (...,3); zero above the ground, a smooth penalty below
    (``contact.py:113``). ``terrain=None`` is the plane z = 0. On a field
    the spring and damper act along the local surface normal and the
    friction lives in the tangent plane, and the points below it are
    counted (``utils/profiling.py::count_ground_contacts``)."""
    if terrain is None:
        ground = 0.0
        n = torch.zeros_like(p_w)
        n[..., 2] = 1.0
    else:
        ground, n = terrain.height_and_normal(p_w[..., 0], p_w[..., 1])
    # signed gap along the normal: the vertical gap scaled by n_z
    phi = (p_w[..., 2] - ground) * n[..., 2]
    phi_dot = torch.sum(v_w * n, -1)  # normal approach rate
    pen = torch.clamp(-phi, min=0.0)
    below = pen > 0
    if terrain is not None:
        count_ground_contacts(below)
    f_n = torch.clamp(
        model.contact_stiffness * pen
        - model.contact_damping * phi_dot * torch.sign(pen),
        min=0.0,
    ) * below
    v_t = v_w - phi_dot[..., None] * n  # tangent-plane slip velocity
    speed = torch.sqrt(torch.sum(v_t * v_t, -1) + model.contact_vslip**2)
    f_t = -model.contact_mu * f_n[..., None] * v_t / speed[..., None]
    return f_n[..., None] * n + f_t
