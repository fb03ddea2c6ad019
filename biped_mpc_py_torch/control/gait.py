"""Gait scheduling (L3): the counterpart of
``biped_mpc_py_tpu/control/gait.py``.

The contact window is computed in closed form from modular arithmetic on
each env's time ``t`` (N,). The contact-sensed clock
(``GaitConfig.contact_clock``) holds the schedule for a late touchdown
(:func:`advance_gait_clock`). Each function that reads ``dt`` takes an
optional ``per_env`` dict whose (N,) ``"dt"`` overrides the config's
(``config.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig, config_value


def _inv_dt(mpc: MpcConfig) -> float:
    """``1/dt`` rounded to f32, as XLA folds a division by the constant
    ``dt`` (see :func:`_steps`)."""
    return float(np.float32(1.0) / np.float32(mpc.dt))


def _steps(t: torch.Tensor, mpc: MpcConfig, per_env: dict | None) -> torch.Tensor:
    """``t / dt`` as the JAX loop computes it. With ``dt`` a trace-time
    constant XLA rewrites the division as ``t * f32(1/dt)``; on a time
    accumulated by repeated ``t + dt`` in f32 the two roundings disagree at
    some phase boundaries (one tick in the first 3000 at dt = 0.04), and a
    flipped contact phase makes the loops diverge. So a shared ``dt``
    multiplies by the same f32 reciprocal. A per-env ``dt`` is a batched
    operand under JAX's vmap, which XLA does not fold: it divides.
    ``tests/test_torch_gait_reference.py`` and
    ``tests/test_torch_sweep_numerics.py`` hold both forms against the
    compiled JAX schedule tick by tick."""
    dt = config_value(mpc, "dt", per_env)
    if isinstance(dt, torch.Tensor):
        return t / dt
    return t * _inv_dt(mpc)


def phase_index(t: torch.Tensor, mpc: MpcConfig, per_env: dict | None = None) -> torch.Tensor:
    """Absolute MPC step index ``floor(t / dt)`` (N,) int64 (see
    :func:`_steps` for how ``t / dt`` rounds)."""
    return torch.floor(_steps(t, mpc, per_env)).to(torch.int64)


def phase_time(mpc: MpcConfig, gait: GaitConfig | None, per_env: dict | None = None):
    """Single-stance phase duration [s]: ``steps_per_phase * dt`` (the
    reference's h/2 when ``gait`` is None), a float, or (N,) with a per-env
    ``dt``."""
    p = gait.steps_per_phase if gait is not None else mpc.h // 2
    return p * config_value(mpc, "dt", per_env)


def gait_for_speed(speed: float, gait_mode: int = 1) -> GaitConfig:
    """Cadence scaled to the commanded speed (``gait.py:34``)."""
    speed = abs(float(speed))
    if speed <= 0.1:
        p = 5
    elif speed <= 0.2:
        p = 4
    elif speed <= 0.3:
        p = 3
    else:
        p = 2
    return GaitConfig(steps_per_phase=p, gait_mode=gait_mode)


def contact_sequence(t: torch.Tensor, mpc: MpcConfig, gait: GaitConfig,
                     per_env: dict | None = None) -> torch.Tensor:
    """Contact flags over the horizon -> (N, h, 2) in {0., 1.}.

    Walking: left foot in stance iff ``(step mod 2(p+f)) < p``; right on
    ``[p+f, 2p+f)``; standing (gait_mode=0): both feet down.
    """
    if gait.gait_mode != 1:
        return torch.ones(t.shape + (mpc.h, 2), dtype=torch.float32, device=t.device)
    p, f = gait.steps_per_phase, gait.flight_steps
    k = phase_index(t, mpc, per_env)
    steps = k[..., None] + torch.arange(mpc.h, device=t.device)
    s = torch.remainder(steps, 2 * (p + f))
    left = (s < p).to(torch.float32)
    right = ((s >= p + f) & (s < 2 * p + f)).to(torch.float32)
    return torch.stack([left, right], dim=-1)


def swing_clock(t: torch.Tensor, mpc: MpcConfig, gait: GaitConfig | None, side, dtype,
                per_env: dict | None = None):
    """Per-leg swing clock -> (phase fraction in [0, 1] (N,), swing
    duration T_sw, a float or (N,)). ``side``: +1 = left (leg 0), -1 =
    right (leg 1)."""
    p = gait.steps_per_phase if gait is not None else mpc.h // 2
    f = gait.flight_steps if gait is not None else 0
    t = t.to(dtype)
    if f == 0:
        t_p = phase_time(mpc, gait, per_env)
        u = torch.remainder(t, t_p)
        return u / t_p, t_p
    dt = config_value(mpc, "dt", per_env)
    period = (2 * (p + f)) * dt
    T_sw = (p + 2 * f) * dt
    start = p * dt if side > 0 else (2 * p + f) * dt
    u = torch.remainder(t - start, period)
    return torch.clamp(u / T_sw, 0.0, 1.0), T_sw


def measured_contact(pf_w: torch.Tensor, terrain, gait: GaitConfig) -> torch.Tensor:
    """Per-foot ground-contact flags (N,2) bool from the measured sole
    heights pf_w (N,6) (``gait.py:93``): a sole within
    ``gait.clock_z_tol`` of the ground under it is down, the plane z = 0 or
    the ``terrain`` field."""
    pz = torch.stack([pf_w[:, 2], pf_w[:, 5]], -1)
    if terrain is not None:
        pz = pz - terrain.height(pf_w[:, 0::3], pf_w[:, 1::3])
    return pz < gait.clock_z_tol


# The clock stores the exact f32 product (k + 1/16) dt, never a sum, so
# that phase_index recovers k with a ~0.44-step margin (``gait.py:122``).
_CLOCK_STEP_BIAS = 1.0 / 16.0


def advance_gait_clock(t_gait: torch.Tensor, hold_count: torch.Tensor,
                       down: torch.Tensor, mpc: MpcConfig, gait: GaitConfig,
                       per_env: dict | None = None):
    """One tick of the contact-sensed gait clock -> (t_used (N,),
    hold_next (N,) int32) (``gait.py:125``).

    The clock advances one MPC step per tick, except when the next step
    enters a stance window (left at cycle step 0, right at p+f) whose foot
    ``down`` (N,2) reports no contact: then it holds, for at most
    ``gait.clock_max_hold`` ticks. Standing never holds.
    """
    k = torch.floor(_steps(t_gait, mpc, per_env) + (0.5 - _CLOCK_STEP_BIAS)).to(torch.int32)
    p, f = gait.steps_per_phase, gait.flight_steps
    s_next = torch.remainder(k + 1, 2 * (p + f))
    wait = ((s_next == 0) & ~down[:, 0]) | ((s_next == p + f) & ~down[:, 1])
    wait = wait & (hold_count < gait.clock_max_hold) & (gait.gait_mode == 1)
    k_used = torch.where(wait, k, k + 1)
    t_used = (k_used.to(t_gait.dtype) + _CLOCK_STEP_BIAS) * config_value(mpc, "dt", per_env)
    hold_next = torch.where(wait, hold_count + 1, torch.zeros_like(hold_count))
    return t_used, hold_next


def advance_gait_clock_host(t_gait: float, hold_count: int, down,
                            mpc: MpcConfig, gait: GaitConfig):
    """:func:`advance_gait_clock` for one env in plain Python floats and
    ints (``gait.py:173``), for synchronous loops on the host: the same
    hold rule and biased-product step. ``down`` is any pair of per-foot
    contact booleans. Returns (t_used, hold_next)."""
    dt = float(mpc.dt)
    k = int(math.floor(t_gait / dt + (0.5 - _CLOCK_STEP_BIAS)))
    p, f = gait.steps_per_phase, gait.flight_steps
    s_next = (k + 1) % (2 * (p + f))
    wait = (
        ((s_next == 0 and not bool(down[0]))
         or (s_next == p + f and not bool(down[1])))
        and hold_count < gait.clock_max_hold
        and int(gait.gait_mode) == 1
    )
    k_used = k if wait else k + 1
    return (k_used + _CLOCK_STEP_BIAS) * dt, hold_count + 1 if wait else 0
