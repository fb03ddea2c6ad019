"""Configuration (L0): the counterpart of ``biped_mpc_py_tpu/config.py``.

``MpcConfig`` and ``GaitConfig`` are frozen dataclasses with the JAX
package's field names and defaults. They are not batched: one config drives
a whole batch of envs, as in the JAX rollouts, where the config is closed
over at trace time. The vector fields (``x_cmd``, ``Q``, ``R``) are tuples of
Python floats; compute code turns them into tensors on the device it runs
on.

Per-env values. Where the JAX package swaps a config field for a traced,
vmapped array (``batched_cmd_rollout_fn`` replaces ``x_cmd`` per env), the
port keeps the config as it is and hands the per-env values beside it:
every function on the SRB path that reads ``mpc.x_cmd`` (``com_reference``,
``foot_reference``, ``swing_target_xy``, ``build_mpc_qp``, ``srb_step``,
``advance_cmd_ref``, ``advance_v_int``, ``ControllerState.init``,
``RolloutMetrics.update``) takes an optional ``x_cmd`` tensor, (12,) or
(N, 12) on the envs' device, that overrides the config's. With
``x_cmd=None`` the config's floats are used and the result is bit-equal to
a call without the argument; a Python branch on a command entry (the
``sqrt`` of the commanded height, the small-turn-rate limit) becomes a
tensor expression on the override branch only. :func:`cmd_entry` reads one
entry under either form. The articulated control chain (the MPC stage, the
gait clock, the low-level control, the controller state, the plain
physics step) takes the same ``x_cmd`` and, beside it, a ``per_env`` dict
that maps any of the :data:`PER_ENV_FIELDS` (the low-level and swing
gains) and the :data:`MPC_PER_ENV_FIELDS` (the MPC model, weights and
step, the contact polygon, the Raibert and command-shaping gains, the
solver numerics) to (N,) tensors, (N, 13) for ``Q`` and (N, 12) for ``R``;
:func:`config_value` and :func:`config_vector` read one such field under
either form. A Python branch on such a field becomes a tensor expression
where the field is per env, as under JAX's vmap; a per-env ``dt`` divides
where the shared one multiplies by its folded reciprocal
(``control/gait.py``). ``parallel/sweep.py::stack_configs`` builds both
from a list of configs. The physics kernels' constant buffers and their
``dt`` hold one config per batch: ``fused_tick`` and ``fused_substeps``
raise on per-env values; the QP kernel takes per-env ``rho``, ``sigma``
and ``alpha``.

State convention (13,): ``[roll, pitch, yaw, px, py, pz, wx, wy, wz, vx, vy,
vz, 1]`` with angular and linear velocity in the world frame; R =
Rz(yaw) Ry(pitch) Rx(roll). Controls (12,): ``[f_L, f_R, m_L, m_R]``. See the
JAX module's docstring and ``docs/DESIGN_NOTES.md`` for the conventions and
the meaning of every field; the comments below are short on purpose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.utils.device import host_to_device

_VECTOR_FIELDS = ("x_cmd", "Q", "R")


def _as_tuple(value) -> tuple:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    # f32-exact values: the JAX package stores these vectors as f32 arrays
    return tuple(float(v) for v in np.asarray(value, np.float32).reshape(-1))


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """MPC horizon, weights, gains and solver budget (``config.py:38``)."""

    h: int = 10
    dt: float = 0.04
    x_cmd: tuple = (0.0, 0.0, 0.0, 0.0, 0.0, 0.55, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    Q: tuple = (500.0, 100.0, 100.0, 300.0, 300.0, 700.0,
                1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    R: tuple = (1e-4,) * 12
    kv: float = 0.01
    kp_swing: float = 500.0
    kd_swing: float = 10.0
    swing_height: float = 0.1
    swing_z_sin2: bool = False
    swing_td_damp: float = 0.0
    swing_track_ff: float = 0.0
    swing_land_frac: float = 1.0
    kp_hipyaw: float = 0.0
    kd_hipyaw: float = 0.0
    hipyaw_target_clip: float = 0.6
    tau_yaw_clip: float = 3.0
    flight_yaw_kd: float = 0.0
    hipyaw_rate_lead: float = 0.0
    kp_pivot: float = 0.0
    kd_pivot: float = 0.0
    foot_frame_wrench: bool = False
    tau_z_max: float | None = None
    mu_z: float | None = None
    swing_td_overdrive: float = 0.0
    lf_toe_shrink: float = 0.01
    lf_heel_shrink: float = 0.02
    cmd_leak_yaw: float = 0.05
    swing_y_offset: float = 0.09
    raibert_capture_gain: float = 0.0
    raibert_am_y: float = 0.0
    raibert_am_x: float = 0.0
    pitch_ref_leak: float = 0.0
    capture_sched: float = 0.0
    raibert_pitch_place: float = 0.0
    raibert_pitch_nom: float = 0.0
    swing_retract: float = 0.0
    raibert_ff_scale: float = 1.0
    cmd_body_frame: bool = False
    cmd_v_int_gain: float = 0.0
    cmd_v_int_max: float = 0.4
    cmd_v_int_ref_scale: float = 1.0
    raibert_vint: float = 0.0
    # --- solver settings ---
    n_admm_iters: int = 60
    admm_rho: float = 0.3
    admm_rho_phases: int = 3
    admm_polish: bool = True
    admm_sigma: float = 1e-6
    admm_alpha: float = 1.6
    kinv_ns_iters: int = 14
    # The JAX package's three bf16 knobs (ops/qp.py:387-500, 574-590), run
    # as there, one value per launch: the first kinv_bf16_iters Newton-Schulz
    # steps of each K^-1 from bf16 operands (on the card one bf16 mma.sync
    # product per tile, csrc/qp_admm.cu), the ADMM steps' K^-1 product from
    # bf16 K^-1 and right-hand side, the Ruiz norms of |P| in bf16; f32
    # accumulation throughout, the polish's K^-1 product in f32.
    kinv_bf16_iters: int = 0
    admm_bf16_matvec: bool = False
    ruiz_bf16_norms: bool = False
    ruiz_iters: int = 10
    # --- compat flags (documented deviations from the reference) ---
    compat_foot_ref_bug: bool = False
    compat_force_box_bug: bool = False
    compat_ref_col0_bug: bool = False
    compat_swing_frame_bug: bool = False
    compat_swing_yaw_bug: bool = False

    def __post_init__(self):
        for name in _VECTOR_FIELDS:
            object.__setattr__(self, name, _as_tuple(getattr(self, name)))

    @property
    def nx(self) -> int:
        return 13

    @property
    def nu(self) -> int:
        return 12


@dataclasses.dataclass(frozen=True)
class GaitConfig:
    """Walking-gait schedule (``config.py:455``). gait_mode: 1 = walking,
    0 = standing; flight_steps > 0 = running."""

    steps_per_phase: int = 5
    gait_mode: int = 1
    flight_steps: int = 0
    contact_clock: bool = False
    clock_max_hold: int = 3
    clock_z_tol: float = 0.012


def default_mpc_config(**overrides) -> MpcConfig:
    return dataclasses.replace(MpcConfig(), **overrides)


def fast_mpc_config(**overrides) -> MpcConfig:
    """The benched solver budget: 40 ADMM iterations, 1 rho phase, no
    polish, 10 Newton-Schulz steps (``config.py:507``), and the three bf16
    knobs on as in the JAX package: 8 bf16 NS steps, the bf16 K^-1 product
    in the ADMM steps, the bf16 Ruiz norms."""
    return dataclasses.replace(
        MpcConfig(), n_admm_iters=40, admm_rho_phases=1, admm_polish=False,
        kinv_ns_iters=10, kinv_bf16_iters=8, admm_bf16_matvec=True,
        ruiz_bf16_norms=True,
        **overrides
    )


def reference_compat_config(**overrides) -> MpcConfig:
    """MpcConfig with every documented reference-defect flag enabled
    (``config.py:535``)."""
    cfg = dataclasses.replace(
        MpcConfig(),
        compat_foot_ref_bug=True,
        compat_force_box_bug=True,
        compat_ref_col0_bug=True,
        compat_swing_yaw_bug=True,
        compat_swing_frame_bug=True,
    )
    return dataclasses.replace(cfg, **overrides)


def cmd_entry(mpc: MpcConfig, x_cmd, i: int):
    """Entry ``i`` of the command in force: ``mpc.x_cmd[i]``, a Python
    float, or with an overriding ``x_cmd`` tensor ((12,) or (N, 12)) its
    column ``x_cmd[..., i]`` (() or (N,))."""
    return mpc.x_cmd[i] if x_cmd is None else x_cmd[..., i]


# The MpcConfig fields that select the program in JAX (``pytree_node=False``
# in ``biped_mpc_py_tpu/config.py``): equal across a sweep, as there. Every
# GaitConfig field is of this kind. Every other field may differ per env.
STATIC_FIELDS = (
    "h", "swing_z_sin2", "foot_frame_wrench", "tau_z_max", "mu_z", "cmd_body_frame",
    "n_admm_iters", "admm_rho_phases", "admm_polish", "kinv_ns_iters",
    "kinv_bf16_iters", "admm_bf16_matvec", "ruiz_bf16_norms", "ruiz_iters",
    "compat_foot_ref_bug", "compat_force_box_bug", "compat_ref_col0_bug",
    "compat_swing_frame_bug", "compat_swing_yaw_bug",
)

# The float fields that may differ between envs (``per_env``): every gain
# the articulated low-level control (the first eight) and the swing force
# (the rest) read ...
PER_ENV_FIELDS = (
    "kp_hipyaw", "kd_hipyaw", "hipyaw_target_clip", "tau_yaw_clip",
    "flight_yaw_kd", "hipyaw_rate_lead", "kp_pivot", "kd_pivot",
    "kp_swing", "kd_swing", "swing_height", "swing_td_damp", "swing_track_ff",
    "swing_land_frac", "swing_td_overdrive", "swing_retract", "swing_y_offset",
)
# ... and every other dynamic field but ``x_cmd``: the MPC step and weights,
# the contact polygon's margins, the Raibert and command-shaping gains and
# the ADMM numerics. ``Q`` and ``R`` are (N, 13) and (N, 12) per env.
MPC_PER_ENV_FIELDS = (
    "dt", "Q", "R", "kv", "lf_toe_shrink", "lf_heel_shrink",
    "raibert_capture_gain", "raibert_am_x", "raibert_am_y", "raibert_pitch_place",
    "raibert_pitch_nom", "raibert_ff_scale", "raibert_vint", "capture_sched",
    "pitch_ref_leak", "cmd_leak_yaw", "cmd_v_int_gain", "cmd_v_int_max",
    "cmd_v_int_ref_scale", "admm_rho", "admm_sigma", "admm_alpha",
)


def config_value(mpc: MpcConfig, name: str, per_env: dict | None = None,
                 dims: int = 0):
    """Field ``name`` in force: ``getattr(mpc, name)`` (a Python float, or
    for ``Q`` and ``R`` the config's tuple), or with ``per_env[name]``
    present that (N,) or (N, k) tensor, followed by ``dims`` axes of length
    1 so that it broadcasts against (N, ...) operands."""
    v = per_env.get(name) if per_env else None
    if v is None:
        return getattr(mpc, name)
    return v.reshape(v.shape + (1,) * dims)


def config_vector(mpc: MpcConfig, name: str, per_env: dict | None,
                  like: torch.Tensor) -> torch.Tensor:
    """Vector field ``name`` (``Q``, ``R``) in force as a tensor: the
    config's (k,) on ``like``'s device (:func:`config_tensor`), or the
    (N, k) ``per_env[name]``."""
    v = config_value(mpc, name, per_env)
    return v if isinstance(v, torch.Tensor) else config_tensor(v, like)


_CONSTANTS: dict = {}  # (values, shape, device, dtype) -> tensor


def config_tensor(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant vector (a config's ``x_cmd``, ``Q``, ``R``, ...) as
    a tensor of ``like``'s dtype on ``like``'s device
    (:func:`device_constant`)."""
    return device_constant(values, like.device, like.dtype)


def device_constant(values, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host values (numbers, nested sequences, a numpy array) as a tensor
    of ``dtype`` on ``device``.

    Memoized: each distinct ``(values, device, dtype)`` is copied to the
    device once (through pinned memory, ``utils.device.host_to_device``)
    and the same tensor is returned ever after. Callers never write into
    it. A CUDA graph that reads it therefore reads a buffer that lives as
    long as the process, and a steady tick makes no host-to-device copy.
    A first use inside a CUDA-graph capture raises: the captured copy would
    read a temporary host buffer on every replay."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (tuple(arr.reshape(-1).tolist()), arr.shape, device, dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"device_constant{key[:2]} first made inside a CUDA-graph capture; "
                "run the step once before capturing it"
            )
        t = _CONSTANTS[key] = host_to_device(arr, device, dtype)
    return t
