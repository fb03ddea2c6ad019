"""The fused articulated tick: CUDA kernel wrapper and plain version.

Counterpart of ``biped_mpc_py_tpu/ops/pallas/tick_kernel.py::
make_fused_tick``. :func:`fused_tick` runs everything below the MPC layer
of one tick for a batch of envs: ``n_lowlevel`` periods of the whole-body
feedback, the walking low-level control (swing clock, Raibert target,
swing PD, stance Jᵀ map, pivot, hip-yaw and flight-yaw channels), the
positive joint work, and ``n_substeps`` physics substeps with the torques
and a held mass-matrix inverse. The clock of period p is ``t0 + p ll_dt``;
``t`` advances by ``mpc.dt`` once, on the host side, as in the JAX wrapper.

Tensors on the card go to the CUDA kernel in ``csrc/tick.cu`` (two lanes
per env, one per leg), built with ``nvcc`` at first use
(``ops/cuda/build.py``). Tensors
on the CPU go to :func:`fused_tick_reference`, the same tick composed of
``sim/engine.py::feedback_and_soles``, ``control/lowlevel.py::
low_level_control`` and ``fused_substeps_reference``. Nothing else chooses
between the two.

The kernel reads the model, the gains and the leg geometry from constant
buffers
(:func:`~biped_mpc_py_torch.ops.cuda.substep_kernel.model_constants` and
:func:`tick_constants`), so they are runtime inputs, one set for the whole
batch as in JAX (or, below, one set of gains per env). Scope, as the Pallas
kernel's: walking gaits (``flight_steps == 0``), flat ground, ``Minv`` held
all tick; and beyond it, a height field.

On a height field per env (``terrain``, (N, H, W), with the per-env robots
``bipeds``) the tick is the plain terrain periods of
``parallel/rollout_art.py::_art_tick``: the contact and the swing apex
follow each env's field, the low-level control reads each env's own leg
geometry, the clock is the state's ``t`` (advanced by ``dt / n_substeps``
at every substep, as ``sim/engine.py::art_step`` does, with period p's
control at that running ``t``) and the sole points below the ground are
counted. On the card that is the kernel's field instantiation
(``tick_kernel<Field>``, one launch); on the CPU
:func:`fused_tick_field_reference`. The JAX package runs a field on the
plain chain only.

With a config per env on flat ground (``x_cmd`` and ``per_env``, as
``parallel/sweep.py`` hands them: commands, low-level and swing gains,
Raibert gains; the MPC's weights and ADMM numerics reach the MPC stage
only) the tick is the plain per-env periods: the low-level control reads
each env's command and gains and each env's robot of ``bipeds``. On the
card that is the kernel's third instantiation (``tick_kernel<PlaneTable>``,
one launch), which reads each env's control constants from the table
:func:`tick_table` forms; on the CPU :func:`fused_tick_reference` with the
same values. A per-env ``dt`` stays on the plain chain: the clock's period
and rates fold it in. The JAX package runs a sweep on the plain chain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from biped_mpc_py_torch.config import (
    MPC_PER_ENV_FIELDS,
    PER_ENV_FIELDS,
    GaitConfig,
    MpcConfig,
    cmd_entry,
    config_value,
    device_constant,
)
from biped_mpc_py_torch.control.gait import phase_time
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda import build
from biped_mpc_py_torch.ops.cuda.substep_kernel import (
    _check_field,
    fused_substeps_reference,
    model_constants,
)
from biped_mpc_py_torch.sim import engine
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.sim.engine import ArtState, feedback_and_soles
from biped_mpc_py_torch.sim.model import ArticulatedModel
from biped_mpc_py_torch.utils import profiling

SOURCE = build.CSRC / "tick.cu"
# The tick constant buffer: body masses (11), CoMs (11x3), the sole depth,
# the total mass, then the control constants in the order of CONTROL_NAMES
# (mirrored by the Ctrl enum of csrc/tick.cu).
CONTROL_NAMES = (
    "t_p", "rate", "two_rate", "xc2", "xc3", "xc4", "xc8", "xc9", "xc10", "kv",
    "kp", "kd", "H", "H_rate", "tff", "td_damp", "kp_over", "retract",
    "y_offset", "capture_gain", "capture_sched", "kc_base", "am_y", "am_x",
    "pitch_place", "pitch_nom", "ff", "vint", "yaw_lead", "kp_hipyaw",
    "kd_hipyaw", "hipyaw_clip", "hipyaw_lead", "tau_yaw_clip",
    "flight_yaw_kd", "kp_pivot", "kd_pivot", "l_thigh", "l_shank", "l_foot",
    "abd_y", "abd_y_const", "hip_x", "hip_y", "hip_z",
)
N_TICK_CONSTS = 11 + 33 + 2 + len(CONTROL_NAMES)  # 91 floats
# the bits of the kernel's `flags` argument
FLAG_SIN2, FLAG_CMD_BODY_FRAME, FLAG_COMPAT_FRAME, FLAG_COMPAT_YAW = 1, 2, 4, 8
# the leg geometry, the last control constants and the columns of the field
# variant's per-env geometry (the Geom enum of csrc/tick.cu)
_GEOMETRY = ("l_thigh", "l_shank", "l_foot", "abd_y", "abd_y_const", "hip_x", "hip_y", "hip_z")
# The per-env fields the kernel path takes (config.PER_ENV_FIELDS and
# config.MPC_PER_ENV_FIELDS but dt, which t_p and the rates fold in): the MPC
# and post stages read each env's value, and each one that the walking
# low-level control reads is in a column of tick_table (swing_land_frac is
# read by running gaits only).
TABLE_FIELDS = tuple(f for f in PER_ENV_FIELDS + MPC_PER_ENV_FIELDS if f != "dt")

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [ctypes.c_double, _F32, _I32, _I32, _I32, _I32, _PTR]  # ll_dt ... stream
# the library's C interface: {name: (argtypes, restype)}
FUNCTIONS = {
    "tick_launch": ([_PTR] * 19 + [_I32] + _TAIL, _I32),
    "tick_field_launch": ([_PTR] * 23 + [_I32] * 3 + [_F32] * 3 + _TAIL, _I32),
    "tick_table_launch": ([_PTR] * 20 + [_I32] + _TAIL, _I32),
    "tick_n_consts": ([], _I32),
    "tick_n_ctrl": ([], _I32),
    "tick_error_string": ([_I32], ctypes.c_char_p),
}

_lib = None
# (ids of model, biped, mpc, gait; device) -> (those objects, buffers): one
# entry per set of objects, never evicted, so no buffer that a captured CUDA
# graph reads is freed (and the objects, held here, keep their ids)
_consts_cache: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE, FUNCTIONS)
        if lib.tick_n_consts() != N_TICK_CONSTS or lib.tick_n_ctrl() != len(CONTROL_NAMES):
            raise RuntimeError(
                f"csrc/tick.cu expects {lib.tick_n_consts()} tick constants and "
                f"{lib.tick_n_ctrl()} table columns, the wrapper packs {N_TICK_CONSTS} and "
                f"{len(CONTROL_NAMES)}"
            )
        _lib = lib
    return _lib


def tick_constants(model: ArticulatedModel, biped: BipedParams, mpc: MpcConfig,
                   gait: GaitConfig, device) -> torch.Tensor:
    """The tick's flat f32 buffer (N_TICK_CONSTS,): the model's body masses
    and CoMs, the sole point's z in the foot frame, the total mass, then the
    control constants of CONTROL_NAMES: the gait cadence, the ``x_cmd``
    entries and gains of ``mpc``, the products that the plain version forms
    from Python floats (computed the same way here), and ``biped``'s
    Jacobian leg geometry."""
    t_p = phase_time(mpc, gait)
    rate = math.pi / t_p
    xc = mpc.x_cmd
    geom = biped.jac_geometry
    control = {
        "t_p": t_p, "rate": rate, "two_rate": 2.0 * rate,
        "xc2": xc[2], "xc3": xc[3], "xc4": xc[4], "xc8": xc[8], "xc9": xc[9],
        "xc10": xc[10], "kv": mpc.kv, "kp": mpc.kp_swing, "kd": mpc.kd_swing,
        "H": mpc.swing_height, "H_rate": mpc.swing_height * rate,
        "tff": mpc.swing_track_ff, "td_damp": mpc.swing_td_damp,
        "kp_over": mpc.kp_swing * mpc.swing_td_overdrive,
        "retract": mpc.swing_retract, "y_offset": mpc.swing_y_offset,
        "capture_gain": mpc.raibert_capture_gain,
        "capture_sched": mpc.capture_sched,
        "kc_base": math.sqrt(max(xc[5], 0.0) / 9.81),
        "am_y": mpc.raibert_am_y, "am_x": mpc.raibert_am_x,
        "pitch_place": mpc.raibert_pitch_place,
        "pitch_nom": mpc.raibert_pitch_nom,
        "ff": 0.5 * t_p * mpc.raibert_ff_scale, "vint": mpc.raibert_vint,
        "yaw_lead": xc[8] * 0.5 * t_p, "kp_hipyaw": mpc.kp_hipyaw,
        "kd_hipyaw": mpc.kd_hipyaw, "hipyaw_clip": mpc.hipyaw_target_clip,
        "hipyaw_lead": mpc.hipyaw_rate_lead, "tau_yaw_clip": mpc.tau_yaw_clip,
        "flight_yaw_kd": mpc.flight_yaw_kd, "kp_pivot": mpc.kp_pivot,
        "kd_pivot": mpc.kd_pivot,
        **{k: float(getattr(geom, k)[0]) for k in _GEOMETRY},
    }
    f32 = torch.float32
    mass = model.mass.to(f32).cpu()
    buf = torch.cat([
        mass, model.com.to(f32).reshape(-1).cpu(),
        model.contact_points[0, 2:3].to(f32).cpu(), torch.sum(mass).reshape(1),
        torch.tensor([control[k] for k in CONTROL_NAMES], dtype=f32),
    ])
    assert buf.numel() == N_TICK_CONSTS
    return buf.to(device)


def tick_table(bipeds: BipedParams, mpc: MpcConfig, gait: GaitConfig,
               x_cmd: torch.Tensor | None = None,
               per_env: dict | None = None) -> torch.Tensor:
    """The per-env variant's control table (N, len(CONTROL_NAMES)), f32 on
    ``bipeds``' device: row e holds env e's control constants in the order
    of CONTROL_NAMES. A constant that depends on a value of ``x_cmd`` ((12,)
    or (N,12)) or ``per_env`` is formed by the tensor expression the plain
    chain forms it by (``control/swing.py``, ``control/reference.py``,
    ``control/lowlevel.py``: a per-env value times a config float in f32, as
    there); one that depends on none is the config's, rounded as
    :func:`tick_constants` rounds it; the leg geometry is each env's of
    ``bipeds.jac_geometry`` ((N,) each). Raises ValueError on a per-env
    ``dt``."""
    if per_env and "dt" in per_env:
        raise ValueError("a per-env dt folds into t_p and the rates: the tick kernel's "
                         "table takes one dt (run the plain chain, art_closed_loop_tick)")
    geom = bipeds.jac_geometry
    n, device = geom.l_thigh.shape[0], geom.l_thigh.device

    def f(name):
        return config_value(mpc, name, per_env)

    def xc(i):
        return cmd_entry(mpc, x_cmd, i)

    t_p = phase_time(mpc, gait)
    rate = math.pi / t_p
    if x_cmd is None:
        kc_base = math.sqrt(max(mpc.x_cmd[5], 0.0) / 9.81)
    else:
        kc_base = torch.sqrt(torch.clamp(x_cmd[..., 5], min=0.0) / 9.81)
    control = {
        "t_p": t_p, "rate": rate, "two_rate": 2.0 * rate,
        "xc2": xc(2), "xc3": xc(3), "xc4": xc(4), "xc8": xc(8), "xc9": xc(9),
        "xc10": xc(10), "kv": f("kv"), "kp": f("kp_swing"), "kd": f("kd_swing"),
        "H": f("swing_height"), "H_rate": f("swing_height") * rate,
        "tff": f("swing_track_ff"), "td_damp": f("swing_td_damp"),
        "kp_over": f("kp_swing") * f("swing_td_overdrive"),
        "retract": f("swing_retract"), "y_offset": f("swing_y_offset"),
        "capture_gain": f("raibert_capture_gain"), "capture_sched": f("capture_sched"),
        "kc_base": kc_base, "am_y": f("raibert_am_y"), "am_x": f("raibert_am_x"),
        "pitch_place": f("raibert_pitch_place"), "pitch_nom": f("raibert_pitch_nom"),
        "ff": 0.5 * t_p * f("raibert_ff_scale"), "vint": f("raibert_vint"),
        "yaw_lead": xc(8) * 0.5 * t_p, "kp_hipyaw": f("kp_hipyaw"),
        "kd_hipyaw": f("kd_hipyaw"), "hipyaw_clip": f("hipyaw_target_clip"),
        "hipyaw_lead": f("hipyaw_rate_lead"), "tau_yaw_clip": f("tau_yaw_clip"),
        "flight_yaw_kd": f("flight_yaw_kd"), "kp_pivot": f("kp_pivot"),
        "kd_pivot": f("kd_pivot"), **{k: getattr(geom, k) for k in _GEOMETRY},
    }
    values = [control[k] for k in CONTROL_NAMES]
    # the shared constants in one memoized buffer (a column's place is 0 where
    # it is per env), each column a view of it or the env's values
    shared = device_constant([0.0 if isinstance(v, torch.Tensor) else v for v in values],
                             device)
    return torch.stack([torch.broadcast_to(v, (n,)) if isinstance(v, torch.Tensor)
                        else shared[i].expand(n) for i, v in enumerate(values)], 1)


def _flags(mpc: MpcConfig) -> int:
    return (FLAG_SIN2 * mpc.swing_z_sin2 + FLAG_CMD_BODY_FRAME * mpc.cmd_body_frame
            + FLAG_COMPAT_FRAME * mpc.compat_swing_frame_bug
            + FLAG_COMPAT_YAW * mpc.compat_swing_yaw_bug)


def _constants(model, biped, mpc, gait, device):
    """(model buffer, tick buffer) on ``device``, made once per set of
    objects (the rollout passes the same ones every tick) and kept."""
    objs = (model, biped, mpc, gait)
    key = tuple(map(id, objs)) + (device,)
    if key not in _consts_cache:
        _consts_cache[key] = (objs, (model_constants(model, device),
                                     tick_constants(model, biped, mpc, gait, device)))
    return _consts_cache[key][1]


def _check(biped, gait, state, u0, c0, t0, cmd_yaw, v_int, Minv, n_lowlevel,
           n_substeps, terrain, x_cmd, per_env, bipeds, table):
    if gait.flight_steps > 0:
        raise ValueError("the tick kernel runs walking gaits only (flight_steps == 0): a "
                         "running gait runs the plain chain (art_closed_loop_tick)")
    if terrain is not None and not isinstance(terrain, Terrain):
        raise ValueError("the tick kernel runs on flat ground (terrain None) or on a "
                         f"Terrain, not on {type(terrain).__name__}")
    per_env_values = x_cmd is not None or bool(per_env)
    if per_env_values and terrain is not None:
        raise ValueError("the tick kernel's field variant holds one config: per-env x_cmd "
                         "or gains on a Terrain run the plain chain (art_closed_loop_tick)")
    if per_env and "dt" in per_env:
        raise ValueError("the tick kernel takes one dt (t_p and the rates fold it in): "
                         "a per-env dt runs the plain chain (art_closed_loop_tick)")
    other = sorted(set(per_env or ()) - set(TABLE_FIELDS))
    if other:
        raise ValueError(f"the tick kernel takes no per-env {other} (run the plain "
                         "chain, art_closed_loop_tick)")
    if table is not None and not per_env_values:
        raise ValueError("a table is the per-env variant's: pass x_cmd or per_env with it")
    if n_lowlevel < 1 or n_substeps < 1:
        raise ValueError("n_lowlevel and n_substeps must be >= 1")
    if biped.jac_geometry.l_thigh.shape[0] != 1:
        raise ValueError("biped must hold one robot (leading axis 1): the "
                         "kernel's leg geometry is one per batch")
    n = state.q.shape[0]
    want = {
        "pos": (state.pos, (n, 3)), "quat": (state.quat, (n, 4)),
        "v_base": (state.v_base, (n, 6)), "q": (state.q, (n, 10)),
        "qd": (state.qd, (n, 10)), "t": (state.t, (n,)), "u0": (u0, (n, 12)),
        "c0": (c0, (n, 2)), "t0": (t0, (n,)), "cmd_yaw": (cmd_yaw, (n,)),
        "v_int": (v_int, (n, 2)), "Minv": (Minv, (n, 16, 16)),
    }
    if per_env_values:
        if x_cmd is not None:
            want["x_cmd"] = (x_cmd, (n, 12) if x_cmd.dim() == 2 else (12,))
        for k, v in (per_env or {}).items():
            want[k] = (v, (n,) + tuple(v.shape[1:]))
        if table is not None:
            want["table"] = (table, (n, len(CONTROL_NAMES)))
    for name, (t, shape) in want.items():
        if t.device != state.q.device:
            raise ValueError(f"{name} is on {t.device}, q on {state.q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if terrain is not None:
        _check_field(terrain, state, n, state.q.device)
        if gait.contact_clock:
            raise ValueError("on a field the tick kernel's clock is the state's t: no "
                             "contact_clock (run art_closed_loop_tick)")
    if terrain is not None or per_env_values:
        if bipeds is None:
            raise ValueError("on a field or with per-env values the tick kernel takes each "
                             "env's leg geometry: pass bipeds")
        for k in _GEOMETRY:
            g = getattr(bipeds.jac_geometry, k)
            if g.device != state.q.device or g.dtype != torch.float32 or tuple(g.shape) != (n,):
                raise ValueError(f"bipeds' leg geometry {k} must be ({n},) float32 on "
                                 f"{state.q.device}, got {tuple(g.shape)} {g.dtype} on "
                                 f"{g.device}")
    return n


def fused_tick(model: ArticulatedModel, biped: BipedParams, mpc: MpcConfig,
               gait: GaitConfig, state: ArtState, u0: torch.Tensor, c0: torch.Tensor,
               t0: torch.Tensor, cmd_yaw: torch.Tensor, v_int: torch.Tensor,
               Minv: torch.Tensor, n_lowlevel: int = 8, n_substeps: int = 5,
               terrain=None, x_cmd=None, per_env=None,
               bipeds: BipedParams | None = None,
               table: torch.Tensor | None = None) -> tuple[ArtState, torch.Tensor]:
    """One tick below the MPC layer -> (ArtState, energy (N,)).

    Args:
      model: one ArticulatedModel for the whole batch.
      biped: one robot (leading axis 1): on flat ground with one config its
        Jacobian leg geometry serves every env's low-level control (the MPC
        stage takes the per-env batch).
      state: ArtState with a leading env axis N (any N).
      u0: (N,12) first MPC control, held all tick; c0: (N,2) first-row
        contact flags; t0: (N,) gait time at the tick's start (on a field the
        state's ``t``, where the running clock starts); cmd_yaw: (N,) the
        command anchor's yaw; v_int: (N,2); Minv: (N,16,16) held.
      terrain: None for flat ground, or a ``sim.contact.Terrain`` with a field
        per env: ``heights`` (N, H, W), float32, contiguous, on the state's
        device, H and W >= 2 (walking gaits without ``contact_clock``).
      x_cmd, per_env: None for one config (the constant buffer's), or on
        flat ground a config per env as ``art_closed_loop_tick`` takes it:
        ``x_cmd`` (12,) or (N,12) and ``per_env`` of :data:`TABLE_FIELDS`
        ((N,) each, ``Q`` (N,13), ``R`` (N,12)), float32 on the state's
        device; no per-env ``dt``.
      bipeds: on a field or with per-env values, the N robots whose Jacobian
        leg geometry (``jac_geometry``, (N,) float32 each) the low-level
        control reads per env, as the plain periods do.
      table: with per-env values, ``tick_table(bipeds, mpc, gait, x_cmd,
        per_env)`` (the kernel's constants, formed by the caller in a stage
        of its own), or None to form it here.

    CUDA tensors launch the kernel, on a field its field instantiation, with
    per-env values its table instantiation (and count the launch in
    ``fused_tick.launches``; a CUDA-graph replay of a captured launch adds to
    it too, ``utils/graphs.py``); CPU tensors run :func:`fused_tick_reference`
    (with per-env values the plain per-env periods, which form the table's
    constants themselves), on a field :func:`fused_tick_field_reference`.
    On a field ``t`` is advanced as the plain chain advances it and the sole
    points below the ground are counted (``utils/profiling.py::
    terrain_contacts``); on flat ground ``t`` advances by ``mpc.dt``.
    Raises ValueError on a running gait, a shared field, a field with
    ``contact_clock`` or without ``bipeds``, per-env values on a field, a
    per-env ``dt`` or a per-env field outside :data:`TABLE_FIELDS`, and per-env
    values without ``bipeds``, or a ``table`` without them.
    """
    n = _check(biped, gait, state, u0, c0, t0, cmd_yaw, v_int, Minv, n_lowlevel,
               n_substeps, terrain, x_cmd, per_env, bipeds, table)
    per_env_values = x_cmd is not None or bool(per_env)
    device = state.q.device
    if device.type == "cpu":
        if terrain is not None:
            return fused_tick_field_reference(model, bipeds, mpc, gait, state, u0, c0, t0,
                                              cmd_yaw, v_int, Minv, terrain, n_lowlevel,
                                              n_substeps)
        if per_env_values:
            return fused_tick_reference(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw,
                                        v_int, Minv, n_lowlevel, n_substeps, x_cmd=x_cmd,
                                        per_env=per_env, bipeds=bipeds)
        return fused_tick_reference(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw,
                                    v_int, Minv, n_lowlevel, n_substeps)
    if device.type != "cuda":
        raise ValueError(f"fused_tick runs on cuda or cpu, not {device}")
    ins = [t.contiguous() for t in (state.pos, state.quat, state.v_base, state.q, state.qd,
                                    u0, c0, t0, cmd_yaw, v_int, Minv)]
    outs = [torch.empty_like(t) for t in ins[:5]] + [torch.empty_like(ins[7])]
    if per_env_values and table is None:
        table = tick_table(bipeds, mpc, gait, x_cmd, per_env)
    if terrain is None:
        t = state.t + mpc.dt
    else:
        geom = torch.stack([getattr(bipeds.jac_geometry, k) for k in _GEOMETRY], 1)
        t = torch.empty_like(ins[7])
        below = profiling.ground_counter((n, 2, 2), device, n_lowlevel * n_substeps)
    if n > 0:
        lib = _load()
        model_buf, tick_buf = _constants(model, biped, mpc, gait, device)
        ll_dt = mpc.dt / n_lowlevel
        tail = (n_lowlevel, n_substeps, _flags(mpc),
                device.index if device.index is not None else torch.cuda.current_device(),
                torch.cuda.current_stream(device).cuda_stream)
        if table is not None:
            rc = lib.tick_table_launch(model_buf.data_ptr(), tick_buf.data_ptr(),
                                       *[x.data_ptr() for x in ins + [table.contiguous()] + outs],
                                       n, ll_dt, float(ll_dt / n_substeps), *tail)
        elif terrain is None:
            rc = lib.tick_launch(model_buf.data_ptr(), tick_buf.data_ptr(),
                                 *[x.data_ptr() for x in ins + outs], n, ll_dt,
                                 float(ll_dt / n_substeps), *tail)
        else:
            H, W = terrain.heights.shape[1:]
            ptrs = ins + [terrain.heights, geom] + outs + [t, below]
            rc = lib.tick_field_launch(
                model_buf.data_ptr(), tick_buf.data_ptr(), *[x.data_ptr() for x in ptrs],
                n, H, W, float(terrain.extent), 0.5 * terrain.extent / (W - 1),
                0.5 * terrain.extent / (H - 1), ll_dt, float(ll_dt / n_substeps), *tail,
            )
        if rc != 0:
            msg = lib.tick_error_string(rc).decode()
            raise RuntimeError(f"tick kernel launch failed: {msg} ({rc})")
        fused_tick.launches += 1
    new = ArtState(pos=outs[0], quat=outs[1], v_base=outs[2], q=outs[3], qd=outs[4], t=t)
    return new, outs[5]


fused_tick.launches = 0


def fused_tick_reference(model: ArticulatedModel, biped: BipedParams, mpc: MpcConfig,
                         gait: GaitConfig, state: ArtState, u0: torch.Tensor,
                         c0: torch.Tensor, t0: torch.Tensor, cmd_yaw: torch.Tensor,
                         v_int: torch.Tensor, Minv: torch.Tensor, n_lowlevel: int = 8,
                         n_substeps: int = 5, x_cmd: torch.Tensor | None = None,
                         per_env: dict | None = None,
                         bipeds: BipedParams | None = None) -> tuple[ArtState, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_tick` on flat ground: per
    period, ``feedback_and_soles``, ``low_level_control`` at ``t0 + p ll_dt``
    (contact row 0 = ``c0``, command yaw = ``cmd_yaw``), the positive work,
    and ``fused_substeps_reference``; then ``t + mpc.dt``. The low-level
    control takes ``x_cmd`` and ``per_env`` where given (the per-env
    variant's), and ``bipeds``' leg geometry per env, else ``biped``'s."""
    n = state.q.shape[0]
    bipeds = biped.expand(n) if bipeds is None else bipeds
    contact = c0[:, None, :]
    cmd_ref = torch.stack([torch.zeros_like(cmd_yaw), torch.zeros_like(cmd_yaw), cmd_yaw], -1)
    ll_dt = mpc.dt / n_lowlevel
    energy = torch.zeros_like(t0)
    sim = state
    for p in range(n_lowlevel):
        x, pf = feedback_and_soles(model, sim)
        tau = low_level_control(x, t0 + p * ll_dt, pf, sim.q, sim.qd, mpc, bipeds, contact,
                                u0, gait=gait, cmd_ref=cmd_ref, v_int=v_int, x_cmd=x_cmd,
                                per_env=per_env)
        energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
        sim = fused_substeps_reference(model, sim, tau, Minv, ll_dt, n_substeps)
    return dataclasses.replace(sim, t=state.t + mpc.dt), energy


def fused_tick_field_reference(model: ArticulatedModel, bipeds: BipedParams, mpc: MpcConfig,
                               gait: GaitConfig, state: ArtState, u0: torch.Tensor,
                               c0: torch.Tensor, t0: torch.Tensor, cmd_yaw: torch.Tensor,
                               v_int: torch.Tensor, Minv: torch.Tensor, terrain: Terrain,
                               n_lowlevel: int = 8,
                               n_substeps: int = 5) -> tuple[ArtState, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_tick` on a field per env: the
    terrain periods of ``parallel/rollout_art.py::_art_tick``, from the
    state with its clock at ``t0``. Per period, ``feedback_and_soles``,
    ``low_level_control`` on ``terrain`` with each env's robot at the
    running ``t`` (contact row 0 = ``c0``, command yaw = ``cmd_yaw``), the
    positive work, and ``sim.engine.art_step(..., terrain, Minv=)``, which
    advances ``t`` and counts the sole points below the ground."""
    contact = c0[:, None, :]
    cmd_ref = torch.stack([torch.zeros_like(cmd_yaw), torch.zeros_like(cmd_yaw), cmd_yaw], -1)
    ll_dt = mpc.dt / n_lowlevel
    energy = torch.zeros_like(t0)
    sim = dataclasses.replace(state, t=t0)
    for _ in range(n_lowlevel):
        x, pf = feedback_and_soles(model, sim)
        tau = low_level_control(x, sim.t, pf, sim.q, sim.qd, mpc, bipeds, contact, u0,
                                gait=gait, cmd_ref=cmd_ref, terrain=terrain, v_int=v_int)
        energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
        sim = engine.art_step(model, sim, tau, ll_dt, n_substeps, terrain, Minv=Minv)
    return sim, energy
