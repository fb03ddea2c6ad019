"""The fused articulated substeps: CUDA kernel wrapper and plain version.

Counterpart of ``biped_mpc_py_tpu/ops/pallas/substep_kernel.py::
fused_substeps``. :func:`fused_substeps` advances a batch of
:class:`~biped_mpc_py_torch.sim.engine.ArtState` by ``n_steps``
semi-implicit substeps of ``dt / n_steps`` under held joint torques and a
held mass-matrix inverse: leg FK and velocities, toe/heel penalty contact,
joint-limit and damping torques, the RNEA bias with the gravity trick,
qdd = Minv (tau - bias), and the Euler step with the exponential-map
quaternion update. On flat ground (``terrain=None``, the TPU kernel's only
ground) ``t`` advances by ``dt`` once, on the host side, as in the JAX
wrapper. On a height field per env (``terrain``, (N, H, W)) the contact acts
along the surface normal, ``t`` advances by ``dt / n_steps`` at every
substep and the sole points below the ground are counted, all as
``sim/engine.py::art_step`` does: the JAX package steps a field with that
plain chain only.

Tensors on the card go to the CUDA kernel in ``csrc/substep.cu`` (two
lanes per env, one per leg; the mass-matrix inverses staged in shared
memory; one instantiation per ground), built with ``nvcc`` at first use
(``ops/cuda/build.py``). Tensors on the CPU go to
:func:`fused_substeps_reference`, a loop of ``sim/engine.py::art_substep``,
or on a field to ``art_step`` itself. Nothing else chooses between the two.

The kernel reads the model from a small constant buffer
(:func:`model_constants`), so the model is a runtime input, not a
compile-time fold; it stays one model for the whole batch, as in JAX. The
kernel repacks the buffer as it stages it (each spatial inertia as its
rotational block, ``m c`` and ``m``), so the buffer's layout is the only
contract between the two sides.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from biped_mpc_py_torch.ops.cuda import build
from biped_mpc_py_torch.sim.dynamics import GRAVITY
from biped_mpc_py_torch.sim.engine import ArtState, art_step, art_substep
from biped_mpc_py_torch.sim.model import ArticulatedModel
from biped_mpc_py_torch.sim.spatial import spatial_inertia
from biped_mpc_py_torch.utils import profiling

SOURCE = build.CSRC / "substep.cu"
# the constant buffer's layout, mirrored in csrc/substep.cu
N_CONSTS = 30 + 12 + 11 * 36 + 8 + 20  # 466 floats

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the library's C interface: {name: (argtypes, restype)}; FLAT_FUNCTIONS
# without the field kernel's launch, which a source of the flat kernel alone
# lacks
FLAT_FUNCTIONS = {
    "substep_launch": ([_PTR] * 13 + [_I32, _F32, _I32, _I32, _PTR], _I32),
    "substep_error_string": ([_I32], ctypes.c_char_p),
}
FUNCTIONS = {
    **FLAT_FUNCTIONS,
    "substep_field_launch": ([_PTR] * 17 + [_I32] * 3 + [_F32] * 4 + [_I32, _I32, _PTR], _I32),
}

_lib = None
# (id(model), device) -> (model, buffer): one entry per model object, never
# evicted, so no buffer that a captured CUDA graph reads is freed
_consts_cache: dict = {}


def _load():
    global _lib
    if _lib is None:
        _lib = build.load(SOURCE, FUNCTIONS)
    return _lib


def model_constants(model: ArticulatedModel, device) -> torch.Tensor:
    """The model as the kernel's flat f32 buffer (466,): joint offsets
    (10x3), contact points (4x3), the 11 spatial inertias (6x6 row-major,
    computed as the plain version computes them), then stiffness, damping,
    mu, vslip², joint damping, limit stiffness, limit damping, gravity, and
    the joint limits (10x2)."""
    f32 = torch.float32
    I6 = spatial_inertia(model.mass, model.com, model.inertia).to(f32)
    scalars = torch.tensor([
        model.contact_stiffness, model.contact_damping, model.contact_mu,
        model.contact_vslip**2, model.joint_damping, model.joint_limit_stiffness,
        model.joint_limit_damping, GRAVITY,
    ], dtype=f32)
    buf = torch.cat([
        model.joint_offset.to(f32).reshape(-1).cpu(),
        model.contact_points.to(f32).reshape(-1).cpu(),
        I6.reshape(-1).cpu(), scalars,
        model.joint_limits.to(f32).reshape(-1).cpu(),
    ])
    assert buf.numel() == N_CONSTS
    return buf.to(device)


def _constants(model: ArticulatedModel, device) -> torch.Tensor:
    """:func:`model_constants` on ``device``, made once per model object
    (the rollouts pass one model for every launch) and kept."""
    key = (id(model), device)
    if key not in _consts_cache:
        _consts_cache[key] = (model, model_constants(model, device))
    return _consts_cache[key][1]


def _check(state: ArtState, tau, Minv):
    n = state.q.shape[0]
    want = {
        "pos": (state.pos, (n, 3)), "quat": (state.quat, (n, 4)),
        "v_base": (state.v_base, (n, 6)), "q": (state.q, (n, 10)),
        "qd": (state.qd, (n, 10)), "tau": (tau, (n, 10)),
        "Minv": (Minv, (n, 16, 16)),
    }
    for name, (t, shape) in want.items():
        if t.device != state.q.device:
            raise ValueError(f"{name} is on {t.device}, q on {state.q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    return n


def _check_field(terrain, state: ArtState, n: int, device) -> torch.Tensor:
    """The heights of a field per env that the field kernels (the substep
    kernel's and the tick kernel's) take: (n, H, W) with H, W >= 2, float32,
    contiguous, on ``device``; the kernels also step ``state.t``, (n,)
    float32."""
    if state.t.dtype != torch.float32 or tuple(state.t.shape) != (n,):
        raise ValueError(f"t must be ({n},) float32, got {tuple(state.t.shape)} {state.t.dtype}")
    h = terrain.heights
    if not terrain.batched:
        raise ValueError("the field kernels take a height field per env, (N, H, W), not "
                         "one shared field (run art_step)")
    if h.shape[0] != n or min(h.shape[1:]) < 2:
        raise ValueError(f"terrain.heights has shape {tuple(h.shape)}, want ({n}, H, W) "
                         "with H, W >= 2")
    if h.dtype != torch.float32:
        raise TypeError(f"terrain.heights must be float32, got {h.dtype}")
    if h.device != device:
        raise ValueError(f"terrain.heights is on {h.device}, q on {device}")
    if not h.is_contiguous():
        raise ValueError("terrain.heights must be contiguous")
    return h


def fused_substeps(model: ArticulatedModel, state: ArtState, tau: torch.Tensor,
                   Minv: torch.Tensor, dt: float, n_steps: int,
                   terrain=None) -> ArtState:
    """Advance every env by ``n_steps`` substeps of ``dt / n_steps``.

    Args:
      model: one ArticulatedModel for the whole batch.
      state: ArtState with a leading env axis N (any N).
      tau: (N,10) joint torques, held across the substeps.
      Minv: (N,16,16) held mass-matrix inverse.
      dt: the full period [s], one float for the batch.
      terrain: None for the plane z = 0, or a ``sim.contact.Terrain`` with a
        field per env: ``heights`` (N, H, W), float32, contiguous, on the
        state's device, H and W >= 2.

    CUDA tensors launch the flat kernel, or on a field the field kernel (and
    count the launch in ``fused_substeps.launches``; a CUDA-graph replay of a
    captured launch adds to it too, ``utils/graphs.py``); CPU tensors run
    :func:`fused_substeps_reference`, or on a field ``art_step(model, state,
    tau, dt, n_steps, terrain, Minv=Minv)``. On a field the sole points below
    the ground are counted as the plain chain counts them
    (``utils/profiling.py::terrain_contacts``). Raises ValueError on a
    shared (H, W) field and on a per-env ``dt`` (a tensor): those run
    ``art_step``'s plain chain.
    """
    if isinstance(dt, torch.Tensor):
        raise ValueError("the substep kernel takes one dt per launch, not a per-env "
                         "tensor (run art_closed_loop_tick)")
    n = _check(state, tau, Minv)
    device = state.q.device
    heights = None if terrain is None else _check_field(terrain, state, n, device)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if device.type == "cpu":
        if terrain is not None:
            return art_step(model, state, tau, dt, n_steps, terrain, Minv=Minv)
        return fused_substeps_reference(model, state, tau, Minv, dt, n_steps)
    if device.type != "cuda":
        raise ValueError(f"fused_substeps runs on cuda or cpu, not {device}")
    ins = [t.contiguous() for t in (state.pos, state.quat, state.v_base,
                                    state.q, state.qd, tau, Minv)]
    outs = [torch.empty_like(t) for t in ins[:5]]
    sub_dt = dt / n_steps
    if terrain is None:
        t = state.t + dt
    else:
        t_in = state.t.contiguous()
        t = torch.empty_like(t_in)
        below = profiling.ground_counter((n, 2, 2), device, n_steps)
    if n > 0:
        lib = _load()
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        consts = _constants(model, device).data_ptr()
        if terrain is None:
            rc = lib.substep_launch(consts, *[x.data_ptr() for x in ins + outs], n,
                                    float(sub_dt), int(n_steps), index, stream)
        else:
            H, W = heights.shape[1:]
            rc = lib.substep_field_launch(
                consts, *[x.data_ptr() for x in ins + [t_in, heights] + outs + [t, below]],
                n, H, W, float(terrain.extent), 0.5 * terrain.extent / (W - 1),
                0.5 * terrain.extent / (H - 1), float(sub_dt), int(n_steps), index, stream,
            )
        if rc != 0:
            msg = lib.substep_error_string(rc).decode()
            raise RuntimeError(f"substep kernel launch failed: {msg} ({rc})")
        fused_substeps.launches += 1
    return ArtState(pos=outs[0], quat=outs[1], v_base=outs[2], q=outs[3], qd=outs[4], t=t)


fused_substeps.launches = 0


def fused_substeps_reference(model: ArticulatedModel, state: ArtState,
                             tau: torch.Tensor, Minv: torch.Tensor, dt: float,
                             n_steps: int) -> ArtState:
    """Plain PyTorch version of :func:`fused_substeps`: ``n_steps`` calls
    of ``art_substep`` with the held ``Minv``, then ``t + dt``."""
    t = state.t
    sub_dt = dt / n_steps
    for _ in range(n_steps):
        state = art_substep(model, state, tau, sub_dt, Minv=Minv)
    return dataclasses.replace(state, t=t + dt)
