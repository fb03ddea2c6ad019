"""The fused articulated substeps: CUDA kernel wrapper and plain version.

Counterpart of ``biped_mpc_py_tpu/ops/pallas/substep_kernel.py::
fused_substeps``. :func:`fused_substeps` advances a batch of
:class:`~biped_mpc_py_torch.sim.engine.ArtState` by ``n_steps``
semi-implicit substeps of ``dt / n_steps`` under held joint torques and a
held mass-matrix inverse, on flat ground: leg FK and velocities, toe/heel
penalty contact, joint-limit and damping torques, the RNEA bias with the
gravity trick, qdd = Minv (tau - bias), and the Euler step with the
exponential-map quaternion update. ``t`` advances by ``dt`` once, on the
host side, as in the JAX wrapper.

Tensors on the card go to the CUDA kernel in ``csrc/substep.cu`` (two
lanes per env, one per leg; the mass-matrix inverses staged in shared
memory), built with ``nvcc`` at first use (``ops/cuda/build.py``).
Tensors on the CPU go to :func:`fused_substeps_reference`, a loop of
``sim/engine.py::art_substep``. Nothing else chooses between the two.

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
from biped_mpc_py_torch.sim.engine import ArtState, art_substep
from biped_mpc_py_torch.sim.model import ArticulatedModel
from biped_mpc_py_torch.sim.spatial import spatial_inertia

SOURCE = build.CSRC / "substep.cu"
# the constant buffer's layout, mirrored in csrc/substep.cu
N_CONSTS = 30 + 12 + 11 * 36 + 8 + 20  # 466 floats

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# the library's C interface: {name: (argtypes, restype)}
FUNCTIONS = {
    "substep_launch": ([_PTR] * 13 + [_I32, ctypes.c_float, _I32, _I32, _PTR], _I32),
    "substep_error_string": ([_I32], ctypes.c_char_p),
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
      terrain: must be None. The kernel knows the plane z = 0 only, as the
        TPU kernel does; a height field runs ``art_step``'s plain chain.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_substeps.launches``; a CUDA-graph replay of a captured launch adds to it too,
    ``utils/graphs.py``); CPU tensors run
    :func:`fused_substeps_reference`. Raises ValueError on a terrain and on
    a per-env ``dt`` (a tensor): the kernel takes one step per launch, and
    a sweep over ``dt`` runs ``art_step``'s plain chain.
    """
    if terrain is not None:
        raise ValueError("the substep kernel runs on flat ground only (terrain is None)")
    if isinstance(dt, torch.Tensor):
        raise ValueError("the substep kernel takes one dt per launch, not a per-env "
                         "tensor (run art_closed_loop_tick)")
    n = _check(state, tau, Minv)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    device = state.q.device
    if device.type == "cpu":
        return fused_substeps_reference(model, state, tau, Minv, dt, n_steps)
    if device.type != "cuda":
        raise ValueError(f"fused_substeps runs on cuda or cpu, not {device}")
    ins = [t.contiguous() for t in (state.pos, state.quat, state.v_base,
                                    state.q, state.qd, tau, Minv)]
    outs = [torch.empty_like(t) for t in ins[:5]]
    if n > 0:
        lib = _load()
        rc = lib.substep_launch(
            _constants(model, device).data_ptr(), *[t.data_ptr() for t in ins + outs],
            n, float(dt / n_steps), int(n_steps),
            device.index if device.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(device).cuda_stream,
        )
        if rc != 0:
            msg = lib.substep_error_string(rc).decode()
            raise RuntimeError(f"substep kernel launch failed: {msg} ({rc})")
        fused_substeps.launches += 1
    return ArtState(pos=outs[0], quat=outs[1], v_base=outs[2], q=outs[3],
                    qd=outs[4], t=state.t + dt)


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
