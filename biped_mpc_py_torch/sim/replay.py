"""Trajectory export for offline visualization and replay: the counterpart
of ``biped_mpc_py_tpu/sim/replay.py``.

A rollout of one robot is exported as a standard MuJoCo pair,
``<prefix>_model.xml`` (``sim/mjcf.py``) and ``<prefix>_traj.npz`` with the
qpos track, so that any MuJoCo viewer replays it without this package:

    import mujoco, numpy as np
    m = mujoco.MjModel.from_xml_path("model.xml")
    d = mujoco.MjData(m)
    t = np.load("traj.npz")
    for q in t["qpos"]:
        d.qpos[:] = q; mujoco.mj_forward(m, d)  # -> render

The rollout of :func:`rollout_qpos_track` is the compiled plain chain at
N = 1: one tick captured as a CUDA graph and replayed (the counterpart of
the JAX function's jitted scan), its frames gathered on the device.

qpos layout (17,): free joint [pos (3), quat wxyz (4)] + 10 joint angles,
the same in :class:`~biped_mpc_py_torch.sim.engine.ArtState` and in the
exported MJCF (``sim/mj_driver.py::state_from_mj`` is the inverse map).
"""

from __future__ import annotations

import numpy as np
import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.sim.mjcf import set_hfield_data, to_mjcf
from biped_mpc_py_torch.sim.model import ArticulatedModel, hector_model
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.graphs import TickGraph
from biped_mpc_py_torch.utils.precision import f32_precision


@f32_precision
@torch.no_grad()
def rollout_qpos_track(
    mpc: MpcConfig,
    gait: GaitConfig,
    n_ticks: int,
    model: ArticulatedModel | None = None,
    biped: BipedParams | None = None,
    terrain=None,
    device=DEFAULT_DEVICE,
    **tick_kw,
):
    """An articulated closed-loop rollout of one robot from standing on
    ``device`` (the card unless named; raises without one) through the plain
    chain at N = 1, and its qpos track (``replay.py:33``): the tick of
    ``batched_art_rollout_fn`` (``art_closed_loop_tick``; ``tick_kw``:
    ``n_lowlevel``, ``n_substeps``, ``minv_ll_hold``) captured once as a CUDA
    graph and replayed, as JAX jits the scan (on the CPU the same buffers
    step eagerly). The frames stay on the device until one copy to the host
    at the end.

    Returns ``(qpos (n_ticks, 17), times (n_ticks,), falls)``: one frame per
    40 ms MPC tick (25 fps, real-time playback at the control rate).
    """
    from biped_mpc_py_torch.parallel.rollout_art import _plain_step, init_art_world

    device = entry_device(device)
    model = model or hector_model(device=device)
    biped = (biped or BipedParams()).to(device)
    w = init_art_world(mpc, 1, device=device)
    tick = TickGraph(_plain_step(mpc, gait, model, terrain=terrain, **tick_kw), w, biped)
    frames = torch.empty(n_ticks, 17, device=device)
    times = torch.empty(n_ticks, device=device)
    for k in range(n_ticks):
        tick.replay()
        s = w.sim
        torch.cat([s.pos, s.quat, s.q], -1, out=frames[k:k + 1])
        times[k:k + 1].copy_(s.t)
    return frames.cpu().numpy(), times.cpu().numpy(), float(w.metrics.falls[0])


def export_rollout(
    prefix: str,
    mpc: MpcConfig,
    gait: GaitConfig,
    n_ticks: int,
    model: ArticulatedModel | None = None,
    biped: BipedParams | None = None,
    terrain=None,
    device=DEFAULT_DEVICE,
    **tick_kw,
) -> dict:
    """Export ``<prefix>_model.xml`` and ``<prefix>_traj.npz`` for replay
    (``replay.py:73``).

    The MJCF carries the contact geometry and, with a ``terrain`` (one
    (H, W) field), the height field, whose grid rides in the npz (MuJoCo's
    compiler reorders inline elevation data; :func:`restore_hfield` fills
    it). Returns a summary dict.
    """
    device = entry_device(device)
    model = model or hector_model(device=device)
    qpos, times, falls = rollout_qpos_track(
        mpc, gait, n_ticks, model=model, biped=biped, terrain=terrain, device=device,
        **tick_kw,
    )
    xml = to_mjcf(
        model, 4e-2, contact=True, terrain=terrain,
        sphere_r=0.02 if terrain is not None else 0.005,
    )
    with open(f"{prefix}_model.xml", "w") as f:
        f.write(xml)
    extra = {}
    if terrain is not None:
        extra = dict(
            terrain_heights=terrain.heights.detach().cpu().numpy(),
            terrain_extent=np.asarray(terrain.extent, np.float32),
        )
    np.savez(f"{prefix}_traj.npz", qpos=qpos, times=times, **extra)
    return dict(
        frames=int(qpos.shape[0]), duration_s=float(times[-1]),
        falls=falls, files=[f"{prefix}_model.xml", f"{prefix}_traj.npz"],
    )


class _HeightsOnly:
    def __init__(self, heights):
        self.heights = heights


def restore_hfield(mj_model, npz) -> None:
    """Fill a loaded MjModel's hfield from an exported traj.npz
    (``replay.py:119``)."""
    set_hfield_data(mj_model, _HeightsOnly(npz["terrain_heights"]))
