"""The torch port's deployment path against the JAX package, with MuJoCo as
the plant: ``sim/mjcf.py``, ``sim/mj_driver.py``, ``runtime/realtime.py``
and ``sim/replay.py``, and the MuJoCo oracles of the engine's dynamics
(``tests/test_sim.py:204-279``) against the port's ``sim/dynamics.py``.
Every controller runs on the CPU here (``device="cpu"``).

Tolerances:
- ``to_mjcf`` and ``penalty_matched_solref``: string-equal; the hfield data
  and ``state_from_mj``: 1e-6 (f32 rotation of the velocity);
- the MuJoCo oracles: ``tests/test_sim.py``'s (free flight: pos 2e-4, quat
  2e-3, q 5e-3, qd 5e-2 after 50 ms; the mass matrix's joint and angular
  blocks 1e-5);
- closed loops in MuJoCo, port against JAX over 5 ticks at the bench
  budget (the bf16 knobs cleared): ``MJ_BOUNDS`` on the feedback states
  (attitude and position 1e-4, velocities 2e-3, as ``CHAIN_BOUNDS`` of
  ``tests/test_torch_rollout_art.py`` bound pos and v_base) and 1 N on the
  tick-mean foot forces (of m g = 117.7 N; measured 0.16 N: MuJoCo's stiff
  contact amplifies the f32 torque roundoff), fall flags equal;
- ``RealtimeLoop``, port against JAX on two identical plants: the same
  bounds on the plants' states; alone, the checks of
  ``tests/test_realtime.py``;
- replay: ``tests/test_sim.py::test_replay_export_roundtrip``'s checks.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.config import GaitConfig as JGaitConfig
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_tpu.runtime.realtime import RealtimeLoop as JRealtimeLoop
from biped_mpc_py_tpu.sim import mj_driver as jmj
from biped_mpc_py_tpu.sim import mjcf as jmjcf
from biped_mpc_py_tpu.sim.contact import Terrain as JTerrain
from biped_mpc_py_tpu.sim.model import hector_model as jax_hector_model
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.rotations import quat_to_rotm
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.runtime.realtime import LoopStats, RealtimeLoop
from biped_mpc_py_torch.sim import mj_driver as tmj
from biped_mpc_py_torch.sim import mjcf as tmjcf
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.sim.dynamics import crba_mass_matrix
from biped_mpc_py_torch.sim.engine import (
    ArtState,
    art_step,
    com_feedback_state,
    sole_positions,
)
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.sim.replay import export_rollout, restore_hfield
from biped_mpc_py_torch.utils.convert import from_numpy
from torch_threads import one_torch_thread  # noqa: F401

mujoco = pytest.importorskip("mujoco")

BENCH = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)
# tests/test_mj_contact.py's pinned MuJoCo operating point
ORACLE_MPC = dict(kp_hipyaw=3.0, kd_hipyaw=0.4, tau_z_max=4.0, swing_td_damp=8.0,
                  swing_z_sin2=True)
MJ_BOUNDS = {"att_pos": 1e-4, "vel": 2e-3, "force": 1.0}
MODEL = hector_model(device="cpu")


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _configs(**kw):
    jm = jra.art_mpc_config(**ORACLE_MPC, **BENCH, **kw)
    return jm, from_numpy(tcfg.MpcConfig, _fields(jm))


def _terrains(res=64, amplitude=0.02):
    jt = JTerrain.rough(jax.random.PRNGKey(3), amplitude=amplitude, res=res)
    return jt, from_numpy(Terrain, _fields(jt))


def _assert_states_close(x_t, x_j, name):
    x_t, x_j = np.asarray(x_t), np.asarray(x_j)
    assert x_t.shape == x_j.shape, (name, x_t.shape, x_j.shape)
    d = np.abs(x_t - x_j)
    assert d[..., 0:6].max() < MJ_BOUNDS["att_pos"], (name, d[..., 0:6].max())
    assert d[..., 6:12].max() < MJ_BOUNDS["vel"], (name, d[..., 6:12].max())


# --- MJCF --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["flight", "contact", "terrain"])
def test_to_mjcf_string_equal(case):
    jmodel = jax_hector_model()
    if case == "flight":
        args, kw = (1e-4,), {}
    elif case == "contact":
        args = (5e-4,)
        kw = dict(contact=True, solref=tmjcf.penalty_matched_solref(MODEL))
        assert kw["solref"] == jmjcf.penalty_matched_solref(jmodel)
    else:
        jt, tt = _terrains()
        args, kw = (4e-2,), dict(contact=True, sphere_r=0.02)
        assert tmjcf.to_mjcf(MODEL, *args, terrain=tt, **kw) == \
            jmjcf.to_mjcf(jmodel, *args, terrain=jt, **kw)
    assert tmjcf.to_mjcf(MODEL, *args, **kw) == jmjcf.to_mjcf(jmodel, *args, **kw)


def test_set_hfield_data_equal():
    jt, tt = _terrains(res=16)
    xml = tmjcf.to_mjcf(MODEL, 5e-4, contact=True, terrain=tt, sphere_r=0.02)
    m_t, m_j = (mujoco.MjModel.from_xml_string(xml) for _ in range(2))
    tmjcf.set_hfield_data(m_t, tt)
    jmjcf.set_hfield_data(m_j, jt)
    np.testing.assert_array_equal(m_t.hfield_data, m_j.hfield_data)
    assert m_t.hfield_data.max() == 1.0 and m_t.hfield_data.min() == 0.0


def test_state_from_mj_matches_jax():
    m = mujoco.MjModel.from_xml_string(tmjcf.to_mjcf(MODEL, 5e-4))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(0)
    d.qpos[:] = rng.normal(size=17)
    d.qpos[3:7] /= np.linalg.norm(d.qpos[3:7])
    d.qvel[:] = rng.normal(size=16)
    s_t = tmj.state_from_mj(d, 0.37, device="cpu")
    s_j = jmj.state_from_mj(d, 0.37)
    for k in ("pos", "quat", "v_base", "q", "qd", "t"):
        np.testing.assert_allclose(getattr(s_t, k)[0].numpy(), np.asarray(getattr(s_j, k)),
                                   atol=1e-6, rtol=0, err_msg=k)


# --- MuJoCo oracles of the port's dynamics (tests/test_sim.py:204-279) -----

def _mj_setup(model, timestep=5e-4):
    m = mujoco.MjModel.from_xml_string(tmjcf.to_mjcf(model, timestep))
    return m, mujoco.MjData(m)


def _sync_state(d, s: ArtState):
    R = quat_to_rotm(s.quat)[0].numpy()
    d.qpos[0:3] = s.pos[0].numpy()
    d.qpos[3:7] = s.quat[0].numpy()
    d.qpos[7:17] = s.q[0].numpy()
    d.qvel[0:3] = R @ s.v_base[0, 3:6].numpy()
    d.qvel[3:6] = s.v_base[0, 0:3].numpy()
    d.qvel[6:16] = s.qd[0].numpy()


def test_flight_trajectory_matches_mujoco():
    """50 ms of torque-driven flight: base and joints match MuJoCo."""
    m0 = dataclasses.replace(MODEL, joint_damping=0.0)
    rng = np.random.default_rng(1)
    s = dataclasses.replace(
        ArtState.standing(z0=3.0),
        v_base=torch.tensor(rng.normal(size=(1, 6)) * 0.2, dtype=torch.float32),
        qd=torch.tensor(rng.normal(size=(1, 10)) * 0.3, dtype=torch.float32),
    )
    tau = torch.tensor(rng.normal(size=(1, 10)) * 2.0, dtype=torch.float32)
    m, d = _mj_setup(m0)
    _sync_state(d, s)
    d.qfrc_applied[6:16] = tau[0].numpy()
    for _ in range(100):  # 50 ms at 0.5 ms
        mujoco.mj_step(m, d)
    s_t = art_step(m0, s, tau, 0.05, 100)
    np.testing.assert_allclose(s_t.pos[0].numpy(), d.qpos[0:3], atol=2e-4)
    q_mj = d.qpos[3:7] * np.sign(d.qpos[3])
    q_t = s_t.quat[0].numpy() * np.sign(float(s_t.quat[0, 0]))
    np.testing.assert_allclose(q_t, q_mj, atol=2e-3)
    np.testing.assert_allclose(s_t.q[0].numpy(), d.qpos[7:17], atol=5e-3)
    np.testing.assert_allclose(s_t.qd[0].numpy(), d.qvel[6:16], atol=5e-2)


def test_mass_matrix_matches_mujoco():
    rng = np.random.default_rng(2)
    m, d = _mj_setup(MODEL)
    for _ in range(3):
        s = dataclasses.replace(
            ArtState.standing(z0=1.0),
            q=torch.tensor(rng.uniform(-0.8, 0.8, (1, 10)), dtype=torch.float32))
        _sync_state(d, s)
        mujoco.mj_forward(m, d)
        M_mj = np.zeros((16, 16))
        mujoco.mj_fullM(m, d, M_mj)
        M_t = crba_mass_matrix(MODEL, s.q)[0].numpy()
        # MuJoCo's free-joint rows are [lin_world, ang_body], the port's
        # [ang_body, lin_body]: the joint block and, at identity
        # orientation, the angular and linear blocks
        np.testing.assert_allclose(M_t[6:, 6:], M_mj[6:, 6:], atol=1e-5)
        np.testing.assert_allclose(M_t[0:3, 0:3], M_mj[3:6, 3:6], atol=1e-5)
        np.testing.assert_allclose(M_t[3:6, 3:6], M_mj[0:3, 0:3], atol=1e-5)


# --- closed loops in MuJoCo ------------------------------------------------

def _loop_case(name):
    """(JAX kwargs, port kwargs) of run_mujoco_closed_loop for a case."""
    if name == "plain":
        return {}, {}
    if name == "schedules":
        cmd = np.zeros(12, np.float32)
        cmd[[5, 9]] = 0.55, 0.2
        jclock = JGaitConfig(contact_clock=True)
        tclock = tcfg.GaitConfig(contact_clock=True)
        common = dict(shove=(1, 0.1, 0.05), cmd_schedule=[(2, cmd)], dq0=np.full(10, 1e-3))
        return (dict(common, gait_schedule=[(3, jclock)]),
                dict(common, gait_schedule=[(3, tclock)]))
    jt, tt = _terrains(res=16, amplitude=0.01)
    return dict(terrain=jt), dict(terrain=tt)


@pytest.mark.parametrize("case", ["plain", "schedules", "terrain"])
def test_mujoco_closed_loop_matches_jax(case):
    """5 ticks of walking in place: plain, with a shove at tick 1, a
    command switch at tick 2 and a switch to the contact-sensed clock at
    tick 3, and on a small height field."""
    jm, tm = _configs()
    jkw, tkw = _loop_case(case)
    f_j, x_j, fell_j = jmj.run_mujoco_closed_loop(jm, JGaitConfig(), 5, **jkw)
    f_t, x_t, fell_t = tmj.run_mujoco_closed_loop(tm, tcfg.GaitConfig(), 5, device="cpu",
                                                  **tkw)
    assert fell_t == fell_j and not fell_t
    _assert_states_close(x_t, x_j, case)
    assert np.abs(f_t - f_j).max() < MJ_BOUNDS["force"], np.abs(f_t - f_j).max()
    assert f_t.sum(axis=1).mean() > 50.0  # feet on the floor


def test_mujoco_closed_loop_rejects_cadence_switch():
    _, tm = _configs()
    with pytest.raises(ValueError, match="gait_mode"):
        tmj.run_mujoco_closed_loop(tm, tcfg.GaitConfig(), 2, device="cpu",
                                   gait_schedule=[(1, tcfg.GaitConfig(steps_per_phase=3))])


# --- the real-time loop ----------------------------------------------------

class MujocoPlant:
    """MuJoCo as the robot behind the Plant interface (the port's feedback,
    as ``tests/test_realtime.py``'s plant uses the JAX package's)."""

    def __init__(self):
        self.m = mujoco.MjModel.from_xml_string(
            tmjcf.to_mjcf(MODEL, tmj.MJ_DT, contact=True,
                          solref=tmjcf.penalty_matched_solref(MODEL)))
        self.d = mujoco.MjData(self.m)
        s0 = ArtState.standing()
        self.d.qpos[0:3] = s0.pos[0].numpy()
        self.d.qpos[3:7] = s0.quat[0].numpy()
        self.d.qpos[7:17] = s0.q[0].numpy()
        self.t = 0.0

    def _state(self):
        return tmj.state_from_mj(self.d, self.t, device="cpu")

    def read_state(self):
        s = self._state()
        return com_feedback_state(MODEL, s)[0].numpy(), s.q[0].numpy(), s.qd[0].numpy()

    def foot_positions(self):
        return sole_positions(MODEL, self._state())[0].numpy()

    def apply(self, tau, dt):
        self.d.qfrc_applied[6:16] = np.asarray(tau)
        for _ in range(int(round(dt / tmj.MJ_DT))):
            mujoco.mj_step(self.m, self.d)
        self.t += dt


def test_realtime_loop_matches_jax():
    """Both loops on identical MuJoCo plants (the port's feedback in both,
    so that only the controllers differ), 5 ticks, bench budget."""
    jm, tm = _configs()
    plants = MujocoPlant(), MujocoPlant()
    loop_j = JRealtimeLoop(jm, JGaitConfig(), JBipedParams())
    loop_t = RealtimeLoop(tm, tcfg.GaitConfig(), BipedParams(), device="cpu")
    for loop, plant in zip((loop_j, loop_t), plants):
        loop.warmup(plant)
        stats = loop.run(plant, n_ticks=5, realtime=False)
        assert stats.n_ticks == 5
    (x_j, q_j, qd_j), (x_t, q_t, qd_t) = (p.read_state() for p in plants)
    _assert_states_close(x_t, x_j, "realtime")
    assert np.abs(q_t - q_j).max() < 1e-3 and np.abs(qd_t - qd_j).max() < 2e-2


def test_realtime_loop_walks_mujoco_plant():
    """``tests/test_realtime.py``'s first case: 2 s of walking, the plant
    stays up, the tick accounting and latency statistics are coherent."""
    _, tm = _configs()
    plant = MujocoPlant()
    loop = RealtimeLoop(tm, tcfg.GaitConfig(), BipedParams(), device="cpu")
    loop.warmup(plant)
    stats = loop.run(plant, n_ticks=50, realtime=False)
    assert isinstance(stats, LoopStats) and stats.n_ticks == 50
    assert plant.d.qpos[2] > 0.4
    assert stats.latency_p50_ms > 0
    assert stats.latency_max_ms >= stats.latency_p99_ms >= stats.latency_p50_ms


def test_realtime_deadline_accounting():
    """``tests/test_realtime.py``'s second case: with deadlines, misses are
    counted and the schedule re-anchors."""
    import time

    _, tm = _configs()
    plant = MujocoPlant()
    loop = RealtimeLoop(tm, tcfg.GaitConfig(gait_mode=0), BipedParams(), device="cpu")
    loop.warmup(plant)
    n = 25
    t0 = time.monotonic()
    stats = loop.run(plant, n_ticks=n, realtime=True)
    wall = time.monotonic() - t0
    assert stats.n_ticks == n and wall >= n * tm.dt - tm.dt
    assert 0 <= stats.deadline_misses <= n
    assert stats.realtime_ok(tm.dt) == (
        stats.deadline_misses <= n * 0.01 and stats.latency_p99_ms * 1e-3 <= tm.dt)


# --- replay ----------------------------------------------------------------

def test_replay_export_roundtrip(tmp_path):
    """``tests/test_sim.py::test_replay_export_roundtrip`` at the bench
    physics: an exported rollout reloads in MuJoCo with the torso at
    walking height and a foot near the ground in every frame, and the
    terrain variant's height field comes back from the npz."""
    mpc = tra.art_mpc_config(**BENCH)
    kw = dict(device="cpu", n_substeps=5, minv_ll_hold=8)
    info = export_rollout(str(tmp_path / "flat"), mpc, tcfg.GaitConfig(), 25, **kw)
    assert info["falls"] == 0 and info["frames"] == 25
    assert abs(info["duration_s"] - 1.0) < 1e-5
    m = mujoco.MjModel.from_xml_path(str(tmp_path / "flat_model.xml"))
    d = mujoco.MjData(m)
    t = np.load(tmp_path / "flat_traj.npz")
    for q in t["qpos"][::8]:
        d.qpos[:] = q
        mujoco.mj_forward(m, d)
        assert 0.45 < d.qpos[2] < 0.65
        foot_z = [d.geom_xpos[mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, g)][2]
                  for g in ("l_foot_toe", "r_foot_toe")]
        assert min(foot_z) < 0.08

    _, terrain = _terrains(res=16)
    info2 = export_rollout(str(tmp_path / "rough"), mpc, tcfg.GaitConfig(), 5,
                           terrain=terrain, **kw)
    m2 = mujoco.MjModel.from_xml_path(str(tmp_path / "rough_model.xml"))
    t2 = np.load(tmp_path / "rough_traj.npz")
    restore_hfield(m2, t2)
    assert info2["falls"] == 0 and float(t2["terrain_extent"]) == terrain.extent
    assert m2.hfield_data.max() == 1.0 and m2.hfield_data.min() == 0.0
