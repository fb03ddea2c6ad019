"""The torch port's utilities against the JAX package: ``utils/logging.py``,
``utils/checkpoint.py``, ``runtime/native.py``, and the demo entry point
(``utils/profiling.py``: ``tests/test_torch_tracing.py``).

Tolerances:
- ``metrics_to_dict`` on metrics carried over from JAX: equal floats (the
  same f32 sums in numpy on both sides);
- checkpoints: a round trip and a resumed rollout bit-equal; a structure,
  leaf-count or shape mismatch raises ``ValueError``;
- the native QP solver against JAX's binding of the same source on random
  QPs: 1e-9 (the same C++ code; both at ``tol`` 1e-9), and the KKT
  residuals of ``tests/test_native_qp.py`` (1e-6);
- the demo on the CPU: exit code 0, and the tick's torques under
  ``--compat`` within the golden tick's 0.02 N m
  (``tests/golden/tick_t0_walking.npz``) plus the 0.005 of the printout's
  two decimals.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.runtime import native as jax_native
from biped_mpc_py_tpu.utils.logging import metrics_to_dict as jax_metrics_to_dict
from biped_mpc_py_tpu.utils.metrics import RolloutMetrics as JRolloutMetrics
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.runtime import native
from biped_mpc_py_torch.utils import checkpoint
from biped_mpc_py_torch.utils.convert import from_numpy
from biped_mpc_py_torch.utils.logging import log_event, metrics_to_dict
from biped_mpc_py_torch.utils.metrics import RolloutMetrics
from tests.oracle_qp import kkt_residuals
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "tick_t0_walking.npz")


def test_metrics_to_dict_matches_jax():
    """``tests/test_utils.py``'s accumulation, on 3 envs carried over."""
    rng = np.random.default_rng(0)
    fields = {f.name: rng.normal(size=3).astype(np.float32)
              for f in dataclasses.fields(RolloutMetrics)}
    fields["n_steps"] = np.full(3, 2.0, np.float32)
    jm = JRolloutMetrics(**{k: jnp.asarray(v) for k, v in fields.items()})
    tm = from_numpy(RolloutMetrics, fields)
    assert metrics_to_dict(tm) == jax_metrics_to_dict(jm)
    m = RolloutMetrics.zeros(1, device="cpu")
    x = torch.zeros(1, 12)
    x[0, 5] = 0.50
    u0 = torch.zeros(1, 12)
    u0[0, 2], u0[0, 5] = 60.0, 58.0
    cmd = tra.art_mpc_config().x_cmd
    m = m.update(x, cmd, u0, torch.tensor([0.01]), torch.tensor([0.0]))
    m = m.update(x, cmd, u0, torch.tensor([0.5]), torch.tensor([1.0]))
    d = metrics_to_dict(m)
    assert d["n_steps"] == 2 and d["falls"] == 1
    assert abs(d["height_err_sq"] - 2 * 0.05**2) < 1e-6
    assert abs(d["res_prim_max"] - 0.5) < 1e-6
    assert metrics_to_dict({"b": torch.ones(2), "a": [np.ones(3)]}) == {"leaf_0": 3.0,
                                                                         "leaf_1": 2.0}


def test_log_event_emits_json(capsys):
    log_event("bench", stream=sys.stdout, value=1.5, tag="x")
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["event"] == "bench" and rec["value"] == 1.5 and rec["tag"] == "x"


def _world(n=2):
    mpc, gait = tra.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                         admm_polish=False, kinv_ns_iters=10)
    return mpc, gait, tra.init_art_world(mpc, n, device="cpu")


def test_checkpoint_round_trip_and_bit_exact_resume(tmp_path):
    mpc, gait, w = _world()
    bipeds = BipedParams().expand(2)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    w1 = tra.batched_art_rollout(w, bipeds, 1, mpc, gait, **kw)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_pytree(path, w1)
    back = checkpoint.load_pytree(path, w)
    for a, b in zip(_leaves(back), _leaves(w1)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    straight = tra.batched_art_rollout(w1, bipeds, 1, mpc, gait, **kw)
    resumed = tra.batched_art_rollout(back, bipeds, 1, mpc, gait, **kw)
    for a, b in zip(_leaves(resumed), _leaves(straight)):
        assert torch.equal(a, b)
    # floats and None fields ride along (a model's scalar parameters)
    model = tra.hector_model(device="cpu")
    checkpoint.save_pytree(str(tmp_path / "model.npz"), model)
    assert checkpoint.load_pytree(str(tmp_path / "model.npz"), model).contact_mu == \
        model.contact_mu


def _leaves(obj):
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out += _leaves(v) if dataclasses.is_dataclass(v) else [v] if torch.is_tensor(v) else []
    return out


def test_checkpoint_rejects_mismatch(tmp_path):
    mpc, gait, w = _world()
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_pytree(path, w)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_pytree(path, w.sim)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_pytree(path, tra.init_art_world(mpc, 3, device="cpu"))
    arrays = dict(np.load(path))
    del arrays["sim.t"]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(path, w)


def test_native_qp_matches_jax_binding(rng, tmp_path, monkeypatch):
    # the JAX binding builds its own library from the same source; here into
    # a private path, so that no other test process races on its default one
    monkeypatch.setattr(jax_native, "_LIB", str(tmp_path / "libqp_ipm.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    for _ in range(3):
        n, m, p = 30, 40, 5
        M = rng.normal(size=(n, n))
        P = M @ M.T + np.eye(n)
        q = rng.normal(size=n)
        G = rng.normal(size=(m, n))
        h = rng.normal(size=m) + 1.0
        A = rng.normal(size=(p, n))
        b = rng.normal(size=p)
        x_t, info_t = native.solve_qp_native(P, q, G, h, A, b)
        x_j, info_j = jax_native.solve_qp_native(P, q, G, h, A, b)
        assert info_t["status"] == info_j["status"] == "optimal"
        np.testing.assert_allclose(x_t, x_j, atol=1e-9)
        res = kkt_residuals(x_t, P, q, G, h, A, b, z=info_t["z"], y=info_t["y"])
        assert max(res.values()) < 1e-6, res
    x, info = native.solve_qp_native(P, q)
    np.testing.assert_allclose(x, np.linalg.solve(P, -q), atol=1e-8)
    assert native.LIBRARY.parent.name == "native" and native.LIBRARY.exists()
    with pytest.raises(ValueError, match="h has"):
        native.solve_qp_native(P, q, G, h[:-1])


def test_demo_module_runs_on_cpu():
    """``python -m biped_mpc_py_torch.demo --device cpu``: the one-tick demo
    and a 5-tick rollout; under ``--compat`` the printed torques are the
    golden tick's."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": REPO,
           "HOME": os.environ.get("HOME", REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "biped_mpc_py_torch.demo", "--device", "cpu", "--compat",
         "--rollout-steps", "5"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "closed-loop rollout (5 ticks" in out.stdout
    block = out.stdout.split("Torques:")[1].split("closed-loop")[0]
    tau = np.array([float(v) for v in re.findall(r"-?\d+\.\d*", block)])
    np.testing.assert_allclose(tau, np.load(GOLDEN)["tau"], atol=0.02 + 0.005)
