"""Torch port vs JAX package: rotations, 3x3 linear algebra and the SRB
horizon linearization, on random batches made with numpy from a fixed seed.

Tolerance: atol 1e-5 throughout — both sides compute the same closed forms
in f32, so they differ by f32 roundoff (transcendental implementations and
summation order), which stays below 1e-5 on O(1) values.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.config import MpcConfig as JMpcConfig
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.models import srb as jsrb
from biped_mpc_py_tpu.ops import linalg3 as jl3
from biped_mpc_py_tpu.ops import rotations as jrot
from biped_mpc_py_tpu.parallel.rollout import randomize_params as j_randomize
from biped_mpc_py_torch.config import MpcConfig
from biped_mpc_py_torch.models import srb as tsrb
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops import linalg3 as tl3
from biped_mpc_py_torch.ops import rotations as trot
from biped_mpc_py_torch.utils.convert import from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _rand(shape, scale=1.0, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _unit_quats(n, seed=0):
    q = _rand((n, 4), seed=seed)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _spd3(n, seed=0):
    a = _rand((n, 3, 3), seed=seed)
    return a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)


def _compare(jfn, tfn, *args):
    j = jfn(*[jnp.asarray(a) for a in args])
    t = tfn(*[torch.from_numpy(a) for a in args])
    if not isinstance(j, tuple):
        j, t = (j,), (t,)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


CASES = {
    "eul2rotm": (jrot.eul2rotm, trot.eul2rotm, lambda: (_rand((64, 3)),)),
    "eul2rotm_horizon": (jrot.eul2rotm, trot.eul2rotm, lambda: (_rand((8, 10, 3)),)),
    "skew": (jrot.skew, trot.skew, lambda: (_rand((64, 3)),)),
    "euler_rate_matrix_inv": (
        jrot.euler_rate_matrix_inv, trot.euler_rate_matrix_inv,
        lambda: (_rand((64,), 0.5), _rand((64,), 2.0, seed=1)),
    ),
    "quat_to_rotm": (jrot.quat_to_rotm, trot.quat_to_rotm, lambda: (_unit_quats(64),)),
    "quat_mul": (
        jrot.quat_mul, trot.quat_mul, lambda: (_unit_quats(64), _unit_quats(64, 1)),
    ),
    "quat_integrate": (
        lambda q, w: jrot.quat_integrate(q, w, 0.01),
        lambda q, w: trot.quat_integrate(q, w, 0.01),
        lambda: (_unit_quats(64), _rand((64, 3), 3.0, seed=2)),
    ),
    "rotm_to_eul": (
        jrot.rotm_to_eul, trot.rotm_to_eul,
        lambda: (np.array(jrot.eul2rotm(jnp.asarray(_rand((64, 3), 0.7)))),),
    ),
    "quat_to_eul": (jrot.quat_to_eul, trot.quat_to_eul, lambda: (_unit_quats(64),)),
    "eul_to_quat": (jrot.eul_to_quat, trot.eul_to_quat, lambda: (_rand((64, 3)),)),
    "mm3": (jl3.mm3, tl3.mm3, lambda: (_rand((64, 3, 3)), _rand((64, 3, 3), seed=1))),
    "mv3": (jl3.mv3, tl3.mv3, lambda: (_rand((64, 3, 3)), _rand((64, 3), seed=1))),
    "mtv3": (jl3.mtv3, tl3.mtv3, lambda: (_rand((64, 3, 3)), _rand((64, 3), seed=1))),
    "mtm3": (jl3.mtm3, tl3.mtm3, lambda: (_rand((64, 3, 3)), _rand((64, 3, 3), seed=1))),
    "inv3": (jl3.inv3, tl3.inv3, lambda: (_spd3(64),)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax(name):
    jfn, tfn, make = CASES[name]
    _compare(jfn, tfn, *make())


def _batched(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("randomized", [False, True])
def test_linearize_horizon_matches_jax(randomized):
    """A (N,h,13,13), B (N,h,13,12) for perturbed references, with one
    robot per env (domain-randomized mass and inertia when asked)."""
    n, h = 8, 10
    mpc_j = JMpcConfig()
    if randomized:
        jb = j_randomize(jax.random.PRNGKey(3), n)
    else:
        jb = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), JBipedParams()
        )
    x_ref = _rand((n, 13, h), 0.2)
    x_ref[:, 5] += 0.55
    x_ref[:, 12] = 1.0
    foot_ref = _rand((n, 6, h), 0.1, seed=1)
    A_j, B_j = jax.vmap(
        lambda b, x, f: jsrb.linearize_horizon(mpc_j, b, x, f)
    )(jb, jnp.asarray(x_ref), jnp.asarray(foot_ref))
    biped = from_numpy(BipedParams, _batched(jb))
    A_t, B_t = tsrb.linearize_horizon(
        MpcConfig(), biped, torch.from_numpy(x_ref), torch.from_numpy(foot_ref)
    )
    assert A_t.shape == (n, h, 13, 13) and B_t.shape == (n, h, 13, 12)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), atol=ATOL, rtol=0)
