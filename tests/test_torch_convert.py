"""Carrying objects across: JAX -> numpy field dict -> torch port -> numpy
is exact for every object the slice carries, field names match one to one
(a missing or extra field raises), and every config and robot default of
the port equals the JAX one, by name."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.models import biped as jbiped
from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_tpu.parallel import rollout as jroll
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_tpu.sim import engine as jeng
from biped_mpc_py_tpu.sim import model as jmodel
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.models import biped as tbiped
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.sim import engine as teng
from biped_mpc_py_torch.sim import model as tmodel
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from torch_threads import one_torch_thread  # noqa: F401


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _assert_same(a, b, path="obj"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if a.ndim:  # arrays keep their dtype; 0-d config scalars may widen
            assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _batch(tree, n):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), tree)


def _randomized_leaves(tree, seed=0):
    """Fill every leaf with random values of its own dtype and shape."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(rng.integers(0, 5, size=x.shape).astype(x.dtype))
        return jnp.asarray(rng.normal(size=x.shape).astype(x.dtype))

    return jax.tree.map(fill, tree)


def _jax_objects():
    jm = jcfg.MpcConfig()
    return {
        "MpcConfig/default": (tcfg.MpcConfig, jm),
        "MpcConfig/fast": (tcfg.MpcConfig, jcfg.fast_mpc_config()),
        "MpcConfig/compat": (tcfg.MpcConfig, jcfg.reference_compat_config()),
        "MpcConfig/cone": (
            tcfg.MpcConfig,
            jcfg.default_mpc_config(
                mu_z=0.035, tau_z_max=4.0,
                x_cmd=jnp.asarray([0, 0, 0.1, 0, 0, 0.5, 0, 0, 0.3, 0.2, 0.1, 0], jnp.float32),
            ),
        ),
        "GaitConfig/default": (tcfg.GaitConfig, jcfg.GaitConfig()),
        "GaitConfig/running": (
            tcfg.GaitConfig,
            jcfg.GaitConfig(steps_per_phase=3, flight_steps=1, contact_clock=True),
        ),
        "BipedParams/batched": (tbiped.BipedParams, _batch(jbiped.BipedParams(), 4)),
        "BipedParams/randomized": (
            tbiped.BipedParams, jroll.randomize_params(jax.random.PRNGKey(0), 4),
        ),
        "BipedParams/leg_jac": (
            tbiped.BipedParams,
            _batch(jbiped.BipedParams(leg_jac=jbiped.HECTOR_LEG_JAC), 3),
        ),
        "World": (troll.World, _randomized_leaves(jroll.batch_worlds(jm, 4))),
        "World/cone": (
            troll.World,
            _randomized_leaves(jroll.batch_worlds(jcfg.MpcConfig(mu_z=0.03), 2), 1),
        ),
        "ArticulatedModel": (tmodel.ArticulatedModel, jmodel.hector_model()),
        "ArticulatedModel/randomized": (
            tmodel.ArticulatedModel, _randomized_leaves(jmodel.hector_model(), 3),
        ),
        "ArtState": (teng.ArtState, _randomized_leaves(_batch(jeng.ArtState.standing(), 3), 4)),
        "ArtWorld": (
            tra.ArtWorld,
            _randomized_leaves(_batch(jra.init_art_world(jra.art_mpc_config()), 2), 5),
        ),
        "MpcConfig/art": (tcfg.MpcConfig, jra.art_mpc_config()),
        "MpcConfig/art_speed": (tcfg.MpcConfig, jra.art_config_for_speed(0.95)[0]),
        "MpcConfig/art_run": (tcfg.MpcConfig, jra.art_config_for_run(1.2, stabilized=True)[0]),
        "MpcConfig/art_turn": (tcfg.MpcConfig, jra.art_config_for_turn(0.3, vx=0.4)[0]),
        "GaitConfig/art_run": (tcfg.GaitConfig, jra.art_config_for_run(1.2)[1]),
        "CondensedQp": (
            tqp.CondensedQp,
            _randomized_leaves(jqp.CondensedQp(
                P=jnp.zeros((2, 120, 120)), q=jnp.zeros((2, 120)),
                A_step=jnp.zeros((2, 24, 12)), l=jnp.zeros((2, 10, 24)),
                u=jnp.zeros((2, 10, 24)), Sx=jnp.zeros((2, 10, 13, 13)),
                Su=jnp.zeros((2, 10, 13, 120)), x0=jnp.zeros((2, 13)),
            ), 2),
        ),
    }


OBJECTS = sorted(_jax_objects())


@pytest.mark.parametrize("name", OBJECTS)
def test_round_trip_exact(name):
    cls, obj = _jax_objects()[name]
    fields = _fields(obj)
    port = from_numpy(cls, fields)
    assert type(port) is cls
    _assert_same(fields, to_numpy(port))


def test_field_drift_raises():
    fields = _fields(_batch(jbiped.BipedParams(), 2))
    with pytest.raises(ValueError, match="missing"):
        from_numpy(tbiped.BipedParams, {k: v for k, v in fields.items() if k != "mu"})
    with pytest.raises(ValueError, match="extra"):
        from_numpy(tbiped.BipedParams, {**fields, "stiffness": np.zeros(2)})
    world = _fields(jroll.batch_worlds(jcfg.MpcConfig(), 2))
    del world["ctrl"]["qp"]["res_dual"]
    with pytest.raises(ValueError, match="res_dual"):
        from_numpy(troll.World, world)


def _defaults(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _defaults(v)
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v, np.float32).reshape(-1)
    return out


def _assert_defaults_equal(port_obj, jax_obj, path):
    p, j = _defaults(port_obj), _defaults(jax_obj)
    assert p.keys() == j.keys(), (path, sorted(set(p) ^ set(j)))
    for k in j:
        if isinstance(j[k], dict):
            _assert_defaults_equal(getattr(port_obj, k), getattr(jax_obj, k), f"{path}.{k}")
        elif isinstance(j[k], np.ndarray) or isinstance(p[k], np.ndarray):
            # a per-env tensor of the port against a JAX scalar or vector
            np.testing.assert_array_equal(
                np.asarray(p[k], np.float32).reshape(-1),
                np.asarray(j[k], np.float32).reshape(-1), err_msg=f"{path}.{k}",
            )
        else:
            assert p[k] == j[k] and type(p[k]) is type(j[k]), (f"{path}.{k}", p[k], j[k])


_ART_FACTORIES = {
    "art_mpc_config": ((), {}),
    "art_config_for_speed/0.3": ((0.3,), {}),
    "art_config_for_speed/0.95": ((0.95,), {}),
    "art_config_for_run/stabilized": ((1.2,), {"stabilized": True}),
    "art_config_for_turn/in_place": ((0.3,), {}),
    "art_config_for_turn/curve": ((0.3,), {"vx": 0.4}),
    "art_config_for_turn/slow_curve": ((0.5,), {"vx": 0.2, "kp_pivot": 2.0}),
}


@pytest.mark.parametrize("name", sorted(_ART_FACTORIES))
def test_art_factories_match_jax(name):
    """The articulated config factories of the port give the JAX package's
    (MpcConfig, GaitConfig), field by field."""
    fn = name.split("/")[0]
    args, kw = _ART_FACTORIES[name]
    port, ref = getattr(tra, fn)(*args, **kw), getattr(jra, fn)(*args, **kw)
    if fn == "art_mpc_config":
        port, ref = (port,), (ref,)
    for p, j in zip(port, ref):
        _assert_same(_fields(j), to_numpy(p), name)


@pytest.mark.parametrize("name", [
    "MpcConfig", "fast_mpc_config", "reference_compat_config", "GaitConfig",
    "BipedParams", "HECTOR_LEG_FK", "HECTOR_LEG_JAC", "ArticulatedModel",
])
def test_defaults_match_jax_by_name(name):
    """Every field default, by name; per-env tensors hold one env, which
    must equal the JAX scalar or vector."""
    pairs = {
        "MpcConfig": (tcfg.MpcConfig(), jcfg.MpcConfig()),
        "fast_mpc_config": (tcfg.fast_mpc_config(), jcfg.fast_mpc_config()),
        "reference_compat_config": (
            tcfg.reference_compat_config(), jcfg.reference_compat_config()
        ),
        "GaitConfig": (tcfg.GaitConfig(), jcfg.GaitConfig()),
        "BipedParams": (tbiped.BipedParams(), jbiped.BipedParams()),
        "HECTOR_LEG_FK": (tbiped.HECTOR_LEG_FK, jbiped.HECTOR_LEG_FK),
        "HECTOR_LEG_JAC": (tbiped.HECTOR_LEG_JAC, jbiped.HECTOR_LEG_JAC),
        "ArticulatedModel": (tmodel.hector_model(device="cpu"), jmodel.hector_model()),
    }
    port_obj, jax_obj = pairs[name]
    _assert_defaults_equal(port_obj, jax_obj, name)
