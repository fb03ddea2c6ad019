"""The multi-device layer (``parallel/sharding.py``, the DCP checkpoint
pair) against the JAX package's ``sharded_rollout_fn`` /
``sharded_art_rollout_fn`` on a 2-device sub-mesh of the conftest's
8-device CPU mesh, and against the port's own unsharded loops.

The port's ranks are real processes: two ``gloo`` ranks on the CPU
(``spawn_env_group``), or one rank in this process through a ``file://``
group. The file starts two process groups, both at once from the module's
fixture (about 55 s alone; one after the other they took ~80): the dry run,
and :func:`_ranks` beside the JAX references computed here meanwhile.

Tolerances:
- SRB, 8 envs x 20 ticks at ``MpcConfig()`` from perturbed standing states:
  x_fb atol 2e-3 (``tests/test_torch_rollout.py``'s port-vs-JAX bound over
  20 ticks); the all-reduced ``n_steps`` and ``falls`` equal,
  ``height_rmse_sum`` rtol 1e-2, ``res_prim_max`` atol 1e-6 (both
  packages' converged solves leave primal residuals near 1e-9; a solve
  that did not converge leaves 1e-3 or more);
- articulated, 4 envs x 2 ticks at the bench budget, 5 substeps, Minv held
  all tick: ``CHAIN_BOUNDS`` of ``tests/test_torch_rollout_art.py``, the
  summary as above;
- the compiled forms (``sharded_rollout_fn``, ``sharded_art_rollout_fn``)
  on the same ranks: the same bounds against JAX, bit-equal to the eager
  sharded loops;
- the port against itself: one rank is the unsharded program, bit-equal;
  two ranks run it on 4 rows each, held at 1.5e-3 on x_fb (the JAX
  package's sharded-against-vmap bound, ``tests/test_rollout.py:273-281``)
  with the summary equal; checkpoints resume bit-equal.

JAX is imported inside the functions that use it: the spawned ranks import
this module to find :func:`_ranks`, and never import JAX.
"""

import dataclasses
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.parallel import sharding
from biped_mpc_py_torch.utils import checkpoint as ckpt
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from biped_mpc_py_torch.utils.struct import TensorStruct
from torch_threads import one_torch_thread  # noqa: F401

TICKS = 20
ART_TICKS = 2
ART_KW = dict(n_substeps=5, minv_ll_hold=8)
CHAIN_BOUNDS = {"pos": 1e-4, "quat": 1e-4, "v_base": 2e-3, "q": 1e-3, "qd": 2e-2}
SPAWN_TIMEOUT = 600.0


def _fields(tree):
    import jax

    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _inputs():
    """The JAX and port objects of both loops, from numpy seed 0: 8 SRB
    worlds with x_fb perturbed by 0.01, nominal robots, ``MpcConfig()``; 4
    articulated worlds with qd desynced by 0.01 rad/s at the bench budget."""
    import jax
    import jax.numpy as jnp

    from biped_mpc_py_tpu import config as jcfg
    from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
    from biped_mpc_py_tpu.parallel import rollout as jroll
    from biped_mpc_py_tpu.parallel import rollout_art as jra

    rng = np.random.default_rng(0)
    jm = dataclasses.replace(jcfg.MpcConfig(), kinv_bf16_iters=0, admm_bf16_matvec=False,
                             ruiz_bf16_norms=False)
    jw = jroll.batch_worlds(jm, 8)
    x0 = np.asarray(jw.sim.x_fb) + (0.01 * rng.normal(size=(8, 12))).astype(np.float32)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, x_fb=jnp.asarray(x0)))
    jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + jnp.shape(x)), JBipedParams())

    jam, jag = jra.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                        admm_polish=False, kinv_ns_iters=10)
    jam = dataclasses.replace(jam, kinv_bf16_iters=0, admm_bf16_matvec=False,
                              ruiz_bf16_norms=False)
    jaw = jax.vmap(lambda _: jra.init_art_world(jam))(jnp.arange(4))
    qd = jaw.sim.qd + jnp.asarray(0.01 * rng.normal(size=(4, 10)), jnp.float32)
    jaw = dataclasses.replace(jaw, sim=dataclasses.replace(jaw.sim, qd=qd))
    jab = jax.vmap(lambda _: JBipedParams())(jnp.arange(4))

    srb = (from_numpy(troll.World, _fields(jw)), from_numpy(BipedParams, _fields(jb)),
           from_numpy(tcfg.MpcConfig, _fields(jm)), tcfg.GaitConfig())
    art = (from_numpy(tra.ArtWorld, _fields(jaw)), from_numpy(BipedParams, _fields(jab)),
           from_numpy(tcfg.MpcConfig, _fields(jam)), from_numpy(tcfg.GaitConfig, _fields(jag)))
    return (jw, jb, jm), (jaw, jab, jam, jag), srb, art


def _jax_references(jax_srb, jax_art):
    """JAX's sharded programs on the first two devices of the CPU mesh."""
    import jax

    from biped_mpc_py_tpu import config as jcfg
    from biped_mpc_py_tpu.parallel import sharding as jsh
    from biped_mpc_py_tpu.utils.precision import f32_precision

    mesh = jsh.env_mesh(jax.devices()[:2])
    jw, jb, jm = jax_srb
    f = jax.jit(f32_precision(jsh.sharded_rollout_fn(TICKS, jm, jcfg.GaitConfig(), mesh)))
    w, s = f(jsh.shard_world(jw, mesh), jsh.shard_world(jb, mesh))
    jaw, jab, jam, jag = jax_art
    fa = jax.jit(f32_precision(jsh.sharded_art_rollout_fn(ART_TICKS, jam, jag, mesh, **ART_KW)))
    aw, as_ = fa(jsh.shard_world(jaw, mesh), jsh.shard_world(jab, mesh))
    summary = lambda d: {k: float(v) for k, v in d.items()}  # noqa: E731
    return _fields(w), summary(s), _fields(aw), summary(as_)


def _ranks(mesh, srb, art, ckpt_dir):
    """Each rank's program: the SRB loop straight through; the same loop
    saved at half way (DCP and npz), reloaded into this mesh and resumed; a
    batch that does not split; and the articulated loop."""
    worlds, bipeds, mpc, gait = srb
    ws, bs = sharding.shard_world(worlds, mesh), sharding.shard_world(bipeds, mesh)
    straight, summary = sharding.sharded_rollout(ws, bs, TICKS, mpc, gait, mesh)
    mid, _ = sharding.sharded_rollout(ws, bs, TICKS // 2, mpc, gait, mesh)
    dcp_dir, npz = os.path.join(ckpt_dir, "dcp"), os.path.join(ckpt_dir, "mid.npz")
    ckpt.save_pytree_dcp(dcp_dir, mid)
    ckpt.save_pytree(npz, mid)
    loaded = ckpt.load_pytree_dcp(dcp_dir, ws)
    from_dcp, _ = sharding.sharded_rollout(loaded, bs, TICKS // 2, mpc, gait, mesh)
    back = sharding.shard_world(ckpt.load_pytree(npz, worlds), mesh)
    from_npz, _ = sharding.sharded_rollout(back, bs, TICKS // 2, mpc, gait, mesh)
    try:
        sharding.shard_world(troll.batch_worlds(mpc, 5, device="cpu"), mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    aw, ab, am, ag = art
    aws, abs_ = sharding.shard_world(aw, mesh), sharding.shard_world(ab, mesh)
    art_out, art_summary = sharding.sharded_art_rollout(aws, abs_, ART_TICKS, am, ag, mesh,
                                                        **ART_KW)
    straight_fn, summary_fn = sharding.sharded_rollout_fn(TICKS, mpc, gait, mesh)(ws, bs)
    art_fn, art_summary_fn = sharding.sharded_art_rollout_fn(ART_TICKS, am, ag, mesh,
                                                             **ART_KW)(aws, abs_)
    return dict(straight=straight, summary=summary, mid=mid, loaded=loaded,
                from_dcp=from_dcp, from_npz=from_npz, refused=refused, art=art_out,
                art_summary=art_summary, straight_fn=straight_fn, summary_fn=summary_fn,
                art_fn=art_fn, art_summary_fn=art_summary_fn)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The dry run and :func:`_ranks` on two gloo ranks each, started at once,
    with the JAX references computed here meanwhile."""
    ckpt_dir = str(tmp_path_factory.mktemp("sharded_ckpt"))
    with ThreadPoolExecutor(2) as pool:
        dryrun = pool.submit(sharding.dryrun_multichip, 2, device="cpu", timeout=SPAWN_TIMEOUT)
        jax_srb, jax_art, srb, art = _inputs()
        ranks = pool.submit(sharding.spawn_env_group, 2, _ranks, srb, art, ckpt_dir,
                            device="cpu", timeout=SPAWN_TIMEOUT)
        ref = _jax_references(jax_srb, jax_art)
        yield types.SimpleNamespace(dryrun=dryrun, ranks=ranks, ref=ref, srb=srb,
                                    ckpt_dir=ckpt_dir)


def _ranks_result(spawned):
    return spawned.ranks.result(timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def whole(spawned):
    """``batched_rollout`` of all 8 SRB worlds in this process."""
    worlds, bipeds, mpc, gait = spawned.srb
    return troll.batched_rollout(worlds, bipeds, TICKS, mpc, gait)


def _cat(trees):
    if isinstance(trees[0], dict):
        return {k: _cat([t[k] for t in trees]) for k in trees[0]}
    return None if trees[0] is None else np.concatenate(trees)


def _rows(results, key):
    """The ranks' rows of ``key``, in rank order, as one field dict."""
    return _cat([to_numpy(r[key]) for r in results])


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _local(struct):
    return to_numpy(struct.map(lambda t: t.to_local()))


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process and its CPU mesh."""
    with sharding.env_group(str(tmp_path / "store"), "gloo"):
        yield sharding.env_mesh("cpu")


def _assert_srb_matches_jax(spawned, world_key, summary_key):
    results = _ranks_result(spawned)
    j_world, j_summary, _, _ = spawned.ref
    t = _rows(results, world_key)
    np.testing.assert_allclose(t["sim"]["x_fb"], j_world["sim"]["x_fb"], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(t["sim"]["t"], j_world["sim"]["t"])
    s = {k: float(v) for k, v in results[0][summary_key].items()}
    assert s == {k: float(v) for k, v in results[1][summary_key].items()}  # all-reduced
    assert s["n_steps"] == j_summary["n_steps"] == TICKS * 8
    assert s["falls"] == j_summary["falls"]
    np.testing.assert_allclose(s["height_rmse_sum"], j_summary["height_rmse_sum"], rtol=1e-2)
    np.testing.assert_allclose(s["res_prim_max"], j_summary["res_prim_max"], atol=1e-6, rtol=0)


def _assert_art_matches_jax(spawned, world_key, summary_key):
    results = _ranks_result(spawned)
    _, _, j_world, j_summary = spawned.ref
    t = _rows(results, world_key)
    for key, tol in CHAIN_BOUNDS.items():
        diff = float(np.abs(t["sim"][key] - j_world["sim"][key]).max())
        assert diff < tol, (key, diff)
    np.testing.assert_array_equal(t["metrics"]["falls"], j_world["metrics"]["falls"])
    s = {k: float(v) for k, v in results[0][summary_key].items()}
    assert sorted(s) == ["falls", "height_rmse_sum", "n_steps"]
    assert s["n_steps"] == j_summary["n_steps"] == ART_TICKS * 4
    assert s["falls"] == j_summary["falls"]
    np.testing.assert_allclose(s["height_rmse_sum"], j_summary["height_rmse_sum"], rtol=1e-2)


def test_srb_matches_jax(spawned):
    _assert_srb_matches_jax(spawned, "straight", "summary")


def test_art_matches_jax(spawned):
    _assert_art_matches_jax(spawned, "art", "art_summary")


@pytest.mark.parametrize("loop", ["srb", "art"])
def test_sharded_fn_matches_jax_and_the_eager_loop(spawned, loop):
    """The compiled forms, ``sharded_rollout_fn`` and
    ``sharded_art_rollout_fn`` (one graph per rank over its rows; on the CPU
    the graph's buffers step eagerly), on the same two ranks: against JAX's
    ``sharded_*_fn`` at the eager loops' bounds, and every row and the
    all-reduced summary bit-equal to the eager sharded loop's."""
    world, summary = ("straight", "summary") if loop == "srb" else ("art", "art_summary")
    check = _assert_srb_matches_jax if loop == "srb" else _assert_art_matches_jax
    check(spawned, world + "_fn", summary + "_fn")
    results = _ranks_result(spawned)
    _assert_equal(_rows(results, world + "_fn"), _rows(results, world))
    for r in results:
        assert {k: float(v) for k, v in r[summary + "_fn"].items()} == {
            k: float(v) for k, v in r[summary].items()}


def test_two_ranks_match_batched_rollout(spawned, whole):
    """Two ranks of 4 rows against ``batched_rollout`` of all 8 in one
    process; prints whether they are bit-equal."""
    results = _ranks_result(spawned)
    whole = to_numpy(whole)
    t = _rows(results, "straight")
    diff = float(np.abs(t["sim"]["x_fb"] - whole["sim"]["x_fb"]).max())
    equal = all(np.array_equal(t[k][f], whole[k][f]) for k in ("sim", "metrics") for f in t[k])
    print(f"two ranks vs batched_rollout: max |dx_fb| {diff:.3e}, bit-equal {equal}")
    assert diff <= 1.5e-3
    np.testing.assert_array_equal(t["metrics"]["falls"], whole["metrics"]["falls"])
    np.testing.assert_array_equal(t["metrics"]["n_steps"], whole["metrics"]["n_steps"])


@pytest.mark.parametrize("key", ["from_dcp", "from_npz"])
def test_checkpoint_resume_on_two_ranks_bit_equal(spawned, key):
    """Saved by both ranks at tick 10 (DCP: each its shards; npz: gathered
    whole), reloaded into the same mesh and resumed: bit-equal at tick 20 to
    the run straight through."""
    results = _ranks_result(spawned)
    _assert_equal(_rows(results, key), _rows(results, "straight"))
    _assert_equal(_rows(results, "loaded"), _rows(results, "mid"))


def test_dcp_two_ranks_to_one_reshards_bit_equal(spawned, one_rank):
    """The two ranks' DCP checkpoint loaded into a one-rank mesh (a
    reshard), then resumed: bit-equal to one rank resumed from the same
    world in memory."""
    results = _ranks_result(spawned)
    worlds, bipeds, mpc, gait = spawned.srb
    like = sharding.shard_world(worlds, one_rank)
    loaded = ckpt.load_pytree_dcp(os.path.join(spawned.ckpt_dir, "dcp"), like)
    mid = _rows(results, "mid")
    _assert_equal(_local(loaded), mid)
    bs = sharding.shard_world(bipeds, one_rank)
    resumed, s_resumed = sharding.sharded_rollout(loaded, bs, TICKS // 2, mpc, gait, one_rank)
    in_memory = sharding.shard_world(from_numpy(troll.World, mid), one_rank)
    straight, s_straight = sharding.sharded_rollout(in_memory, bs, TICKS // 2, mpc, gait,
                                                    one_rank)
    _assert_equal(_local(resumed), _local(straight))
    assert {k: float(v) for k, v in s_resumed.items()} == {
        k: float(v) for k, v in s_straight.items()}


def test_one_rank_is_the_unsharded_program(spawned, whole, one_rank):
    worlds, bipeds, mpc, gait = spawned.srb
    out, summary = sharding.sharded_rollout(
        sharding.shard_world(worlds, one_rank), sharding.shard_world(bipeds, one_rank),
        TICKS, mpc, gait, one_rank)
    _assert_equal(_local(out), to_numpy(whole))
    m = whole.metrics
    assert float(summary["n_steps"]) == float(m.n_steps.sum())
    assert float(summary["height_rmse_sum"]) == float(m.height_err_sq.sum())
    assert float(summary["falls"]) == float(m.falls.sum())
    assert float(summary["res_prim_max"]) == float(m.res_prim_max.max())
    assert summary["n_steps"].dim() == 0 and summary["n_steps"].device.type == "cpu"


@dataclasses.dataclass(frozen=True)
class _Leaves(TensorStruct):
    """Every kind of leaf a checkpoint keeps: a 0-d metric, an int32 count,
    a Python float and int, and a None field."""

    total: torch.Tensor
    counts: torch.Tensor
    gain: float
    steps: int
    unused: torch.Tensor | None = None


def test_dcp_without_process_group(tmp_path, spawned):
    """Plain tensors in one process (``test_checkpoint_resume_orbax``): a
    world resumes bit-equal, and every kind of leaf round-trips."""
    worlds, bipeds, mpc, gait = spawned.srb
    mid = troll.batched_rollout(worlds, bipeds, 5, mpc, gait)
    ckpt.save_pytree_dcp(str(tmp_path / "world"), mid)
    loaded = ckpt.load_pytree_dcp(str(tmp_path / "world"), worlds)
    _assert_equal(to_numpy(loaded), to_numpy(mid))
    _assert_equal(to_numpy(troll.batched_rollout(loaded, bipeds, 5, mpc, gait)),
                  to_numpy(troll.batched_rollout(mid, bipeds, 5, mpc, gait)))
    leaves = _Leaves(total=torch.tensor(2.5), counts=torch.tensor([3, 1], dtype=torch.int32),
                     gain=0.1, steps=7)
    ckpt.save_pytree_dcp(str(tmp_path / "leaves"), leaves)
    like = _Leaves(total=torch.tensor(0.0), counts=torch.zeros(2, dtype=torch.int32),
                   gain=0.0, steps=0)
    back = ckpt.load_pytree_dcp(str(tmp_path / "leaves"), like)
    assert back.total.dim() == 0 and float(back.total) == 2.5
    assert back.counts.dtype == torch.int32 and back.counts.tolist() == [3, 1]
    assert (back.gain, back.steps, back.unused) == (0.1, 7, None)
    assert type(back.steps) is int and float(like.total) == 0.0  # like untouched


@pytest.mark.parametrize("fault", ["structure", "shape", "no_record"])
def test_dcp_rejects_a_mismatch(tmp_path, spawned, fault):
    worlds, _, mpc, _ = spawned.srb
    path = str(tmp_path / "ckpt")
    if fault == "no_record":
        import torch.distributed.checkpoint as dcp

        dcp.save({"sim.x_fb": worlds.sim.x_fb}, checkpoint_id=path, no_dist=True)
    else:
        ckpt.save_pytree_dcp(path, worlds)
    like = {"structure": tra.init_art_world(mpc, 8, device="cpu"),
            "shape": troll.batch_worlds(mpc, 4, device="cpu"),
            "no_record": worlds}[fault]
    with pytest.raises(ValueError, match={"structure": "structure mismatch",
                                          "shape": "shape", "no_record": "holds no"}[fault]):
        ckpt.load_pytree_dcp(path, like)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("case", ["indivisible", "cuda_without_card", "no_group",
                                  "nccl_past_the_cards", "dryrun_cuda", "spawn_cuda"])
def test_refusals(case, spawned, tmp_path, monkeypatch):
    """Nothing falls back: an env count that does not divide, a card that is
    not there, a mesh without a group, NCCL ranks past the cards."""
    if case == "indivisible":
        results = _ranks_result(spawned)
        assert all("does not split" in r["refused"] for r in results)
        return
    if case == "no_group":
        with pytest.raises(RuntimeError, match="process group"):
            sharding.env_mesh("cpu")
        return
    _no_card(monkeypatch)
    if case == "dryrun_cuda":
        with pytest.raises(RuntimeError, match="cuda"):
            sharding.dryrun_multichip(2, device="cuda")
    elif case == "spawn_cuda":
        with pytest.raises(RuntimeError, match="cuda"):
            sharding.spawn_env_group(2, sharding._dryrun_rank, device="cuda")
    else:
        with sharding.env_group(str(tmp_path / "store"), "gloo"), monkeypatch.context() as m:
            match = "cuda"
            if case == "nccl_past_the_cards":
                m.setattr(torch.cuda, "is_available", lambda: True)
                m.setattr(torch.cuda, "device_count", lambda: 0)
                m.setattr(sharding.dist, "get_backend", lambda *a: "nccl")
                match = "NCCL ranks need"
            with pytest.raises(RuntimeError, match=match):
                sharding.env_mesh("cuda")


def test_env_mesh_sets_the_device_before_the_batch_is_built(spawned, tmp_path, monkeypatch):
    """On ``cuda``, ``env_mesh`` makes the rank's card current before the
    mesh is built, so that ``make_sharded_batch`` (which builds on
    ``"cuda"``, no index) lands on it: rank ``LOCAL_RANK`` modulo the
    cards. The card and the CUDA mesh are mocked; the mesh is a CPU mesh."""
    events = []
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: events.append(("set_device", i)))
    real_mesh, real_batch = sharding.init_device_mesh, sharding.batch_worlds

    def cpu_mesh(device_type, shape, mesh_dim_names):
        events.append(("mesh", device_type))
        return real_mesh("cpu", shape, mesh_dim_names=mesh_dim_names)

    def batch(mpc, n, device):
        events.append(("build", device))
        return real_batch(mpc, n, device=device)

    monkeypatch.setattr(sharding, "init_device_mesh", cpu_mesh)
    monkeypatch.setattr(sharding, "batch_worlds", batch)
    with sharding.env_group(str(tmp_path / "store"), "gloo"):
        mesh = sharding.env_mesh("cuda")
        worlds = sharding.make_sharded_batch(spawned.srb[2], 4, mesh)
    assert events == [("set_device", 1), ("mesh", "cuda"), ("build", "cpu")]
    assert worlds.sim.x_fb.shape == (4, 12)


def test_dryrun_multichip_on_cpu(spawned):
    lines = spawned.dryrun.result(timeout=SPAWN_TIMEOUT)
    text = "\n".join(lines)
    assert "dryrun_multichip SRB OK: 2 ranks on cpu, 4 envs" in text
    assert "dryrun_multichip ART OK: 2 ranks on cpu, 4 envs, 50 steps" in text
    assert "weak scaling" in text
    assert "ranks=1 envs=4 steps=50" in text and "ranks=2 envs=8 steps=50" in text
