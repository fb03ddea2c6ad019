"""CUDA-graph capture of one tick: the port's counterpart of ``jax.jit``
around the JAX package's ``lax.scan`` rollouts.

JAX traces a rollout once and runs the compiled program again and again;
the port records one tick's kernel launches once as a
``torch.cuda.CUDAGraph`` and replays them, so the host issues one replay
per tick instead of every op's launch.

:class:`TickGraph` captures a pure ``step(carry, *consts) -> carry`` over a
tree of tensors (a :class:`~biped_mpc_py_torch.utils.struct.TensorStruct`,
a tuple, a dict, a tensor) on static buffers, as ``carry.copy_(step(carry,
*consts))``, and replays it in place. :func:`graphed` is the functional
form a rollout factory returns: one ``TickGraph`` per key (device, the
tree's structure, every tensor leaf's shape and dtype and every other
leaf's value, such as a ``Terrain``'s ``extent``), re-captured on a new key
as ``jax.jit`` retraces; each call copies its inputs in, replays ``n_steps`` times and
returns a clone of the carry.

On the card a capture warms the step up once on a side stream, on a
scratch copy of the buffers (the caller's state does not advance), then
captures it. A capture that fails raises: nothing falls back to eager
launches. Because the captured launches never pass through the kernel
wrappers again, the graph adds the launches it captured to each wrapper's
``launches`` counter on every replay, and a counter goes on meaning
launches on the card. On CPU tensors the same buffers run the step eagerly
(copy in, step, copy back), without a graph.

The step must be capture-safe: no host synchronization (``.item()``, a
Python branch on a tensor), no copy from pageable host memory, and every
constant made before the capture (``config.config_tensor`` is memoized and
the kernels' constant buffers are cached per object for this).
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from biped_mpc_py_torch.utils import profiling
from biped_mpc_py_torch.utils.precision import f32_matmul
from biped_mpc_py_torch.utils.struct import TensorStruct


def leaves(tree) -> list:
    """The tensor leaves of a tree, in a fixed order (a dict's by sorted
    key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, TensorStruct):
        return [t for f in dataclasses.fields(tree) for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in leaves(v)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return []


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, TensorStruct):
        return tree.map(torch.clone)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _clone(tree[k]) for k in sorted(tree)}
    return tree


def _signature(tree):
    """The tree's structure, every tensor leaf's shape and dtype, and every
    other leaf's value (a ``Terrain``'s ``extent``): what a capture bakes
    in, as the static arguments and shapes that ``jax.jit`` keys its
    traces on."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, TensorStruct):
        return (type(tree),) + tuple(_signature(getattr(tree, f.name))
                                     for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_signature(v) for v in tree)
    if isinstance(tree, dict):
        return (dict,) + tuple((k, _signature(tree[k])) for k in sorted(tree))
    return tree


def kernel_wrappers():
    """The kernel wrappers whose ``launches`` a replay adds to."""
    from biped_mpc_py_torch.ops.cuda import qp_kernel, ruiz_kernel, substep_kernel, tick_kernel

    return (qp_kernel.fused_qp_solve, substep_kernel.fused_substeps, tick_kernel.fused_tick,
            ruiz_kernel.fused_ruiz)


_WARMUP_STREAMS: dict = {}  # device -> the side stream of every warm-up on it


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of the warm-ups on ``device``. cuBLAS keeps a
    workspace (32 MiB on Hopper) for each stream it has run on, for the
    life of the process: a new stream per capture held one more each time."""
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


def _load(dst, src) -> None:
    """Copy the leaves of ``src`` into the buffers ``dst`` of the same tree."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        d.copy_(s)


class TickGraph:
    """``step(carry, *consts) -> carry`` captured on the buffers ``carry``
    and ``consts``, which the caller owns and which must stay alive: the
    graph reads and writes their memory. ``consts`` are read only; the
    caller may copy new values into any buffer between replays.

    On the card the constructor warms ``step`` up once on a scratch copy
    (on a side stream) and captures it; ``pool_mb`` is then the device
    memory the capture reserved for the graph's private pool, and
    ``launches`` maps each counted kernel wrapper to its launches per
    replay. Several ``TickGraph`` may share buffers (``RealtimeLoop``'s
    solve and low-level graphs share their state). ``marks`` holds the
    timing events that the step's ``profiling.stage`` blocks recorded into
    the graph (None on the CPU); ``profiling.stage_ms()`` reads them after
    a replay."""

    def __init__(self, step, carry, *consts):
        self.step, self.carry, self.consts = step, carry, consts
        self.graph, self.launches, self.pool_mb, self.marks = None, {}, 0.0, None
        self.device = (leaves(carry) + leaves(consts))[0].device
        if self.device.type == "cuda":
            self._capture()

    def _write(self) -> None:
        """The captured body: ``carry <- step(carry, *consts)``. A result
        leaf that shares memory with a buffer other than its own (a step
        that passes an input on into another field) is cloned first, so no
        copy reads a buffer that an earlier copy wrote."""
        out = self.step(self.carry, *self.consts)
        dst, src = leaves(self.carry), leaves(out)
        if len(dst) != len(src) or any((d.shape, d.dtype) != (s.shape, s.dtype)
                                       for d, s in zip(dst, src)):
            raise ValueError("step must return a carry of its input's structure, shapes "
                             "and dtypes")
        owned = {t.untyped_storage().data_ptr() for t in dst + leaves(self.consts)}
        src = [s.clone() if s is not d and s.untyped_storage().data_ptr() in owned else s
               for d, s in zip(dst, src)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)

    def _capture(self) -> None:
        counted = kernel_wrappers()
        with torch.no_grad(), f32_matmul():
            scratch = _clone((self.carry, self.consts))
            side = _warmup_stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.step(scratch[0], *scratch[1])
            torch.cuda.current_stream(self.device).wait_stream(side)
            del scratch
            torch.cuda.synchronize(self.device)
            before = [fn.launches for fn in counted]
            torch.cuda.empty_cache()  # as the capture does first: count its pool alone
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collected cycle that holds a
            # graph or an event (a dropped RealtimeLoop's graphs hold its bound methods)
            # would free it there, which CUDA refuses while a stream captures
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph), profiling.marking() as marks:
                    self._write()
            finally:
                if collecting:
                    gc.enable()
            self.pool_mb = (torch.cuda.memory_reserved(self.device) - reserved) / 2**20
        # the capture recorded these launches; none ran on the card
        for fn, n in zip(counted, before):
            if fn.launches != n:
                self.launches[fn] = fn.launches - n
                fn.launches = n
        self.graph, self.marks = graph, marks

    def replay(self, n: int = 1) -> None:
        """``n`` steps in place (on the CPU, ``n`` eager steps)."""
        if self.graph is None:
            with torch.no_grad(), f32_matmul():
                for _ in range(n):
                    self._write()
        else:
            for _ in range(n):
                self.graph.replay()
            for fn, k in self.launches.items():
                fn.launches += k * n
        profiling.replayed(self.marks)


def _key(trees) -> tuple:
    return (leaves(trees)[0].device, _signature(trees))


def graphed(step, n_steps: int):
    """``fn(carry, *consts) -> carry``: ``n_steps`` steps of ``step``
    replayed from one :class:`TickGraph` per key (made at the first call
    with that key). Each call copies ``carry`` and ``consts`` into the
    graph's buffers, replays, and returns a clone of the carry: the inputs
    are not modified and the result aliases no buffer. ``fn.graphs`` maps
    each key to its ``TickGraph``."""
    graphs: dict = {}

    def fn(carry, *consts):
        key = _key((carry, consts))
        g = graphs.get(key)
        if g is None:
            g = graphs[key] = TickGraph(step, _clone(carry), *_clone(consts))
        with torch.no_grad():
            _load((g.carry, g.consts), (carry, consts))
            g.replay(n_steps)
            return _clone(g.carry)

    fn.graphs = graphs
    return fn
