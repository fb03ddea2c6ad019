"""The batched loop: many envs stepped in chunks of ticks through the
program's compiled rollout, as a trainer collects its rollouts.

The program's entry is the configuration's (``entry.batched``: ``program``,
an import path, built as ``program(ticks_per_call, mpc, gait, **kwargs)``
and called as ``fn(world, bipeds[, x_cmd])``), and so is the reference's
counterpart (``reference``, ``benchmark/reference/entries.py``) and the
starts' constructor (``start``). Each call runs ``ticks_per_call`` ticks:
the world is copied into the graph's buffers, the ticks replay, and the
result is cloned out; the next call starts from that result.

- set-up: the inputs from the seed (the traffic's generator), the graph's
  capture and one more call;
- the timed window: calls back to back, each ended by a synchronization,
  until ``seconds`` have passed; ``env_steps_per_s`` is envs x ticks over
  the window's seconds;
- the traced window (``--trace 1``): three calls, the middle one under
  ``torch.profiler``;
- the check: one call of the window and one tick in it drawn from the
  seed. The program's own graph replays the call from its input: the
  state it reaches before the drawn tick is the input both sides step,
  the tick's output is the program's answer, and the call's last tick so
  replayed has to equal the window's answer bit for bit (``replay``).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import check, common, spec, trace as tr
from benchmark.harness.tree import leaves, named_leaves, rebuild
from benchmark.reference import config as rconfig
from benchmark.reference.precision import matmul


@dataclasses.dataclass
class Window:
    chunks: int
    seconds: float
    failed_envs: int  # envs found with a non-finite state after a call, summed over calls
    nonfinite_envs: int  # envs whose state is not finite after the window's last call
    kept: tuple  # (input world, output world) of the sampled call
    trace: tr.Trace | None = None
    checked_input: object = None  # the program's state before the checked tick
    call_ends: list = dataclasses.field(default_factory=list)  # seconds into the window


def answers(world, groups: dict) -> dict:
    """``{group: {path: (N, k) tensor}}`` of the world's leaves that the
    workload file's ``groups`` name: a dotted field path, optionally with
    ``:a:b`` for the columns a..b of its per-env values flattened
    (``ctrl.qp.controls:0:12`` is the first MPC control)."""
    out = {}
    for group, paths in groups.items():
        out[group] = {}
        for p in paths:
            field, *cols = p.split(":")
            t = world
            for name in field.split("."):
                t = getattr(t, name)
            t = t.reshape(t.shape[0], -1)
            out[group][p] = t[:, int(cols[0]):int(cols[1])] if cols else t
    return out


class Driver:
    """One batched cell on ``device``: the program's entry built once (its
    graph is captured at the first call and reused for every seed)."""

    def __init__(self, cell, device: torch.device):
        import biped_mpc_py_torch as bt
        from biped_mpc_py_torch.utils.precision import f32_precision

        self.cell, self.device = cell, device
        self.entry = spec.entry(cell)
        self.envs, self.ticks = cell.traffic["envs"], cell.traffic["ticks_per_call"]
        program = spec.resolve(self.entry["program"])
        self.reference = spec.resolve(self.entry["reference"])
        self.start = spec.resolve(self.entry["start"])
        self.port = common.port_classes(common.module_of(program))
        self.ref = common.reference_classes(common.module_of(self.start))
        self.mpc, self.gait = common.configs(cell, bt)
        self.rmpc, self.rgait = common.configs(cell, rconfig)
        self.gen = spec.generator(cell)
        fn = program(self.ticks, self.mpc, self.gait, **self.entry.get("kwargs", {}))
        self.graphs = fn.graphs  # the captured tick, keyed by shapes (one key here)
        self.fn = f32_precision(fn)

    def prepare(self, seed: int) -> None:
        """The seed's robots, starts and commands, made on the card: the
        reference keeps its own, the program gets a copy."""
        self.r_bipeds, self.r_world, self.r_cmd = self.gen.inputs(
            self.cell.traffic, self.rmpc, self.start, self.entry.get("takes_command", False),
            seed, self.device)
        self.bipeds = rebuild(self.r_bipeds, self.port)
        self.world0 = rebuild(self.r_world, self.port)
        self.extra = () if self.r_cmd is None else (self.r_cmd.clone(),)
        self.seed = seed

    def call(self, world):
        return self.fn(world, self.bipeds, *self.extra)

    def warm_up(self) -> None:
        """The capture and one call after it."""
        self.call(self.call(self.world0))
        common.sync(self.device)

    def _nonfinite(self, world) -> torch.Tensor:
        """(N,) True where an env's simulator state holds a non-finite value."""
        ok = torch.stack([torch.isfinite(t.reshape(self.envs, -1)).all(1)
                          for t in named_leaves(world.sim).values()], 1).all(1)
        return ~ok

    def window(self, seconds: float, traced: bool = False) -> Window:
        """Calls until ``seconds`` have passed, or three with the middle one
        profiled; keeps the call drawn from the seed among the first
        ``chunk_draws`` (among the three where traced; the last, if the
        window ends first)."""
        from torch.profiler import record_function

        draws = 3 if traced else self.cell.workload["check"]["chunk_draws"]
        pick = int(common.host_rng(self.seed, 1).integers(draws))
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        w, kept, n, out, ends = self.world0, None, 0, {}, []
        common.sync(self.device)
        t0 = common.now()
        while True:
            w_in = w
            if traced and n == 1:
                with tr.profiled(out), record_function(tr.WINDOW):
                    w = self.call(w_in)
                    common.sync(self.device)
            else:
                w = self.call(w_in)
            bad += self._nonfinite(w).sum()
            common.sync(self.device)
            if n <= pick:
                kept = (w_in, w)
            n += 1
            elapsed = common.now() - t0
            ends.append(elapsed)
            if (traced and n == 3) or (not traced and elapsed >= seconds):
                break
        last = int(self._nonfinite(w).sum())
        if not traced:
            return Window(n, elapsed, int(bad), last, kept, call_ends=ends)
        win = [(a, b) for name, a, b in out["host"] if name == tr.WINDOW][0]
        trace = tr.Trace(kernels=out["kernels"], host=out["host"], ticks=self.ticks, window=win)
        return Window(n, (win[1] - win[0]) * 1e-6, int(bad), last, kept, trace, call_ends=ends)

    def end_to_end(self, w: Window) -> dict:
        return {"env_steps_per_s": self.envs * self.ticks * w.chunks / w.seconds}

    def accounting(self, w: Window) -> tuple[int, int, str]:
        """(attempted, failed, a line for standard error): env-steps, and
        env-steps of envs whose state was not finite after a call."""
        h, e = len(w.call_ends) // 2, w.call_ends
        halves = (f"; calls of the first half {e[h - 1] / h:.6f} s, of the second "
                  f"{(e[-1] - e[h - 1]) / (len(e) - h):.6f} s" if h else "")
        return (self.envs * self.ticks * w.chunks, w.failed_envs * self.ticks,
                f"[window] {w.chunks} calls of {self.ticks} ticks in {w.seconds:.6f} s{halves}; falls "
                f"by the checked call's end {float(w.kept[1].metrics.falls.sum()):.0f} (reset, "
                f"not failures); envs with a non-finite state after a call, summed "
                f"{w.failed_envs}; after the last call {w.nonfinite_envs}")

    def _sample(self, world) -> torch.Tensor:
        """The envs checked: a draw from the seed, less those whose state is
        already not finite at the checked tick's input (counted in
        ``failed`` and ``nonfinite_envs``)."""
        rng = common.host_rng(self.seed, 2)
        n = min(self.cell.workload["check"]["envs"], self.envs)
        idx = torch.as_tensor(rng.choice(self.envs, size=n, replace=False))
        idx = idx.sort().values.to(self.device)
        return idx[~self._nonfinite(world)[idx]]

    def program_answers(self, w: Window) -> tuple[dict, dict]:
        """The kept call stepped again by the program's own graph from its
        input world: the tick drawn from the seed (``k`` ticks in) is the
        one checked. Returns (the sample's answers after that tick, the
        numbers ``replay``: the largest |difference| between the call's
        last tick so replayed and the window's answer, 0 where the replay
        reproduces it, and ``nonfinite_envs``)."""
        k = int(common.host_rng(self.seed, 3).integers(self.ticks))
        g = next(iter(self.graphs.values()))
        for d, s in zip(leaves(g.carry), leaves(w.kept[0]), strict=True):
            d.copy_(s)
        if k:
            g.replay(k)
        w.checked_input = rebuild(g.carry, self.port)
        g.replay(1)
        out = rebuild(g.carry, self.port)
        if self.ticks - 1 - k:
            g.replay(self.ticks - 1 - k)
        replay = max(check.bit_gap(a, b) for a, b in zip(leaves(g.carry), leaves(w.kept[1]),
                                                         strict=True))
        idx = self._sample(w.checked_input)
        return (answers(common.index(out, idx), self.cell.workload["groups"]),
                {"replay": replay, "nonfinite_envs": float(w.nonfinite_envs)})

    def reference_answers(self, w: Window, tf32: bool = False) -> dict:
        """The reference's step of the checked tick for the sample of envs,
        from the same input (f32, or TF32 for the control)."""
        idx = self._sample(w.checked_input)
        rw = rebuild(common.index(w.checked_input, idx), self.ref)
        rb = common.index(self.r_bipeds, idx)
        cmd = None if self.r_cmd is None else self.r_cmd[idx]
        with matmul(tf32), torch.no_grad():
            rw = self.reference(rw, rb, self.rmpc, self.rgait, cmd,
                                **self.entry.get("kwargs", {}))
        return answers(rw, self.cell.workload["groups"])

    def release_program(self) -> None:
        """Drop the program's graph and the inputs it holds (the kept call,
        the checked tick's input and the reference's own inputs stay)."""
        self.fn = self.call = self.graphs = None
        self.world0 = self.bipeds = self.extra = None
