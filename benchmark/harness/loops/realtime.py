"""The real-time loop: one robot driven by the configuration's
``entry.realtime.program`` (``RealtimeLoop``) against the sensor-log plant
(the traffic's generator, ``traffic/plant.py``), paced at the
controller's own rate.

- set-up: the loop (its two graphs captured by ``warmup``) and
  ``warmup_ticks`` unpaced ticks against a plant of their own;
- the timed window: ``seconds`` x rate ticks, paced (``run(realtime=True)``);
  the plant times each tick from its first read to its last torque back;
- the traced window (``--trace 1``): one second of paced ticks under
  ``torch.profiler``, each tick a host range;
- the check: a sample of the window's ticks drawn from the seed. The
  controller state the program carried into each (its warm start,
  ``cmd_ref``, ``v_int``) and out of it is copied after the tick's last
  torque, outside the timed span; the reference solves each sampled tick
  from the reads the plant served and the state carried in, and runs its
  low-level periods.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.harness import common, spec, trace as tr
from benchmark.harness.tree import rebuild
from benchmark.reference import config as rconfig
from benchmark.reference.precision import matmul


@dataclasses.dataclass
class Window:
    ticks: int
    seconds: float
    latencies_ms: np.ndarray
    late: int  # ticks whose torques came back later than one period after their first read
    plant: object  # the traffic's plant (``traffic/plant.py``)
    carried: dict  # tick k -> the controller state after it (-1: before the window)
    t0: float  # the loop's clock at the window's first tick
    sample: list
    trace: tr.Trace | None = None


class Driver:
    def __init__(self, cell, device: torch.device):
        import biped_mpc_py_torch as bt

        self.cell, self.device = cell, device
        entry = spec.entry(cell)
        if cell.traffic["envs"] != 1:
            raise ValueError("the real-time loop runs one robot")
        self.port = common.port_classes()
        self.ref = common.reference_classes()
        self.mpc, self.gait = common.configs(cell, bt)
        self.rmpc, self.rgait = common.configs(cell, rconfig)
        self.solve = spec.resolve(entry["reference"]["solve"])
        self.lowlevel = spec.resolve(entry["reference"]["lowlevel"])
        self.n_ll = entry["kwargs"]["n_lowlevel"]
        self.loop = spec.resolve(entry["program"])(self.mpc, self.gait, bt.BipedParams(),
                                                   device=device, **entry["kwargs"])
        self.gen = spec.generator(cell)
        self.log = np.load(cell.root / "benchmark" / "traffic" / cell.traffic["log"])
        self.dt = float(self.mpc.dt)

    def _plant(self, n_ticks, stream, **kw):
        return self.gen.SensorLogPlant(self.log, n_ticks, self.n_ll,
                                       common.host_rng(self.seed, stream),
                                       self.cell.traffic["log_noise"], **kw)

    def prepare(self, seed: int) -> None:
        self.seed = seed
        self.t_next = 0.0

    def warm_up(self) -> None:
        """The graphs' capture, then ``warmup_ticks`` unpaced ticks."""
        n = self.cell.traffic["warmup_ticks"]
        self.loop.warmup(self._plant(1, 3))
        self.loop.run(self._plant(n, 4), n, t0=self.t_next, realtime=False)
        self.t_next += n * self.dt
        common.sync(self.device)

    def _carry(self) -> dict:
        s = self.loop.state
        return {"qp": rebuild(s.qp, self.port), "cmd_ref": s.cmd_ref.clone(),
                "v_int": s.v_int.clone()}

    def window(self, seconds: float, traced: bool = False) -> Window:
        """``seconds`` of paced ticks (one second where traced); the ticks
        checked are drawn from the seed."""
        from torch.profiler import record_function

        n = max(1, round((1.0 if traced else seconds) / self.dt))
        n_sample = self.cell.workload["check"]["ticks"]
        rng = common.host_rng(self.seed, 5)
        sample = sorted(rng.choice(n, size=min(n_sample, n), replace=False).tolist())
        wanted = set(sample) | {k - 1 for k in sample}
        carried = {-1: self._carry()} if -1 in wanted else {}

        def on_tick_end(k):
            if k in wanted:
                carried[k] = self._carry()

        plant = self._plant(n, 6, on_tick_end=on_tick_end,
                            mark=(lambda: record_function(tr.TICK)) if traced else None)
        t0, out = self.t_next, {}
        if traced:
            with tr.profiled(out), record_function(tr.WINDOW):
                self.loop.run(plant, n, t0=t0, realtime=True)
                common.sync(self.device)
        else:
            self.loop.run(plant, n, t0=t0, realtime=True)
        common.sync(self.device)
        self.t_next += n * self.dt
        lat = (plant.ends - plant.starts) * 1e3
        late = int(np.sum(lat > self.dt * 1e3))
        trace = None
        if traced:
            win = [(a, b) for name, a, b in out["host"] if name == tr.WINDOW][0]
            trace = tr.Trace(kernels=out["kernels"], host=out["host"], ticks=n, window=win)
        return Window(n, float(plant.ends[-1] - plant.starts[0]), lat, late, plant, carried, t0,
                      sample, trace)

    def end_to_end(self, w: Window) -> dict:
        return {"tick_latency_ms_p50": float(np.percentile(w.latencies_ms, 50)),
                "tick_latency_ms_p95": float(np.percentile(w.latencies_ms, 95))}

    def accounting(self, w: Window) -> tuple[int, int, str]:
        """(attempted, failed, a line for standard error): ticks, and ticks
        whose torques came back later than one period after their first
        read."""
        return (w.ticks, w.late,
                f"[window] {w.ticks} ticks in {w.seconds:.6f} s; later than one period "
                f"{w.late}; latency p50 {float(np.percentile(w.latencies_ms, 50)):.4f} ms, "
                f"max {float(w.latencies_ms.max()):.4f} ms")

    def release_program(self) -> None:
        """Drop the loop and its two graphs (the window's record stays)."""
        self.loop = None

    def _times(self, w: Window) -> np.ndarray:
        """The clock value of each read of each tick, as the loop writes it
        into the f32 read (t_sim advanced by dt a tick; read 0 and 1 at the
        tick's time, read j + 1 at j low-level periods on)."""
        ll_dt = self.dt / self.n_ll
        t, out = w.t0, np.zeros((w.ticks, self.n_ll + 1), np.float32)
        for k in range(w.ticks):
            out[k] = [t] + [t + j * ll_dt for j in range(self.n_ll)]
            t += self.dt
        return out

    @staticmethod
    def program_answers(w: Window) -> tuple[dict, dict]:
        """Per sampled tick: the torques the plant got back, and the state the
        controller carried out of the tick (no further numbers)."""
        out_ = [w.carried[k] for k in w.sample]
        qp = _cat([c["qp"] for c in out_])
        return {
            "torque": {"tau": torch.as_tensor(w.plant.torques[w.sample],
                                              device=qp.controls.device)},
            "carry": {"u": qp.controls, "z": qp.z, "y": qp.y,
                      "cmd_ref": torch.cat([c["cmd_ref"] for c in out_]),
                      "v_int": torch.cat([c["v_int"] for c in out_])},
        }, {}

    def reference_answers(self, w: Window, tf32: bool = False) -> dict:
        """The reference's answers for the sampled ticks, each solved from
        the reads the plant served and the state the program carried in."""
        dev, S = self.device, w.sample
        reads = np.concatenate([w.plant.reads[S], self._times(w)[S][..., None]], axis=2)
        reads = torch.as_tensor(reads, device=dev)  # (N, 9, 39)
        into = [w.carried[k - 1] for k in S]
        qp = rebuild(_cat([c["qp"] for c in into]), self.ref)
        cmd_ref = torch.cat([c["cmd_ref"] for c in into])
        v_int = torch.cat([c["v_int"] for c in into])
        biped = self.ref["BipedParams"]().expand(len(S)).to(dev)
        with matmul(tf32), torch.no_grad():
            sol, cmd2, vint2, contact, u0, vint_ll = self.solve(
                reads[:, 0], qp, cmd_ref, v_int, self.rmpc, self.rgait, biped)
            taus = torch.stack([
                self.lowlevel(reads[:, j + 1], contact, u0, cmd2, vint_ll, self.rmpc,
                              self.rgait, biped)
                for j in range(self.n_ll)], 1)
        return {"torque": {"tau": taus},
                "carry": {"u": sol.controls, "z": sol.z, "y": sol.y, "cmd_ref": cmd2,
                          "v_int": vint2}}


def _cat(structs: list):
    """Concatenate same-class dataclasses of (1, ...) tensors along dim 0."""
    first = structs[0]
    return type(first)(**{f.name: torch.cat([getattr(s, f.name) for s in structs])
                          for f in dataclasses.fields(first)})
