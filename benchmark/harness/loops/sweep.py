"""The sweep loop: the batched loop (``batched.py``) with a config per env,
as a controller is tuned by mapping its stability region in one batch
(gains x commands x starts along the env axis).

The program's entry is the configuration's ``entry.sweep``: ``program``
built as ``program(ticks_per_call, mpc, gait, **kwargs)`` and called as
``fn(world, bipeds, per_env)``, the per-env values (``x_cmd`` among them)
an input of its graph. The reference's counterpart (``reference``) takes
the batched signature with the checked envs' commands as ``x_cmd`` and
their other values as ``per_env=``. The generator (``traffic/sweep.py``)
draws the robots, the starts and the configs from the seed; the window,
the traced window, the accounting and the check are the batched loop's.
"""

from __future__ import annotations

import torch

from benchmark.harness import common
from benchmark.harness.loops import batched
from benchmark.harness.tree import rebuild
from benchmark.reference.precision import matmul


class Driver(batched.Driver):
    """One sweep cell on ``device``."""

    def __init__(self, cell, device: torch.device):
        missing = {"chunk_draws", "envs"} - set(cell.workload["check"])
        if missing:
            raise ValueError(f"{cell.name}: the check of a batched loop needs {sorted(missing)}")
        super().__init__(cell, device)

    def prepare(self, seed: int) -> None:
        """The seed's robots, starts and configs, made on the card: the
        reference keeps its own, the program gets a copy."""
        self.r_bipeds, self.r_world, self.r_per_env = self.gen.inputs(
            self.cell.traffic, self.rmpc, self.start, seed, self.device)
        self.r_cmd = None
        self.bipeds = rebuild(self.r_bipeds, self.port)
        self.world0 = rebuild(self.r_world, self.port)
        self.extra = ({k: v.clone() for k, v in self.r_per_env.items()},)
        self.seed = seed

    def warm_up(self) -> None:
        """The capture and one call after it, then on the card calls back to
        back for the workload's ``warm_up_s`` seconds: a card runs each graph
        kernel slower for a while after a process starts, and the window
        starts from the seed's starts again after it."""
        super().warm_up()
        if self.device.type != "cuda":
            return
        w, t0 = self.world0, common.now()
        while common.now() - t0 < self.cell.workload.get("warm_up_s", 0):
            w = self.call(w)
            common.sync(self.device)

    def reference_answers(self, w: batched.Window, tf32: bool = False) -> dict:
        """The reference's step of the checked tick for the sample of envs
        under their own configs, from the same input (f32, or TF32 for the
        control)."""
        idx = self._sample(w.checked_input)
        rw = rebuild(common.index(w.checked_input, idx), self.ref)
        rb = common.index(self.r_bipeds, idx)
        values = {k: v[idx] for k, v in self.r_per_env.items()}
        x_cmd = values.pop("x_cmd")
        with matmul(tf32), torch.no_grad():
            rw = self.reference(rw, rb, self.rmpc, self.rgait, x_cmd, per_env=values,
                                **self.entry.get("kwargs", {}))
        return batched.answers(rw, self.cell.workload["groups"])
