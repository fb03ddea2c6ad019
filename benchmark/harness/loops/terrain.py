"""The rough-ground loop: the batched loop (``batched.py``) with a height
field per env, as a trainer on randomized rough terrain collects its
rollouts.

The program's entry is the configuration's ``entry.terrain``: ``program``
built as ``program(ticks_per_call, mpc, gait, **kwargs)`` and called as
``fn(world, bipeds, terrains)``, the fields (N, H, W) an input of its graph.
The reference's counterpart (``reference``) takes the batched signature
and the checked envs' fields as ``terrains=``. The generator
(``traffic/terrain.py``) draws the robots, the starts and the fields from
the seed; the window, the traced window, the accounting and the check are
the batched loop's.

An env diverges now and then (``PERF.md`` §7.1); its sole points then
query the ground at NaN. A program whose ``Terrain.height`` reads such a
query off its grid stops the card at an index assertion somewhere in the
window, so the loop asks the program's ``Terrain`` first, on the CPU, and
refuses one that cannot answer it.
"""

from __future__ import annotations

import torch

from benchmark.harness import common
from benchmark.harness.loops import batched
from benchmark.harness.tree import classes, rebuild
from benchmark.reference.precision import matmul
from benchmark.reference.sim import contact as rcontact


class Driver(batched.Driver):
    """One rough-ground cell on ``device``."""

    def __init__(self, cell, device: torch.device):
        from biped_mpc_py_torch.sim import contact

        missing = {"chunk_draws", "envs"} - set(cell.workload["check"])
        if missing:
            raise ValueError(f"{cell.name}: the check of a batched loop needs {sorted(missing)}")
        probe = contact.Terrain(heights=torch.zeros((1, 4, 4)))
        try:
            probe.height(torch.tensor([float("nan")]), torch.tensor([0.0]))
        except IndexError as e:
            raise RuntimeError("the program's Terrain.height indexes off its grid at a NaN "
                               "query (an env whose state diverged): it cannot run this "
                               "configuration") from e
        super().__init__(cell, device)
        self.port = {**self.port, **classes(contact)}
        self.ref = {**self.ref, **classes(rcontact)}

    def prepare(self, seed: int) -> None:
        """The seed's robots, starts and fields, made on the card: the
        reference keeps its own, the program gets a copy."""
        self.r_bipeds, self.r_world, self.r_terrains = self.gen.inputs(
            self.cell.traffic, self.rmpc, self.start, self.cell.config["terrain"], seed,
            self.device)
        self.r_cmd = None
        self.bipeds = rebuild(self.r_bipeds, self.port)
        self.world0 = rebuild(self.r_world, self.port)
        self.extra = (rebuild(self.r_terrains, self.port),)
        self.seed = seed

    def reference_answers(self, w: batched.Window, tf32: bool = False) -> dict:
        """The reference's step of the checked tick for the sample of envs
        on their own fields, from the same input (f32, or TF32 for the
        control)."""
        idx = self._sample(w.checked_input)
        rw = rebuild(common.index(w.checked_input, idx), self.ref)
        rb = common.index(self.r_bipeds, idx)
        rt = common.index(self.r_terrains, idx)
        with matmul(tf32), torch.no_grad():
            rw = self.reference(rw, rb, self.rmpc, self.rgait, None, terrains=rt,
                                **self.entry.get("kwargs", {}))
        return batched.answers(rw, self.cell.workload["groups"])
