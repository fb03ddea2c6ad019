"""The sensor-log plant of the one-robot cells: it serves a walking
HECTOR's recorded states to the controller under test and takes its
torques back, timestamping both ends of every tick.

The log (``walk_log.npy``, ``make_walk_log.py``) holds one row per 5 ms
low-level period: x_fb (12), sole positions (6), q (10), qd (10). The plant
starts at a row drawn from the seed and moves one row on at each
``apply``, wrapping at the end; each read adds Gaussian noise drawn from
the seed ahead of the window. It is open loop: the torques do not move the
logged robot, so every seed serves the same amount of work.

A tick is the span from its first read to the ``n_lowlevel``-th torque
back. ``starts`` and ``ends`` hold those instants (``perf_counter``), and
``reads`` and ``torques`` every value served and returned, for the check
of ``correct``. A call costs a few microseconds of the host.
"""

from __future__ import annotations

import time

import numpy as np

FIELDS = {"x_fb": slice(0, 12), "soles": slice(12, 18), "q": slice(18, 28),
          "qd": slice(28, 38)}


class SensorLogPlant:
    """``read_state`` / ``foot_positions`` / ``apply`` over a log, for
    ``n_ticks`` ticks of ``n_lowlevel`` periods (one more read a tick: the
    solve's). ``on_tick_end(k)`` is called after tick ``k``'s last torque
    has been stamped, outside the timed span; ``mark()``, where given, makes
    a context that is open over each tick (a profiler range)."""

    def __init__(self, log: np.ndarray, n_ticks: int, n_lowlevel: int,
                 rng: np.random.Generator, noise: dict, on_tick_end=None,
                 mark=None):
        self.log = np.ascontiguousarray(log, dtype=np.float32)
        self.n_ticks, self.n_ll = n_ticks, n_lowlevel
        self.row = int(rng.integers(len(self.log)))
        sigma = np.zeros(38, np.float32)
        for name, sl in FIELDS.items():
            sigma[sl] = noise[name]
        reads = n_ticks * (n_lowlevel + 1)
        self.noise = (rng.standard_normal((reads, 38), dtype=np.float32) * sigma)
        self.reads = np.zeros((n_ticks, n_lowlevel + 1, 38), np.float32)
        self.torques = np.zeros((n_ticks, n_lowlevel, 10), np.float32)
        self.starts = np.zeros(n_ticks)
        self.ends = np.zeros(n_ticks)
        self.on_tick_end, self.mark, self._open = on_tick_end, mark, None
        self.tick, self.k_read, self.k_apply, self.n_read = 0, 0, 0, 0
        self._current = None

    def _serve(self) -> np.ndarray:
        """The row a read sees, with its noise, logged once per read."""
        if self._current is None:
            if self.k_read == 0 and self.k_apply == 0:
                self.starts[self.tick] = time.perf_counter()
                if self.mark is not None:
                    self._open = self.mark()
                    self._open.__enter__()
            v = self.log[self.row] + self.noise[self.n_read]
            self.reads[self.tick, self.k_read] = v
            self.n_read += 1
            self.k_read += 1
            self._current = v
        return self._current

    def read_state(self):
        self._current = None
        v = self._serve()
        return v[0:12], v[18:28], v[28:38]

    def foot_positions(self):
        return self._serve()[12:18]

    def apply(self, tau, dt: float) -> None:
        self.torques[self.tick, self.k_apply] = tau
        self.k_apply += 1
        self.row = (self.row + 1) % len(self.log)
        self._current = None
        if self.k_apply == self.n_ll:
            self.ends[self.tick] = time.perf_counter()
            if self._open is not None:
                self._open.__exit__(None, None, None)
                self._open = None
            k = self.tick
            self.tick, self.k_read, self.k_apply = self.tick + 1, 0, 0
            if self.on_tick_end is not None:
                self.on_tick_end(k)
