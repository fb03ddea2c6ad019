"""The port's span recorder: host spans at the layers' boundaries and device
stages inside a captured tick.

- :func:`span` (``with span("realtime.read"):``) is a host span. It is off
  unless a ``torch.profiler`` is recording or a :func:`tracing` block is
  open; off, it costs one check and calls nothing of ``torch.profiler``.
  With a profiler recording it is one of the profiler's host events, on the
  profiler's clock, and it has no device-side twin: it is a function-scoped
  record (``_RecordFunctionFast``), which the profiler does not pair with
  the kernels launched inside it, as it pairs a ``record_function`` range.
  Inside :func:`tracing` it is also kept in memory as a :class:`Span`.
- :func:`stage` (``with stage("qp.ruiz"):``) is a stage of a tick. While a
  :class:`~biped_mpc_py_torch.utils.graphs.TickGraph` is captured it
  records CUDA timing events into the graph (event-record nodes), always:
  the marks are part of the graph and add no kernel. Consecutive stages
  share one boundary event: a stage runs from the end of the stage before
  it in the capture (the first from its own start) to its end, so the
  stages of a tick, which do not nest, partition it. :func:`stage_ms`
  reads each stage's device time in the last replay. Outside a capture a
  stage is a host span, as :func:`span`; inside :func:`tracing` it is also
  timed on the device (:attr:`Span.device_ms`).

The marks of a capture belong to its ``TickGraph`` (``TickGraph.marks``);
the recorder keeps only those of the graph replayed last, for
:func:`stage_ms`.

- :func:`count_nonfinite` adds the envs that a tick's post stage reset
  because their new simulator state held a non-finite value to a counter
  on their device: one in-place add, no host synchronization, so a
  captured tick records it into its graph and every replay adds to it.
  :func:`nonfinite_resets` reads the count on demand.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class Span:
    """One span of a :func:`tracing` block: host times from
    ``time.perf_counter_ns``; ``parent`` the index in the block's list of
    the span open around it (None at the top); ``tick`` the number given to
    its top span (``span(name, tick)``), else that top span's call number
    among the top spans of its name; ``device_ms`` a stage's device time
    (CUDA events on the current stream where CUDA is initialized, else its
    host time), None for a span."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    tick: int
    device_ms: float | None = None


class Marks:
    """The stage marks recorded into one captured graph: ``events`` the
    boundary events in order, ``names[i]`` the stage from ``events[i]`` to
    ``events[i + 1]``."""

    def __init__(self):
        self.events, self.names = [], []

    def _record(self) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.events.append(event)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.events:
            self._record()
        yield
        self._record()
        self.names.append(name)

    def ms(self) -> dict:
        """``{stage: device ms}`` of the last replay, each stage's
        occurrences summed; waits for the last boundary event only."""
        if not self.names:
            return {}
        self.events[-1].synchronize()
        out: dict = {}
        for i, name in enumerate(self.names):
            out[name] = out.get(name, 0.0) + self.events[i].elapsed_time(self.events[i + 1])
        return out


_OFF = contextlib.nullcontext()
_records: list | None = None  # the Spans of the open tracing() block
_open: list = []  # indices in _records of the spans open now, innermost last
_calls: dict = {}  # name -> top spans of that name so far
_pending: list = []  # (Span, start event, end event) of the block's device-timed stages
_capture: Marks | None = None  # the marks of the TickGraph being captured
_replayed: Marks | None = None  # the marks of the TickGraph replayed last
_nonfinite: dict = {}  # device -> int64 count of envs reset for a non-finite state


class _Span:
    __slots__ = ("name", "tick", "timed", "_fast", "_rec", "_start")

    def __init__(self, name: str, tick: int | None = None, timed: bool = False):
        self.name, self.tick, self.timed = name, tick, timed

    def __enter__(self):
        self._fast = self._rec = None
        if _autograd_profiler._is_profiler_enabled:
            self._fast = torch._C._profiler._RecordFunctionFast(self.name)
            self._fast.__enter__()
        if _records is not None:
            parent = _open[-1] if _open else None
            tick = self.tick
            if tick is None and parent is not None:
                tick = _records[parent].tick
            elif tick is None:
                tick = _calls.get(self.name, 0)
                _calls[self.name] = tick + 1
            _open.append(len(_records))
            self._rec = Span(self.name, 0, 0, parent, tick)
            _records.append(self._rec)
            if self.timed and torch.cuda.is_initialized():
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
            else:
                self._start = None
            self._rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            rec.end_ns = time.perf_counter_ns()
            _open.pop()
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                _pending.append((rec, self._start, end))
            elif self.timed:
                rec.device_ms = (rec.end_ns - rec.start_ns) * 1e-6
        if self._fast is not None:
            self._fast.__exit__(*exc)
        return False


def span(name: str, tick: int | None = None):
    """A host span named ``name`` over the ``with`` block (off unless a
    profiler records or :func:`tracing` is open). ``tick`` numbers a top
    span and the spans inside it (default: its call number)."""
    if _records is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, tick)


def stage(name: str):
    """A stage of the tick named ``name`` over the ``with`` block: marks in
    the graph being captured, else a host span as :func:`span`, also timed
    on the device inside :func:`tracing`."""
    if _capture is not None:
        return _capture.stage(name)
    if _records is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, timed=True)


@contextlib.contextmanager
def marking():
    """Collect the stage marks of a capture: yields the :class:`Marks` that
    every :func:`stage` of the block records into (``TickGraph``'s
    capture)."""
    global _capture
    outer, _capture = _capture, Marks()
    try:
        yield _capture
    finally:
        _capture = outer


def replayed(marks: Marks | None) -> None:
    """Note the marks of the graph just replayed (None: a graph without)."""
    global _replayed
    _replayed = marks


def stage_ms() -> dict:
    """``{stage: device ms}`` of the most recent replay of the most
    recently replayed ``TickGraph``, each stage's occurrences in the tick
    summed; empty where that graph has no marks (or none was replayed).
    Waits for the replay's last boundary event, nothing else."""
    return {} if _replayed is None else _replayed.ms()


@contextlib.contextmanager
def tracing():
    """Turn spans and stages on over the block and keep each as a
    :class:`Span`; yields the list, complete (the device times of its
    stages read) when the block ends."""
    global _records, _open, _calls, _pending
    outer = (_records, _open, _calls, _pending)
    records = _records, _open, _calls, _pending = [], [], {}, []
    try:
        yield records[0]
    finally:
        for rec, start, end in records[3]:
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        _records, _open, _calls, _pending = outer


def count_nonfinite(reset: torch.Tensor) -> None:
    """Add the envs where ``reset`` (N,) bool is true to the count of envs
    reset for a non-finite state on its device, by one in-place add. The
    counter is made at the first call, which must come before any capture
    (a ``TickGraph`` runs its step once before it captures): one made
    inside a capture would be zeroed by every replay."""
    counter = _nonfinite.get(reset.device)
    if counter is None:
        if reset.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("count_nonfinite: the counter must be made before a capture")
        counter = _nonfinite[reset.device] = torch.zeros((), dtype=torch.int64,
                                                         device=reset.device)
    counter.add_(reset.sum())


def nonfinite_resets(device="cuda") -> int:
    """Envs reset for a non-finite simulator state on ``device`` since the
    process started (0 before any); waits for the work queued on it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _nonfinite.get(device)
    return 0 if counter is None else int(counter)
