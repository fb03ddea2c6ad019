"""What the program's own spans say (``biped_mpc_py_torch/utils/profiling.py``).

- The batched cells: each stage's device time in the captured tick, read
  from the marks the capture recorded into the graph
  (``profiling.stage_ms()``: the last tick of the last call replayed, which
  in a traced run is the window's third call, run without the profiler).
- The one-robot cell: the ``RealtimeLoop``'s per-period host spans among
  the profiler's host events (``realtime.tick``, its ``realtime.read`` and
  ``realtime.torques``), against the device's kernels, whose durations the
  profiler does not stretch.

A program without these spans (an earlier commit) gives None throughout.
"""

from __future__ import annotations

from benchmark.harness import trace as tr


def stage_ms(name: str):
    """Device ms of the stage ``name`` in the program's last replayed tick,
    or None."""
    from biped_mpc_py_torch.utils import profiling

    read = getattr(profiling, "stage_ms", None)
    return None if read is None else read().get(name)


def realtime_ticks(t: tr.Trace) -> list:
    """Per ``realtime.tick`` span: (start, end, reads, torques), the
    (start, end) of the tick's ``realtime.read`` and ``realtime.torques``
    spans in order; ticks whose reads are not one more than their torques
    are left out."""
    reads, torques = t.ranges("realtime.read"), t.ranges("realtime.torques")
    out = []
    for a, b in sorted(t.ranges("realtime.tick")):
        r = sorted((s, e) for s, e in reads if a <= s and e <= b)
        q = sorted((s, e) for s, e in torques if a <= s and e <= b)
        if q and len(r) == len(q) + 1:
            out.append((a, b, r, q))
    return out


def busy_us(t: tr.Trace, lo: float, hi: float) -> float:
    """The union of the device's intervals inside [lo, hi]."""
    return tr.union_us(tr.clipped([(a, b) for _, a, b in t.kernels], lo, hi))


def lowlevel_periods_us(t: tr.Trace, ticks: list) -> list:
    """Device busy time of each low-level period after a tick's first, from
    its read's start to its torques' end: the torques of the period before
    ended with the host waiting for the device, so nothing else runs there."""
    return [busy_us(t, reads[j + 1][0], torques[j][1])
            for _, _, reads, torques in ticks for j in range(1, len(torques))]
