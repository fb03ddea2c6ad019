"""What a ``torch.profiler`` window saw: the device's kernels and the
host's ranges, on the profiler's clock (microseconds), and the arithmetic
that the per-layer metrics share (the union of kernel intervals is the
device's busy time; ``chip_smoke.py``'s ``_union_ms``, copied)."""

from __future__ import annotations

import contextlib
import dataclasses

# the port's hand-written kernels, by the name of their __global__ function
HANDWRITTEN = {"qp_admm_kernel": "qp", "tick_kernel": "tick", "substep_kernel": "substep"}
# host ranges that the harness opens with record_function
WINDOW, TICK = "benchmark.window", "benchmark.tick"


@dataclasses.dataclass
class Trace:
    kernels: list  # (name, start_us, end_us) of every device activity
    host: list  # (name, start_us, end_us) of every host event
    ticks: int  # ticks the window ran
    window: tuple  # (start_us, end_us) of the harness's window range

    def ranges(self, name: str) -> list:
        return [(a, b) for n, a, b in self.host if n == name]

    def in_window(self) -> list:
        a, b = self.window
        return [k for k in self.kernels if k[1] >= a and k[2] <= b]


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def clipped(spans, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def kind(name: str) -> str:
    """``qp``, ``tick`` or ``substep`` for the port's kernels, ``torch`` for
    every other device activity (ATen, cuBLAS, copies and fills)."""
    for k, v in HANDWRITTEN.items():
        if k in name:
            return v
    return "torch"


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (CPU and CUDA activity); on exit ``out["kernels"]``
    and ``out["host"]`` hold its device activities and host events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    kernels, events = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            events.append(span)
        elif e.name not in (WINDOW, TICK):  # the device side of the harness's own ranges
            kernels.append(span)
    out["kernels"], out["host"] = kernels, events


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and its
    longest idle gaps named by the innermost host event open across each."""
    ks = trace.in_window()
    by_name: dict = {}
    for n, a, b in ks:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    gaps, end = [], lo
    for _, a, b in sorted(ks, key=lambda k: k[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [(n, s, e) for n, s, e in trace.host if s <= mid <= e and n != WINDOW]
        what = min(open_, key=lambda h: h[2] - h[1])[0] if open_ else "no host event"
        named.append([what, (b - a) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
