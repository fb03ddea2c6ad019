"""Profiling and timing helpers: the counterpart of
``biped_mpc_py_tpu/utils/profiling.py``.

:func:`trace` captures a ``torch.profiler`` trace (the card's kernels too,
where there is one), :data:`scope` labels a stage in it, and
:func:`time_fn` times a function in its steady state: with CUDA events when
its tensors are on the card, with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

scope = torch.profiler.record_function  # stage labels inside traced code


@contextlib.contextmanager
def trace(dir_path: str | None = None):
    """Capture a ``torch.profiler`` trace of the block into
    ``dir_path/trace.json`` (Chrome trace format; default a directory under
    the temporary directory). Yields the directory."""
    dir_path = dir_path or os.path.join(tempfile.gettempdir(), "biped_torch_trace")
    os.makedirs(dir_path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield dir_path
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if hasattr(tree, "__dataclass_fields__"):
        return any(_on_cuda(getattr(tree, k)) for k in tree.__dataclass_fields__)
    return False


def time_fn(fn, *args, warmup: int = 2, iters: int = 10) -> dict:
    """Steady-state time of ``fn(*args)`` (seconds per call) after
    ``warmup`` calls (``profiling.py:31``): CUDA events around ``iters``
    calls when the arguments or the result hold CUDA tensors, else the host
    clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_cuda(args) or _on_cuda(out):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) * 1e-3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"sec_per_call": dt, "calls_per_sec": 1.0 / dt}
