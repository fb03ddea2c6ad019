"""Host-side structured logging: the counterpart of
``biped_mpc_py_tpu/utils/logging.py``.

One JSON line per event, written after the metrics have been copied off
the device, never inside the hot loop.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _leaves(tree) -> list:
    """The array leaves of nested dicts (sorted keys), lists and tuples, in
    ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def metrics_to_dict(metrics) -> dict:
    """Flatten a metrics object (e.g. ``RolloutMetrics``) to plain floats:
    each field summed over envs (``logging.py:18``); any other container of
    arrays to ``leaf_i`` sums."""
    out = {}
    if dataclasses.is_dataclass(metrics):
        for f in dataclasses.fields(metrics):
            v = _numpy(getattr(metrics, f.name))
            out[f.name] = float(v.sum()) if v.ndim else float(v)
    else:
        for i, leaf in enumerate(_leaves(metrics)):
            out[f"leaf_{i}"] = float(_numpy(leaf).sum())
    return out


def log_event(event: str, stream=sys.stderr, **fields) -> None:
    """Emit one structured JSON log line (``logging.py:33``)."""
    rec = {"ts": time.time(), "event": event, **fields}
    print(json.dumps(rec), file=stream, flush=True)
