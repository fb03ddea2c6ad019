"""The device the port's entry points build on.

The constructors a user calls first (``init_world``, ``batch_worlds``,
``randomize_params``, ``init_art_world``, ``hector_model``, the ``Terrain``
constructors) build on the card unless the caller names another device, for
example ``device="cpu"``. Without a card they raise at once: nothing falls
back to the CPU.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def entry_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raise if it is a CUDA device and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to build on the CPU"
        )
    return dev


def host_to_device(values, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host values (a numpy array or a sequence of numbers) as a new tensor
    of ``dtype`` on ``device``. To the card they go through pinned memory
    with a non-blocking copy: a copy from pageable memory (what
    ``torch.tensor(list, device="cuda")`` makes) synchronizes the stream,
    and the card would then idle while the host queues the rest of the
    tick."""
    t = torch.tensor(np.asarray(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` reads them (a card set below its
    maximum runs slower under load), or why they were not read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__}: {e})"
