"""Runs one cell of ``BENCHMARK.json`` once and prints its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and check
are files under ``benchmark/`` found by name (``harness/spec.py``); the
program under test is ``biped_mpc_py_torch`` on one NVIDIA GPU.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number of the check of
``correct`` beside its limit, which are also the last lines of standard
error. Without a card, on fewer cards than the cell asks for, or where
JAX or the JAX package has been imported, it prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "biped_mpc_py_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port keeps its nvcc libraries in ``build/torch_kernels/`` itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def end_to_end(cell, values: dict) -> dict:
    """The cell's end-to-end metrics from the values its loop measured."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    missing = set(units) - set(values)
    if missing:
        raise ValueError(f"the harness measures no {sorted(missing)} for {cell.name}")
    return {n: {"value": values[n], "unit": u} for n, u in units.items()}


def per_layer(cell, w) -> dict:
    from benchmark.harness import spec

    ctx = {"trace": w.trace, "cell": cell}
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"], cell.root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell``: set-up, the window, the check; the result's
    fields (``compared`` last)."""
    from benchmark.harness import check, common, spec
    from benchmark.harness import trace as tr

    d = spec.driver(cell, device)
    d.prepare(seed)
    d.warm_up()
    setup_s = common.now() - t_start
    w = d.window(seconds, traced=trace)
    dev = common.device_record(device)
    out = {"correct": False}
    out["attempted"], out["failed"], line = d.accounting(w)
    log(line)
    if trace:
        busy = tr.union_us(tr.clipped([(a, b) for _, a, b in w.trace.kernels],
                                      *w.trace.window))
        dev["busy_s"] = busy * 1e-6
        dev["window_s"] = (w.trace.window[1] - w.trace.window[0]) * 1e-6
        out["metrics"] = per_layer(cell, w)
        out["breakdown"] = tr.breakdown(w.trace)
        w.trace = None
    else:
        out["metrics"] = end_to_end(cell, {**d.end_to_end(w), "setup_s": setup_s})
    out["device"] = dev
    # the program's answers are taken, then its graphs and the state it no longer needs
    # go before the reference runs
    prog, numbers = d.program_answers(w)
    d.release_program()
    common.release()
    ref = d.reference_answers(w)
    numbers = {**check.numbers(prog, ref, cell.workload), **numbers}
    ok, rows = check.judge(numbers, cell.workload["limits"])
    log("[check] " + json.dumps(numbers))
    out["correct"] = ok
    out["compared"] = rows
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_caches(ROOT)
    import torch

    import biped_mpc_py_torch  # noqa: F401  (the program under test: a checkout without it fails here)

    from benchmark.harness import spec

    cell = spec.load(args.workload, ROOT)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was imported: {found}")
        return 3
    for name, value, limit in result["compared"]:
        log(f"compared {name} {value!r} limit {limit!r}")
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
