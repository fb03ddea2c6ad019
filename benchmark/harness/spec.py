"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

- ``BENCHMARK.json`` (the checkout's root): the cell's ``config`` and
  ``traffic`` names and the metrics it reports;
- ``benchmark/configs/<config>.json``: the configuration as it is run,
  with its program entry and the reference's counterpart for each kind of
  loop (``entry``), named by import path;
- ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters,
  naming its kind of loop (``loop``) and its generator (``generator``);
- ``benchmark/harness/loops/<loop>.py``: the driver of one kind of loop;
- ``benchmark/traffic/<generator>.py``: a generator of inputs from a seed;
- ``benchmark/workloads/<cell>.json``: what the check of ``correct``
  samples and compares, and the limit of each number;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.

A later cell, configuration, traffic mix, loop, generator or metric is a
new file and a new entry of ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # benchmark/
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list  # the cell's entries of BENCHMARK.json's end_to_end
    per_layer: list  # and of its per_layer
    chips: int
    root: Path


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError`` if
    it has none of that name and ``FileNotFoundError`` if a file it names
    is missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / "benchmark"
    return Cell(
        name=name,
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        workload=json.loads((here / "workloads" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        chips=int(w["chips"]),
        root=root,
    )


def _module(root: Path, folder: str, name: str):
    """The module ``benchmark/<folder>/<name>.py`` of the checkout at
    ``root``, found by its name alone."""
    path = root / "benchmark" / folder / f"{name}.py"
    key = f"benchmark_{folder}_{name}".replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module  # a dataclass looks its module up by name
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell, device):
    """The driver of the cell's kind of loop (``harness/loops/<loop>.py``)."""
    return _module(cell.root, "harness/loops", cell.traffic["loop"]).Driver(cell, device)


def generator(cell: Cell):
    """The module that makes the cell's inputs (``traffic/<generator>.py``)."""
    return _module(cell.root, "traffic", cell.traffic["generator"])


def entry(cell: Cell) -> dict:
    """The configuration's entry for the cell's kind of loop: ``program``,
    ``reference`` and ``start`` (import paths), ``kwargs``."""
    return cell.config["entry"][cell.traffic["loop"]]


def resolve(path: str):
    """The object at an import path ``package.module.attribute``."""
    module, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    return _module(root, "metrics", name).read
