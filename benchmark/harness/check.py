"""The comparison that decides ``correct``: the program's answers against
the plain reference's, number by number, each against its limit from the
cell's workload file (``benchmark/workloads/<cell>.json``: ``limits``).

Batched cells: the kept call's first tick, as the program's own graph
replays it, against the reference's step of that tick from the same input
world, env by env. The one-robot cell: for a sample of ticks, the
reference solves the tick from the reads the plant served and the
controller state the program carried into it, then runs the eight
low-level periods. A sample's gap in a group of answers (pose, velocity,
force; torques, carried state) is its largest absolute difference there.

Each group's numbers are the median of its gaps over the sample, the
share of samples whose gap exceeds the group's threshold (the workload
file's ``over``) and, where the workload file gives the group a
``tail`` threshold far out in the sound runs' gaps, the count of samples
past it: the first moves with a change of precision on every sample, the
second with a fault in some, the third with a fault in a handful of
envs of thousands. Batched cells also compare the call replayed by the
program's own graph with the window's answer (``replay``, exact) and
count the envs left non-finite at the window's end (``nonfinite_envs``).
"""

from __future__ import annotations

import math

import torch


def env_gaps(prog: dict, ref: dict) -> torch.Tensor:
    """Per-env largest |prog - ref| over the given (N, ...) tensors. A value
    that is not finite on one side only counts as an infinite gap; one not
    finite on both sides (an env whose physics diverged in both) as none."""
    cols = []
    for name, a in prog.items():
        a, b = a.float().reshape(a.shape[0], -1), ref[name].float().reshape(a.shape[0], -1)
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        d = torch.where(fa & fb, (a - b).abs(), torch.where(fa | fb, math.inf, 0.0))
        cols.append(d.amax(1))
    return torch.stack(cols, 1).amax(1)


def bit_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """0.0 where ``a`` and ``b`` are equal value for value (NaN where the
    other is NaN), else the largest |a - b| (infinite where only one is
    NaN)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if torch.equal(na, nb) and torch.equal(a[~na], b[~nb]):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.where(na ^ nb, math.inf, d.nan_to_num(0.0)).max())


def numbers(prog: dict, ref: dict, workload: dict) -> dict:
    """Every compared number of two sets of answers ``{group: {name:
    (N, ...) tensor}}``: for each group, the median of the per-sample gaps
    (``<group>.p50``), the share in % of samples whose gap exceeds the
    group's threshold in the workload's ``over`` (``<group>.share_over``)
    and, for a group in its ``tail``, the count of samples whose gap
    exceeds that threshold (``<group>.tail_count``)."""
    out, tail = {}, workload.get("tail", {})
    for group, answers in prog.items():
        g = env_gaps(answers, ref[group]).double().cpu()
        if not len(g):
            out[f"{group}.p50"] = out[f"{group}.share_over"] = math.nan
            continue
        out[f"{group}.p50"] = float(torch.quantile(g.nan_to_num(math.inf), 0.5))
        out[f"{group}.share_over"] = 100.0 * float((g > workload["over"][group]).double().mean())
        if group in tail:
            out[f"{group}.tail_count"] = float((g > tail[group]).sum())
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every limited number within its limit, ``[[name, value, limit],
    ...]``). A number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        passed = math.isfinite(v) and v <= limit
        ok = ok and passed
        rows.append([name, v, limit])
    return ok, rows
