"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

    python3 -m benchmark.control --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For each seed: the cell's set-up and a short window at its own load, then
the check's numbers for the program against the reference (the lower
readings, from sound runs), and on the control seeds for the control
against the reference: the reference itself computed with TF32 matmuls,
the nearest precision below the configuration's f32 (the upper readings).
One JSON line per seed and side; with ``--out`` the same lines and every
sampled gap, sorted, go to that file. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def readings(cell, device, seeds, control_seeds, seconds: float):
    """Yield ``(seed, side, numbers, gaps)`` for side ``program`` on every
    seed and ``control`` on the control seeds."""
    from benchmark.harness import check, spec

    d = spec.driver(cell, device)
    for seed in seeds:
        d.prepare(seed)
        d.warm_up()
        w = d.window(seconds)
        prog, extra = d.program_answers(w)
        # the reference runs while the program's graphs stay: the next seed reuses them
        r32 = d.reference_answers(w)
        sides = [("program", prog)]
        if seed in control_seeds:
            sides.append(("control", d.reference_answers(w, tf32=True)))
        for side, answers in sides:
            nums = check.numbers(answers, r32, cell.workload)
            if side == "program":
                nums.update(extra)
            gaps = {g: sorted(check.env_gaps(a, r32[g]).tolist()) for g, a in answers.items()}
            yield seed, side, nums, gaps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    run.set_caches(run.ROOT)
    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(args.workload, run.ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t0 = time.perf_counter()
    out = open(args.out, "a") if args.out else None
    try:
        for seed, side, nums, gaps in readings(cell, torch.device("cuda", 0), seeds, controls,
                                               args.seconds):
            line = {"workload": cell.name, "seed": seed, "side": side, "numbers": nums,
                    "at_s": round(time.perf_counter() - t0, 3)}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps({**line, "gaps": gaps}) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
