"""The QP kernel's share of its bound: the least time the solve's work
(counted from the cell's envs, horizon, rows and budget,
``benchmark/roofline/counts.py``) takes at the H100's peaks, over the
kernel's mean device time a launch in the traced window."""

from benchmark.harness import trace as tr
from benchmark.roofline import counts


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    ks = [(a, b) for name, a, b in t.in_window() if tr.kind(name) == "qp"]
    if not ks:
        return None
    mpc = {**cell.config["mpc"], **cell.traffic["budget"]}
    rows = 24 if mpc.get("mu_z") is None else 28
    work = counts.qp_solve_work(
        cell.traffic["envs"], mpc["h"], rows, n_iters=mpc["n_admm_iters"],
        n_phases=mpc["admm_rho_phases"], ns_iters=mpc["kinv_ns_iters"],
        polish=mpc["admm_polish"], bf16_iters=mpc["kinv_bf16_iters"])
    bound, _ = counts.qp_solve_bound_ms(work)
    ms = sum(b - a for a, b in ks) / len(ks) / 1e3
    return 100.0 * bound / ms
