"""The share of sole-point substeps below the ground in the program's last
replayed tick, in %: the program's device counter of sole points below
their height field (``profiling.terrain_contacts()``), one add a substep,
zeroed at each tick's start. A program without the counter gives None."""


def read(ctx):
    from biped_mpc_py_torch.utils import profiling

    share = getattr(profiling, "terrain_contacts", lambda: None)()
    return None if share is None else 100.0 * share
