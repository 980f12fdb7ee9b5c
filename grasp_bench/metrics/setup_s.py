"""Set-up of the run, from the process's start to the window's: imports,
the kernels' build or cache load, weights and the detector, the scene
pool, the warm-up calls."""

UNIT = "s"


def read(run, name):
    return run.setup_s
