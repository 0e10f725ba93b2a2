"""Set-up: from the process's start to the window's, the inputs made,
the kernels built or loaded and the cell's shapes warmed (host clock)."""


def read(run):
    return run.setup_s
