"""sim_days_per_min: simulated days over the whole window, one model,
host clock; the window is a whole number of calls of the cell's chunk and
ends in a synchronise."""


def read(run, name):
    return run.window_days / run.window_s * 60.0
