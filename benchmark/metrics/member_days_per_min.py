"""member_days_per_min: members x simulated days over the whole window,
host clock; the window is a whole number of calls and ends in a
synchronise."""


def read(run, name):
    return run.members * run.window_days / run.window_s * 60.0
