"""capture_s: the benchmark's span around its warm-up call (the warm-up
day on a side stream and the capture of the cell's captured day, then its
first replay), host clock."""


def read(run, name):
    done = run.spans.done.get("capture")
    return done[0] if done else None
