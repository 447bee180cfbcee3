"""writer_ms_per_day: the benchmark's spans around each call of the writer
it passes to ``Model.run``, summed over the window and divided by its
days, host clock."""


def read(run, name):
    days = run.day_seconds()
    if not days:
        return None
    calls = run.spans.done.get("writer", [])
    stamps = run.spans.stamps.get("writer", [])
    end = run.window_start + sum(days)
    total = sum(d for d, t in zip(calls, stamps)
                if run.window_start < t <= end)
    return total / len(days) * 1e3
