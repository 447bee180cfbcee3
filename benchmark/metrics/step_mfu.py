"""step_mfu: the whole step's share of the H100's float32 peak outside the
tensor cores (67 TFLOP/s), in %: the step's counted operations
(counts.step_operations: the transforms over nonzero table entries and the
column physics' 100 operations a level a column, times the members) times
the window's steps, over the window's seconds. A lower count; the card's
power limit is printed beside it."""
from benchmark.counts import step_operations
from benchmark.peaks import PEAK_FLOPS


def read(run, name):
    if not run.window_days:
        return None
    ops = step_operations(run.shapes, run.cell.sppt, run.members) \
        * run.window_days * run.nsteps
    precision = run.shapes.get("precision", "fp32")
    return 100.0 * ops / run.window_s / PEAK_FLOPS[precision]
