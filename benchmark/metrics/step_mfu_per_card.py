"""step_mfu_per_card: the whole step's share of the float32 peak of the
cards the cell runs on (67 TFLOP/s each, outside the tensor cores), in %:
step_mfu's count (counts.step_operations, all the cell's members) times
the window's steps, over the window's seconds and the cell's cards. A
lower count; the card's power limit is printed beside it."""
from benchmark.counts import step_operations
from benchmark.peaks import PEAK_FLOPS


def read(run, name):
    if not run.window_days:
        return None
    ops = step_operations(run.shapes, run.cell.sppt, run.members) \
        * run.window_days * run.nsteps
    precision = run.shapes.get("precision", "fp32")
    return 100.0 * ops / run.window_s / PEAK_FLOPS[precision] \
        / run.cell.chips
