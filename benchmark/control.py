"""The readings that the limits of ``correct`` are set from: for a cell
and a list of seeds, in one process, each seed's run (set-up, a window of
``--seconds``, the check's day) judged twice against the float64
reference: the program's numbers, and the control's (the reference itself
in the program's place, in float32 with TF32 matrix products, the
precision below the configuration's). Prints one JSON line per seed.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--no-control] [--steps N] [--other]

``--steps`` and ``--other`` read more than the cell's limits ask for: the
fields of the check day's first N steps, and the end state of the timed
entry's other path (``fast``, ``ckpt``).

The benchmark's own runs never run the control. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import check as chk
from benchmark import harness


def readings(cell: harness.Cell, seed: int, seconds: float,
             with_control: bool = True, device: str = "cuda",
             steps: int = 0, other: bool = False) -> dict:
    """One seed's program numbers and, with ``with_control``, the
    control's."""
    import torch
    run = harness.Run(cell, seed, seconds, False, device,
                      time.perf_counter())
    run.check_steps, run.check_other = steps, other
    driver = harness.make_driver(run)
    try:
        harness.start(run, driver, log=lambda *a, **k: None)
        harness.window(run, driver, seconds)
        pair = driver.check_day()
        driver.free()
        if device == "cuda":
            torch.cuda.empty_cache()
        out = {"seed": seed, "days": run.window_days + 1,
               "program": chk.evaluate(run, pair)}
        if with_control:
            out["control"] = chk.evaluate(run, pair, control=True)
    finally:
        driver.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--other", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    from benchmark.run import environment
    environment()
    cell = harness.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = readings(cell, seed, args.seconds, not args.no_control,
                       steps=args.steps, other=args.other)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
