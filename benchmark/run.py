"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last the compared numbers with their limits under
``checks``); the compared numbers are also the last lines of standard
error. Without a card, with fewer cards than the cell asks for, without the
program, or with JAX loaded, it exits with another code than 0 and prints
no result.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from benchmark import harness  # noqa: E402


def environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX behind a
    library's back."""
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(harness.CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from benchmark.peaks import card_line
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    try:
        result = harness.drive(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_PROCESS,
                               log=print)
    except Exception:
        traceback.print_exc()
        return 1
    result["card"] = card
    names = harness.forbidden_modules()
    if names:
        print("benchmark: loaded " + ", ".join(names), file=sys.stderr)
        return 1
    checks = result.pop("checks")
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
