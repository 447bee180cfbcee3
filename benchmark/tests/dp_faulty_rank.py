"""A rank of a cell run over several processes (benchmark/dp_rank.py)
with a fault planted, for test_bench_dp.py:

    python -m benchmark.tests.dp_faulty_rank FAULT <dp_rank's arguments>

FAULT is one of ``FAULTS``; ``apply`` plants it in the harness's process
(rank 0) too.
"""
from __future__ import annotations

import os
import signal
import sys

FAULTS = ("none", "killed", "unchanged", "half", "altered", "exchange")


def apply(fault: str, rank: int) -> None:
    """Plant ``fault`` in this process, rank ``rank``: ``killed``, rank 1
    dies at the start of the window's first call; ``unchanged`` and
    ``altered``, rank 1's steps return their state unchanged or with the
    top level's global-mean temperature off (test_bench_faults.py);
    ``half``, on every rank half of its members are the mean of the
    others'; ``exchange``, the guard's all-reduce over the ranks is left
    out on every rank."""
    import torch.distributed as dist
    from benchmark import dp_rank
    from benchmark.tests import test_bench_faults as faults
    from speedy_tpu_torch.models import model as model_mod
    if fault not in FAULTS:
        raise ValueError(fault)
    if fault == "killed" and rank == 1:
        advance = dp_rank.Rank.advance
        calls = []

        def dying(self, days):
            calls.append(days)
            if len(calls) == 2:         # the first is the warm-up's
                os.kill(os.getpid(), signal.SIGKILL)
            return advance(self, days)
        dp_rank.Rank.advance = dying
    step = {"unchanged": faults.unchanged, "altered": faults.altered,
            "half": faults.half_batch}.get(fault)
    if step is not None and (rank == 1 or fault == "half"):
        model_mod.one_step = step(model_mod.one_step)
    if fault == "exchange":
        dist.all_reduce = lambda *a, **k: None


def main(argv) -> int:
    from benchmark import dp_rank
    fault, rest = argv[0], argv[1:]
    apply(fault, int(rest[rest.index("--rank") + 1]))
    return dp_rank.main(rest)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
