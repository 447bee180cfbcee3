"""One rank of a cell that runs its ensemble over several cards
(drivers/ensemble_dp.py): the program's ensemble on the rank's block of
the members, built as the program's CLI builds it under torchrun, and
driven one call at a time.

Rank 0 is the harness's own process. Every further rank is a process of
this module, which rank 0 starts and drives over its pipes: one
command a line on standard input, one answer a line on the standard
output the process was started with (the program's own prints go to
standard error):

    python -m benchmark.dp_rank --root DIR --workload CELL --seed N \
        --rank R --port P [--device cpu]

The process answers ``started`` once its imports are done and ``ready``
once it has joined the process group and booted, then takes the
commands ``advance <days>`` (the ensemble's ``run_days``, unprofiled),
``check <steps> <other>`` (its part of the check's collectives with rank
0) and ``close``. An answer is ``ok <word> <json>``, or ``error <text>``,
after which the process exits. Before each answer it looks for modules of
JAX or the JAX package and, finding one, answers ``error``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time
import traceback
from types import SimpleNamespace
from typing import List, Optional

from benchmark import harness, program
from benchmark.check import arrays

# the stability guard's error names the first day and member it rejects
TRIPPED = re.compile(r"at day (\d+), member (\d+)")


class Rank:
    """One rank's program: its process group, its place in a (chips, 1)
    dp mesh, the model on its card (``cuda:<rank>``, or the CPU), and the
    cell's ensemble over the mesh, booted and perturbed from the run's
    seed. Every rank makes the same calls in the same order."""

    def __init__(self, run, rank: int, port: int):
        self.run, self.rank, self.port = run, rank, port
        self.world = run.cell.chips
        self.on_card = run.device == "cuda"
        self.mesh = self.model = self.ens = None
        self.state = self.first = self.boot = None

    def setup(self) -> None:
        """As ``python -m speedy_tpu_torch ensemble`` under torchrun: the
        process group (its backend follows from the device: NCCL on the
        cards, Gloo on the CPU), the mesh, the model on the rank's device,
        ``Ensemble(..., mesh=)``, its boot; then the run's perturbation."""
        from speedy_tpu_torch.parallel.ensemble import Ensemble
        from speedy_tpu_torch.parallel.mesh import (initialize_distributed,
                                                    make_mesh)
        run = self.run
        initialize_distributed(f"localhost:{self.port}", self.world,
                               self.rank,
                               device=None if self.on_card else "cpu")
        self.mesh = make_mesh(self.world, 1, device=f"cuda:{self.rank}"
                              if self.on_card else "cpu")
        self.model = program.build_model(SimpleNamespace(
            cell=run.cell, device=self.mesh.device))
        self.ens = Ensemble(self.model, run.members, base_seed=run.seed,
                            mesh=self.mesh)
        self.date = program.start_date(run)
        state = self.ens.initialize(self.date)
        if self.rank == 0:
            # every member is booted alike: global member 0's is compared
            self.boot = {k: v[0].clone() for k, v in arrays(state).items()}
        # the window's start, which the entry leaves as it was
        self.first = self.state = program.perturb(run, state)

    def advance(self, days: int) -> int:
        self.state, self.date = self.ens.run_days(self.state, self.date,
                                                  days)
        return days

    def check(self, steps: int, other: bool) -> Optional[dict]:
        """This rank's part of the check, the first day once more from the
        window's start: its end state, and where asked the same day
        through the output day (``run_days`` with writers): its end state
        and its first ``steps`` steps' fields; each brought to rank 0
        (states by ``convert.gather_members``, fields by
        ``gather_object``); then the guard's trip (``trip``). Rank 0 gets
        ``{"start", "end", "other_end", "steps", "trip"}`` (numpy trees
        and lists of every member in global order), the others None."""
        import torch.distributed as dist
        from speedy_tpu_torch.convert import gather_members
        ens, date = self.ens, program.start_date(self.run)
        end, _ = ens.run_days(self.first, date, 1)
        out = {"start": gather_members(self.first, self.mesh),
               "end": gather_members(end, self.mesh),
               "other_end": None, "steps": None}
        if steps or other:
            writers = [program._noop_writer] * ens.n_local
            o, _ = ens.run_days(self.first, date, 1, output_writers=writers)
            out["other_end"] = gather_members(o, self.mesh)
            mine = [{k: v.float().numpy() for k, v in s.items()}
                    for s in program.buffered_steps(self.model, self.first,
                                                    steps)]
            parts = [None] * self.world if self.rank == 0 else None
            dist.gather_object(mine, parts, dst=0)
            out["steps"] = parts
        out["trip"] = self.trip()
        return out if self.rank == 0 else None

    def trip(self) -> Optional[List[Optional[str]]]:
        """The guard over the ranks: the last rank pushes its first
        member's temperature out of the guard's range (+300 K in the global
        mean of every level) and every rank runs one day from the window's
        start. Each rank's error message (None where it raised none), on
        rank 0; None elsewhere."""
        import torch.distributed as dist
        from speedy_tpu_torch.utils.diagnostics import InstabilityError
        state = self.first
        if self.rank == self.world - 1:
            t = state.prog.t.clone()
            t[0, :, :, 0, 0, 0] += 300.0 * math.sqrt(2.0)
            state = state._replace(prog=state.prog._replace(t=t))
        said = None
        try:
            self.ens.run_days(state, program.start_date(self.run), 1)
        except InstabilityError as e:
            said = str(e)
        parts = [None] * self.world if self.rank == 0 else None
        dist.gather_object(said, parts, dst=0)
        return parts

    def peak_bytes(self) -> int:
        """The peak of memory allocated on this rank's card so far."""
        import torch
        return torch.cuda.max_memory_allocated(self.mesh.device) \
            if self.on_card else 0

    def planted(self) -> int:
        """The global member the trip pushes out of range."""
        return (self.world - 1) * (self.run.members // self.world)

    def free(self) -> None:
        self.model = self.ens = self.state = self.first = self.boot = None

    def end(self) -> None:
        """This process's process group destroyed, where it has one."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def trip_share(said: List[Optional[str]], planted: int) -> float:
    """The share of ranks whose guard did not raise at the day and member
    where the planted member's rank did; 1 where that rank raised none,
    or named another member."""
    found = [TRIPPED.search(s or "") for s in said]
    keys = [(int(m.group(1)), int(m.group(2))) if m else None
            for m in found]
    holder = keys[-1]
    if holder is None or holder[1] != planted:
        return 1.0
    return sum(k != holder for k in keys) / len(keys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    # answers on the standard output given; whatever else prints goes to
    # standard error
    answers = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)

    def answer(word: str, payload=None) -> None:
        names = harness.forbidden_modules()
        if names:
            raise RuntimeError("modules of JAX or the JAX package loaded: "
                               + ", ".join(names))
        answers.write(f"ok {word} {json.dumps(payload)}\n")

    try:
        cell = harness.Cell(args.workload, root=args.root)
        run = harness.Run(cell, args.seed, 0.0, False, args.device,
                          time.perf_counter())
        rank = Rank(run, args.rank, args.port)
        import speedy_tpu_torch.parallel.ensemble  # noqa: F401
        answer("started")
        rank.setup()
        answer("ready")
        while True:
            cmd, *rest = sys.stdin.readline().split() or ["close"]
            if cmd == "advance":
                answer("advanced", rank.advance(int(rest[0])))
            elif cmd == "check":
                # the window's peak, read as rank 0's is, before the check
                peak = rank.peak_bytes()
                rank.check(int(rest[0]), bool(int(rest[1])))
                answer("checked", peak)
            elif cmd == "close":
                break
            else:
                raise ValueError(f"unknown command {cmd!r}")
        rank.free()
        rank.end()
        answer("closed")
        return 0
    except Exception as e:   # noqa: BLE001  rank 0 is told, then the process ends
        traceback.print_exc()
        text = f"rank {args.rank}: {type(e).__name__}: {e}"
        answers.write("error " + " ".join(text.split()) + "\n")
        answers.flush()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
