"""``Ensemble.run_days`` over several cards: the cell's members split over
a (chips, 1) dp mesh, one process a card, as the program's CLI runs an
ensemble under torchrun (NCCL; Gloo on the CPU). Each call of the window
is a forecast of the cell's chunk of days on every rank, from the state
and date the last one ended at; the guard's one all-reduce at each
call's end holds the ranks together, so rank 0's call ends with every
card's. The members' SPPT base seed is the run's seed.

The harness's process is rank 0 (benchmark/dp_rank.py ``Rank``): it
starts a process of ``benchmark.dp_rank`` for each further card and sends
each the calls it makes itself, one line each, without waiting for their
answers inside the window. A rank that ends or raises ends rank 0's
current call: its collectives are aborted (NCCL) or fail (Gloo), and the
call raises. ``close`` reaps every rank.

The check (check.py) covers every member: each rank runs the first day
again from its own perturbed start, and its members' start and end states
and the output day's first steps are brought to rank 0. Then the guard's
trip: the last rank's first member is pushed out of range and every rank
runs one day; a rank whose guard does not raise there, naming that member,
makes the check day a failed call (``trip`` on standard error, limit 0).
"""
from __future__ import annotations

import json
import os
import queue
import socket
import subprocess
import sys
import threading
from typing import Dict, List, Optional

import numpy as np

from benchmark import harness, program
from benchmark.check import asked
from benchmark.dp_rank import Rank, trip_share
from benchmark.inputs import as_tuple

# seconds to wait for the other ranks' answers: in set-up (a checkout's
# first run builds the program's libraries) and after the window
SETUP_WAIT = 1200.0
WAIT = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def as_arrays(tree) -> Dict[str, "torch.Tensor"]:
    """A numpy tree (``convert.model_state_to_numpy``) as ``check.arrays``
    gives a state: float64 tensors by ``group.field``."""
    import torch
    return {f"{g}.{f}": torch.from_numpy(np.asarray(v, np.float64))
            for g, sub in tree.items() for f, v in sub.items()}


class Driver:
    # a further rank's process, less its arguments
    worker = [sys.executable, "-m", "benchmark.dp_rank"]

    def __init__(self, run):
        self.run = run
        self.procs: List[subprocess.Popen] = []
        self.answers: List[queue.Queue] = []
        self.readers: List[threading.Thread] = []
        self.me: Optional[Rank] = None
        self.fault: Optional[str] = None
        self.pending = 0
        self.closing = False
        self.aborted = False
        self.lock = threading.Lock()

    # -- the other ranks ----------------------------------------------
    def _start_workers(self, port: int) -> None:
        run = self.run
        cell = run.cell
        for r in range(1, cell.chips):
            p = subprocess.Popen(
                self.worker + [
                    "--root", os.path.dirname(cell.package_dir),
                    "--workload", cell.name, "--seed", str(run.seed),
                    "--rank", str(r), "--port", str(port),
                    "--device", run.device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                bufsize=1, cwd=harness.ROOT)
            q: queue.Queue = queue.Queue()
            t = threading.Thread(target=self._read, args=(r, p, q),
                                 daemon=True)
            t.start()
            self.procs.append(p)
            self.answers.append(q)
            self.readers.append(t)

    def _read(self, r: int, p: subprocess.Popen, q: queue.Queue) -> None:
        """Rank ``r``'s answers into ``q``; at its end, None, and unless
        rank 0 is closing, a fault."""
        last = ""
        for line in p.stdout:
            last = line.strip()
            q.put(last)
        q.put(None)
        if not self.closing:
            self._fail(last if last.startswith("error") else
                       f"rank {r} ended (exit code {p.poll()})")

    def _fail(self, why: str) -> None:
        """Record the first fault and end rank 0's collectives: under NCCL
        a collective waits on the device for a rank that is gone, so the
        process group is aborted; under Gloo the closed connection fails
        it."""
        with self.lock:     # the readers' threads and the main thread
            if self.fault is None:
                self.fault = why
                print(f"ensemble_dp: {why}", file=sys.stderr, flush=True)
            if self.me is not None and self.me.mesh is not None \
                    and self.me.mesh.backend == "nccl" and not self.aborted:
                self.aborted = True
                abort_process_group()

    def _send(self, line: str) -> None:
        if self.fault:
            raise RuntimeError(self.fault)
        for r, p in enumerate(self.procs, 1):
            try:
                p.stdin.write(line + "\n")
                p.stdin.flush()
            except OSError:
                self._fail(f"rank {r} took no command ({line})")
                raise RuntimeError(self.fault)
        self.pending += 1

    def _wait(self, word: str, timeout: float) -> List:
        """Each other rank's next answer, which must be ``word``: its
        payloads."""
        got = []
        for r, q in enumerate(self.answers, 1):
            try:
                line = q.get(timeout=timeout)
            except queue.Empty:
                self._fail(f"rank {r} gave no answer in {timeout:.0f} s")
                raise RuntimeError(self.fault)
            if line is None or not line.startswith(f"ok {word}"):
                self._fail(line or f"rank {r} ended")
                raise RuntimeError(self.fault)
            got.append(json.loads(line.split(" ", 2)[2]))
        return got

    def _sync(self, timeout: float = WAIT) -> None:
        """The answers of every call sent since the last sync."""
        while self.pending:
            self._wait("advanced", timeout)
            self.pending -= 1

    def _call(self, days: int) -> int:
        """``days`` on every rank: the others told first, then rank 0's own
        call, with no wait for their answers."""
        self._send(f"advance {days}")
        self.me.advance(days)
        if self.fault:
            raise RuntimeError(self.fault)
        return days

    # -- the harness's interface ----------------------------------------
    def setup(self) -> None:
        import speedy_tpu_torch.parallel.ensemble  # noqa: F401  fails here without the program
        port = free_port()
        self._start_workers(port)
        self._wait("started", SETUP_WAIT)
        self.me = Rank(self.run, 0, port)
        self.me.setup()
        self._wait("ready", SETUP_WAIT)

    def warm_up(self) -> None:
        self._call(1)
        self._sync(SETUP_WAIT)

    def chunk(self) -> int:
        return self._call(int(self.run.cell.params["chunk_days"]))

    def profile_call(self, days: int):
        self._sync()
        return lambda: self._call(days)

    def check_day(self) -> dict:
        """The check's pair of every member (see the module's docstring),
        and the guard's trip."""
        import torch
        self._sync()
        run = self.run
        steps, other = asked(run)
        self._send(f"check {steps} {int(other)}")
        got = self.me.check(steps, other)
        peaks = self._wait("checked", WAIT)
        print(f"memory_peak_bytes of ranks 1-{len(peaks)}: {peaks}",
              file=sys.stderr)
        share = trip_share(got["trip"], self.me.planted())
        print(f"trip {share!r} limit 0 (member {self.me.planted()}: "
              f"{got['trip']!r})", file=sys.stderr)
        if share > 0:
            run.failed += 1
        out_steps = None
        if got["steps"] is not None:
            out_steps = [{k: torch.from_numpy(np.concatenate(
                [part[i][k] for part in got["steps"]]).astype(np.float64))
                for k in got["steps"][0][i]} for i in range(steps)]
        date = as_tuple(program.start_date(run))
        seeds = [run.seed + g for g in range(run.members)] \
            if run.cell.sppt else None
        return {"kind": "state", "boot": self.me.boot,
                "start": as_arrays(got["start"]),
                "end": as_arrays(got["end"]),
                "other_end": None if got["other_end"] is None
                else as_arrays(got["other_end"]),
                "steps": out_steps, "sppt_seeds": seeds,
                "date": date, "run_start": date}

    def built_libraries(self) -> bool:
        return program.built_libraries()

    def free(self) -> None:
        """Rank 0's program freed; after a sound run every rank's process
        group ended together, the other ranks told to close."""
        if self.me is None:
            return
        if not self.fault and not self.closing:
            self.closing = True
            try:
                self._send("close")
            except RuntimeError:
                pass
            else:
                self.me.end()
        self.me.free()

    def close(self) -> None:
        """Every other rank ended (killed where it does not end by itself
        in time: at once after a fault), then rank 0's process group."""
        sound = self.closing and not self.fault
        self.closing = True
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
            try:
                p.wait(timeout=WAIT if sound else 5.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in self.readers:
            t.join(timeout=5.0)
        errors = [line for q in self.answers for line in list(q.queue)
                  if line and line.startswith("error")]
        if self.me is not None:
            self.me.free()
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            # after a fault an NCCL group may wait on a rank that is gone
            if dist.get_backend() != "nccl":
                dist.destroy_process_group()
            else:
                with self.lock:
                    if not self.aborted:
                        self.aborted = True
                        abort_process_group()
        if errors and not self.fault:
            raise RuntimeError("; ".join(errors))


def abort_process_group() -> None:
    """Abort every process group of this process, so that a collective
    waiting on a rank that is gone returns."""
    import torch.distributed as dist
    try:
        dist.distributed_c10d._abort_process_group()
    except Exception as e:   # noqa: BLE001  reported; the call fails anyway
        print(f"ensemble_dp: abort failed: {e!r}", file=sys.stderr,
              flush=True)
