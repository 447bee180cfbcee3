"""``Model.run`` with output, as a user's production run: a restart chain
of calls of the cell's chunk of days, each resumed from the state and date
the last one ended at, writing the gridded fields every ``nsteps_out``
steps through the native asynchronous NetCDF writer and a checkpoint at
each call's end. The benchmark wraps the writer it passes in, so each
writer call is a span (a day ends at one). Files go under ``TMPDIR`` and
are deleted when the run ends."""
from __future__ import annotations

import os
import shutil
import tempfile

from benchmark import program
from benchmark.check import arrays, asked
from benchmark.inputs import as_tuple


class Driver:
    def __init__(self, run):
        self.run = run
        self.dir = None

    def setup(self) -> None:
        from speedy_tpu_torch.utils.native_output import AsyncNetCDFWriter
        run = self.run
        self.model = program.build_model(run)
        self.dir = tempfile.mkdtemp(prefix="speedy-bench-",
                                    dir=os.environ.get("TMPDIR"))
        self.writer = AsyncNetCDFWriter(self.model.cfg,
                                        os.path.join(self.dir, "out"))
        self.run_start = self.date = program.start_date(run)
        state = self.model.initialize(self.date)
        self.boot = arrays(state)
        # the chain's start, which the entry leaves as it was
        self.first = self.state = program.perturb(run, state)
        self.model_step = 0
        self.files = []

    def _write(self, step, date, start, fields):
        with self.run.spans.span("writer"):
            self.files.append(self.writer(step, date, start, fields))

    def _call(self, days: int, sub: str = "ckpt") -> int:
        cfg = self.model.cfg
        end = program.add_days(self.date, days, cfg.nsteps)
        self.state = self.model.run(
            self.run_start, end, output_writer=self._write, verbose=False,
            state=self.state, resume_date=self.date,
            model_step=self.model_step, checkpoint_every=days,
            checkpoint_dir=os.path.join(self.dir, sub))
        self.model_step += days * cfg.nsteps
        self.date = end
        return days

    def warm_up(self) -> None:
        self._call(1)

    def chunk(self) -> int:
        return self._call(int(self.run.cell.params["chunk_days"]))

    def profile_call(self, days: int):
        return lambda: self._call(days)

    def check_day(self) -> dict:
        """The chain's first day once more, from its start, into files of
        its own: the fields written at step 0 and at the day's end, the
        checkpoint written at its end with the end state the call returned,
        and the first steps' fields from the output day's buffer (every
        step's fields, which ``Model.run`` fetches each day)."""
        cfg, start = self.model.cfg, self.run_start
        self.date, self.state, self.model_step = start, self.first, 0
        first_file = len(self.files)
        self._call(1, "check")
        self.writer.drain()
        steps, _ = asked(self.run)
        d = program.add_days(start, 1, cfg.nsteps)
        ckpt = os.path.join(self.dir, "check", f"ckpt_{d.year:04d}"
                            f"{d.month:02d}{d.day:02d}{d.hour:02d}"
                            f"{d.minute:02d}.npz")
        per_day = cfg.nsteps // cfg.nsteps_out
        return {"kind": "files", "boot": self.boot,
                "start": arrays(self.first), "checkpoint": ckpt,
                "fields0_file": self.files[first_file],
                "fields_file": self.files[first_file + per_day],
                "other_end": arrays(self.state),
                "steps": program.buffered_steps(self.model, self.first,
                                                steps),
                "date": as_tuple(start), "run_start": as_tuple(start)}

    def built_libraries(self) -> bool:
        return program.built_libraries()

    def free(self) -> None:
        self.model = self.state = self.first = None

    def close(self) -> None:
        self.free()
        if self.dir is not None:
            try:
                self.writer.drain()
            finally:
                shutil.rmtree(self.dir, ignore_errors=True)
                self.dir = None
