"""Command-line driver (the JAX package's speedy_tpu/cli.py).

    python -m speedy_tpu_torch run --synthetic-bc 0 --start 1982-01-01 \\
        --end 1982-01-02
    python -m speedy_tpu_torch ensemble --synthetic-bc 0 --members 8
    torchrun --nproc-per-node 4 -m speedy_tpu_torch ensemble \\
        --synthetic-bc 0 --members 8

The same sub-commands, flags, defaults and printed lines as the JAX CLI,
with two flags that the port's setting asks for: ``--device`` (``cuda``
by default; a run never falls back to the CPU) and ``--synthetic-bc SEED``
(the seeded stand-in boundary set of utils/synthetic_bc.py, in memory, in
place of the boundary files of ``--bc-path``, which are not in the
repository). Where the JAX CLI shards ``ensemble``'s members over the
devices of one controller, the port runs one process per GPU under
torchrun (parallel/mesh.py): each rank runs its block of members
(``--device cuda`` means ``cuda:LOCAL_RANK``; ``--device cuda:0`` puts
every rank on one GPU, over Gloo, since NCCL refuses a GPU twice), and
rank 0 gathers the members and writes their final files. The reference's
namelist file is accepted as it is (``--namelist``). Output goes through
the native asynchronous writer (utils/native_output.py) and, where it
cannot be built, the scipy writer (utils/output.py); a line names the
writer taken.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import sys
import time

from .config import from_preset, PRESETS
from .utils import tracing
from .utils.calendar import Datetime

# --matmul-precision (the JAX package's XLA names) ->
# torch.set_float32_matmul_precision
MATMUL_PRECISION = {"float32": "highest", "highest": "highest",
                    "tensorfloat32": "high", "bfloat16": "medium"}


def parse_namelist(path: str) -> dict:
    """Parse the reference's namelist.nml (&params and &date groups;
    params.f90:54-68, date.f90:57-71)."""
    out = {}
    with open(path) as f:
        text = f.read()
    for m in re.finditer(r"^\s*([\w%]+)\s*=\s*(\S+)", text, re.M):
        key, val = m.group(1).lower(), m.group(2).rstrip(",")
        try:
            out[key] = int(val)
        except ValueError:
            pass
    return out


def _dt(s: str) -> Datetime:
    m = re.match(r"(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2}):(\d{2}))?", s)
    if not m:
        raise argparse.ArgumentTypeError(f"bad datetime {s!r}")
    g = [int(x) if x else 0 for x in m.groups()]
    return Datetime(*g)


def _device(s: str) -> str:
    if s in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", s):
        return s
    raise argparse.ArgumentTypeError(f"bad device {s!r}: cuda, cuda:N or "
                                     "cpu")


def add_boundary_args(p: argparse.ArgumentParser) -> None:
    """--bc-path or --synthetic-bc, and --device."""
    bc = p.add_mutually_exclusive_group()
    bc.add_argument("--bc-path", help="boundary-condition directory")
    bc.add_argument("--synthetic-bc", type=int, metavar="SEED",
                    help="run on the seeded stand-in boundary set "
                         "(utils/synthetic_bc.py) instead of files")
    p.add_argument("--device", default="cuda", type=_device,
                   help="device to run on: cuda, cuda:N or cpu (default "
                        "cuda; never falls back to the CPU)")


def boundary_kwargs(args) -> dict:
    """Model's boundary arguments from add_boundary_args' flags."""
    if args.synthetic_bc is not None:
        from .utils.synthetic_bc import synthetic_boundaries
        return dict(bc_arrays=synthetic_boundaries(args.synthetic_bc))
    return dict(bc_search=[args.bc_path] if args.bc_path else None)


def make_writer(cfg, outdir: str):
    """The native asynchronous writer into ``outdir`` or, where it cannot
    be built or loaded, the scipy writer; returns (writer, a line naming
    the writer taken and, on a fall-back, why)."""
    try:
        from .utils.native_output import AsyncNetCDFWriter
        return AsyncNetCDFWriter(cfg, outdir), \
            "output writer: native asynchronous (utils/native_output.py)"
    except (RuntimeError, OSError) as e:
        from .utils.output import NetCDFWriter
        reason = " ".join(str(e).split())[:300]
        return NetCDFWriter(cfg, outdir), \
            f"output writer: scipy (utils/output.py); native unavailable: " \
            f"{reason}"


def _drain(writer) -> None:
    if hasattr(writer, "drain"):
        writer.drain()


def synchronize(model) -> None:
    """Wait for the model's device (a no-op on the CPU)."""
    if model.device.type == "cuda":
        import torch
        torch.cuda.synchronize(model.device)


def counter_line() -> str:
    """The end-of-run line of the program's counters (utils/tracing.py):
    column-physics kernel launches, graph captures and the megabytes the
    staged days copied to the host."""
    c = tracing.counters
    return (f"column-physics kernel launches {c['k1.launches']} "
            f"(sw {c['k1.launches_sw']}), graph captures "
            f"{c['graph.captures']}, fetched {c['d2h.bytes'] / 1e6:.3f} MB")


def write_spans(path: str, t0: float, t1: float) -> None:
    """The program's spans and counter events (utils/tracing.py) that
    ended within [t0, t1] of ``time.perf_counter``, as JSON: ``t0``, the
    profile's start on that clock, ``spans`` (name, start, end, id,
    parent id) and ``counts`` (name, time, amount); ``whole`` is false
    where the ring had dropped some of them."""
    spans, counts = [], []
    for e in tracing.events():
        if t0 <= e.end <= t1:
            if e.seq < 0:
                counts.append([e.name, e.start, e.n])
            else:
                spans.append([e.name, e.start, e.end, e.seq, e.parent])
    with open(path, "w") as f:
        json.dump({"t0": t0, "whole": tracing.whole_since(t0),
                   "spans": spans, "counts": counts}, f)


@contextlib.contextmanager
def _profiled(directory, device):
    """A torch.profiler trace of the block written into ``directory``
    (the counterpart of jax.profiler's start_trace/stop_trace), with the
    program's spans and counter events of the block beside it
    (``spans.json``, ``write_spans``)."""
    if not directory:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    write_spans(os.path.join(directory, "spans.json"), t0, t1)
    print(f"profile: {path}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="speedy-tpu-torch",
        description="SPEEDY atmospheric model on PyTorch and CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="run a forecast")
    r.add_argument("--preset", default="t30", choices=sorted(PRESETS))
    r.add_argument("--start", type=_dt, default=Datetime(1982, 1, 1))
    r.add_argument("--end", type=_dt, default=Datetime(1982, 1, 2))
    r.add_argument("--namelist", help="reference-format namelist.nml")
    r.add_argument("--output-dir", default="rundir")
    r.add_argument("--nsteps-out", type=int, default=1)
    r.add_argument("--nstdia", type=int, default=180)
    r.add_argument("--precision", default="fp32", choices=["fp32", "fp64"])
    r.add_argument("--matmul-precision", default=None,
                   choices=["bfloat16", "tensorfloat32", "float32", "highest"],
                   help="float32 matmul precision of fp32 runs "
                        "(torch.set_float32_matmul_precision: tensorfloat32 "
                        "-> high, bfloat16 -> medium; default: full float32, "
                        "TF32 off)")
    r.add_argument("--sppt", action="store_true", help="enable SPPT")
    r.add_argument("--sppt-seed", type=int, default=0)
    r.add_argument("--no-output", action="store_true")
    r.add_argument("--profile", help="write a torch.profiler trace to this "
                                     "dir")
    r.add_argument("--debug-nans", action="store_true",
                   help="run the days eagerly, step by step, and raise at "
                        "the first step that leaves a value that is not "
                        "finite instead of tripping the stability guard "
                        "later (slower; debugging aid)")
    r.add_argument("--checkpoint-every", type=int, default=0, metavar="DAYS",
                   help="write a restart checkpoint every DAYS days")
    r.add_argument("--checkpoint-dir", default="checkpoints")
    r.add_argument("--restart-from", metavar="CKPT.npz",
                   help="resume a run from a checkpoint file")
    r.add_argument("--auto-resume", action="store_true",
                   help="elastic recovery: resume from the newest checkpoint "
                        "in --checkpoint-dir if one exists (use with "
                        "--checkpoint-every so a crashed/preempted run "
                        "re-launched with the same command line continues)")
    add_boundary_args(r)

    e = sub.add_parser("ensemble", help="run an SPPT ensemble forecast")
    e.add_argument("--preset", default="t30", choices=sorted(PRESETS))
    e.add_argument("--members", type=int, default=8)
    e.add_argument("--days", type=int, default=2)
    e.add_argument("--start", type=_dt, default=Datetime(1982, 1, 1))
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--precision", default="fp32", choices=["fp32", "fp64"])
    e.add_argument("--output-dir", default="rundir_ens",
                   help="per-member final-state NetCDF output directory")
    e.add_argument("--no-output", action="store_true")
    e.add_argument("--output-every-step", action="store_true",
                   help="write every member's grid fields every step "
                        "(memberNNN/yyyymmddhhmm.nc, the reference's one-"
                        "file-per-step schema per member)")
    add_boundary_args(e)

    args = p.parse_args(argv)
    if args.command == "ensemble":
        return _ensemble(args)
    return _run(args)


def _ensemble(args) -> int:
    """``ensemble``: in one process, or under torchrun (WORLD_SIZE set)
    over a (world, 1) dp mesh of one process per rank."""
    if "WORLD_SIZE" not in os.environ:
        return _run_ensemble(args, None)
    import torch.distributed as dist
    from .parallel.mesh import initialize_distributed, make_mesh
    world = int(os.environ["WORLD_SIZE"])
    if args.members % world:
        raise ValueError(
            f"{args.members} members do not divide over {world} processes: "
            "each process would run every member and write every member's "
            "files; run a member count that the process count divides")
    device = None if args.device == "cuda" else args.device
    initialize_distributed(device=device)
    try:
        mesh = make_mesh(world, 1, device=device)
        return _run_ensemble(args, mesh)
    finally:
        dist.destroy_process_group()


def _run_ensemble(args, mesh) -> int:
    import torch
    import torch.distributed as dist
    from .convert import gather_members
    from .models.model import Model
    from .models.state import PrognosticState
    from .parallel.ensemble import Ensemble
    from .utils.output import NetCDFWriter

    cfg = from_preset(args.preset, precision=args.precision, sppt_on=True)
    model = Model(cfg, device=args.device if mesh is None else mesh.device,
                  **boundary_kwargs(args))
    ens = Ensemble(model, args.members, base_seed=args.seed, mesh=mesh)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"speedy_tpu_torch ensemble: {args.members} members, "
        f"{args.days} days, {args.preset.upper()}"
        + (f", {mesh.dp}-process dp mesh" if mesh else ""))
    writers = None
    if args.output_every_step and not args.no_output:
        writers = []
        for i in ens.members:
            w, line = make_writer(
                cfg, os.path.join(args.output_dir, f"member{i:03d}"))
            writers.append(w)
        say(line)
    first_done = []

    def after_day(day: int) -> None:
        # day 0 holds the warm-up day and the capture of the replayed day
        if day == 0:
            synchronize(model)
            first_done.append(time.time())

    t0 = time.time()
    estate = ens.initialize(args.start)
    estate, end_date = ens.run_days(estate, args.start, args.days,
                                    output_writers=writers,
                                    after_day=after_day)
    synchronize(model)
    for w in writers or ():
        _drain(w)
    t_end = time.time()
    wall = t_end - t0
    say(f"done at {end_date} in {wall:.1f}s")
    say(f"{args.members * args.days / wall * 60.0:.1f} member-days/min "
        "(initialize and capture included)")
    if args.days > 1:
        # from the first rank to begin day 2 to the last rank to end
        span = torch.tensor([-first_done[0], t_end], dtype=torch.float64)
        if mesh is not None:
            span = span.to(mesh.host_device())
            dist.all_reduce(span, op=dist.ReduceOp.MAX)
        span = float(span.sum())
        say(f"{args.members * (args.days - 1) / span * 60.0:.1f} "
            f"member-days/min over the {args.days - 1} replayed days after "
            "the first")
    if model.device.type == "cuda":
        print(("" if mesh is None else f"rank {mesh.rank}: ")
              + counter_line())
    if writers is not None:
        say(f"wrote per-step member files to {args.output_dir}/"
            f"memberNNN/")
    if not args.no_output and writers is None:
        tree = gather_members(estate, mesh) if mesh else None
        if lead:
            for i in range(args.members):
                if mesh is None:
                    fields = ens.member_fields(estate, i)
                else:
                    fields = model.gridded_fields(PrognosticState(**{
                        f: torch.as_tensor(v[i], device=model.device)
                        for f, v in tree["prog"].items()}))
                w = NetCDFWriter(cfg, os.path.join(args.output_dir,
                                                   f"member{i:03d}"))
                w(args.days * cfg.nsteps, end_date, args.start,
                  {k: v.cpu().numpy() for k, v in fields.items()})
            print(f"wrote member states to {args.output_dir}/")
    return 0


def _run(args) -> int:
    import torch
    from .models.model import Model
    from .utils.checkpoint import checkpoint_start

    kw = dict(nsteps_out=args.nsteps_out, nstdia=args.nstdia,
              precision=args.precision, sppt_on=args.sppt)
    start, end = args.start, args.end
    if args.namelist:
        nl = parse_namelist(args.namelist)
        kw["nsteps_out"] = nl.get("nsteps_out", kw["nsteps_out"])
        kw["nstdia"] = nl.get("nstdia", kw["nstdia"])
        start = Datetime(nl.get("start_datetime%year", start.year),
                         nl.get("start_datetime%month", start.month),
                         nl.get("start_datetime%day", start.day),
                         nl.get("start_datetime%hour", 0),
                         nl.get("start_datetime%minute", 0))
        end = Datetime(nl.get("end_datetime%year", end.year),
                       nl.get("end_datetime%month", end.month),
                       nl.get("end_datetime%day", end.day),
                       nl.get("end_datetime%hour", 0),
                       nl.get("end_datetime%minute", 0))

    cfg = from_preset(args.preset, **kw)
    print(f"speedy_tpu_torch: {args.preset.upper()} "
          f"{cfg.ix}x{cfg.il}x{cfg.kx}, dt={cfg.delt:.0f}s, "
          f"{args.precision}")
    print(f"start {start} -> end {end}")
    model = Model(cfg, device=args.device, sppt_seed=args.sppt_seed,
                  **boundary_kwargs(args))
    # Model() turns TF32 off; the precision asked for holds from here, and
    # a captured day keeps the GEMM kernels chosen at its capture
    if args.matmul_precision:
        torch.set_float32_matmul_precision(
            MATMUL_PRECISION[args.matmul_precision])
    writer = None
    if not args.no_output:
        writer, line = make_writer(cfg, args.output_dir)
        print(line)
    run_kw = dict(checkpoint_every=args.checkpoint_every,
                  checkpoint_dir=args.checkpoint_dir,
                  debug_nans=args.debug_nans)
    if args.auto_resume and not args.restart_from:
        cks = sorted(glob.glob(os.path.join(args.checkpoint_dir,
                                            "ckpt_*.npz")))
        if cks:
            args.restart_from = cks[-1]  # names sort chronologically
        else:
            print(f"auto-resume: no checkpoints in "
                  f"{args.checkpoint_dir}, starting fresh")
    if args.restart_from:
        # season_vars / anomaly-window phase must use the run's original
        # start date, not the resume invocation's --start: read it before
        # restore builds its template from initialize(start)
        ck_start = checkpoint_start(args.restart_from)
        if ck_start is not None and ck_start != start:
            print(f"note: using original run start {ck_start} "
                  "from checkpoint")
            start = ck_start
        state, ck_date, model_step, _ = model.restore(args.restart_from,
                                                      start)
        print(f"resuming from {args.restart_from} at {ck_date} "
              f"(step {model_step})")
        run_kw.update(state=state, resume_date=ck_date,
                      model_step=model_step)
    t0 = time.time()
    with _profiled(args.profile, model.device):
        model.run(start, end, output_writer=writer, **run_kw)
        synchronize(model)
        if writer is not None:
            _drain(writer)
        wall = time.time() - t0
    print(f"wall time: {wall:.3f}s")
    if model.device.type == "cuda":
        print(counter_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
