"""Scaling of one coupled day over ranks (the JAX package's
scripts/bench_scaling.py).

    python -m speedy_tpu_torch.bench_scaling [--preset t30|t42|t63|t85]
        [--mode dp|sp] [--members 8] [--counts 1,2,4,8] [--reps 3]
        [--device cuda|cpu]

For each rank count n, one torchrun launch of n ranks (one process each)
runs an fp32 SPPT ensemble of ``--members`` members (diag_every=3) over a
mesh of n x 1 ('dp': the members split over the ranks) or 1 x n ('sp':
every rank holds all members on its latitude band, parallel/mesh.py):
``Ensemble.initialize``, one day to warm up (and capture), then
``--reps`` days of ``Ensemble.run_days`` timed, the slowest rank's wall.
Prints one JSON line per count: the grid-point-steps per second (ix il kx
nsteps M a day over the day's seconds), the efficiency against the first
count (per-rank throughput ratio, which equals "against one rank" when
the counts start at 1), the process group's backend and whether the day
was captured as a CUDA graph.

On CUDA each rank takes its own GPU while there are enough (NCCL);
beyond the machine's GPUs the ranks share them (``cuda:r % GPUs``), over
Gloo, since NCCL refuses a GPU twice, and a Gloo sp day runs eagerly
(models/captured.py): such a count time-slices the cards and says nothing
of NVLink. A count is skipped, with the reason, where the machine has
fewer CPU cores than ranks, or in dp mode where the members do not divide
over the ranks.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

START = (1982, 1, 1)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="t30",
                    choices=("t30", "t42", "t63", "t85"))
    ap.add_argument("--mode", default="dp", choices=("dp", "sp"))
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--counts", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank of a torchrun launch")
    return ap.parse_args(argv)


def rank_device(device: str, n: int) -> str:
    """What each of n ranks names as its device: ``cuda`` (cuda:LOCAL_RANK,
    NCCL) where every rank has a GPU of its own, ``cuda:K`` with K =
    LOCAL_RANK mod the GPUs where they share (Gloo), or ``cpu``."""
    if device == "cpu":
        return "cpu"
    gpus = torch.cuda.device_count()
    if n <= gpus:
        return "cuda"
    return f"cuda:{int(os.environ.get('LOCAL_RANK', 0)) % gpus}"


def worker(args) -> int:
    """One rank: the ensemble's days, timed; rank 0 prints the JSON of
    the slowest rank's time."""
    import torch.distributed as dist
    from .config import from_preset
    from .models.model import Model
    from .parallel.ensemble import Ensemble
    from .parallel.mesh import initialize_distributed, make_mesh
    from .utils import calendar as cal
    from .utils.synthetic_bc import synthetic_boundaries

    world = int(os.environ.get("WORLD_SIZE", 1))
    device = rank_device(args.device, world)
    rank = initialize_distributed(device=device)
    try:
        mesh = make_mesh(*((world, 1) if args.mode == "dp" else (1, world)),
                         device=device)
        cfg = from_preset(args.preset, precision="fp32", sppt_on=True,
                          diag_every=3)
        model = Model(cfg, device=mesh.device,
                      bc_arrays=synthetic_boundaries(0))
        ens = Ensemble(model, args.members, mesh=mesh)
        start = cal.Datetime(*START)
        state = ens.initialize(start)
        ens.run_days(state, start, 1)          # warm-up and capture
        sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
            else (lambda: None)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            ens.run_days(state, start, 1)
        sync()
        took = torch.tensor([(time.perf_counter() - t0) / args.reps],
                            dtype=torch.float64, device=mesh.host_device())
        dist.all_reduce(took, op=dist.ReduceOp.MAX)
        cd = ens.band.captured_day(state)
        if rank == 0:
            print("RESULT " + json.dumps({
                "day_seconds": float(took.item()), "backend": mesh.backend,
                "captured": cd.captured, "device": str(mesh.device),
                "rows_per_rank": len(range(cfg.il)[ens.rows]),
                "points": cfg.ix * cfg.il * cfg.kx * cfg.nsteps
                * args.members}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    if args.worker:
        return worker(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_scaling: CUDA is not available; pass --device cpu",
              file=sys.stderr)
        return 2
    counts = [int(c) for c in args.counts.split(",")]
    metric = f"scaling_{args.mode}_{args.preset}"
    base = None
    rc = 0
    for n in counts:
        reason = None
        if n > (os.cpu_count() or 1):
            reason = f"{n} ranks on {os.cpu_count()} CPU cores"
        elif args.mode == "dp" and args.members % n:
            reason = f"members {args.members} % dp {n} != 0"
        if reason:
            print(json.dumps({"metric": metric, "skipped_ranks": n,
                              "reason": reason}), flush=True)
            continue
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(n), "-m",
               "speedy_tpu_torch.bench_scaling", "--worker", "--preset",
               args.preset, "--mode", args.mode, "--members",
               str(args.members), "--reps", str(args.reps), "--device",
               args.device]
        env = dict(os.environ)
        if args.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        r = subprocess.run(cmd, capture_output=True, text=True, env=env)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if r.returncode != 0 or not lines:
            print(json.dumps({"metric": metric, "failed_ranks": n,
                              "rc": r.returncode}), flush=True)
            print(r.stdout[-2000:] + r.stderr[-4000:], file=sys.stderr)
            rc = 1
            continue
        rec = json.loads(lines[-1][len("RESULT "):])
        thr = rec["points"] / rec["day_seconds"]
        if base is None:
            base = (thr, n)
        shared = args.device == "cuda" and n > torch.cuda.device_count()
        print(json.dumps({
            "metric": metric, "ranks": n, "members": args.members,
            "grid_point_steps_per_s": thr,
            "day_seconds": rec["day_seconds"], "reps": args.reps,
            "base_ranks": base[1],
            "efficiency_vs_first": (thr / n) / (base[0] / base[1]),
            "backend": rec["backend"], "captured": rec["captured"],
            "device": rec["device"], "shared_gpu": shared,
            "rows_per_rank": rec["rows_per_rank"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
