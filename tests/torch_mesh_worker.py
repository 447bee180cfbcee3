"""One rank of a sharded ensemble (parallel/mesh.py, Ensemble(mesh=)),
started by torchrun; tests/test_torch_mesh.py and test_torch_mesh_sp*.py
run it on the CPU over Gloo, tests/test_torch_gpu.py with every rank on
one GPU (``--device cuda:0``, Gloo):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_mesh_worker.py OUT_DIR [--device cpu] [--grid t21] \\
        [--precision fp64] [--members 4] [--seed 5] [--days 1] [--sp 1] \\
        [--steps N] [--no-sppt] [--state STATE.npz] [--writers] \\
        [--trip-rank R] [--no-trip]

The ranks form a (world / sp) x sp mesh. Each rank runs its block of the
members, on its latitude band where sp > 1, over ``--days`` days from
1982-01-01 (with ``--steps N``: the boot and N steps of the first day
instead, the shortwave every nstrad steps, from ``--state``'s numpy state
of one model (convert.model_state_from_numpy, the npz keys
"group.field") in place of the boot where given). Rank 0 saves the
gathered state (convert.gather_members) as OUT_DIR/gathered.npz (keys
"group.field", every member in global order), each rank its own
spectral leaves as OUT_DIR/spec<r>.npz and OUT_DIR/run<r>.json: the
seconds its steps or days took, its column-physics kernel launches (and
those of the SW variant), its all-reduces and whether its day was
captured as a CUDA graph (null in step mode). With ``--writers`` the
days run with a NetCDF writer per member (OUT_DIR/memberNNN/), and rank
0 saves member 0's gathered fields (Ensemble.member_fields) as
OUT_DIR/fields0.npz. Then, unless ``--no-trip``, rank ``--trip-rank``
(the last by default) pushes its first member's temperature out of the
guard's range and every rank runs one more day: each writes the error it
raised to OUT_DIR/rank<r>.txt and exits with code 3 (0 if none was
raised).
"""
import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from speedy_tpu_torch.config import from_preset
from speedy_tpu_torch.convert import (band_state, gather_members,
                                      model_state_from_numpy,
                                      model_state_to_numpy)
from speedy_tpu_torch.models.model import Model, one_step
from speedy_tpu_torch.parallel.ensemble import Ensemble, broadcast_state
from speedy_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.diagnostics import InstabilityError
from speedy_tpu_torch.utils.output import NetCDFWriter
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries
from speedy_tpu_torch.utils.tracing import counters, reset

GRIDS = {"t21": ("t30", dict(trunc=21, ix=64, il=32, kx=5)),
         "t30": ("t30", {}), "t85": ("t85", {}), "t170": ("t170", {})}
START = cal.Datetime(1982, 1, 1)


def steps(ens, estate, n):
    """n steps of the first day on the ensemble's band, after the day's
    forcing update."""
    band = ens.band
    daily = band.daily_forcing(estate, START, START)
    for i in range(n):
        estate, _ = one_step(band.cfg, band.pp, band.lsp, band.mc, estate,
                             daily, compute_sw=(i % band.cfg.nstrad == 0),
                             noise=ens.noise)
    return estate


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--grid", default="t21", choices=sorted(GRIDS))
    ap.add_argument("--precision", default="fp64")
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--days", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--no-sppt", action="store_true")
    ap.add_argument("--state", default=None)
    ap.add_argument("--writers", action="store_true")
    ap.add_argument("--trip-rank", type=int, default=None)
    ap.add_argument("--no-trip", action="store_true")
    args = ap.parse_args(argv)
    rank = initialize_distributed(device=args.device)
    raised = None
    out = lambda name: os.path.join(args.out, name)
    try:
        world = dist.get_world_size()
        mesh = make_mesh(world // args.sp, args.sp, device=args.device)
        preset, kw = GRIDS[args.grid]
        cfg = from_preset(preset, precision=args.precision,
                          sppt_on=not args.no_sppt, **kw)
        model = Model(cfg, device=mesh.device,
                      bc_arrays=synthetic_boundaries(0))
        ens = Ensemble(model, args.members, base_seed=args.seed, mesh=mesh)
        reset()
        captured = None
        if args.state is not None:
            with np.load(args.state) as z:
                tree = {}
                for key in z.files:
                    group, field = key.split(".")
                    tree.setdefault(group, {})[field] = z[key]
            state = model_state_from_numpy(tree, mesh.device, cfg.rdtype)
            estate = broadcast_state(band_state(state, ens.rows),
                                     ens.n_local)
        else:
            estate = ens.initialize(START)
        date = START
        sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
            else (lambda: None)
        sync()
        t0 = time.perf_counter()
        writers = None
        if args.writers:
            writers = [NetCDFWriter(cfg, out(f"member{g:03d}"))
                       for g in ens.members]
        if args.steps is not None:
            estate = steps(ens, estate, args.steps)
        else:
            estate, date = ens.run_days(estate, START, args.days,
                                        output_writers=writers)
            captured = ens.band.captured_day(
                estate, collect_output=args.writers,
                grids=args.writers).captured
        sync()
        seconds = time.perf_counter() - t0
        with open(out(f"run{rank}.json"), "w") as f:
            json.dump(dict(seconds=seconds,
                           launches=counters["k1.launches"],
                           launches_sw=counters["k1.launches_sw"],
                           allreduces=counters["spectral.allreduces"],
                           captured=captured), f)
        if args.writers:
            fields = ens.member_fields(estate, ens.members.start)
            if rank == 0:
                np.savez(out("fields0.npz"),
                         **{k: v.cpu().numpy() for k, v in fields.items()})
        mine = model_state_to_numpy(estate)
        np.savez(out(f"spec{rank}.npz"),
                 **{f"{g}.{f}": v for g in ("prog", "sppt") if g in mine
                    for f, v in mine[g].items()})
        tree = gather_members(estate, mesh, il=cfg.il)
        if rank == 0:
            np.savez(out("gathered.npz"),
                     **{f"{g}.{f}": v for g, sub in tree.items()
                        for f, v in sub.items()})
        if not args.no_trip:
            trip = world - 1 if args.trip_rank is None else args.trip_rank
            if rank == trip:
                # the global mean temperature of every level up by 300 K
                estate.prog.t[0, :, :, 0, 0, 0] += 300.0 * math.sqrt(2.0)
            try:
                ens.run_days(estate, date, 1)
            except InstabilityError as e:
                raised = str(e)
        with open(out(f"rank{rank}.txt"), "w") as f:
            f.write(raised or "")
        # torchrun stops the other ranks once one exits non-zero: none
        # leaves before every rank has written its file
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0 if raised is None else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
