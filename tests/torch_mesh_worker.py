"""One rank of a sharded SPPT ensemble (parallel/mesh.py, Ensemble(mesh=)),
started by torchrun; tests/test_torch_mesh.py runs it on the CPU over
Gloo, chip_smoke.py [15] and tests/test_torch_gpu.py with every rank on
one GPU (``--device cuda:0``, Gloo):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_mesh_worker.py OUT_DIR [--device cpu] [--grid t21] \\
        [--precision fp64] [--members 4] [--seed 5] [--days 1]

Each rank runs its block of the members over ``--days`` days from
1982-01-01, and rank 0 saves the gathered state (convert.gather_members)
as OUT_DIR/gathered.npz (keys "group.field", every member in global
order) and each rank its column-physics kernel launches in
OUT_DIR/launches<r>.txt. Then the last rank pushes its first member's
temperature out of the guard's range and every rank runs one more day:
each writes the error it raised to OUT_DIR/rank<r>.txt and exits with
code 3 (0 if none was raised).
"""
import argparse
import math
import os
import sys

import numpy as np
import torch.distributed as dist

from speedy_tpu_torch.config import t30
from speedy_tpu_torch.convert import gather_members
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.diagnostics import InstabilityError
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

GRIDS = {"t21": dict(trunc=21, ix=64, il=32, kx=5), "t30": {}}
START = cal.Datetime(1982, 1, 1)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--grid", default="t21", choices=sorted(GRIDS))
    ap.add_argument("--precision", default="fp64")
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--days", type=int, default=1)
    args = ap.parse_args(argv)
    rank = initialize_distributed(device=args.device)
    raised = None
    try:
        world = dist.get_world_size()
        mesh = make_mesh(world, 1, device=args.device)
        cfg = t30(precision=args.precision, sppt_on=True, **GRIDS[args.grid])
        model = Model(cfg, device=mesh.device,
                      bc_arrays=synthetic_boundaries(0))
        ens = Ensemble(model, args.members, base_seed=args.seed, mesh=mesh)
        fused.reset_launches()
        estate, date = ens.run_days(ens.initialize(START), START, args.days)
        with open(os.path.join(args.out, f"launches{rank}.txt"), "w") as f:
            f.write(f"{fused.launches} {fused.launches_sw}")
        tree = gather_members(estate, mesh)
        if rank == 0:
            np.savez(os.path.join(args.out, "gathered.npz"),
                     **{f"{g}.{f}": v for g, sub in tree.items()
                        for f, v in sub.items()})
        if rank == world - 1:
            # the global mean temperature of every level up by 300 K
            estate.prog.t[0, :, :, 0, 0, 0] += 300.0 * math.sqrt(2.0)
        try:
            ens.run_days(estate, date, 1)
        except InstabilityError as e:
            raised = str(e)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.out, f"rank{rank}.txt"), "w") as f:
        f.write(raised or "")
    return 0 if raised is None else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
