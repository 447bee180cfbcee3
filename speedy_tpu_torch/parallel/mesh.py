"""Process meshes for runs over several processes and GPUs (the JAX
package's speedy_tpu/parallel/mesh.py).

The JAX package runs one controller over a device mesh with the axes
'dp' (ensemble members) and 'sp' (latitude and total-wavenumber bands).
PyTorch's idiom is one process per GPU on ``torch.distributed``: a rank
holds its share of the members on its own device and runs them through
its own captured day. What a rank holds and does not slice is replicated,
so the JAX package's ``replicated`` has nothing to place here.

Only the 'dp' axis is ported: the members need no collective inside a
day, only one reduction of the stability guard per chunk of days, on the
host (parallel/ensemble.py). A mesh with ``n_spatial > 1`` raises.

    torchrun --nproc-per-node 4 -m speedy_tpu_torch ensemble --members 8

Importing this module starts nothing; ``initialize_distributed`` starts
the process group.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> int:
    """Start this process's process group (call once per process, before
    ``make_mesh``) and return its rank.

    Arguments left None are read from the environment torchrun sets
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK). ``coordinator_address``
    is ``host:port`` of rank 0. Unless the caller names the backend, it
    follows from ``device``, the ranks' device as ``make_mesh`` takes it:
    Gloo on the CPU and where every rank names one GPU (``cuda:N`` with
    more than one process: NCCL refuses a GPU twice), else NCCL, or Gloo
    where CUDA is not available."""
    if backend is None:
        world = num_processes if num_processes is not None \
            else int(os.environ.get("WORLD_SIZE", 1))
        dev = torch.device("cuda" if device is None else device)
        shared = dev.index is not None and world > 1
        backend = "nccl" if dev.type == "cuda" and not shared \
            and torch.cuda.is_available() else "gloo"
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend, **kw)
    return dist.get_rank()


def member_range(n_members: int, n_dp: int, dp_rank: int) -> range:
    """The global members that dp rank ``dp_rank`` of ``n_dp`` holds:
    contiguous blocks of n_members / n_dp, as the JAX package's
    ``ensemble_state_sharding`` places the member axis over 'dp'."""
    if n_members % n_dp:
        raise ValueError(f"{n_members} members do not divide over "
                         f"{n_dp} dp ranks")
    if not 0 <= dp_rank < n_dp:
        raise ValueError(f"dp rank {dp_rank} of {n_dp}")
    per = n_members // n_dp
    return range(dp_rank * per, (dp_rank + 1) * per)


@dataclass(frozen=True)
class Mesh:
    """This process's place in a ('dp', 'sp') mesh of ranks: the mesh's
    shape, its rank, its dp coordinate, the device it computes on and the
    process group's backend (None without a process group)."""
    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: Optional[str]

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    def members(self, n_members: int) -> range:
        """The global members this rank holds (``member_range``)."""
        return member_range(n_members, self.dp, self.dp_rank)

    def host_device(self) -> torch.device:
        """Where a tensor for the process group's collectives lives: the
        rank's GPU under NCCL, the CPU under Gloo."""
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")


def _rank_device(device) -> torch.device:
    """``device`` where given, else ``cuda:LOCAL_RANK``; a CUDA index the
    machine does not have raises, and so does CUDA where it is not
    available (no rank falls back to the CPU)."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank device cuda:{index}, but this machine has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        device = torch.device("cuda", index)
    return device


def make_mesh(n_ensemble: int = 1, n_spatial: int = 1,
              device=None) -> Mesh:
    """This process's place in an ``n_ensemble`` x ``n_spatial`` mesh
    with the axes ('dp', 'sp'). dp x sp must equal the process group's
    size (1 without a process group). ``device``: the rank's compute
    device, ``cuda:LOCAL_RANK`` by default; name it, e.g. ``cuda:0`` for
    every rank, to share one GPU. Only the 'dp' axis is ported: ``n_spatial
    > 1`` raises NotImplementedError."""
    if n_spatial > 1:
        raise NotImplementedError(
            f"n_spatial={n_spatial}: the 'sp' axis (latitude and "
            "total-wavenumber bands) is not ported yet (ROADMAP.md, "
            "section 1); shard the members over 'dp' only")
    if n_ensemble < 1 or n_spatial < 1:
        raise ValueError(f"mesh {n_ensemble} x {n_spatial}")
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    if n_ensemble * n_spatial != world:
        raise ValueError(f"mesh {n_ensemble} x {n_spatial} needs "
                         f"{n_ensemble * n_spatial} ranks; the process "
                         f"group has {world}")
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if on and dist.get_backend() == "nccl":
        # NCCL sets up its communicator at the first collective: here,
        # not in the first chunk's guard
        dist.all_reduce(torch.zeros(1, device=device))
    return Mesh(dp=n_ensemble, sp=n_spatial,
                rank=dist.get_rank() if on else 0, device=device,
                backend=dist.get_backend() if on else None)
