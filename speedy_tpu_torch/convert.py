"""Model state to and from numpy.

The model has no learned weights; what carries over between runs and
between implementations is its state: the spectral prognostics
``prog.{vor,div,t,ps,tr}``, the nine surface fields ``surf.*`` and the six
radiation fields ``rad.*``, and with SPPT on the spectral AR(1) state
``sppt.spec``. ``model_state_from_numpy`` takes that tree (objects with
those attributes, such as the JAX package's ModelState mapped to numpy
arrays, or the nested dicts ``model_state_to_numpy`` returns) and builds
this package's ModelState on a device. The random-number state does not
carry over between the two packages (a JAX key is not a torch generator):
the SPPT state gets a new generator seeded with 0.

An ensemble's state (the JAX package's Ensemble state, every leaf [M, ...])
converts the same way, member axis and all; its SPPT state gets one
generator per member, member i's seeded with i. ``gather_members`` brings
the members that the ranks of a mesh hold to one rank, in global order,
as such a tree, the latitude bands of an sp mesh joined; ``band_state``
keeps a latitude band's rows of a full state's grid leaves.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .models.model import ModelState
from .models.physics import SurfaceState
from .models.physics.shortwave import RadiationState
from .models.physics.sppt import SpptState
from .models.state import PrognosticState

_GROUPS = (("prog", PrognosticState), ("surf", SurfaceState),
           ("rad", RadiationState))
_GRID_GROUPS = ("surf", "rad")  # leaves [..., il, ix]; the others spectral


def _get(tree: Any, name: str) -> Any:
    return tree.get(name) if isinstance(tree, dict) \
        else getattr(tree, name, None)


def model_state_from_numpy(tree: Any, device, dtype: torch.dtype
                           ) -> ModelState:
    """numpy state tree -> ModelState of ``dtype`` tensors on ``device``
    (one model's, or an ensemble's with a leading member axis)."""
    tensor = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                       device=device)
    groups = {}
    for group, cls in _GROUPS:
        sub = _get(tree, group)
        groups[group] = cls(**{f: tensor(_get(sub, f)) for f in cls._fields})
    sppt = _get(tree, "sppt")
    if sppt is not None:
        spec = tensor(_get(sppt, "spec"))
        gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
        members = spec.dim() == 5     # [M, kx, mx, nx, 2]
        groups["sppt"] = SpptState(
            spec=spec,
            generator=tuple(gen(i) for i in range(len(spec)))
            if members else gen(0))
    return ModelState(**groups)


def model_state_to_numpy(state: ModelState) -> Dict[str, Dict[str, np.ndarray]]:
    """ModelState -> {"prog": {...}, "surf": {...}, "rad": {...}} of numpy
    arrays, with "sppt": {"spec": ...} where the state has SPPT."""
    tree = {group: {f: getattr(state, group)._asdict()[f].cpu().numpy()
                    for f in cls._fields}
            for group, cls in _GROUPS}
    if state.sppt is not None:
        tree["sppt"] = {"spec": state.sppt.spec.cpu().numpy()}
    return tree


def band_state(state: ModelState, rows: slice) -> ModelState:
    """``state`` with its grid leaves (surf, rad: [..., il, ix]) cut to
    the latitude rows ``rows`` (a band of parallel/mesh.py, copied); the
    spectral leaves as they are. A numpy state placed on a band this way
    compares like with like against a band's run."""
    cut = lambda g: type(g)(*(x[..., rows, :].contiguous() for x in g))
    return state._replace(surf=cut(state.surf), rad=cut(state.rad))


def gather_members(estate: ModelState, mesh=None, dst: int = 0,
                   il: Optional[int] = None):
    """An ensemble state split over the ranks of ``mesh``
    (parallel/mesh.py) as one numpy tree (``model_state_to_numpy``) of
    all members in global order, on rank ``dst``; other ranks get None.
    With sp > 1, ``il`` (the model's latitude count) is needed: the grid
    leaves of a dp row are joined along latitude in sp order (each sp
    rank's band, ``mesh.rows(il)``), its spectral leaves are sp rank 0's.
    A collective: every rank calls it. Without a mesh or process group,
    the state's own tree."""
    tree = model_state_to_numpy(estate)
    if mesh is None or mesh.backend is None:
        return tree
    if mesh.sp > 1 and il is None:
        raise ValueError("gather_members over an sp mesh needs il")
    parts = [None] * (mesh.dp * mesh.sp) if mesh.rank == dst else None
    dist.gather_object(tree, parts, dst=dst)
    if mesh.rank != dst:
        return None
    # one tree per dp row (ranks row * sp .. row * sp + sp - 1), then the
    # rows' contiguous blocks of members in dp order
    bands = mesh.sp > 1 and il % mesh.sp == 0
    rows = [{group: {f: np.concatenate(
        [p[group][f] for p in parts[r * mesh.sp:(r + 1) * mesh.sp]],
        axis=-2) if bands and group in _GRID_GROUPS
        else parts[r * mesh.sp][group][f] for f in tree[group]}
        for group in tree} for r in range(mesh.dp)]
    return {group: {f: np.concatenate([row[group][f] for row in rows])
                    for f in tree[group]}
            for group in tree}
