"""Model state to and from numpy.

The model has no learned weights; what carries over between runs and
between implementations is its state: the spectral prognostics
``prog.{vor,div,t,ps,tr}``, the nine surface fields ``surf.*`` and the six
radiation fields ``rad.*``. ``model_state_from_numpy`` takes that tree
(objects with those attributes, such as the JAX package's ModelState
mapped to numpy arrays, or the nested dicts ``model_state_to_numpy``
returns) and builds this package's ModelState on a device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.model import ModelState
from .models.physics import SurfaceState
from .models.physics.shortwave import RadiationState
from .models.state import PrognosticState

_GROUPS = (("prog", PrognosticState), ("surf", SurfaceState),
           ("rad", RadiationState))


def _get(tree: Any, name: str) -> Any:
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def model_state_from_numpy(tree: Any, device, dtype: torch.dtype
                           ) -> ModelState:
    """numpy state tree -> ModelState of ``dtype`` tensors on ``device``."""
    groups = {}
    for group, cls in _GROUPS:
        sub = _get(tree, group)
        groups[group] = cls(**{
            f: torch.as_tensor(np.array(_get(sub, f)), dtype=dtype,
                               device=device)
            for f in cls._fields})
    return ModelState(**groups)


def model_state_to_numpy(state: ModelState) -> Dict[str, Dict[str, np.ndarray]]:
    """ModelState -> {"prog": {...}, "surf": {...}, "rad": {...}} of numpy
    arrays."""
    return {group: {f: getattr(state, group)._asdict()[f].cpu().numpy()
                    for f in cls._fields}
            for group, cls in _GROUPS}
