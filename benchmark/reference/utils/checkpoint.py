"""Checkpoint and resume of the full model state.

The reference cannot restart: its NetCDF output holds float32 grid
fields, too little to restore the spectral state. A checkpoint here stores
every leaf of the ModelState (both leapfrog time levels, the surface slab
state, the radiation state and, with SPPT on, the AR(1) state and its
generator's state as bytes), the model date and step, the run's start date
and the configuration's metadata, in one ``.npz``. The layout is the JAX
package's (``speedy_tpu/utils/checkpoint.py``): leaves under
``group::field`` names, ``__date__``, ``__start__``, ``__config__`` and,
where given (``Model.run`` gives it when SST-anomaly forcing is on; the
JAX package writes it always), ``__sstan3__``, the SST-anomaly window,
which lives outside the state and is read back into ``extras``
(``Model.restore`` puts it back into the model); only the SPPT random
state differs, as ``sppt::generator`` where the JAX package stores
``sppt::key``.
Loading restores the state bit for bit and refuses a checkpoint whose
configuration metadata differ from the given config, or whose leaves are
not exactly the template's.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .calendar import Datetime

_SEP = "::"

# config fields that must match between save and resume for the restored
# trajectory to continue the original one
CONFIG_META_KEYS = ("preset", "precision", "sppt_on", "sea_coupling_flag",
                    "ice_coupling_flag", "land_coupling_flag",
                    "sst_anomaly_forcing", "increase_co2", "trunc", "kx",
                    "nsteps")


def config_meta(cfg) -> dict:
    return {k: getattr(cfg, k) for k in CONFIG_META_KEYS if hasattr(cfg, k)}


def _leaves(tree, prefix: str = ""):
    """(name, leaf) for every tensor or generator in a tree of NamedTuples;
    a None subtree has no leaves."""
    for field in tree._fields:
        value = getattr(tree, field)
        name = prefix + field
        if value is None:
            continue
        if isinstance(value, tuple):
            yield from _leaves(value, name + _SEP)
        else:
            yield name, value


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy()
    return leaf.cpu().numpy()


def save_checkpoint(path: str, state, date: Datetime, model_step: int = 0,
                    start: Optional[Datetime] = None, sstan3=None,
                    cfg=None) -> None:
    arrays: Dict[str, np.ndarray] = {k: _to_numpy(v)
                                     for k, v in _leaves(state)}
    arrays["__date__"] = np.array(
        [date.year, date.month, date.day, date.hour, date.minute, model_step],
        dtype=np.int64)
    if start is not None:
        arrays["__start__"] = np.array(
            [start.year, start.month, start.day, start.hour, start.minute],
            dtype=np.int64)
    if sstan3 is not None:
        arrays["__sstan3__"] = _to_numpy(sstan3)
    if cfg is not None:
        arrays["__config__"] = np.frombuffer(
            json.dumps(config_meta(cfg)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _restore(template, data, prefix: str = ""):
    """A tree shaped like ``template`` with its leaves read from ``data``,
    each on its template leaf's device and in its dtype."""
    values = {}
    for field in template._fields:
        leaf = getattr(template, field)
        name = prefix + field
        if leaf is None or isinstance(leaf, tuple):
            values[field] = None if leaf is None \
                else _restore(leaf, data, name + _SEP)
            continue
        if name not in data:
            raise ValueError(
                f"checkpoint is missing state leaf {name!r}: it was saved "
                "with a different model configuration")
        arr = data[name]
        if isinstance(leaf, torch.Generator):
            gen = torch.Generator(device=leaf.device)
            gen.set_state(torch.from_numpy(arr.copy()))
            values[field] = gen
            continue
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name!r} has shape "
                             f"{arr.shape}, expected {tuple(leaf.shape)}")
        values[field] = torch.as_tensor(arr, dtype=leaf.dtype,
                                        device=leaf.device)
    return type(template)(**values)


def checkpoint_start(path: str) -> Optional[Datetime]:
    """The start date of the run that wrote the checkpoint ``path``, None
    if it was not saved: a resumed run takes its season and SST-anomaly
    phase from it, so read it before building the restore template."""
    with np.load(path) as data:
        if "__start__" not in data.files:
            return None
        return Datetime(*[int(x) for x in data["__start__"]])


def load_checkpoint(path: str, template, cfg=None
                    ) -> Tuple[object, Datetime, int, dict]:
    """Restore a ModelState shaped like ``template`` (e.g. from
    Model.initialize), on its devices.

    Returns (state, date, model_step, extras); extras may hold 'start' (the
    run's start Datetime), 'sstan3' and 'config' (the saved metadata). If
    ``cfg`` is given, its metadata are checked against the checkpoint's and
    a mismatch raises ValueError, as does a leaf that the template lacks or
    has and the checkpoint does not.
    """
    with np.load(path) as data:
        data = {k: data[k] for k in data.files}
    d = data["__date__"]
    date = Datetime(*[int(x) for x in d[:5]])
    model_step = int(d[5])

    extras = {}
    if "__start__" in data:
        extras["start"] = Datetime(*[int(x) for x in data["__start__"]])
    if "__sstan3__" in data:
        extras["sstan3"] = data["__sstan3__"]
    if "__config__" in data:
        saved = json.loads(bytes(data["__config__"]).decode())
        extras["config"] = saved
        if cfg is not None:
            mine = config_meta(cfg)
            bad = {k: (saved[k], mine[k]) for k in saved
                   if k in mine and mine[k] != saved[k]}
            if bad:
                raise ValueError(
                    "checkpoint config mismatch (saved vs current): "
                    + ", ".join(f"{k}: {s!r} != {m!r}"
                                for k, (s, m) in bad.items()))

    state = _restore(template, data)
    # leaves in the checkpoint but not in the template would be dropped
    # silently (e.g. the SPPT state when SPPT is off): refuse
    kept = {k for k, _ in _leaves(template)}
    extra = [k for k in data if not k.startswith("__") and k not in kept]
    if extra:
        raise ValueError(
            "checkpoint holds state the current config would drop: "
            f"{extra}; resume with the original configuration (e.g. "
            "sppt_on=True)")
    return state, date, model_step, extras
