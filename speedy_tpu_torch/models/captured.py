"""A simulated day staged into static buffers and, on CUDA, captured as one
CUDA graph and replayed (the counterpart of the JAX package's jitted
``run_day`` and ``run_span``, speedy_tpu/models/model.py).

A day splits in two. The host stages it: the state is copied into static
buffers once per call (``load``), the date inputs of a chunk of days reach
the device in one copy (``set_days``) and each day's row is copied into a
static ``DateScalars`` before its replay, and the day's SPPT innovations
are drawn ahead into a static buffer (``sppt.draw_day``), all on the
stream the replay runs on, so stream order alone keeps day d+1's staging
behind day d's replay and the host does not wait. The device part
(``model.day_steps``, the daily update included) reads only those buffers
and ends by copying the new state back into the static state, so one
replay maps static state to static state; it also writes the day's guard
extrema and, for the output variants, every step's diagnostics and, where
grids are written, gridded fields into static buffers. The accumulating
variant (``accumulate``) adds, at each replay, the day-end gridded u and
t and the step-summed precipitation and radiation fluxes into static
accumulators (the JAX package's month_span carry,
scripts/run_multiyear.py); they are zeroed outside the graph
(``reset_accumulators``) and reach the host with the guard rows in one
copy (``accumulated``). On the CPU the same staged day runs eagerly.

The graph bakes in the addresses it read at capture: the static buffers
and every constant of ``model.mc``, ``model.pp`` and ``model.lsp``.
Anything that later changes such a constant must ``copy_`` into it in
place, or capture again: the SST-anomaly window (``mc.clim.sstan3``),
which the run drivers shift at month starts, is copied into in place on
the replays' stream.

A band view's day (``Model.for_band``, the 'sp' axis of parallel/mesh.py)
holds its analyses' all-reduces over the band ranks' group. Under NCCL
they are captured with the rest of the day (NCCL sets up the group's
communicator when the mesh is made: it cannot inside a capture). A Gloo
collective cannot be captured, so where the group's backend is Gloo (ranks
that share a GPU) the staged day runs eagerly on CUDA too, its
all-reduces staged through host copies, marked as syncs. That choice is
made here, from the model's ``collectives`` (the mesh's backend), once
(``CapturedDay.captured``).

The first day of a ``CapturedDay`` on CUDA warms up on a side stream on
the staged copy of the state (building and loading the kernel libraries,
K1's shared-memory opt-in, cuBLAS's handles), then captures. Capture or
replay errors propagate; nothing falls back to eager execution. A replay
runs no Python, so the program's counters (utils/tracing.py: the K1
launches, the all-reduces) do not see it: what the body counts while it is
captured, which launches nothing, is taken back out of them and kept
(``counts``), and added at each replay.

The day's spans (utils/tracing.py): ``capture.warmup`` and
``capture.graph``; in ``advance``, ``day.draw`` around the SPPT draws and
``day.replay`` around the replay (the eager day where there is no graph);
``day.fetch`` around the wait for each host copy (``HostCopy``), whose
bytes count as ``d2h.bytes``.
"""
from __future__ import annotations

import contextlib
import gc
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import coupling
from .physics.sppt import draw_day
from ..utils import tracing
from ..utils.diagnostics import Diagnostics, guard_extrema

# the accumulating variant's sums: day-end gridded fields, then step fluxes
ACC_GRIDS = ("u", "t")
ACC_FLUXES = ("precnv", "precls", "olr", "tsr", "ssr")


@contextlib.contextmanager
def host_sync():
    """Marks a deliberate host synchronisation (the guard's extrema once a
    chunk, a day's output, the capture): under
    ``torch.cuda.set_sync_debug_mode("error")``, which the GPU tests
    (tests/test_torch_gpu.py) set around whole runs, any other
    synchronisation raises."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def pool_bytes(pool) -> int:
    """The device memory that the graph memory pool ``pool`` holds
    (the segments the caching allocator reserved for it)."""
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def leaves(state):
    """The tensors of a ModelState: prog, surf, rad fields and the SPPT
    spectral state."""
    out = [x for g in state[:3] for x in g]
    if state.sppt is not None:
        out.append(state.sppt.spec)
    return out


def copy_state(dst, src) -> None:
    """Copy every tensor of ModelState ``src`` into ``dst``'s, which must
    have the same shapes (an expanded view is copied as its values)."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        if d.shape != s.shape:
            raise ValueError(f"state leaf of shape {tuple(s.shape)}, "
                             f"expected {tuple(d.shape)}")
        d.copy_(s)


def step_sum(xs):
    """The sum of a day's per-step tensors, added in step order (how the
    accumulating day sums its fluxes)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def _views(flat, shapes):
    """Views of ``flat`` with the given shapes, back to back."""
    out, off = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        out[k] = flat[off:off + n].reshape(s)
        off += n
    return out


def _rebuild(template, tensors, generator):
    """A ModelState shaped like ``template`` from its tensors in ``leaves``
    order and the SPPT generator(s)."""
    it = iter(tensors)
    groups = [type(g)(*(next(it) for _ in g)) for g in template[:3]]
    sppt = None
    if template.sppt is not None:
        sppt = template.sppt._replace(spec=next(it), generator=generator)
    return template._replace(prog=groups[0], surf=groups[1], rad=groups[2],
                             sppt=sppt)


class HostCopy:
    """A copy of a tensor into new host memory (pinned on CUDA), enqueued
    on the current stream without a host synchronisation: stream order
    alone keeps a later day's writes to the source behind it. ``wait()``
    waits for it (a marked synchronisation, the span ``day.fetch``) and
    returns the host array, or with ``shapes`` its views of those shapes,
    back to back. On the CPU the copy is made at once, since ``.cpu()``
    of a CPU tensor would be the source itself."""

    def __init__(self, tensor: torch.Tensor, shapes=None):
        self.shapes = shapes
        self.host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                pin_memory=tensor.is_cuda)
        self.host.copy_(tensor, non_blocking=tensor.is_cuda)
        self.event = None
        if tensor.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        with tracing.span("day.fetch"), host_sync():
            if self.event is not None:
                self.event.synchronize()
        flat = self.host.numpy()
        return flat if self.shapes is None else _views(flat, self.shapes)


class CapturedDay:
    """One simulated day of ``model`` for states shaped like ``template``
    (one model's, or an ensemble's with a leading member axis), with
    diagnostics every ``diag_every`` steps; with ``collect_output`` they
    are kept as outputs, and with ``grids`` every step's gridded fields;
    with ``accumulate`` each day adds into the accumulators (the module
    docstring). Use: ``load(state)``, ``set_days(rows)``, then
    ``advance(d, noise)`` for each day d of the rows; ``guard_rows``,
    ``outputs``, ``accumulated`` and ``result`` read what the days left,
    each in one host copy (counted in ``host_copies``; ``copy_outputs``
    enqueues ``outputs``' copy without waiting). ``pool``: the
    graph memory pool to share (``torch.cuda.graph_pool_handle()``)."""

    def __init__(self, model, template, diag_every: int,
                 collect_output: bool, grids: bool = False, pool=None,
                 accumulate: bool = False):
        from .model import day_steps, gridded_fields
        self._day_steps, self._gridded = day_steps, gridded_fields
        cfg = self.cfg = model.cfg
        # the model's constants, not the model: the model holds its
        # captured days, and a cycle would leave a dropped model's graphs
        # to the garbage collector
        self.pp, self.lsp, self.mc = model.pp, model.lsp, model.mc
        self.diag_every, self.collect = diag_every, collect_output
        self.grids, self.accumulate = grids, accumulate
        self.host_copies = 0
        dev = self.device = template.prog.vor.device
        # a graph on CUDA unless the day's collectives are Gloo's
        self.captured = dev.type == "cuda" and model.collectives != "gloo"
        dtype = cfg.rdtype
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        self.state = _rebuild(template, [zeros(*x.shape)
                                         for x in leaves(template)], None)
        lead = tuple(template.prog.vor.shape[:-5])   # the member axis
        self.date = zeros(coupling.date_row_size(cfg, model.rows))
        self.ds = coupling.date_scalars_view(cfg, self.date, model.rows)
        self.days = zeros(0, self.date.numel())
        self.eta = zeros(cfg.nsteps, *template.sppt.spec.shape) \
            if cfg.sppt_on else None
        self.guard = zeros(4, *lead, cfg.kx)
        self.rows = zeros(0, *self.guard.shape)
        # the output variants' static outputs, views of one buffer that
        # reaches the host in one copy a day
        self.out_shapes = {}
        if collect_output:
            n_diag = cfg.nsteps // diag_every
            self.out_shapes = {f: (n_diag,) + lead + (cfg.kx,)
                               for f in Diagnostics._fields}
        grid = tuple(template.surf.stl_lm.shape[-2:])   # [il, ix] or a band
        if grids:
            self.out_shapes.update(
                {k: (cfg.nsteps,) + lead + (cfg.kx,) + grid
                 for k in ("u", "v", "t", "q", "phi")},
                ps=(cfg.nsteps,) + lead + grid)
        self.out_flat = zeros(sum(int(np.prod(s))
                                  for s in self.out_shapes.values()))
        self.out = _views(self.out_flat, self.out_shapes)
        # the accumulating variant's sums, views of one buffer
        self.acc_shapes = {}
        if accumulate:
            self.acc_shapes = {k: lead + (cfg.kx,) + grid for k in ACC_GRIDS}
            self.acc_shapes.update({k: lead + grid for k in ACC_FLUXES})
        self.acc_flat = zeros(sum(int(np.prod(s))
                                  for s in self.acc_shapes.values()))
        self.acc = _views(self.acc_flat, self.acc_shapes)
        self.generator = None
        self.pool = pool
        self.graph = None
        self.counts = Counter()   # what the graph's body counted
        self._source = None

    # ------------------------------------------------------------------
    def _body(self) -> None:
        """The device part: the day from the static buffers back into
        them."""
        cfg = self.cfg
        diags, fluxes = [], []
        for i, (state, outs) in enumerate(self._day_steps(
                cfg, self.pp, self.lsp, self.mc, self.state, self.ds,
                self.diag_every, eta=self.eta,
                with_fluxes=self.accumulate)):
            if outs.diag is not None:
                diags.append(outs.diag)
            if self.accumulate:
                fluxes.append(outs.fluxes)
            if self.grids:
                for k, g in self._gridded(cfg, self.mc, state.prog).items():
                    self.out[k][i].copy_(g)
        copy_state(self.state, state)
        self.guard.copy_(guard_extrema(diags))
        if self.accumulate:
            g = self._gridded(cfg, self.mc, state.prog)
            for k in ACC_GRIDS:
                self.acc[k].add_(g[k])
            for k in ACC_FLUXES:
                self.acc[k].add_(step_sum([getattr(f, k) for f in fluxes]))
        if self.collect:
            for f in Diagnostics._fields:
                self.out[f].copy_(torch.stack([getattr(d, f)
                                               for d in diags]))

    def capture(self) -> None:
        """On CUDA, warm up one day (the first staged date row) on a side
        stream on the staged state, stage the loaded state (and the
        accumulators as they were) again, and capture the day; a no-op
        once captured, on the CPU and for a day that runs eagerly
        (``captured`` false). Needs ``load`` and ``set_days`` first;
        ``advance`` calls it."""
        if self.graph is not None or not self.captured:
            return
        if self._source is None or self.days.shape[0] == 0:
            raise RuntimeError("load a state and set its days before the "
                               "first day")
        with host_sync():
            with tracing.span("capture.warmup"):
                self.date.copy_(self.days[0])
                acc = self.acc_flat.clone()
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self._body()
                torch.cuda.current_stream(self.device).wait_stream(side)
                copy_state(self.state, self._source)
                self.acc_flat.copy_(acc)
            with tracing.span("capture.graph"):
                graph = torch.cuda.CUDAGraph()
                # a collection inside the capture could destroy another
                # graph (of a dropped object in a reference cycle), which a
                # capturing stream does not permit: it would invalidate
                # this capture
                gc.collect()
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with tracing.recorded() as counts, \
                            torch.cuda.graph(graph, pool=self.pool):
                        self._body()
                finally:
                    if gc_on:
                        gc.enable()
            tracing.count("graph.captures")
        self.counts = counts
        self.graph = graph
        self._source = None

    # ------------------------------------------------------------------
    def load(self, state) -> None:
        """Stage ``state`` (same shapes as the template) as the next day's
        start; the caller's tensors are copied, never kept."""
        copy_state(self.state, state)
        if self.cfg.sppt_on:
            self.generator = state.sppt.generator
        if self.graph is None and self.captured:
            self._source = state

    def set_days(self, rows: np.ndarray) -> None:
        """The date inputs of the next days, [days, F] as
        ``coupling.pack_date_scalars`` gives them, in one copy to the
        device."""
        n = rows.shape[0]
        if self.days.shape[0] < n:
            self.days = torch.empty((n, self.date.numel()),
                                    dtype=self.date.dtype, device=self.device)
            self.rows = torch.empty((n,) + tuple(self.guard.shape),
                                    dtype=self.guard.dtype,
                                    device=self.device)
        host = torch.from_numpy(np.ascontiguousarray(rows)).to(
            self.date.dtype)
        if self.device.type == "cuda":   # a copy the host does not wait on
            host = host.pin_memory()
        self.days[:n].copy_(host, non_blocking=True)

    def advance(self, d: int, noise=None) -> None:
        """Day ``d`` of the staged rows: its date row and SPPT innovations
        (from ``noise`` where given, else the loaded generators) staged,
        then the replay (the eager day on the CPU), and its guard extrema
        kept as row d of ``guard_rows``. No host synchronisation after the
        first day's capture."""
        self.capture()
        self.date.copy_(self.days[d])
        if self.cfg.sppt_on:
            with tracing.span("day.draw"):
                self.generator = draw_day(self.generator, noise, self.eta)
        with tracing.span("day.replay"):
            if self.graph is not None:
                self.graph.replay()
                tracing.replay(self.counts)
            else:
                self._body()
        self.rows[d].copy_(self.guard)

    def reset_accumulators(self) -> None:
        """Zero the accumulating variant's sums, on the stream the replays
        run on (no host synchronisation)."""
        self.acc_flat.zero_()

    # ------------------------------------------------------------------
    def _copy(self, tensor: torch.Tensor, shapes=None) -> HostCopy:
        """``HostCopy(tensor, shapes)``, enqueued now; its bytes count as
        ``d2h.bytes``."""
        self.host_copies += 1
        tracing.count("d2h.bytes", tensor.numel() * tensor.element_size())
        return HostCopy(tensor, shapes)

    def _fetch(self, tensor: torch.Tensor) -> np.ndarray:
        """A host copy of ``tensor``, waited for."""
        return self._copy(tensor).wait()

    def guard_rows(self, n: int) -> np.ndarray:
        """The guard extrema of days 0..n-1 of the staged rows, [n, 4, ...,
        kx], in one host copy."""
        return self._fetch(self.rows[:n])

    def accumulated(self, n: int) -> Tuple[Dict[str, np.ndarray],
                                           np.ndarray]:
        """The accumulating variant's sums since the last
        ``reset_accumulators`` (u, t [..., kx, il, ix] summed over the
        days' ends; precnv, precls, olr, tsr, ssr [..., il, ix] summed over
        their steps) and the guard rows of days 0..n-1 (``guard_rows``),
        together in one host copy."""
        flat = self._fetch(torch.cat([self.acc_flat,
                                      self.rows[:n].reshape(-1)]))
        size = self.acc_flat.numel()
        return (_views(flat[:size], self.acc_shapes),
                flat[size:].reshape((n,) + tuple(self.guard.shape)))

    def outputs(self, steps: Optional[Sequence[int]] = None
                ) -> Dict[str, np.ndarray]:
        """The last day's outputs (the output variants) in one host copy:
        every step's diagnostics (reke, deke, tmean [nsteps, ..., kx]) and,
        with ``grids``, gridded fields (u, v, t, q, phi [nsteps, ..., kx,
        il, ix], ps [nsteps, ..., il, ix]). With ``steps`` (step indices of
        the day), the gridded fields of those steps only, in that order
        ([len(steps), ...])."""
        return self.copy_outputs(steps).wait()

    def copy_outputs(self, steps: Optional[Sequence[int]] = None
                     ) -> HostCopy:
        """``outputs(steps)`` enqueued on the replays' stream and not waited
        for: with ``steps``, the fields of those steps are gathered behind
        the diagnostics into a new buffer on the device, which later
        replays do not touch, before the copy; the next day can be
        enqueued before ``wait()``."""
        if steps is None or not self.grids or \
                list(steps) == list(range(self.cfg.nsteps)):
            return self._copy(self.out_flat, self.out_shapes)
        shapes = {f: self.out_shapes[f] for f in Diagnostics._fields}
        n_diag = sum(int(np.prod(s)) for s in shapes.values())
        grids = [k for k in self.out_shapes if k not in shapes]
        shapes.update({k: (len(steps),) + self.out_shapes[k][1:]
                       for k in grids})
        parts = [self.out_flat[:n_diag]] + [self.out[k][i].reshape(-1)
                                            for k in grids for i in steps]
        return self._copy(torch.cat(parts), shapes)

    def result(self):
        """The staged state as a new ModelState (a copy: the next replay
        overwrites the static buffers), with the SPPT generators advanced
        past the days run."""
        return _rebuild(self.state, [x.clone() for x in leaves(self.state)],
                        self.generator)


def members_of(state) -> Optional[int]:
    """The member count of an ensemble state, None for one model's."""
    vor = state.prog.vor
    return vor.shape[0] if vor.dim() == 6 else None
