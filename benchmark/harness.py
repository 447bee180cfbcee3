"""One run of one cell of the benchmark, driven by data.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix. Everything that belongs to one of them lives in files of
its own, found by name: the configuration's sizes in the file its entry
names (``configs/<config>.json``), the cell's run parameters in
``workloads/<cell>.json``, the entry point that the parameters' ``driver``
names in ``drivers/<driver>.py``, and each metric's reader in
``metrics/<metric>.py`` (or, for a metric split by the end-to-end metric it
moves, ``metrics/<name before the first dot>.py``), and the plain
reference the check follows in the package the configuration's file names
(``"reference": "<dir>"``: ``<dir>/__init__.py``), or without that key
``reference/`` (SPEEDY's frozen day; its ``__init__.py`` says what a
reference package gives). Adding a cell, a configuration, a model with its
reference or a metric adds files and entries; no file here changes.

A run: the program is built, booted and perturbed from the seed, warmed
up through one call of its entry (the warm-up day and the capture), then
driven in whole calls of the cell's chunk until ``--seconds`` have passed,
ending in a synchronise. With ``--trace 1`` a short sub-window is then
profiled. Last, once the peak memory is read and the program is freed, the
check: the configuration's plain reference follows the program's own state
through one day of the timed entry, and the comparison decides
``correct`` (check.py).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
import traceback
import zlib
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# every build and kernel cache under the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "speedy_tpu")


class Spans:
    """The benchmark's own spans: named host-clock intervals around the
    calls it makes, kept in memory (``done``: each one's seconds,
    ``stamps``: each one's end); each is also a profiler range
    (``bench.<name>``) so a trace can name what the host was in."""

    def __init__(self):
        self.done: Dict[str, List[float]] = {}
        self.stamps: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        import torch
        with torch.profiler.record_function("bench." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.done.setdefault(name, []).append(t1 - t0)
                self.stamps.setdefault(name, []).append(t1)


def load_manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell as its files give it: the manifest's entry, the
    configuration's entry and sizes, the traffic's run parameters, and the
    metrics it reports."""

    def __init__(self, name: str, manifest: Optional[dict] = None,
                 root: str = ROOT):
        m = manifest if manifest is not None else load_manifest(
            os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in m["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in m["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        paths = m["paths"]
        self.params = None
        for p in paths:
            path = os.path.join(root, p, "workloads", name + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    self.params = json.load(f)
                self.package_dir = os.path.join(root, p)
                break
        if self.params is None:
            raise FileNotFoundError(f"no workloads/{name}.json under "
                                    f"{paths}")
        # the directory of the reference package the configuration names,
        # or None for the default (``reference``)
        self.reference_dir = None
        ref = self.config.get("reference")
        if ref is not None:
            path = os.path.join(self.package_dir, str(ref))
            if not str(ref).isidentifier() or not os.path.isfile(
                    os.path.join(path, "__init__.py")):
                raise FileNotFoundError(
                    f"configuration {self.entry['config']!r} names the "
                    f"reference {ref!r}: no package {path}")
            self.reference_dir = path
        self.chips = int(self.entry["chips"])
        self.end_to_end = [x for x in m["end_to_end"]
                           if name in x.get("workloads", [name])]
        reported = {x["name"] for x in self.end_to_end}
        self.per_layer = [x for x in m["per_layer"]
                          if (name in x["workloads"] if "workloads" in x
                              else x["moves"] in reported)]

    @property
    def members(self) -> int:
        return int(self.params.get("members", 1))

    @property
    def sppt(self) -> bool:
        return bool(self.params.get("sppt", False))

    @property
    def reference(self):
        """The configuration's reference package: the one in
        ``reference_dir``, or without it this benchmark's ``reference/``,
        which a copy of the benchmark's directory need not hold."""
        if self.reference_dir is None:
            from . import reference
            return reference
        return load_file(
            "benchmark_reference_%08x" % zlib.crc32(
                self.reference_dir.encode()),
            os.path.join(self.reference_dir, "__init__.py"), package=True)

    @property
    def model_config(self) -> Dict[str, Any]:
        """The ModelConfig fields: the configuration file's ``model`` with
        the cell's overrides (SPPT, the output interval)."""
        kw = dict(self.config["model"])
        kw["sppt_on"] = self.sppt
        kw.update(self.params.get("model", {}))
        return kw


def load_file(modname: str, path: str, package: bool = False):
    """The module in the file ``path``, loaded under the name ``modname``.
    A package's ``__init__.py`` (``package``) is kept in sys.modules, so
    that its relative imports resolve, and loaded once a process."""
    if package and modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(
        modname, path, submodule_search_locations=(
            [os.path.dirname(path)] if package else None))
    mod = importlib.util.module_from_spec(spec)
    if package:
        sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        if package:
            del sys.modules[modname]
        raise
    return mod


def find_module(package_dir: str, kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's directory, or
    for a dotted name ``<kind>/<name before the first dot>.py``; None
    where neither exists."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(package_dir, kind, stem + ".py")
        if os.path.exists(path):
            return load_file(f"benchmark_{kind}_{stem.replace('.', '_')}",
                             path)
    return None


class Run:
    """What one run measured, as the metric readers read it."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_process: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.device = trace, device
        self.t_process = t_process
        self.spans = Spans()
        self.setup_s = None
        self.window_days = 0
        self.window_s = None
        self.window_start = None
        self.calls = 0
        self.failed = 0
        self.trace = None
        self.profile_days = 0
        self.first_run = False
        # readings beyond the cell's limits (control.py): this many of the
        # check day's first steps, and the entry's other path
        self.check_steps = 0
        self.check_other = False

    # the configuration's shapes, as the counts read them, and the
    # reference package whose tables they count (``reference``)
    @property
    def shapes(self) -> Dict[str, Any]:
        return dict(self.cell.model_config, reference=self.cell.reference)

    @property
    def members(self) -> int:
        return self.cell.members

    @property
    def nsteps(self) -> int:
        return int(self.shapes["nsteps"])

    @property
    def wall_per_day_s(self) -> float:
        """The unprofiled wall a simulated day of the window."""
        return self.window_s / self.window_days

    def day_seconds(self) -> List[float]:
        """Each simulated day of the window, from one day-end writer call
        to the next (the first from the window's start)."""
        stamps = [t for t in self.spans.stamps.get("writer", [])
                  if t > self.window_start][:self.window_days]
        edges = [self.window_start] + stamps
        return [b - a for a, b in zip(edges, edges[1:])]


def quantile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[int(q) - 1]


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(run: Run, entries: List[dict]) -> Dict[str, dict]:
    """Each metric's value by its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in entries:
        mod = find_module(run.cell.package_dir, "metrics", m["name"])
        if mod is None:
            raise FileNotFoundError(f"no reader for metric {m['name']!r}")
        value = mod.read(run, m["name"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def make_driver(run: Run):
    """The driver the cell's traffic names, for ``run``."""
    cell = run.cell
    drivers = find_module(cell.package_dir, "drivers", cell.params["driver"])
    if drivers is None:
        raise FileNotFoundError(f"no driver {cell.params['driver']!r}")
    return drivers.Driver(run)


def start(run: Run, driver, log=print) -> None:
    """Set-up: the program built, booted and perturbed, then the warm-up
    call (the warm-up day and the capture); ``run.setup_s`` from the
    process's start to here, ending in a synchronise."""
    import torch
    driver.setup()
    with run.spans.span("capture"):
        driver.warm_up()
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - run.t_process
    run.first_run = driver.built_libraries()
    log(f"setup_s {run.setup_s:.3f} (capture "
        f"{run.spans.done['capture'][0]:.3f} s, libraries built in this "
        f"process: {run.first_run})", file=sys.stderr)


def window(run: Run, driver, seconds: float) -> None:
    """Whole calls of the cell's chunk until ``seconds`` have passed,
    ending in a synchronise; a call that raises ends the window and counts
    as failed."""
    import torch
    run.window_start = t0 = time.perf_counter()
    while True:
        run.calls += 1
        try:
            with run.spans.span("chunk"):
                run.window_days += driver.chunk()
        except Exception:    # the program failed a call: reported
            traceback.print_exc()
            run.failed += 1
            break
        if time.perf_counter() - t0 >= seconds:
            break
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0


def drive(cell: Cell, seed: int, seconds: float, trace: bool,
          device: str = "cuda", t_process: Optional[float] = None,
          log=print) -> dict:
    """One run of ``cell``: set-up, warm-up, window, optional trace, check.
    Returns the result line's object."""
    import torch
    from . import check as chk
    t_process = time.perf_counter() if t_process is None else t_process
    run = Run(cell, seed, seconds, trace, device, t_process)
    driver = make_driver(run)
    on_card = device == "cuda"
    try:
        start(run, driver, log)
        window(run, driver, seconds)
        peak = torch.cuda.max_memory_allocated() if on_card else 0

        days = run.day_seconds()
        if days:
            q = lambda x: quantile(days, x) * 1e3
            log(f"day_ms n={len(days)} p50={q(50):.2f} p90={q(90):.2f} "
                f"p95={q(95):.2f} p99={q(99):.2f} max={max(days) * 1e3:.2f}",
                file=sys.stderr)
        if trace and not run.failed:
            run.profile_days = int(cell.params["profile_days"])
            from .trace import profile
            call = driver.profile_call(run.profile_days)

            def sub_window():
                with run.spans.span("chunk"):
                    call()
            run.trace = profile(sub_window)

        names = forbidden_modules()
        if names:
            raise RuntimeError("modules of JAX or the JAX package loaded: "
                               + ", ".join(names))
        wanted = cell.per_layer if trace else cell.end_to_end
        metrics = read_metrics(run, wanted) if run.window_days else {}

        numbers = {}
        if not run.failed:
            pair = driver.check_day()
            driver.free()
            if on_card:
                torch.cuda.empty_cache()
            t_check = time.perf_counter()
            numbers = chk.evaluate(run, pair)
            log(f"check_s {time.perf_counter() - t_check:.3f}",
                file=sys.stderr)
    finally:
        driver.close()
    for k, v in numbers.items():
        log(f"candidate {k} {v!r}", file=sys.stderr)
    limits = cell.params["check"]
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limit}
              for k, limit in limits.items()}
    correct = run.failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": run.calls + 1,
              "failed": run.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device,
                         "kind": torch.cuda.get_device_name(0)
                         if on_card else device,
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if run.trace is not None:
        from .trace import busy_us, idle_gaps, top_kernels
        result["device"].update(busy_s=busy_us(run.trace.kernels) * 1e-6,
                                window_s=run.trace.wall_s)
        result["breakdown"] = {"device_ops": top_kernels(run.trace.kernels),
                               "idle_gaps": idle_gaps(run.trace)}
    result["first_run"] = run.first_run
    result["checks"] = checks
    return result
