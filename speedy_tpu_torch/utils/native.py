"""Build and load the package's native sources.

Each library is compiled once into a shared object with a plain C
interface and loaded with ``ctypes``: a CUDA source with ``nvcc``,
NVCC_FLAGS and the library's own flags; a host C++ source (``host=True``,
the NetCDF writer) with ``g++``, GXX_FLAGS and its own flags after the
sources (libraries to link). The build happens at first use, into
``speedy_tpu_torch/csrc/build/`` (git-ignored), under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused within a checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_loaded = {}
build_seconds = {}
build_log = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def gxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found")
    return path


def _library_path(name: str, sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, sources, flags, host: bool = False):
    """Start the compiler for ``sources`` unless the library exists;
    returns (path, process or None, temporary path, start time, compiler
    name)."""
    base = GXX_FLAGS if host else NVCC_FLAGS
    path = _library_path(name, sources, base + list(flags))
    compiler = "g++" if host else "nvcc"
    if os.path.exists(path):
        return path, None, None, 0.0, compiler
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [os.path.join(CSRC, s) for s in sources]
    if host:
        cmd = [gxx_path(), *GXX_FLAGS, "-o", tmp, *srcs, *flags]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp, *srcs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return path, proc, tmp, time.perf_counter(), compiler


def _finish(name: str, started) -> str:
    path, proc, tmp, t0, compiler = started
    if proc is None:
        return path
    out, err = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = out + err
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed for {name}:\n{err}")
    os.replace(tmp, path)
    return path


def build(name: str, sources, flags=(), host: bool = False) -> str:
    """Compile ``sources`` (file names under csrc/) with ``flags`` added to
    NVCC_FLAGS (or, with ``host``, to GXX_FLAGS) into a shared library
    unless it exists already; returns its path."""
    return _finish(name, _start(name, sources, flags, host))


def build_all(libraries: dict) -> None:
    """Build every library of ``{name: (sources, flags)}``, one nvcc
    process for each, all started together."""
    started = {name: _start(name, srcs, flags)
               for name, (srcs, flags) in libraries.items()}
    errors = []
    for name, st in started.items():
        try:
            _finish(name, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, sources, flags=(), host: bool = False) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name, sources, flags, host))
    return _loaded[name]
