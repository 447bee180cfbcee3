"""Helpers of the sp axis's tests (tests/test_torch_mesh_sp.py and
test_torch_mesh_sp_presets.py), importing no JAX: tests/torch_mesh_worker.py
over torchrun ranks, and the checks of what the ranks saved. Bounds are
max |sharded - unsharded| / max |unsharded| per field and member."""
import os
import subprocess
import sys

import numpy as np

from speedy_tpu_torch.utils import calendar as cal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-12
START = cal.Datetime(1982, 1, 1)
TIMEOUT = 300


def torchrun(nproc, *args, cwd, timeout=TIMEOUT):
    """tests/torch_mesh_worker.py over ``nproc`` ranks (torchrun, Gloo,
    one thread each) in ``cwd``."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc),
         os.path.join(REPO, "tests", "torch_mesh_worker.py"), str(cwd),
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def gathered(d):
    return dict(np.load(os.path.join(d, "gathered.npz")))


def assert_matches(got, estate, n_members, bound=BOUND):
    """The gathered tree against an unsharded ensemble state, per field
    and member."""
    bad = {}
    for group in ("prog", "surf", "rad"):
        for f, v in getattr(estate, group)._asdict().items():
            g = got[f"{group}.{f}"]
            assert g.shape == tuple(v.shape), (group, f)
            for m in range(n_members):
                err = rel_err(g[m], v[m].numpy())
                if not err <= bound:
                    bad[(group, f, m)] = err
    if estate.sppt is not None:
        for m in range(n_members):
            err = rel_err(got["sppt.spec"][m], estate.sppt.spec[m].numpy())
            if not err <= bound:
                bad[("sppt", "spec", m)] = err
    assert not bad, bad


def assert_spec_equal_across_sp(d, dp, n_sp):
    """Every sp rank of a dp row holds the same spectral leaves, bit for
    bit."""
    for row in range(dp):
        first = np.load(os.path.join(d, f"spec{row * n_sp}.npz"))
        for k in range(1, n_sp):
            other = np.load(os.path.join(d, f"spec{row * n_sp + k}.npz"))
            assert first.files == other.files
            for f in first.files:
                assert np.array_equal(first[f], other[f]), (row, k, f)
