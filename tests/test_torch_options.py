"""The options of the port that no other test holds, against the JAX
package, fp64 on the CPU: ``increase_co2``, ``ice_coupling_flag=0``,
``land_coupling_flag=0``, ``iseasc=0``, and ``l_globe=False`` with each
regional ocean domain (``l_northe`` ... ``l_elnino``). Each is one
parametrised case of boot + 6 steps from 1982-01-01 at T21 kx=5
(<= 1e-10 per field, tests/torch_parity.py), on the stand-in boundary
set (the JAX model reads HDF5 copies of it, the port the same arrays in
memory). Each configuration compiles the JAX step anew, hence the small
grid. The reference LW order and SST-anomaly forcing have files of their
own (tests/test_torch_lw_order.py, test_torch_sst.py).
"""
import pytest

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_parity import SMALL, START, assert_close, jax_steps, port_steps

OPTIONS = {
    "increase_co2": dict(increase_co2=True),
    "ice_coupling_0": dict(ice_coupling_flag=0),
    "land_coupling_0": dict(land_coupling_flag=0),
    "iseasc_0": dict(iseasc=0),
    **{f"domain_{d}": dict(l_globe=False, **{f"l_{d}": True})
       for d in ("northe", "natlan", "npacif", "tropic", "indian",
                 "elnino")},
}


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def bc_dir(bc, tmp_path_factory):
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    return str(d)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_boot_and_steps_match_jax(bc, bc_dir, option):
    kw = dict(SMALL, **OPTIONS[option])
    jm = JModel(jt30(**kw), bc_search=[bc_dir])
    tm = Model(t30(**kw), device="cpu", bc_arrays=bc)
    _, js, _ = jax_steps(jm, jcal.Datetime(*START))
    _, ts = port_steps(tm, cal.Datetime(*START))
    assert_close(js, ts)
