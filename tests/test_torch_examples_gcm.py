"""The remaining GCM examples on climt_tpu_torch against the JAX
package's, on the CPU at float64: examples/gmd_aquaplanet.py (with its
NetCDF output, equal to the JAX example's file read back with scipy) and
examples/grey_gcm_energy_balanced.py, at tests/test_examples.py's sizes
with verbose=False, every field of the final state to 1e-10 of max.
Also the RRTMG table rows of a negative optical depth, which
radiative_equilibrium_rrtmg_realistic_profiles reaches, against JAX.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from climt_tpu.components.rrtmg import lw_spectral as JL
from climt_tpu.components.rrtmg import sw_spectral as JS
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import sw_spectral as TS

from torch_helpers import (assert_states_match, rel_err,
                           reset_port_registries, run_both_examples)

TOL = 1e-10
AQUAPLANET = dict(n_days=0.02, nx=32, ny=16, nz=8, dt_minutes=15)


@pytest.fixture(autouse=True)
def _reset_registries():
    reset_port_registries()
    yield
    reset_port_registries()


def test_grey_gcm_energy_balanced_matches_jax():
    st, sj, n_calls = run_both_examples('grey_gcm_energy_balanced',
                                        n_steps=2, nx=32, ny=16, nz=8)
    assert n_calls == 2
    assert_states_match(st, sj, TOL)
    assert isinstance(st['eastward_wind'].values, torch.Tensor)


def test_gmd_aquaplanet_matches_jax():
    st, sj, n_calls = run_both_examples('gmd_aquaplanet', **AQUAPLANET)
    assert n_calls == 1
    assert_states_match(st, sj, TOL)


def _read_nc(path):
    gc.collect()
    f = netcdf_file(path, 'r', mmap=False)
    out = {name: (np.array(var.data), var.dimensions,
                  getattr(var, 'units', b''))
           for name, var in f.variables.items()}
    f.close()
    return out


def test_gmd_aquaplanet_netcdf_output(tmp_path):
    """Two stores (calls 0 and 18) of five quantities through the
    buffered scipy writer; the port's file equals the JAX example's."""
    paths = [str(tmp_path / 'port.nc'), str(tmp_path / 'jax.nc')]
    kw = dict(AQUAPLANET, n_days=19 * 15 / 1440.0)
    st, sj, n_calls = run_both_examples(
        'gmd_aquaplanet', port_kw=dict(output_file=paths[0]),
        jax_kw=dict(output_file=paths[1]), **kw)
    assert n_calls == 19
    assert_states_match(st, sj, TOL)
    a, b = _read_nc(paths[0]), _read_nc(paths[1])
    assert set(a) == set(b) == {
        'time', 'air_temperature', 'eastward_wind', 'surface_air_pressure',
        'specific_humidity', 'surface_temperature'}
    for name, (values, dims, units) in b.items():
        assert a[name][1:] == (dims, units), name
        assert a[name][0].shape == values.shape, name
        assert rel_err(a[name][0], values) <= TOL, name
    assert a['air_temperature'][0].shape == (2, 8, 16, 32)


def test_table_rows_of_negative_optical_depth_follow_jax():
    """The Pade tables' rows outside the table (a negative optical depth,
    a depth past -BPADE) are taken as JAX takes them: a negative row
    counts from the end, then clamps."""
    tau = np.array([-1e6, -0.5, -1e-3, -1e-6, 0.0, 1e-6, 0.05, 0.3, 7.0,
                    499.0, 600.0, 1e6])
    out = TS._exp_transmittance(torch.as_tensor(tau))
    ref = JS._exp_transmittance(jnp.asarray(tau))
    assert rel_err(out, ref) <= 1e-15
    for a, b in zip(TL._tbl_lookup(torch.as_tensor(tau)),
                    JL._tbl_lookup(jnp.asarray(tau))):
        assert rel_err(a, b) <= 1e-15
