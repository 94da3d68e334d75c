"""The column examples on climt_tpu_torch against the JAX package's, on
the CPU at float64: each examples/*.py text with climt_tpu replaced by
climt_tpu_torch (tests/torch_helpers.py:run_both_examples), at
tests/test_examples.py's sizes with verbose=False, every field of the
final state to 1e-10 of max.  Also the examples' output branches: the
NetCDF file of gmd_radiative_convective (read back with scipy, equal to
the JAX example's file) and the plot monitors of zenith_angle and
column_code_with_slab.

radiative_heating_rrtmg_clouds draws McICA subcolumns, which the two
packages cannot draw alike: its clear case is held to 1e-10, its cloudy
case in distribution.
"""

import gc

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from torch_helpers import (assert_states_match, rel_err,
                           reset_port_registries, run_both_examples)

TOL = 1e-10


@pytest.fixture(autouse=True)
def _reset_registries():
    reset_port_registries()
    yield
    reset_port_registries()
    plt.close('all')


@pytest.mark.parametrize('name, kw', [
    ('radiative_equilibrium', dict(n_steps=3)),
    ('radiative_convective_equilibrium', dict(n_steps=3)),
    ('radiative_equilibrium_rrtmg', dict(n_steps=2)),
    ('radiative_equilibrium_rrtmg_realistic_profiles', dict(n_steps=2)),
    ('simple_physics_example', dict(n_steps=3)),
    ('column_code_with_slab', dict(n_steps=3)),
    ('gmd_radiative_convective', dict(n_steps=3)),
    ('zenith_angle', dict(n_steps=2, nx=8, ny=8)),
])
def test_column_example_matches_jax(name, kw):
    st, sj, _ = run_both_examples(name, **kw)
    assert_states_match(st, sj, TOL)
    assert any(isinstance(v.values, torch.Tensor) for k, v in st.items()
               if k != 'time')


def test_radiative_heating_rrtmg_clouds_in_distribution():
    """Area fraction 0 to 1e-10; the 0.5 cloud, drawn 6 times in each
    package, moves the heating (tests/test_examples.py:66-73) and its
    in-cloud mean agrees within 4 sigma of the draws' spread."""
    fractions = (0.0,) + (0.5,) * 6
    np.random.seed(0)
    port, jax_, _ = run_both_examples('radiative_heating_rrtmg_clouds',
                                      area_fractions=fractions)
    for (af_t, sw_t, lw_t), (af_j, sw_j, lw_j) in zip(port[:1], jax_[:1]):
        assert af_t == af_j == 0.0
        assert rel_err(sw_t, sw_j) <= TOL and rel_err(lw_t, lw_j) <= TOL
    clear_sw = port[0][1]
    for _, sw, lw in port[1:]:
        assert np.isfinite(sw).all() and np.isfinite(lw).all()
    assert max(np.abs(sw - clear_sw).max() for _, sw, _ in port[1:]) > 0.01
    for k in (1, 2):                             # SW, LW
        moved = [np.stack([r[k] - ref[0][k] for r in ref[1:]])
                 for ref in (port, jax_)]
        mean_t, mean_j = (m.mean(axis=1) for m in moved)
        sigma = np.sqrt((mean_t.var() + mean_j.var()) / len(mean_t))
        assert abs(mean_t.mean() - mean_j.mean()) <= 4 * sigma + 1e-9, k


def _read_nc(path):
    gc.collect()                 # the example's monitor finalizes its file
    f = netcdf_file(path, 'r', mmap=False)
    out = {name: (np.array(var.data), var.dimensions,
                  getattr(var, 'units', b''))
           for name, var in f.variables.items()}
    f.close()
    return out


def assert_files_match(path_t, path_j, tol=TOL):
    """Two NetCDF files with the same variables, dims and units, every
    variable within tol of its max."""
    a, b = _read_nc(path_t), _read_nc(path_j)
    assert set(a) == set(b) and len(a) > 1
    for name, (values, dims, units) in b.items():
        assert a[name][1:] == (dims, units), name
        assert a[name][0].shape == values.shape, name
        assert rel_err(a[name][0], values) <= tol, name
    return a


def test_gmd_radiative_convective_netcdf_output(tmp_path):
    """20 steps: one store of the seven quantities, streamed by the
    native writer (write_on_store=True) in both packages."""
    paths = [str(tmp_path / 'port.nc'), str(tmp_path / 'jax.nc')]
    st, sj, _ = run_both_examples(
        'gmd_radiative_convective', n_steps=20,
        port_kw=dict(output_file=paths[0]),
        jax_kw=dict(output_file=paths[1]))
    assert_states_match(st, sj, TOL)
    out = assert_files_match(*paths)
    assert out['air_temperature'][0].shape[0] == 1
    assert len(out) == 8


@pytest.mark.parametrize('name, kw', [
    ('zenith_angle', dict(n_steps=2, nx=8, ny=8)),
    ('column_code_with_slab', dict(n_steps=100)),
])
def test_plot_branch(name, kw, monkeypatch):
    """plot=True: the example's plot function draws the port's state
    through PlotFunctionMonitor (headless) at every store, and the state
    still matches JAX."""
    import climt_tpu_torch
    stores = []
    store = climt_tpu_torch.PlotFunctionMonitor.store

    def counted(self, state):
        stores.append(state['time'])
        store(self, state)

    monkeypatch.setattr(climt_tpu_torch.PlotFunctionMonitor, 'store',
                        counted)
    st, sj, _ = run_both_examples(name, plot=True, **kw)
    assert_states_match(st, sj, TOL)
    assert len(stores) == (2 if name == 'zenith_angle' else 1)
    assert plt.get_fignums()
