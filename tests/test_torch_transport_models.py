"""Grid-space moisture and tracer transport through climt_tpu_torch's
models against the JAX package's, on the CPU at float64: SpectralDycore
with moisture_advection='fv'/'sl', and GFSDynamicalCore with grid
moisture and with registered tracers (tests/test_tracers.py mirrored).

The dycore runs at 64x32x10, where FV's zonal pass has five latitude
bands (the substeps).  build_moist_gcm's 'fv'/'sl' modes are in
tests/test_torch_transport_gcm.py.
"""

from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.core import tracers as jtracers
from climt_tpu.core.dataarray import DataArray as JDataArray
from climt_tpu.dycore.spectral_dynamics import SpectralDycore as JDycore
from climt_tpu_torch.core import grid as tgrid
from climt_tpu_torch.core import tracers as ttracers
from climt_tpu_torch.dycore.spectral_dynamics import SpectralDycore as TDycore

from torch_helpers import rel_err, reset_port_registries, to_torch

DT = timedelta(minutes=10)
GFS_OUTPUTS = ('eastward_wind', 'northward_wind', 'air_temperature',
               'specific_humidity', 'surface_air_pressure', 'air_pressure',
               'air_pressure_on_interface_levels', 'divergence_of_wind',
               'atmosphere_relative_vorticity')


@pytest.fixture(autouse=True)
def _reset_registries():
    reset_port_registries()
    jtracers.reset_tracers()
    jtracers.reset_packers()
    yield
    reset_port_registries()
    jtracers.reset_tracers()
    jtracers.reset_packers()


# -- SpectralDycore ---------------------------------------------------------

def _dycore_inputs(nlon, nlat, nz, mu, seed=6):
    rng = np.random.RandomState(seed)
    shape = (nz, nlat, nlon)
    mu = mu[:, None]
    u = 20.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape)
    v = rng.randn(*shape)
    T = 250.0 + 30.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape)
    q = 1e-3 * rng.rand(*shape)
    lnps = np.log(1e5) + 0.01 * rng.randn(nlat, nlon)
    phys = {k: 1e-5 * rng.randn(*shape) for k in ('du', 'dv', 'dT')}
    phys['dq'] = 1e-9 * rng.randn(*shape)
    return (u, v, T, q, lnps), phys


@pytest.mark.parametrize('mode', ['fv', 'sl'])
def test_dycore_grid_moisture_matches_jax(mode):
    """initial_step and 3 leapfrog steps with grid physics tendencies at
    64x32x10; q stays a grid field and takes no hyperdiffusion."""
    nlon, nlat, nz = 64, 32, 10
    ak, bk = tgrid.hybrid_sigma_pressure_coefficients(nz + 1, 1e5, 20.0)
    kw = dict(timestep=600.0, number_of_damped_levels=3,
              moisture_advection=mode)
    jd = JDycore(nlon, nlat, nz, ak, bk, dtype=jnp.float64, **kw)
    td = TDycore(nlon, nlat, nz, ak, bk, dtype=torch.float64, device='cpu',
                 **kw)
    if mode == 'fv':
        assert len(td.fv.zonal_bands) >= 3
    fields, phys = _dycore_inputs(nlon, nlat, nz, jd.sht.mu)
    jprev, jnow = jd.initial_step(jd.spectral_state_from_grid(
        *[jnp.asarray(x) for x in fields]))
    tprev, tnow = td.initial_step(td.spectral_state_from_grid(
        *[to_torch(x) for x in fields]))
    assert tnow['q'].shape == (nz, nlat, nlon)
    assert not tnow['q'].is_complex()
    jphys = {k: jnp.asarray(x) for k, x in phys.items()}
    tphys = {k: to_torch(x) for k, x in phys.items()}
    for _ in range(3):
        jprev, jnow, jgrids = jd.step(jprev, jnow, phys=jphys)
        tprev, tnow, tgrids = td.step(tprev, tnow, phys=tphys)
    for key in jnow:
        assert rel_err(tnow[key], jnow[key]) < 1e-10, key
        assert rel_err(tprev[key], jprev[key]) < 1e-10, key
    for key in jgrids:
        assert rel_err(tgrids[key], jgrids[key]) < 1e-10, key
    for a, b in zip(td.grids_of(tnow).values(), jd.grids_of(jnow).values()):
        assert rel_err(a, b) < 1e-10
    for a, b in zip(td.diagnose_mass_fluxes(tnow),
                    jd.diagnose_mass_fluxes(jnow)):
        assert rel_err(a, b) < 1e-12


# -- GFSDynamicalCore -------------------------------------------------------

def _gfs_states(dyc_t, dyc_j, nx=32, ny=16, nz=10):
    """Both packages' default states with a jet, a perturbed temperature
    and moisture from one seed."""
    st = tct.get_default_state([dyc_t],
                               grid_state=tct.get_grid(nx=nx, ny=ny, nz=nz))
    sj = jct.get_default_state([dyc_j],
                               grid_state=jct.get_grid(nx=nx, ny=ny, nz=nz))
    rng = np.random.RandomState(42)
    shape = st['air_temperature'].shape
    lat = np.asarray(sj['latitude'].values)
    fields = {
        'air_temperature': np.asarray(sj['air_temperature'].values)
        + 0.5 * rng.randn(*shape),
        'eastward_wind': 25.0 * np.cos(np.deg2rad(lat))[None]
        + rng.randn(*shape),
        'northward_wind': rng.randn(*shape),
        'specific_humidity': 1e-3 * rng.rand(*shape),
    }
    for s in (st, sj):
        for name, value in fields.items():
            s[name].values[:] = value
    return st, sj


def _run_both(dyc_t, dyc_j, st, sj, n_calls):
    for _ in range(n_calls):
        for dycore, state in ((dyc_t, st), (dyc_j, sj)):
            _, new_state = dycore(state, DT)
            state.update(new_state)
            state['time'] += DT


@pytest.mark.parametrize('mode', ['fv', 'sl'])
def test_gfs_grid_moisture_matches_jax(mode):
    dyc_t = tct.GFSDynamicalCore(number_of_damped_levels=5, device='cpu',
                                 moisture_advection=mode)
    dyc_j = jct.GFSDynamicalCore(number_of_damped_levels=5,
                                 moisture_advection=mode)
    st, sj = _gfs_states(dyc_t, dyc_j)
    _run_both(dyc_t, dyc_j, st, sj, 5)
    assert dyc_t._dycore.fv is not None
    for name in GFS_OUTPUTS:
        assert rel_err(st[name].values, sj[name].values) <= 1e-10, name


def _register_two(state_t, state_j, shape):
    """tracer_blob (a zonal blob) and tracer_uniform (0.5) in both
    packages, in kg/kg and g/kg."""
    lon_idx = np.arange(shape[-1])
    blob = np.broadcast_to(np.exp(-((lon_idx - shape[-1] // 4) / 2.0) ** 2),
                           shape).copy()
    for reg, state, DA in ((ttracers, state_t, tct.DataArray),
                           (jtracers, state_j, JDataArray)):
        reg.register_tracer('tracer_blob', 'kg/kg')
        reg.register_tracer('tracer_uniform', 'g/kg')
        state['tracer_blob'] = DA(blob, dims=['mid_levels', 'lat', 'lon'],
                                  attrs={'units': 'kg/kg'})
        state['tracer_uniform'] = DA(np.full(shape, 0.5),
                                     dims=['mid_levels', 'lat', 'lon'],
                                     attrs={'units': 'g/kg'})
    return blob


@pytest.mark.parametrize('mode', ['spectral', 'fv'])
def test_gfs_registered_tracers_match_jax(mode):
    """Two registered tracers move with FV on the dycore's diagnosed mass
    fluxes whatever moisture_advection is; 5 calls, to 1e-10 of max."""
    dyc_t = tct.GFSDynamicalCore(device='cpu', moisture_advection=mode)
    dyc_j = jct.GFSDynamicalCore(moisture_advection=mode)
    st, sj = _gfs_states(dyc_t, dyc_j)
    blob = _register_two(st, sj, st['air_temperature'].shape)
    _run_both(dyc_t, dyc_j, st, sj, 5)
    for name in GFS_OUTPUTS + ('tracer_blob', 'tracer_uniform'):
        assert st[name].units == sj[name].units, name
        assert rel_err(st[name].values, sj[name].values) <= 1e-10, name
    assert float((st['tracer_blob'].values - torch.as_tensor(blob))
                 .abs().max()) > 1e-4
    assert len(dyc_t._fv.zonal_bands) >= 1


# -- tests/test_tracers.py:86-137, mirrored ---------------------------------

def _tracer_dycore(nx=16, ny=8, nz=10):
    dycore = tct.GFSDynamicalCore(device='cpu')
    state = tct.get_default_state(
        [dycore], grid_state=tct.get_grid(nx=nx, ny=ny, nz=nz))
    state['eastward_wind'].values[:] = 12.0
    return dycore, state, state['air_temperature'].shape


def _add_tracer(state, name, units, field):
    state[name] = tct.DataArray(field, dims=['mid_levels', 'lat', 'lon'],
                                attrs={'units': units})


def test_two_tracers_advect_and_conserve():
    tct.register_tracer('tracer_blob', 'kg/kg')
    tct.register_tracer('tracer_uniform', 'kg/kg')
    dycore, state, shape = _tracer_dycore()
    lon_idx = np.arange(shape[-1])
    blob = np.broadcast_to(np.exp(-((lon_idx - shape[-1] // 4) / 2.0) ** 2),
                           shape).copy()
    _add_tracer(state, 'tracer_blob', 'kg/kg', blob)
    _add_tracer(state, 'tracer_uniform', 'kg/kg', np.full(shape, 0.5))
    _, out = dycore(state, DT)
    b1 = np.asarray(out['tracer_blob'])
    assert np.isfinite(b1).all() and np.abs(b1 - blob).max() > 1e-4
    np.testing.assert_allclose(np.asarray(out['tracer_uniform']), 0.5,
                               rtol=1e-10)
    assert b1.min() >= -1e-10 and b1.max() <= blob.max() + 1e-8


def test_tracer_mass_conserved_through_dycore():
    tct.register_tracer('tracer_m', 'kg/kg')
    dycore, state, shape = _tracer_dycore()
    field = 1e-3 * (1.0 + np.random.RandomState(3).rand(*shape))
    _add_tracer(state, 'tracer_m', 'kg/kg', field)
    dp = np.abs(np.diff(np.asarray(
        state['air_pressure_on_interface_levels'].values), axis=0))
    _, out = dycore(state, DT)
    w = dycore._dycore.sht.weights[None, :, None]
    m0 = float((field * dp * w).sum())
    m1 = float((np.asarray(out['tracer_m']) * dp * w).sum())
    assert abs(m1 - m0) / m0 < 5e-3


def test_dycore_without_tracers_unaffected():
    dycore, state, _ = _tracer_dycore()
    _, out = dycore(state, DT)
    assert not any(k.startswith('tracer') for k in out)
    assert dycore._fv is None
