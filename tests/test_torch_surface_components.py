"""climt_tpu_torch's surface and land components against the JAX package,
on the CPU at float64: BucketHydrology, SeaIce, LandIce, IceSheet,
LandMask, DataOcean (with mid_month_values and interp_time), SecondBEST
with its BEST process objects, and examples/ice_sheet.py.  Every floating
output is held to 1e-10 of its max; area_type and the land mask's
nearest-neighbour indices exactly.  Each new component's device default
is the CUDA card, and without one it raises.
"""

import contextlib
import datetime
from datetime import timedelta

import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.components import geodata as jgeo
from climt_tpu_torch.components import geodata as tgeo

from torch_helpers import (AREA_KINDS, assert_outputs_match,
                           assert_states_match, ice_fields, rel_err,
                           reset_port_registries, run_both_examples,
                           surface_fields)

DT = timedelta(minutes=30)


@pytest.fixture(autouse=True)
def _reset_port_registries():
    reset_port_registries()
    yield
    reset_port_registries()


def _states(comp_t, comp_j, nx=8, ny=4, nz=6):
    return [pkg.get_default_state(
        [comp], grid_state=pkg.get_grid(nx=nx, ny=ny, nz=nz))
        for pkg, comp in ((tct, comp_t), (jct, comp_j))]


def _set(states, fields):
    for name, value in fields.items():
        for s in states:
            if name in s:
                s[name].values[:] = value


def _step_both(comp_t, comp_j, st, sj, n_calls):
    """n_calls calls of both, each output fed back; the last outputs."""
    for _ in range(n_calls):
        outs_t, outs_j = comp_t(st, DT), comp_j(sj, DT)
        assert_outputs_match(outs_t, outs_j)
        for o_t, o_j in zip(outs_t, outs_j):
            st.update(o_t)
            sj.update(o_j)
    return outs_t, outs_j


@pytest.mark.parametrize('options', [
    {}, dict(num_layers=2, moisture_diffusion_timescale=86400.0),
    dict(num_layers=2, deep_drainage_timescale=5 * 86400.0)],
    ids=['one_layer', 'two_layers', 'two_layers_drained'])
def test_bucket_hydrology_matches_jax(options):
    """Three calls; buckets from dry to full, some raining."""
    comp_t = tct.BucketHydrology(device='cpu', **options)
    comp_j = jct.BucketHydrology(**options)
    st, sj = _states(comp_t, comp_j)
    rng = np.random.RandomState(5)
    fields = surface_fields(st, rng)
    shape = fields['surface_temperature'].shape
    fields.update({
        'lwe_thickness_of_soil_moisture_content': 0.2 * rng.rand(*shape),
        'deep_soil_moisture_content': 0.55 * rng.rand(*shape),
        'deep_soil_temperature': 280.0 + 10.0 * rng.rand(*shape),
        'convective_precipitation_rate': 2e-7 * rng.rand(*shape),
        'stratiform_precipitation_rate': 1e-7 * rng.rand(*shape),
    })
    _set((st, sj), fields)
    outs_t, outs_j = _step_both(comp_t, comp_j, st, sj, 3)
    if 'runoff_rate' in outs_j[0]:
        assert np.asarray(outs_j[0]['runoff_rate'].values).max() > 0


@pytest.mark.parametrize('name', ['SeaIce', 'LandIce', 'IceSheet'])
def test_snow_ice_matches_jax(name):
    """Three calls over a mix of area types."""
    with (pytest.warns(DeprecationWarning) if name == 'IceSheet'
          else contextlib.nullcontext()):
        comp_t = getattr(tct, name)(device='cpu')
    comp_j = getattr(jct, name)()
    st, sj = _states(comp_t, comp_j)
    fields = ice_fields(st, np.random.RandomState(6))
    _set((st, sj), fields)
    outs_t, _ = _step_both(comp_t, comp_j, st, sj, 3)
    assert rel_err(outs_t[1]['snow_and_ice_temperature'].values,
                   fields['snow_and_ice_temperature']) > 1e-4


def test_snow_ice_refuses_a_column_too_tall():
    comp = tct.SeaIce(device='cpu', maximum_snow_ice_height=2.0)
    state = tct.get_default_state([comp])
    state['area_type'].values[:] = 'sea_ice'
    state['sea_ice_thickness'].values[:] = 1.5
    state['surface_snow_thickness'].values[:] = 1.0
    with pytest.raises(ValueError, match='exceeds maximum'):
        comp(state, DT)


@pytest.mark.parametrize('options', [
    {}, dict(load_topography=False), dict(include_land_ice=False)],
    ids=['default', 'no_topography', 'no_land_ice'])
def test_land_mask_matches_jax(options):
    """The bundled 2-degree mask and topography on a 32x16 grid: the
    nearest-neighbour indices and area_type exactly, the topography to
    1e-10 of max."""
    comp_t = tct.LandMask(device='cpu', **options)
    comp_j = jct.LandMask(**options)
    st, sj = _states(comp_t, comp_j, nx=32, ny=16, nz=4)
    out_t, out_j = comp_t(st), comp_j(sj)
    assert_outputs_match(out_t, out_j)
    for a, b in zip(comp_t._weights, comp_j._weights):
        assert np.array_equal(a, b)
    kinds = set(np.asarray(out_t['area_type'].values).ravel())
    assert kinds == ({'sea', 'land'} if options.get('include_land_ice', 1)
                     is False else {'sea', 'land', 'land_ice'})
    # a second call on the same grid gives the same fields
    assert_outputs_match(comp_t(st), out_j)


def test_mid_month_values_and_interp_time_match_jax():
    means = 280.0 + 10.0 * np.random.RandomState(7).rand(12, 3, 4)
    mid_t, mid_j = tgeo.mid_month_values(means), jgeo.mid_month_values(means)
    assert rel_err(mid_t, mid_j) <= 1e-12
    for when in (datetime.datetime(2001, 1, 3), datetime.datetime(2001, 1,
                                                                   20, 6),
                 datetime.datetime(2001, 7, 3, 9, 30),
                 datetime.datetime(2001, 12, 30, 18)):
        assert rel_err(tgeo.interp_time(torch.as_tensor(mid_t), when),
                       jgeo.interp_time(mid_j, when)) <= 1e-12


def _data_ocean_states(comp_t, comp_j, rng):
    """32x16 states with a mix of area types and surface temperatures;
    for compute_fluxes, the near-surface fields DataOcean reads as (lat,
    lon) fields (no default state has them so)."""
    surface = {'area_type': ('dimensionless', AREA_KINDS),
               'surface_temperature': ('degK', (250.0, 50.0)),
               'latitude': ('degrees_north', None),
               'longitude': ('degrees_east', None),
               'eastward_wind': ('m/s', (0.0, 6.0)),
               'northward_wind': ('m/s', (0.0, 3.0)),
               'air_temperature': ('degK', (280.0, 20.0)),
               'specific_humidity': ('kg/kg', (0.0, 0.01)),
               'surface_specific_humidity': ('kg/kg', (0.0, 0.015)),
               'air_density': ('kg/m^3', (1.1, 0.2))}
    grid = tct.get_grid(nx=32, ny=16, nz=4)
    shape = grid['latitude'].shape
    st, sj = {'time': datetime.datetime(2000, 1, 1)}, {}
    for name in comp_j.input_properties:
        units, values = surface[name]
        if values is None:
            values = np.asarray(grid[name].values)
        elif name == 'area_type':
            values = values[rng.randint(0, 4, shape)]
        else:
            values = values[0] + values[1] * rng.rand(*shape)
        for pkg, s in ((tct, st), (jct, sj)):
            s[name] = pkg.DataArray(values.copy(), dims=('lat', 'lon'),
                                    attrs={'units': units})
    return st, sj


@pytest.mark.parametrize('options', [
    {}, dict(time_interpolation='monthly'), dict(compute_fluxes=True)],
    ids=['mid_month', 'monthly', 'compute_fluxes'])
def test_data_ocean_matches_jax(options):
    """The bundled 1-degree SST climatology at four times of year."""
    comp_t = tct.DataOcean(device='cpu', **options)
    comp_j = jct.DataOcean(**options)
    assert rel_err(comp_t._mid, comp_j._mid) == 0
    st, sj = _data_ocean_states(comp_t, comp_j, np.random.RandomState(8))
    for when in (datetime.datetime(2000, 1, 2), datetime.datetime(2000, 4,
                                                                  15, 12),
                 datetime.datetime(2000, 8, 31, 23),
                 datetime.datetime(2000, 12, 24, 6)):
        st['time'] = sj['time'] = when
        assert_outputs_match(comp_t(st), comp_j(sj))


@pytest.mark.parametrize('soil_type, frozen', [('clay', False),
                                               ('sand', True)])
def test_second_best_matches_jax(soil_type, frozen):
    """Two calls over land, land ice and sea; frozen soil starts below
    freezing with ice in it, so melt and freeze both run."""
    comp_t = tct.SecondBEST(device='cpu', soil_type=soil_type)
    comp_j = jct.SecondBEST(soil_type=soil_type)
    st, sj = _states(comp_t, comp_j)
    rng = np.random.RandomState(9)
    fields = surface_fields(st, rng)
    soil_shape = st['soil_temperature'].shape
    fields.update({
        'soil_temperature': (268.0 if frozen else 283.0)
        + 8.0 * rng.rand(*soil_shape),
        'soil_liquid_water_content': 0.05 + 0.3 * rng.rand(*soil_shape),
        'soil_ice_content': (0.1 if frozen else 0.0) * rng.rand(
            *soil_shape),
    })
    if frozen:
        fields['surface_temperature'] = 262.0 + 15.0 * rng.rand(
            *fields['surface_temperature'].shape)
    _set((st, sj), fields)
    _step_both(comp_t, comp_j, st, sj, 2)


def test_best_process_objects_match_jax():
    """The BEST process objects alone on the same columns (the port's
    SoilProperties takes the dtype of its parameters too)."""
    rng = np.random.RandomState(10)
    ice = rng.rand(24) < 0.3
    wet = 0.2 + 0.6 * rng.rand(24)
    layer_args = (5.0 + 20.0 * rng.rand(24), np.where(ice, 0.001, 0.01),
                  0.5 + 8.0 * rng.rand(24), np.full(24, 288.0),
                  283.0 + 10.0 * rng.rand(24))
    profiles = {'T': np.linspace(270.0, 276.0, 5)[:, None]
                + rng.rand(5, 24),
                'X_w': 0.2 * rng.rand(5, 24), 'X_i': 0.05 * rng.rand(5, 24)}
    flux_bc = np.linspace(-50.0, 50.0, 24)
    out = {}
    for pkg, wrap in ((tct, torch.as_tensor), (jct.components, np.asarray)):
        extra = (torch.float64,) if pkg is tct else ()
        props = pkg.BestSoilProperties()('sand', wrap(ice), *extra)
        out[pkg] = dict(props, **pkg.BestSurfaceAlbedo()(
            props, wrap(wet), wrap(ice)))
        out[pkg].update(pkg.BestSurfaceLayer()(*map(wrap, layer_args)))
        transport = pkg.BestSubsurfaceTransport()(
            {k: wrap(v) for k, v in profiles.items()},
            surface_flux_bc=wrap(flux_bc), timestep=1800.0,
            dz=wrap(np.full(24, 0.4)))
        out[pkg].update({'sub_' + k: v for k, v in transport.items()})
    for name, value in out[jct.components].items():
        if np.ndim(value):
            assert rel_err(out[tct][name], value) <= 1e-10, name
        else:
            assert out[tct][name] == value, name


def test_ice_sheet_example_matches_jax():
    """examples/ice_sheet.py, 50 steps of 100 minutes."""
    st, sj, _ = run_both_examples('ice_sheet', n_steps=50)
    assert_states_match(st, sj)


NEW_COMPONENTS = ['Instellation', 'GridScaleCondensation',
                  'DryConvectiveAdjustment', 'DcmipInitialConditions',
                  'SimpleBoundaryLayer', 'BucketHydrology', 'SeaIce',
                  'LandIce', 'IceSheet', 'BergerSolarInsolation', 'LandMask',
                  'DataOcean', 'SecondBEST']


def test_port_exports_every_component_class_of_the_jax_package():
    names = {name for name, value in vars(jct.components).items()
             if isinstance(value, type)
             and value.__module__.startswith('climt_tpu.components')}
    assert len(names) == 27
    for name in names:
        assert isinstance(getattr(tct, name, None), type), name
        assert getattr(tct, name).__name__ == name


@pytest.mark.parametrize('name', NEW_COMPONENTS)
def test_new_component_defaults_to_the_card(name, monkeypatch):
    """Built with no device, each computes on 'cuda', and without a card
    it raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        getattr(tct, name)()
