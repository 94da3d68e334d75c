"""climt_tpu_torch's EmanuelConvection, SimplePhysics, SlabSurface (with
and without Ekman transport), the grey radiation pair, the horizontal
operators and examples/grey_gcm.py against the JAX package, on the CPU
at float64.  Every output is held to 1e-10 of its max (measured 1e-16 to
1e-12): both packages compute the same arithmetic on the same inputs.
"""

from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.ops import horizontal as jh
from climt_tpu_torch.core import constants as tconstants
from climt_tpu_torch.core import tracers as ttracers
from climt_tpu_torch.ops import horizontal as th

from torch_helpers import assert_states_match, rel_err, run_both_examples

TOL = 1e-10
DT = timedelta(minutes=10)


def _reset_port():
    tconstants.reset_constants()
    tconstants.set_constant('top_of_model_pressure', 20., 'Pa')
    ttracers.reset_tracers()
    ttracers.reset_packers()


@pytest.fixture(autouse=True)
def _reset_port_registries():
    _reset_port()
    yield
    _reset_port()


def _states(comp_t, comp_j, nx=8, ny=4, nz=12, seed=0):
    """Both packages' default states for their components (one or a
    list) with a warm, moist, conditionally unstable troposphere, winds
    and a warm surface."""
    states = [pkg.get_default_state(
        comp if isinstance(comp, list) else [comp],
        grid_state=pkg.get_grid(nx=nx, ny=ny, nz=nz))
        for pkg, comp in ((tct, comp_t), (jct, comp_j))]
    s0 = states[0]
    rng = np.random.RandomState(seed)
    p = np.asarray(s0['air_pressure'].values)
    fields = {
        'air_temperature': np.maximum(
            302.0 * (p / 1e5) ** (2. / 7. * 0.85), 200.0)
        + 0.5 * rng.randn(*p.shape),
        'specific_humidity': 0.018 * (p / 1e5) ** 3 * (
            1.0 + 0.1 * rng.rand(*p.shape)),
        'eastward_wind': 5.0 * rng.randn(*p.shape),
        'northward_wind': 3.0 * rng.randn(*p.shape),
    }
    surface = p.shape[1:]
    fields['surface_temperature'] = 295.0 + 8.0 * rng.rand(*surface)
    for name, value in fields.items():
        for s in states:
            if name in s:
                s[name].values[:] = value
    return states


def _compare(outs_t, outs_j):
    for o_t, o_j in zip(outs_t, outs_j):
        assert set(o_t) == set(o_j)
        for name in o_j:
            assert o_t[name].units == o_j[name].units, name
            a = o_t[name].transpose(*o_j[name].dims)
            assert isinstance(a.values, torch.Tensor), name
            assert rel_err(a.values, o_j[name].values) <= TOL, name


def test_emanuel_component_matches_jax():
    """Three calls, the cloud-base mass flux fed back as the GCM does;
    the comparison has teeth only if columns convect."""
    comp_t = tct.EmanuelConvection(device='cpu')
    comp_j = jct.EmanuelConvection()
    assert issubclass(tct.EmanuelConvectionPython, tct.EmanuelConvection)
    st, sj = _states(comp_t, comp_j)
    for _ in range(3):
        outs_t = comp_t(st, DT)
        outs_j = comp_j(sj, DT)
        _compare(outs_t, outs_j)
        st.update(outs_t[1])
        sj.update(outs_j[1])
    assert (np.asarray(sj['convective_state'].values) > 0).any()
    assert np.abs(np.asarray(
        sj['convective_precipitation_rate'].values)).max() > 0


SIMPLE_OPTIONS = [
    {}, dict(large_scale_condensation=False), dict(boundary_layer=False),
    dict(surface_fluxes=False),
    dict(use_external_surface_temperature=False),
    dict(use_external_surface_temperature=False, simulate_cyclone=True),
    dict(use_external_surface_specific_humidity=True)]


@pytest.mark.parametrize('options', SIMPLE_OPTIONS,
                         ids=lambda o: ','.join(o) or 'default')
def test_simple_physics_matches_jax(options):
    comp_t = tct.SimplePhysics(device='cpu', **options)
    comp_j = jct.SimplePhysics(**options)
    st, sj = _states(comp_t, comp_j)
    qs = 0.01 * np.random.RandomState(1).rand(
        *st['surface_specific_humidity'].shape)
    st['surface_specific_humidity'].values[:] = qs
    sj['surface_specific_humidity'].values[:] = qs
    _compare(comp_t(st, DT), comp_j(sj, DT))


@pytest.mark.parametrize('include_ekman', [False, True])
def test_slab_surface_matches_jax(include_ekman):
    """Land, sea, land ice and sea ice cells, wind stress and a q-flux,
    on the 16x8 grid (Ekman needs 3 points in each direction).  With
    include_ekman neither package can be called on a state: the stress
    and coordinate inputs name 'lat' and 'lon', so the flux profiles'
    'lat' is no longer a wildcard dim and extraction refuses them
    (ROADMAP queue 3).  That case holds array_call on the raw fields
    that extraction would give."""
    comp_t = tct.SlabSurface(device='cpu', include_ekman=include_ekman)
    comp_j = jct.SlabSurface(include_ekman=include_ekman)
    st, sj = _states(comp_t, comp_j, nx=16, ny=8, nz=4)
    rng = np.random.RandomState(3)
    shape = st['surface_temperature'].shape
    kinds = np.array(['sea', 'land', 'sea_ice', 'land_ice'])
    area = kinds[np.minimum(rng.randint(0, 6, shape), 3)]
    for s in (st, sj):
        s['area_type'].values[:] = area
        for name, scale in (
                ('surface_downward_eastward_stress', 0.2),
                ('surface_downward_northward_stress', 0.1),
                ('ocean_heat_transport_convergence', 30.0),
                ('surface_upward_latent_heat_flux', 80.0),
                ('surface_upward_sensible_heat_flux', 20.0),
                ('upward_heat_flux_at_ground_level_in_soil', 5.0),
                ('heat_flux_into_sea_water_due_to_sea_ice', 5.0)):
            if name in s:
                s[name].values[:] = scale * np.random.RandomState(
                    len(name)).randn(*s[name].shape)
        for name, value in (('downwelling_longwave_flux_in_air', 350.0),
                            ('downwelling_shortwave_flux_in_air', 400.0),
                            ('upwelling_longwave_flux_in_air', 390.0),
                            ('upwelling_shortwave_flux_in_air', 60.0)):
            s[name].values[:] = value
    assert st['area_type'].values.dtype.kind == 'U'
    if not include_ekman:
        outs_t, outs_j = comp_t(st), comp_j(sj)
        _compare(outs_t, outs_j)
        assert np.abs(np.asarray(
            outs_j[0]['surface_temperature'].values)).max() > 0
        return
    with pytest.raises(Exception, match="has dim 'lat'"):
        comp_j(sj)
    with pytest.raises(Exception, match="has dim 'lat'"):
        comp_t(st)
    raw = {}
    for name, props in comp_j.input_properties.items():
        value = sj[name]
        if props['dims'] == ['lat', 'lon']:
            raw[name] = np.asarray(value.values)
        elif 'interface_levels' in props['dims']:
            raw[name] = np.asarray(value.values).reshape(
                value.shape[0], -1).T
        else:
            raw[name] = np.asarray(value.values).reshape(-1)
    outs_t = comp_t.array_call(raw)
    outs_j = comp_j.array_call(raw)
    for o_t, o_j in zip(outs_t, outs_j):
        assert set(o_t) == set(o_j)
        for name in o_j:
            assert rel_err(o_t[name], o_j[name]) <= TOL, name
    assert np.abs(np.asarray(outs_j[1]['ekman_pumping'])).max() > 0
    assert np.abs(np.asarray(
        outs_j[1]['ekman_heat_transport_convergence'])).max() > 0


def test_horizontal_operators_match_jax():
    rng = np.random.RandomState(4)
    lat = np.repeat(np.linspace(-80, 80, 9)[:, None], 12, 1)
    lon = np.repeat(np.linspace(0, 330, 12)[None, :], 9, 0)
    fx, fy = rng.randn(9, 12), rng.randn(9, 12)
    for name in ('curl_z', 'divergence'):
        a = getattr(th, name)(*(torch.as_tensor(x) for x in (fx, fy, lat,
                                                            lon)))
        b = getattr(jh, name)(*(jnp.asarray(x) for x in (fx, fy, lat, lon)))
        assert rel_err(a, b) <= 1e-13, name
    # too short to difference: zero, as in JAX
    small = torch.as_tensor(fx[:2])
    assert float(th.divergence(small, small, torch.as_tensor(lat[:2]),
                               torch.as_tensor(lon[:2])).abs().max()) == 0


def test_grey_radiation_matches_jax():
    """Frierson06LongwaveOpticalDepth's tau into GrayLongwaveRadiation."""
    kw = dict(linear_optical_depth_parameter=0.2,
              longwave_optical_depth_at_equator=5.0)
    tau_t = tct.Frierson06LongwaveOpticalDepth(device='cpu', **kw)
    tau_j = jct.Frierson06LongwaveOpticalDepth(**kw)
    rad_t = tct.GrayLongwaveRadiation(device='cpu')
    rad_j = jct.GrayLongwaveRadiation()
    st, sj = _states([rad_t, tau_t], [rad_j, tau_j])
    diag_t, diag_j = tau_t(st), tau_j(sj)
    _compare([diag_t], [diag_j])
    st.update(diag_t)
    sj.update(diag_j)
    _compare(rad_t(st), rad_j(sj))


def test_grey_gcm_example_matches_jax():
    """examples/grey_gcm.py at 32x16x8 for 2 steps (tests/test_examples.py's
    size): the grey pair, Emanuel and SimplePhysics in GFSDynamicalCore."""
    st, sj, n_calls = run_both_examples('grey_gcm', n_steps=2, nx=32, ny=16,
                                        nz=8)
    assert n_calls == 2
    assert_states_match(st, sj)
