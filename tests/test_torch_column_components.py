"""climt_tpu_torch's column components and their helpers against the JAX
package, on the CPU at float64: tridiagonal_solve and bulk_fluxes (to
1e-12 of max), GridScaleCondensation, DryConvectiveAdjustment,
DcmipInitialConditions, SimpleBoundaryLayer, Instellation and
BergerSolarInsolation (to 1e-10 of max; the orbital scalars exactly),
and examples/full_radiation_with_insolation_gcm.py, baroclinic_wave.py
and grey_radiative_convective.py (to 1e-10 of max).

Inputs are made with numpy from a seed.  Where a component branches on a
threshold (condensation's saturation, dry convection's instability, the
boundary layer's Richardson numbers), the inputs stay at least 1% away
from it, and the test checks that they do: a summation order that
differs by roundoff must not flip a branch.
"""

import datetime
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.components import berger_solar_insolation as jberger
from climt_tpu.core.surface_fluxes import bulk_fluxes as jbulk
from climt_tpu.ops.tridiagonal import tridiagonal_solve as jsolve
from climt_tpu_torch.components import berger_solar_insolation as tberger
from climt_tpu_torch.core.surface_fluxes import bulk_fluxes as tbulk
from climt_tpu_torch.ops.tridiagonal import tridiagonal_solve as tsolve

from torch_helpers import (assert_outputs_match, assert_states_match,
                           rel_err, reset_port_registries, run_both_examples)

DT = timedelta(minutes=10)
RD, RV, CPD, CVAP = 287.04, 461.5, 1004.64, 1846.0


@pytest.fixture(autouse=True)
def _reset_port_registries():
    reset_port_registries()
    yield
    reset_port_registries()


def _states(comp_t, comp_j, nx=8, ny=4, nz=12, fields=None):
    """Both packages' default states for one component each, with
    ``fields`` ({name: numpy array of the port state's shape}) set in
    both."""
    states = [pkg.get_default_state(
        [comp], grid_state=pkg.get_grid(nx=nx, ny=ny, nz=nz))
        for pkg, comp in ((tct, comp_t), (jct, comp_j))]
    for name, value in (fields or {}).items():
        for s in states:
            s[name].values[:] = value
    return states


def test_tridiagonal_solve_matches_jax():
    """A diagonally dominant system of 17 rows batched over (5, 3)."""
    rng = np.random.RandomState(0)
    lower, upper, rhs = (rng.randn(17, 5, 3) for _ in range(3))
    diag = 4.0 + rng.rand(17, 5, 3)
    x_t = tsolve(*(torch.as_tensor(a) for a in (lower, diag, upper, rhs)))
    x_j = jsolve(*(jnp.asarray(a) for a in (lower, diag, upper, rhs)))
    assert rel_err(x_t, x_j) <= 1e-12
    # and it solves the system
    full = np.zeros((17, 17))
    i = np.arange(17)
    full[i, i] = diag[:, 2, 1]
    full[i[1:], i[:-1]] = lower[1:, 2, 1]
    full[i[:-1], i[1:]] = upper[:-1, 2, 1]
    assert np.allclose(full @ x_t[:, 2, 1].numpy(), rhs[:, 2, 1])


def test_bulk_fluxes_match_jax():
    rng = np.random.RandomState(1)
    args = [rng.rand(64) * s + o for s, o in ((10, 0.5), (30, 280),
                                              (30, 280), (0.02, 0),
                                              (0.02, 0), (0.3, 1.0))]
    kw = dict(bulk_coefficient=0.0013, beta=0.8)
    out_t = tbulk(*(torch.as_tensor(a) for a in args), **kw)
    out_j = jbulk(*(jnp.asarray(a) for a in args), **kw)
    out_np = tbulk(*args, **kw)
    assert set(out_t) == set(out_j)
    for name in out_j:
        assert rel_err(out_t[name], out_j[name]) <= 1e-12, name
        assert rel_err(out_np[name], out_j[name]) <= 1e-12, name


def _bolton_q_sat(T, p):
    es = 611.2 * np.exp(17.67 * (T - 273.15) / (T - 29.65))
    eps = RD / RV
    return eps * es / (p - (1 - eps) * es)


def test_condensation_matches_jax():
    """Half the cells 2-20% supersaturated, the rest 2-20% below."""
    comp_t = tct.GridScaleCondensation(device='cpu')
    comp_j = jct.GridScaleCondensation()
    st, sj = _states(comp_t, comp_j)
    rng = np.random.RandomState(2)
    p = np.asarray(st['air_pressure'].values)
    T = np.maximum(300.0 * (p / 1e5) ** 0.19, 200.0) + rng.randn(*p.shape)
    sign = np.where(rng.rand(*p.shape) < 0.5, 1.0, -1.0)
    q = _bolton_q_sat(T, p) * (1.0 + sign * (0.02 + 0.18 * rng.rand(
        *p.shape)))
    for s in (st, sj):
        s['air_temperature'].values[:] = T
        s['specific_humidity'].values[:] = q
    outs_t, outs_j = comp_t(st, DT), comp_j(sj, DT)
    assert_outputs_match(outs_t, outs_j)
    # every column condenses, and the JAX package's precipitation comes
    # out negative: its layer masses p_int[1:] - p_int[:-1] count the
    # interfaces from the surface up (ROADMAP queue 3); the port keeps
    # that sign
    assert np.asarray(outs_j[0]['precipitation_amount'].values).max() < 0


def _theta_q(T, q, p):
    kappa = (RD * (1 - q) + RV * q) / (CPD * (1 - q) + CVAP * q)
    return T * (1e5 / p) ** kappa * (1.0 + q * RV / RD - q)


def test_dry_convection_matches_jax():
    """Columns whose theta_q falls with height by 3-5% a level (every
    layer unstable) beside columns where it rises by 3-5% (stable); each
    running mean of theta_q stays at least 1% from theta_q above it."""
    comp_t = tct.DryConvectiveAdjustment(device='cpu')
    comp_j = jct.DryConvectiveAdjustment()
    nz = 10
    st, sj = _states(comp_t, comp_j, nz=nz)
    rng = np.random.RandomState(3)
    p = np.asarray(st['air_pressure'].values)
    ncol = p[0].size
    q = 0.01 * (p / 1e5) ** 3 * (1.0 + 0.1 * rng.rand(*p.shape))
    rate = np.where(np.arange(ncol) % 2 == 0, -1.0, 1.0) * (
        0.03 + 0.02 * rng.rand(ncol))
    theta_q = 300.0 * np.cumprod(np.concatenate(
        [np.ones((1, ncol)), np.broadcast_to(1.0 + rate, (nz - 1, ncol))]),
        axis=0).reshape(p.shape)
    T = theta_q / _theta_q(np.ones_like(p), q, p)
    tq = _theta_q(T, q, p).reshape(nz, -1)
    for level in range(nz):
        mean = np.cumsum(tq[level:], 0) / np.arange(1, nz - level + 1)[:, None]
        assert (np.abs(mean[1:] / tq[level + 1:] - 1.0) > 0.01).all()
    for s in (st, sj):
        s['air_temperature'].values[:] = T
        s['specific_humidity'].values[:] = q
    outs_t, outs_j = comp_t(st, DT), comp_j(sj, DT)
    assert_outputs_match(outs_t, outs_j)
    moved = np.abs(np.asarray(outs_j[1]['air_temperature'].values) - T)
    assert moved.reshape(nz, -1)[:, 0].max() > 1.0      # mixed
    assert moved.reshape(nz, -1)[:, 1].max() == 0.0     # left alone


@pytest.mark.parametrize('options', [
    {}, dict(add_perturbation=False), dict(moist=True),
    dict(moist=True, condition_type='tropical_cyclone')],
    ids=['perturbed', 'unperturbed', 'moist', 'tropical_cyclone'])
def test_dcmip_matches_jax(options):
    comp_t = tct.DcmipInitialConditions(device='cpu', **options)
    comp_j = jct.DcmipInitialConditions(**options)
    st, sj = _states(comp_t, comp_j, nx=32, ny=16, nz=10)
    assert_outputs_match(comp_t(st), comp_j(sj))


def _boundary_layer_fields(p, p_int, rng):
    """A warm, moist surface under a lapse-rate profile with winds: the
    surface layer unstable in most columns, stable in some."""
    T = np.maximum(300.0 * (p / 1e5) ** 0.2, 210.0) + 0.3 * rng.randn(
        *p.shape)
    ncol = p[0].size
    shape = p.shape[1:]
    Ts = (T[0] + np.where(np.arange(ncol) % 4 == 0, -3.0, 4.0).reshape(
        shape) + rng.rand(*shape))
    return {
        'air_temperature': T,
        'specific_humidity': 0.015 * (p / 1e5) ** 3,
        'eastward_wind': 8.0 + 3.0 * rng.randn(*p.shape),
        'northward_wind': 2.0 * rng.randn(*p.shape),
        'surface_temperature': Ts,
        'surface_specific_humidity': 0.018 + 0.002 * rng.rand(*shape),
        'surface_upward_sensible_heat_flux': 20.0 * rng.rand(*shape),
        'surface_upward_latent_heat_flux': 80.0 * rng.rand(*shape),
    }


def _richardson_margins(f, p_int, ps, ric=1.0):
    """The relative distances of the surface-layer Richardson number from
    0 and Ric, and of each interface's from Ric (:94-107)."""
    g, P0, kap = 9.80665, 1e5, RD / CPD
    nz = f['air_temperature'].shape[0]
    T, q = (f[k].reshape(nz, -1) for k in ('air_temperature',
                                           'specific_humidity'))
    u, v = (f[k].reshape(nz, -1) for k in ('eastward_wind',
                                           'northward_wind'))
    Ts, qs = (f[k].reshape(-1) for k in ('surface_temperature',
                                         'surface_specific_humidity'))
    pi = p_int.reshape(nz + 1, -1)[1:-1]
    ps = ps.reshape(-1)
    Ti, qi = 0.5 * (T[1:] + T[:-1]), 0.5 * (q[1:] + q[:-1])
    wind = np.maximum(np.hypot(0.5 * (u[1:] + u[:-1]),
                               0.5 * (v[1:] + v[:-1])), 1.0)
    pv = Ti * (P0 / pi) ** kap * (1 + 0.608 * qi)
    pvs = Ts * (P0 / ps) ** kap * (1 + 0.608 * qs)
    dz0 = RD * (1 + 0.608 * q[0]) * T[0] / g * np.log(ps / pi[0])
    dzs = RD * (1 + 0.608 * q[1:-1]) * T[1:-1] / g * np.log(pi[:-1] / pi[1:])
    z = np.cumsum(np.concatenate([dz0[None], dzs]), 0)
    ri_a = g * z[0] * (pv[0] - pvs) / (pvs * wind[0] ** 2)
    rich = g * z * (pv - pv[0]) / (pv[0] * wind ** 2)
    return (np.abs(ri_a).min(), np.abs(ri_a - ric).min() / ric,
            np.abs(rich[1:] - ric).min() / ric)


@pytest.mark.parametrize('surface_fluxes', ['bulk', 'external', None])
def test_boundary_layer_matches_jax(surface_fluxes):
    """Two calls, the first's output fed to the second."""
    comp_t = tct.SimpleBoundaryLayer(device='cpu',
                                     surface_fluxes=surface_fluxes)
    comp_j = jct.SimpleBoundaryLayer(surface_fluxes=surface_fluxes)
    st, sj = _states(comp_t, comp_j, nz=16)
    p = np.asarray(st['air_pressure'].values)
    p_int = np.asarray(st['air_pressure_on_interface_levels'].values)
    ps = np.asarray(st['surface_air_pressure'].values)
    f = _boundary_layer_fields(p, p_int, np.random.RandomState(4))
    assert min(_richardson_margins(f, p_int, ps)) > 0.01
    for name, value in f.items():
        for s in (st, sj):
            if name in s:
                s[name].values[:] = value
    for _ in range(2):
        outs_t, outs_j = comp_t(st, DT), comp_j(sj, DT)
        assert_outputs_match(outs_t, outs_j)
        st.update(outs_t[1])
        sj.update(outs_j[1])
    h = np.asarray(outs_j[0]['boundary_layer_height'].values)
    assert h.min() < h.max()


def test_instellation_matches_jax():
    """Four times of one day and one of another season."""
    comp_t = tct.Instellation(device='cpu')
    comp_j = jct.Instellation()
    st, sj = _states(comp_t, comp_j, nx=16, ny=8, nz=4)
    for when in (datetime.datetime(2000, 1, 1, h) for h in (0, 6, 13, 19)):
        st['time'] = sj['time'] = when
        assert_outputs_match(comp_t(st), comp_j(sj))
    st['time'] = sj['time'] = datetime.datetime(2017, 7, 3, 9, 30)
    out_t = comp_t(st)
    assert_outputs_match(out_t, comp_j(sj))
    assert out_t['zenith_angle'].values.dtype == torch.float64


@pytest.mark.parametrize('compat', [False, True])
def test_berger_insolation_matches_jax(compat):
    """Three times over two years: the host orbital parameters exactly,
    the insolation and zenith maps to 1e-10 of max."""
    comp_t = tct.BergerSolarInsolation(device='cpu',
                                       degrees_as_radians_compat=compat)
    comp_j = jct.BergerSolarInsolation(degrees_as_radians_compat=compat)
    st, sj = _states(comp_t, comp_j, nx=16, ny=8, nz=4)
    for when in (datetime.datetime(2000, 3, 1, 10),
                 datetime.datetime(2000, 9, 12, 22, 15),
                 datetime.datetime(1850, 6, 21, 12)):
        st['time'] = sj['time'] = when
        assert_outputs_match(comp_t(st), comp_j(sj))
    for years in (-1e5, -100.0, 0.0, 50.0, 3e4):
        assert (tberger.get_orbital_parameters(years)
                == jberger.get_orbital_parameters(years))


def test_full_radiation_with_insolation_example_matches_jax():
    """examples/full_radiation_with_insolation_gcm.py at 16x8x8 for 7
    calls: Instellation every call, RRTMG refreshed at calls 0 and 6."""
    st, sj, n_calls = run_both_examples(
        'full_radiation_with_insolation_gcm', n_steps=7, nx=16, ny=8, nz=8)
    assert n_calls == 7
    assert_states_match(st, sj)


def test_baroclinic_wave_example_matches_jax():
    """examples/baroclinic_wave.py at 32x16x10, 5 calls of 10 minutes."""
    st, sj, n_calls = run_both_examples('baroclinic_wave', n_steps=5, nx=32,
                                        ny=16, nz=10)
    assert n_calls == 5
    assert_states_match(st, sj)


def test_grey_radiative_convective_example_matches_jax():
    """examples/grey_radiative_convective.py at its own nz=30, 10 steps."""
    st, sj, _ = run_both_examples('grey_radiative_convective', n_steps=10)
    assert_states_match(st, sj)
