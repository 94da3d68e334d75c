"""climt_tpu_torch's CORK longwave radiation (components/cork/) against
the JAX package's, on the CPU at float64.

- the table loaders, on every file shipped under
  climt_tpu/data/cork/correlated_k/ (npz and netCDF): the same arrays;
- ``bracket`` on grid nodes, between them and outside both ends: the same
  indices, fractions to 1e-15;
- ``compute_ck_optical_depth`` for each of the 11 shipped LW tables and a
  synthetic two-gas ESFT table on 28 levels x 16 columns with surface
  pressures 550-1050 hPa: to 1e-12 of max;
- ``lw_transport`` with and without the per-g-point diagnostics: 1e-12;
- ``CorkLongwaveRadiation.array_call`` for each table and the Parmentier
  optics, with clouds and emissivity below 1, at diagnostics_level 0 and
  1: every output to 1e-10 of max;
- the component API on ``get_default_state`` at 16x8x8 for
  earth_low_res_lw, mars_lw and Parmentier: the same names, dims and
  units, values to 1e-10 of max;
- the Parmentier helpers over every coefficient region and both branches
  of Freedman's fit.

JAX's diagnostics_level-1 averages divide by the float32 sum of a float32
table's g-point weights (climt_tpu/components/cork/lw.py:279); the port
sums in the working dtype.  Those three fields are held against JAX's
values rescaled by that sum's float32-over-float64 ratio, which the test
computes as JAX does.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.components.cork import ck_tables as JCK
from climt_tpu.components.cork import common as JCM
from climt_tpu.components.cork import lw as JLW
from climt_tpu.components.cork import parmentier as JPM
from climt_tpu.core import initialization as jinit
from climt_tpu_torch.components.cork import ck_tables as TCK
from climt_tpu_torch.components.cork import common as TCM
from climt_tpu_torch.components.cork import lw as TLW
from climt_tpu_torch.components.cork import parmentier as TPM
from climt_tpu_torch.core import initialization as tinit

from torch_helpers import (CORK_HOT_SHIFT, CORK_T_EFF, assert_outputs_match,
                           cork_columns, cork_fields, esft_table, rel_err,
                           reset_port_registries)

TABLE_DIR = os.path.join(os.path.dirname(JCK.__file__), os.pardir,
                         os.pardir, 'data', 'cork', 'correlated_k')
LW_TABLES = ('earth_low_res_lw', 'earth_low_res_lw_4band_ngpt2_before',
             'mars_lw', 'single_band_gray_lw', 'single_band_unit_lw',
             'test_2band_lw', 'titan_lw', 'tour_gray_lw',
             'trappist1e_hab1_lw', 'trappist1e_hab2_lw', 'venus_lw')
TABLE_FILES = sorted(f for f in os.listdir(TABLE_DIR)
                     if f.endswith(('.nc', '.npz')))
# the diagnostics_level-1 fields that JAX averages over its float32 sum
GPOINT_AVERAGES = ('lw_layer_transmittance', 'lw_up_per_gpoint',
                   'lw_down_per_gpoint')
FREEDMAN_BOUNDARY = 800.0


@pytest.fixture(autouse=True)
def _restore_band_counts():
    """A CORK component declares its band count in both packages' module
    globals; the next test in this worker must find RRTMG's."""
    reset_port_registries()
    saved = (jinit._num_longwave_bands, tinit._num_longwave_bands)
    yield
    jinit._num_longwave_bands, tinit._num_longwave_bands = saved
    reset_port_registries()


def _table(name):
    return esft_table() if name == 'esft' else name


def _components(name, diagnostics_level=0):
    kw = (dict(optics='parmentier') if name == 'parmentier'
          else dict(table=_table(name)))
    return (TLW.CorkLongwaveRadiation(device='cpu',
                                      diagnostics_level=diagnostics_level,
                                      **kw),
            JLW.CorkLongwaveRadiation(diagnostics_level=diagnostics_level,
                                      **kw))


def _jax_weight_ratio(comp_j):
    """(nband,) float32 sum of the table's g-point weights, as JAX's
    ``w.sum(axis=1)`` takes it, over their float64 sum."""
    if comp_j._optics_mode == 'parmentier':
        return np.ones(2)
    w = comp_j._table['gpoint_weights']
    return (np.asarray(jnp.asarray(w).sum(axis=1), np.float64)
            / np.asarray(w, np.float64).sum(axis=1))


def _check_thresholds(T, T_irr, T_int):
    """The inputs sit more than 1% from Freedman's branch temperature and
    from every Parmentier region boundary."""
    T_eff = np.maximum((T_int ** 4 + 0.25 * T_irr ** 4) ** 0.25, 100.0)
    assert np.all(np.abs(T / FREEDMAN_BOUNDARY - 1.0) > 0.01)
    for b in (200.0, 300.0, 600.0, 1400.0, 2000.0):
        assert np.all(np.abs(T_eff / b - 1.0) > 0.01)


# -- tables and brackets ------------------------------------------------------

@pytest.mark.parametrize('filename', TABLE_FILES)
def test_table_loaders_match_jax(filename):
    path = os.path.join(TABLE_DIR, filename)
    got, ref = TCK.load_k_table(path), JCK.load_k_table(path)
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        assert np.array_equal(got[key], value), key


def test_named_tables_prefer_npz_and_dicts_pass_through():
    for name in LW_TABLES:
        got, ref = TCK.load_k_table(name), JCK.load_k_table(name)
        assert set(got) == set(ref)
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    table = esft_table()
    assert TCK.load_k_table(table) is table
    with pytest.raises(FileNotFoundError, match='no_such_table'):
        TCK.load_k_table('no_such_table')


def test_bracket_matches_jax_on_nodes_between_and_outside():
    grid = np.asarray(JCK.load_k_table('earth_low_res_lw')
                      ['temperature_grid'], float)
    mids = 0.5 * (grid[1:] + grid[:-1])
    values = np.concatenate([grid, mids, [grid[0] - 50.0, grid[0] - 1e-9,
                                          grid[-1] + 1e-9, grid[-1] + 80.0]])
    i_t, f_t = TCM.bracket(torch.as_tensor(grid), torch.as_tensor(values))
    i_j, f_j = JCM.bracket(jnp.asarray(grid), jnp.asarray(values))
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    assert np.abs(f_t.numpy() - np.asarray(f_j)).max() <= 1e-15
    # a value on an inner node brackets from the node below at fraction 1
    assert i_t[1] == 0 and f_t[1] == 1.0
    assert i_t[0] == 0 and f_t[0] == 0.0


# -- optical depth and transport ----------------------------------------------

def _optics_inputs(name, comp_t):
    """(table dict, T, p, gas_amounts, h2o_vmr, co2_vmr) as numpy, for the
    branch the component takes on this table."""
    c = cork_columns(comp_t.num_longwave_bands)
    dp = np.abs(c['p_int'][1:] - c['p_int'][:-1])
    g = 9.80665
    table = comp_t._table
    h2o_vmr = co2_vmr = None
    if comp_t._fully_premixed:
        amounts = (dp / g)[None]
    elif comp_t._premixed_bg:
        amounts = (dp / g)[None]
        ratio = TCM.MOLAR_MASS['h2o'] / TCM.MOLAR_MASS_DRY_AIR
        h2o_vmr = c['h2o'] / (c['h2o'] + (1.0 - c['h2o']) * ratio)
        if comp_t._has_co2_axis:
            co2_vmr = c['co2']
    else:
        amounts = np.stack([c[gas] * dp / g for gas in comp_t._gas_names])
    return table, c['T'], c['p'], amounts, h2o_vmr, co2_vmr


@pytest.mark.parametrize('name', LW_TABLES + ('esft',))
def test_ck_optical_depth_matches_jax(name):
    comp_t, _ = _components(name)
    table, *arrays = _optics_inputs(name, comp_t)
    got = TCK.compute_ck_optical_depth(
        table, *(None if a is None else torch.as_tensor(a) for a in arrays))
    ref = JCK.compute_ck_optical_depth(
        table, *(None if a is None else jnp.asarray(a) for a in arrays))
    if name == 'esft':
        (got, got_w), (ref, ref_w) = got, ref
        assert got.shape == (3, 4, 28, 16)
        assert np.array_equal(got_w, ref_w)
    assert rel_err(got, np.asarray(ref)) <= 1e-12


@pytest.mark.parametrize('want_diag', [False, True])
def test_lw_transport_matches_jax(want_diag):
    rng = np.random.RandomState(7)
    nband, ngpt, nlev, ncol = 3, 4, 28, 16
    args = (rng.rand(nband, ngpt, nlev, ncol) * 0.8,
            100.0 + 300.0 * rng.rand(nband, ngpt, nlev, ncol),
            150.0 + 300.0 * rng.rand(nband, ngpt, ncol),
            0.9 + 0.09 * rng.rand(nband, ncol),
            rng.dirichlet(np.ones(ngpt), nband))
    got = TLW.lw_transport(*(torch.as_tensor(a) for a in args), 1.66,
                           want_diag=want_diag)
    ref = JLW.lw_transport(*(jnp.asarray(a) for a in args), 1.66,
                           want_diag=want_diag)
    for g, r in zip(got[:4], ref[:4]):
        assert rel_err(g, np.asarray(r)) <= 1e-12
    if want_diag:
        assert set(got[4]) == set(ref[4])
        for key, r in ref[4].items():
            assert rel_err(got[4][key], np.asarray(r)) <= 1e-12, key
    else:
        assert got[4] is None and ref[4] is None


# -- the component --------------------------------------------------------------

def _assert_diagnostics_match(diag_t, diag_j, ratio, tol=1e-10):
    assert set(diag_t) == set(diag_j)
    for key, r in diag_j.items():
        r = np.asarray(r)
        if key in GPOINT_AVERAGES:
            r = r * ratio
        assert rel_err(diag_t[key], r) <= tol, key


@pytest.mark.parametrize('diagnostics_level', [0, 1])
@pytest.mark.parametrize('name', LW_TABLES + ('esft', 'parmentier'))
def test_array_call_matches_jax(name, diagnostics_level):
    comp_t, comp_j = _components(name, diagnostics_level)
    c = cork_columns(comp_t.num_longwave_bands, hot=name == 'parmentier')
    if name == 'parmentier':
        _check_thresholds(c['T'], c['T_irr'], c['T_int'])
    tend_t, diag_t = comp_t.array_call(c)
    tend_j, diag_j = comp_j.array_call({k: jnp.asarray(v)
                                        for k, v in c.items()})
    assert rel_err(tend_t['T'], np.asarray(tend_j['T'])) <= 1e-10
    _assert_diagnostics_match(diag_t, diag_j, _jax_weight_ratio(comp_j))
    olr = diag_t['upwelling_longwave_flux_in_air'][-1]
    assert bool(torch.all(olr > 0.0))
    # the heating in K/s in the tendency, K/day in the diagnostics
    assert torch.equal(diag_t['air_temperature_tendency_from_longwave'],
                       tend_t['T'] * 86400.0)


@pytest.mark.parametrize('diagnostics_level', [0, 1])
@pytest.mark.parametrize('name', ['earth_low_res_lw', 'mars_lw',
                                  'parmentier'])
def test_component_api_matches_jax(name, diagnostics_level):
    comp_t, comp_j = _components(name, diagnostics_level)
    states = [pkg.get_default_state([comp], grid_state=pkg.get_grid(
        nx=16, ny=8, nz=8)) for pkg, comp in ((tct, comp_t), (jct, comp_j))]
    fields = cork_fields(states[0], np.random.RandomState(3),
                         hot=name == 'parmentier')
    if name == 'parmentier':
        _check_thresholds(fields['air_temperature'],
                          fields['irradiation_temperature'],
                          fields['internal_temperature'])
    for s in states:
        for key, value in fields.items():
            s[key].values[:] = value
    outs_t, outs_j = comp_t(states[0]), comp_j(states[1])
    nband = comp_t.num_longwave_bands
    assert states[0]['surface_longwave_emissivity'].shape[0] == nband
    assert set(outs_t[1]) == set(comp_t.diagnostic_properties)
    for key, value in outs_j[1].items():
        assert outs_t[1][key].dims == value.dims, key
    ratio = _jax_weight_ratio(comp_j)
    for key in GPOINT_AVERAGES[:diagnostics_level * 3]:
        got, ref = outs_t[1].pop(key), outs_j[1].pop(key)
        assert got.units == ref.units, key
        assert rel_err(got.values, np.asarray(ref.values) * ratio) <= 1e-10
    assert_outputs_match(outs_t, outs_j)


# -- Parmentier helpers and options ----------------------------------------------

def test_parmentier_helpers_match_jax():
    coeffs = JPM.load_parmentier_coefficients('solar_composition')
    T_eff = np.concatenate([CORK_T_EFF, [50.0, 1e4]])
    got = TPM.lookup_ratio_coefficients(
        TPM.load_parmentier_coefficients('solar_composition'),
        torch.as_tensor(T_eff))
    ref = JPM.lookup_ratio_coefficients(coeffs, T_eff)
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= 1e-13
    rng = np.random.RandomState(4)
    T = np.concatenate([200.0 + 500.0 * rng.rand(50),
                        900.0 + 1500.0 * rng.rand(50)])
    p = 10.0 ** rng.uniform(0.0, 7.0, 100)
    fit = JPM.load_freedman2014_coefficients()
    assert rel_err(TPM.compute_rosseland_mean_opacity(
        torch.as_tensor(T), torch.as_tensor(p),
        TPM.load_freedman2014_coefficients()),
        JPM.compute_rosseland_mean_opacity(T, p, fit)) <= 1e-13
    up, down = rng.rand(20) * 300.0, np.where(rng.rand(20) < 0.3, 0.0,
                                              rng.rand(20) * 400.0)
    assert rel_err(TPM.bond_albedo_from_fluxes(
        torch.as_tensor(up), torch.as_tensor(down)),
        JPM.bond_albedo_from_fluxes(up, down)) <= 1e-15
    sun = TPM.load_stellar_spectrum('sun')
    limits = np.asarray(JCK.load_k_table('earth_low_res_sw')
                        ['band_wavenumber_limits'], float)
    assert np.array_equal(TPM.integrate_spectrum_over_bands(sun, limits),
                          JPM.integrate_spectrum_over_bands(
                              JPM.load_stellar_spectrum('sun'), limits))


def test_hot_columns_cross_the_freedman_branch():
    c = cork_columns(2, hot=True)
    assert c['T'][:, 1::2].min() > FREEDMAN_BOUNDARY + 0.01 * CORK_HOT_SHIFT
    assert c['T'][:, ::2].max() < FREEDMAN_BOUNDARY


def test_any_rosseland_mean_fit_runs_freedman_as_jax():
    """A rosseland_mean_fit other than 'freedman2014' is accepted and runs
    Freedman's fit, as JAX's component does (cork/lw.py:122): the same
    outputs as JAX's with that value, and as the port's default."""
    kw = dict(optics='parmentier', rosseland_mean_fit='guillot2010')
    comp_t = TLW.CorkLongwaveRadiation(device='cpu', **kw)
    comp_j = JLW.CorkLongwaveRadiation(**kw)
    c = cork_columns(2, hot=True)
    tend_t, diag_t = comp_t.array_call(c)
    tend_j, diag_j = comp_j.array_call({k: jnp.asarray(v)
                                        for k, v in c.items()})
    assert rel_err(tend_t['T'], np.asarray(tend_j['T'])) <= 1e-10
    _assert_diagnostics_match(diag_t, diag_j, np.ones(2))
    default = TLW.CorkLongwaveRadiation(optics='parmentier', device='cpu')
    assert torch.equal(default.array_call(c)[0]['T'], tend_t['T'])


def test_options_and_device_default():
    with pytest.raises(ValueError, match='Unknown optics'):
        TLW.CorkLongwaveRadiation(optics='grey', device='cpu')
    comp = TLW.CorkLongwaveRadiation(table='earth_low_res_lw', device='cpu')
    assert tinit.get_num_longwave_bands() == 14
    assert 'mole_fraction_of_carbon_dioxide_in_air' in comp.input_properties
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the default builds there')
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        TLW.CorkLongwaveRadiation(table='titan_lw')
