"""climt_tpu_torch's RRTMG numerics and components against the JAX
package, on the CPU at float64: the Pade tables, the cloud optics of
every flag, the LW and SW drivers with and without tables, McICA given
JAX's own subcolumns and the port's generator in distribution, the two
components on transposed states, and the full-radiation GCM example.

Tolerances: everything given the same inputs agrees to 1e-10 of max
(measured 1e-16 to 5e-13 on these inputs); the table lookups agree
exactly, so no table index differs between the packages on these inputs.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.components.rrtmg import lw_spectral as JL
from climt_tpu.components.rrtmg import mcica as JM
from climt_tpu.components.rrtmg import sw_spectral as JS
from climt_tpu_torch.components.rrtmg import fused_mix
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import mcica as TM
from climt_tpu_torch.components.rrtmg import sw_spectral as TS
from climt_tpu_torch.core import constants as tconstants
from climt_tpu_torch.core import tracers as ttracers

from torch_helpers import (AVOG, CPD, G, assert_states_match,
                           radiation_columns, rel_err, run_both_examples)

TOL = 1e-10
NZ, NCOL = 12, 10


def _reset_port():
    tconstants.reset_constants()
    tconstants.set_constant('top_of_model_pressure', 20., 'Pa')
    ttracers.reset_tracers()
    ttracers.reset_packers()


@pytest.fixture(autouse=True)
def _reset_port_registries():
    """The port's constants and tracers are its own; the examples set
    stellar_irradiance."""
    _reset_port()
    yield
    _reset_port()


def J(x):
    return jnp.asarray(x, jnp.float64)


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _clouds(seed=5, nz=NZ, ncol=NCOL):
    """Cloud and aerosol fields (float64 numpy) with clear cells, ice and
    liquid apart and together, and particle sizes across the tables."""
    rng = np.random.RandomState(seed)

    def sparse(scale):
        return np.where(rng.rand(nz, ncol) > 0.4,
                        scale * rng.rand(nz, ncol), 0.0)

    return dict(
        cld=sparse(1.0), ciwp=sparse(30.0), clwp=sparse(80.0),
        rei=5.0 + 125.0 * rng.rand(nz, ncol),
        rel=2.5 + 55.0 * rng.rand(nz, ncol),
        taucld_lw=2.0 * rng.rand(nz, ncol, 16),
        tauaer_lw=0.05 * rng.rand(nz, ncol, 16),
        tauc=2.0 * rng.rand(nz, ncol, 14), ssac=rng.rand(nz, ncol, 14),
        asmc=0.9 * rng.rand(nz, ncol, 14),
        fsfc=0.5 * rng.rand(nz, ncol, 14),
        taua=0.1 * rng.rand(nz, ncol, 14),
        ssaa=0.5 + 0.5 * rng.rand(nz, ncol, 14),
        asma=0.8 * rng.rand(nz, ncol, 14),
        ecaer=0.05 * rng.rand(6, nz, ncol))


COLS = radiation_columns(nz=NZ, ncol=NCOL)
CLD = _clouds()


def _lw_args(X, c=COLS, k=CLD):
    z = X(c['zero'])
    return (X(c['play']), X(c['plev']), X(c['tlay']), X(c['tlev']),
            X(c['tsfc']), X(c['h2o']), X(c['o3']), X(c['co2']), z, z,
            X(c['o2']), z, z, z, z, X(c['emis']), X(k['cld']),
            X(k['taucld_lw']), X(k['ciwp']), X(k['clwp']), X(k['rei']),
            X(k['rel']), X(k['tauaer_lw']), G, AVOG, CPD)


def _assert_all_close(outs_t, outs_j, tol=TOL):
    assert len(outs_t) == len(outs_j)
    for a, b in zip(outs_t, outs_j):
        assert rel_err(a, b) <= tol


def test_pade_tables_agree_exactly():
    """The lookups on optical depths across the whole table, at and
    between table nodes, and below the quadratic threshold: the table
    path exactly (so every table index agrees), the analytic one to
    1e-13 absolute: the last bit of exp, magnified by the cancellation in
    tfn just above od = 0.06 (measured 6.4e-14)."""
    rng = np.random.RandomState(0)
    od = np.concatenate([10.0 ** rng.uniform(-4, 3, 4000),
                         JL.TAU_TBL[1:-1:37], [0.0, 0.06, 1e4]])
    for use_tables, atol in ((True, 0.0), (False, 1e-13)):
        outs_t = TL._tbl_lookup(T(od), use_tables) + (
            TS._exp_transmittance(T(od), use_tables),)
        outs_j = JL._tbl_lookup(J(od), use_tables) + (
            JS._exp_transmittance(J(od), use_tables),)
        for a, b in zip(outs_t, outs_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.0,
                                       atol=atol)
    np.testing.assert_array_equal(TL.TFN_TBL, JL.TFN_TBL)
    np.testing.assert_array_equal(TS.EXP_TBL, JS.EXP_TBL)


LW_CLOUD_FLAGS = [(0, 0, 0), (1, 0, 0)] + [
    (2, ice, liq) for ice in range(4) for liq in range(2)]


@pytest.mark.parametrize('flags', LW_CLOUD_FLAGS)
def test_cldprop_lw_matches_jax(flags):
    k = CLD
    args = [k[n] for n in ('cld', 'taucld_lw', 'ciwp', 'clwp', 'rei',
                           'rel')]
    out_t = TL.cldprop_lw(*flags, *map(T, args))
    out_j = JL.cldprop_lw(*flags, *map(J, args), jnp.float64)
    assert out_t.dtype == torch.float64
    assert rel_err(out_t, out_j) <= 1e-13


@pytest.mark.parametrize('flags', [(0, 1, 1), (2, 1, 1), (2, 2, 1),
                                   (2, 3, 0)])
def test_cldprop_sw_matches_jax(flags):
    k = CLD
    args = [k[n] for n in ('cld', 'tauc', 'ssac', 'asmc', 'fsfc', 'ciwp',
                           'clwp', 'rei', 'rel')]
    outs_t = TS.cldprop_sw(*flags, *map(T, args))
    outs_j = JS.cldprop_sw(*flags, *map(J, args), jnp.float64)
    for a in outs_t:
        assert a.dtype == torch.float64
    _assert_all_close(outs_t, outs_j, 1e-13)


@pytest.mark.parametrize('use_tables', [False, True])
@pytest.mark.parametrize('idrv', [False, True])
def test_rrtmg_lw_fluxes_matches_jax(use_tables, idrv):
    """Cloudy columns (inflag 2, Key ice, Hu & Stamnes liquid) with
    aerosol: fluxes, heating rates and, with idrv, dF_up/dT_s."""
    kw = dict(iceflag=2, idrv=idrv, use_tables=use_tables)
    outs_t = TL.rrtmg_lw_fluxes(*_lw_args(T), **kw)
    outs_j = JL.rrtmg_lw_fluxes(*_lw_args(J), **kw)
    assert len(outs_t) == (8 if idrv else 6)
    _assert_all_close(outs_t, outs_j)


def _sw_call(S, X, icld, iaer, use_tables, cloud_g=None, c=COLS, k=CLD,
             isolvar=-1):
    """rrtmg_sw_fluxes of package S with the cloud optics of cldprop_sw
    (inflag 2, Fu ice) and iaer 0, 6 or 10."""
    z = X(c['zero'])
    nz, ncol = c['play'].shape
    extra = (jnp.float64,) if X is J else ()
    cloud = S.cldprop_sw(2, 3, 1, X(k['cld']), X(k['tauc']), X(k['ssac']),
                         X(k['asmc']), X(k['fsfc']), X(k['ciwp']),
                         X(k['clwp']), X(k['rei']), X(k['rel']), *extra)
    zero_b = X(np.zeros((nz, ncol, 14)))
    if iaer == 0:
        aerosol = (zero_b, X(np.ones((nz, ncol, 14))), zero_b)
    elif iaer == 6:
        aerosol = S.ecmwf_aerosol_optics(X(k['ecaer']), *extra)
    else:
        aerosol = (X(k['taua']), X(k['ssaa']), X(k['asma']))
    alb = X(c['alb'])
    return S.rrtmg_sw_fluxes(
        X(c['play']), X(c['plev']), X(c['tlay']), X(c['h2o']), X(c['o3']),
        X(c['co2']), z, z, X(c['o2']), alb, 0.8 * alb, 1.2 * alb, alb,
        X(0.05 + 0.9 * c['mu0']), X(k['cld']), cloud, aerosol, 1.0, 172,
        0.0, isolvar, S.solar_variability(isolvar, 1360.0), G, AVOG, CPD,
        icld, per_g_cloud=cloud_g is not None, cloud_g=cloud_g,
        use_tables=use_tables)


@pytest.mark.parametrize('use_tables,icld,iaer', [
    (False, 1, 6), (True, 0, 0), (True, 1, 10), (True, 2, 6),
    (True, 3, 0)])
def test_rrtmg_sw_fluxes_matches_jax(use_tables, icld, iaer):
    """Total and clear sky for every overlap, each aerosol input, day of
    year 172, the solar constant 1360 W/m^2."""
    _assert_all_close(_sw_call(TS, T, icld, iaer, use_tables),
                      _sw_call(JS, J, icld, iaer, use_tables))


@pytest.mark.parametrize('overlap', [1, 2, 3])
def test_mcica_subcolumns_from_jax_deviates(overlap):
    """The port's overlap rules on JAX's own uniform deviates give JAX's
    subcolumns exactly."""
    k = CLD
    key = jax.random.PRNGKey(11)
    ngb = JL.NGB
    shape = (1 if overlap == 3 else NZ, NCOL, len(ngb))
    raw = np.asarray(jax.random.uniform(key, shape, jnp.float64))
    outs_j = JM.mcica_subcolumns(key, overlap, J(k['cld']), J(k['ciwp']),
                                 J(k['clwp']), J(k['taucld_lw']),
                                 jnp.asarray(ngb))
    outs_t = TM.subcolumns_from_deviates(
        T(raw), overlap, T(k['cld']), T(k['ciwp']), T(k['clwp']),
        T(k['taucld_lw']), ngb)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('inflag,iceflag', [(0, 0), (2, 1), (2, 3)])
def test_lw_mcica_given_jax_subcolumns(inflag, iceflag):
    """cldprmc_lw and the per-g-point sweep on JAX's subcolumns."""
    k = CLD
    sub = JM.mcica_subcolumns(jax.random.PRNGKey(3), 2, J(k['cld']),
                              J(k['ciwp']), J(k['clwp']),
                              J(k['taucld_lw']), jnp.asarray(JL.NGB))
    sub = [np.asarray(x) for x in sub]
    rei, rel = k['rei'], k['rel']
    tau_t = TL.cldprmc_lw(inflag, iceflag, 1, *map(T, sub), T(rei), T(rel))
    tau_j = JL.cldprmc_lw(inflag, iceflag, 1, *map(J, sub), J(rei), J(rel),
                          jnp.float64)
    assert rel_err(tau_t, tau_j) <= 1e-13
    outs_t = TL.rrtmg_lw_fluxes(*_lw_args(T), per_g_cloud=True,
                                cldfrac_g=T(sub[0]), taucld_g=tau_t)
    outs_j = JL.rrtmg_lw_fluxes(*_lw_args(J), per_g_cloud=True,
                                cldfrac_g=J(sub[0]), taucld_g=tau_j)
    _assert_all_close(outs_t, outs_j)


def test_sw_mcica_given_jax_subcolumns():
    """spcvmc_sw on JAX's subcolumns of the band cloud optics."""
    k = CLD
    tauc, ssac, asmc, _ = JS.cldprop_sw(
        2, 2, 1, J(k['cld']), J(k['tauc']), J(k['ssac']), J(k['asmc']),
        J(k['fsfc']), J(k['ciwp']), J(k['clwp']), J(k['rei']), J(k['rel']),
        jnp.float64)
    cldfmc, _, _, taucmc = JM.mcica_subcolumns(
        jax.random.PRNGKey(4), 1, J(k['cld']), J(k['ciwp']), J(k['clwp']),
        tauc, jnp.asarray(JS.NGB))
    iscld = cldfmc > 0
    cloud_g = [np.asarray(x) for x in (
        cldfmc, taucmc, jnp.where(iscld, ssac[..., JS.NGB], 1.0),
        jnp.where(iscld, asmc[..., JS.NGB], 0.0))]
    _assert_all_close(
        _sw_call(TS, T, 1, 0, True, cloud_g=[T(x) for x in cloud_g]),
        _sw_call(JS, J, 1, 0, True, cloud_g=[J(x) for x in cloud_g]))


def test_mcica_generator_statistics():
    """The port's generator against the overlap rules, over 40 draws of
    140 g-points x 64 columns: each layer cloudy at its cloud fraction,
    two adjacent layers together at c1*c2 (random), min(c1, c2)
    (maximum-random, both cloudy layers adjacent) and min(c1, c2)
    (maximum); 4 sigma of the sampling noise."""
    c = torch.tensor([0.3, 0.6, 0.45], dtype=torch.float64)
    cld = c[:, None].expand(3, 64).contiguous()
    z = torch.zeros_like(cld)
    gen = torch.Generator().manual_seed(1)
    expect_pair = {1: float(c[0] * c[1]), 2: float(min(c[0], c[1])),
                   3: float(min(c[0], c[1]))}
    for overlap in (1, 2, 3):
        draws = torch.stack([
            TM.mcica_subcolumns(gen, overlap, cld, z, z,
                                torch.zeros(3, 64, 16, dtype=torch.float64),
                                TL.NGB)[0] for _ in range(40)])
        n = draws[:, 0].numel()
        frac = draws.mean(dim=(0, 2, 3))
        sigma = torch.sqrt(c * (1 - c) / n)
        assert bool((torch.abs(frac - c) < 4 * sigma).all()), overlap
        pair = float((draws[:, 0] * draws[:, 1]).mean())
        p = expect_pair[overlap]
        assert abs(pair - p) < 4 * np.sqrt(p * (1 - p) / n) + 1e-12, (
            overlap, pair, p)


def _component_state(package, components, nx=3, ny=2, nz=15):
    state = package.get_default_state(
        components, grid_state=package.get_grid(nx=nx, ny=ny, nz=nz))
    for name in ('cloud_area_fraction_in_atmosphere_layer',
                 'mass_content_of_cloud_ice_in_atmosphere_layer'):
        state[name].values[10:12] = 0.5 if 'fraction' in name else 0.3
    state['mass_content_of_cloud_liquid_water_in_atmosphere_layer'
          ].values[4:7] = 20.0
    if 'zenith_angle' in state:
        state['zenith_angle'].values[:] = 0.4
    return state


def _transposed(state):
    """Every field of two or more dims with its dims reversed."""
    out = dict(state)
    for name, value in state.items():
        if getattr(value, 'ndim', 0) >= 2:
            out[name] = value.transpose(*value.dims[::-1])
    return out


def _assert_outputs_match(outs_t, outs_j):
    for o_t, o_j in zip(outs_t, outs_j):
        assert set(o_t) == set(o_j)
        for name in o_j:
            a = o_t[name].transpose(*o_j[name].dims)
            assert a.units == o_j[name].units, name
            assert rel_err(a.values, o_j[name].values) <= TOL, name


@pytest.mark.parametrize('kind', ['lw', 'sw'])
def test_components_on_transposed_states_match_jax(kind):
    """RRTMGLongwave with interface temperatures from the state and
    dF_up/dT_s, and RRTMGShortwave with ECMWF aerosol and the solar cycle,
    on a cloudy state whose fields the port gets with reversed dims."""
    if kind == 'lw':
        kw = dict(calculate_change_up_flux=True,
                  calculate_interface_temperature=False,
                  cloud_ice_properties='fu')
        comp_t = tct.RRTMGLongwave(device='cpu', **kw)
        comp_j = jct.RRTMGLongwave(**kw)
    else:
        kw = dict(aerosol_type='ecmwf', solar_variability_method=1,
                  cloud_overlap_method='maximum_random')
        comp_t = tct.RRTMGShortwave(device='cpu', **kw)
        comp_j = jct.RRTMGShortwave(**kw)
    st = _component_state(tct, [comp_t])
    sj = _component_state(jct, [comp_j])
    if kind == 'lw':
        tlev = np.linspace(300.0, 200.0, 16)[:, None, None] * np.ones(
            st['air_temperature_on_interface_levels'].shape)
        st['air_temperature_on_interface_levels'].values[:] = tlev
        sj['air_temperature_on_interface_levels'].values[:] = tlev
    else:
        ec = 0.02 * np.random.RandomState(2).rand(
            *st['aerosol_optical_depth_at_55_micron'].shape)
        st['aerosol_optical_depth_at_55_micron'].values[:] = ec
        sj['aerosol_optical_depth_at_55_micron'].values[:] = ec
    _assert_outputs_match(comp_t(_transposed(st)), comp_j(sj))
    if kind == 'lw':
        for suffix in ('', '_clear_sky'):
            name = 'last_upward_flux_derivative' + suffix
            assert rel_err(getattr(comp_t, name),
                           getattr(comp_j, name)) <= TOL


def test_shortwave_options_keep_separate_kernel_layouts():
    """Two RRTMGShortwave of other solar-source term structures in one
    process: each keeps its own cached kernel-B layout."""
    modes = (-1, 0, 3)
    comps = [tct.RRTMGShortwave(device='cpu', solar_variability_method=m,
                                solar_variability_by_band=np.full(14, 1.01))
             for m in modes]
    state = _component_state(tct, comps)
    for _ in range(2):
        for comp in comps:
            tend, _ = comp(state)
            assert bool(torch.isfinite(tend['air_temperature'].values).all())
    keys = [k for k in fused_mix.Group._LAYOUTS if k[0][0] == 'sw_sflux']
    assert {k[0][1] for k in keys} >= {'ref', 'svar', 'band'}


def test_mcica_components_in_distribution():
    """tests/test_rrtmg.py's McICA state (3x2x15, ice cloud at layers
    10:12, fraction 0.5): over 16 draws the mean TOA upward SW flux of
    the port and of JAX agree within 4 sigma of their draws' spread;
    clear sky agrees to 1e-10; LW as well over 8 draws."""
    for kind, n_draws in (('sw', 16), ('lw', 8)):
        name = ('upwelling_shortwave_flux_in_air' if kind == 'sw'
                else 'upwelling_longwave_flux_in_air')
        means, clear = {}, {}
        for pkg, kw in ((tct, dict(device='cpu')), (jct, {})):
            cls = pkg.RRTMGShortwave if kind == 'sw' else pkg.RRTMGLongwave
            comp = cls(mcica=True, **kw)
            state = _component_state(pkg, [comp])
            np.random.seed(0)
            draws = []
            for _ in range(n_draws):
                _, diag = comp(state)
                draws.append(np.asarray(diag[name].values)[-1].mean())
            means[pkg] = np.asarray(draws)
            clear[pkg] = diag[name + '_assuming_clear_sky'].values
        assert rel_err(clear[tct], clear[jct]) <= TOL
        sigma = np.sqrt((means[tct].var() + means[jct].var()) / n_draws)
        assert abs(means[tct].mean() - means[jct].mean()) <= (
            4 * sigma + 1e-6), (kind, means)
        assert means[tct].std() > 0.0


def test_rrtmg_logging(caplog):
    """The same advisories as the JAX components (test_rrtmg.py:90)."""
    caplog.set_level(logging.INFO)
    for cls in (tct.RRTMGLongwave, tct.RRTMGShortwave):
        caplog.clear()
        cls(mcica=True, cloud_overlap_method='clear_only', device='cpu')
        assert 'no clouds' in caplog.text
        caplog.clear()
        cls(mcica=True, cloud_optical_properties='single_cloud_type',
            device='cpu')
        assert ("must be 'direct_input' or "
                "'liquid_and_ice_clouds'") in caplog.text
    caplog.clear()
    tct.RRTMGShortwave(mcica=True, cloud_ice_properties='ebert_curry_one',
                       device='cpu')
    assert "not be set to 'ebert_curry_one'" in caplog.text
    caplog.clear()
    tct.RRTMGShortwave(
        mcica=True,
        cloud_liquid_water_properties='radius_independent_absorption',
        device='cpu')
    assert "must be set to 'radius_dependent_absorption'" in caplog.text
    caplog.clear()
    tct.RRTMGShortwave(cloud_optical_properties='single_cloud_type',
                       device='cpu')
    assert 'not supported by the shortwave scheme' in caplog.text


def test_full_radiation_example_matches_jax():
    """examples/full_radiation_gcm_energy_balanced.py at 16x8x8 for 2
    steps (tests/test_examples.py's size): RRTMG, Emanuel, SimplePhysics
    and SlabSurface inside GFSDynamicalCore, every field of the state."""
    st, sj, n_calls = run_both_examples(
        'full_radiation_gcm_energy_balanced', n_steps=2, nx=16, ny=8, nz=8)
    assert n_calls == 2
    assert_states_match(st, sj)
    assert isinstance(
        st['upwelling_longwave_flux_in_air'].values, torch.Tensor)
    assert st['area_type'].values.dtype.kind == 'U'
