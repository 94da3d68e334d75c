"""climt_tpu_torch's RRTMG LW and SW pipelines against the JAX package,
on the physical columns of tests/test_radiation_fastpath.py.

The port computes every taumol interpolation as a direct gather (the
JAX f64 path), so at float64 the two agree to roundoff; at float32 the
port is held to the JAX package's own fast-path bounds against f64.
taumol's terms, written by the term writer's plain version
(``term_writer.taumol_terms_plain``), are held to the JAX taumol on
``taumol_columns`` too, with each LW table case and SW solar mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import sw_spectral as TS
from climt_tpu_torch.components.rrtmg import term_writer

from torch_helpers import (LW_TABLE_CASES, jax_lw, jax_sw, jax_taumol,
                           lw_table_case, port_lw, port_sw,
                           port_taumol_groups, radiation_columns, rel_err,
                           solar_case, taumol_coefs, taumol_columns,
                           varying_ps_columns)


@pytest.fixture(scope='module')
def columns():
    return radiation_columns()


@pytest.mark.parametrize('band', ['lw', 'sw'])
def test_f64_matches_jax_f64(columns, band):
    port, ref = (port_lw, jax_lw) if band == 'lw' else (port_sw, jax_sw)
    out = port(columns, torch.float64)
    expect = ref(columns, jnp.float64, use_tables=False)
    assert len(out) == len(expect) == 6
    for a, b in zip(out, expect):       # fluxes and heating rates
        assert a.dtype == torch.float64
        assert rel_err(a, b) < 1e-9


def test_lw_f32_tracks_jax_f64(columns):
    out = port_lw(columns, torch.float32)
    ref = jax_lw(columns, jnp.float64, use_tables=True)
    for i in (0, 1):                    # fluxes, W/m^2
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   atol=0.5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]),
                               atol=0.05)  # K/day


def test_sw_f32_tracks_jax_f64(columns):
    out = port_sw(columns, torch.float32)
    ref = jax_sw(columns, jnp.float64, use_tables=True)
    for i in (0, 1):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   atol=1.0)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]),
                               atol=0.08)


@pytest.mark.parametrize('band', ['lw', 'sw'])
def test_f32_tracks_jax_f64_with_varying_surface_pressure(band):
    """Surface pressure 550-1050 hPa across columns.  The port's direct
    gather keeps the fast-path bounds against f64 here; the JAX f32 path's
    windowed contraction (interp.mix_rows_windowed) drops terms outside
    its per-level window and misses by tens of W/m^2 on these columns."""
    c = varying_ps_columns()
    if band == 'lw':
        out, ref = port_lw(c, torch.float32), jax_lw(c, jnp.float64, False)
        atol_flux, atol_hr, hr = 0.5, 0.05, 2
    else:
        out, ref = port_sw(c, torch.float32), jax_sw(c, jnp.float64, False)
        atol_flux, atol_hr, hr = 1.0, 0.08, 4
    for i in (0, 1):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   atol=atol_flux)
    np.testing.assert_allclose(out[hr].numpy(), np.asarray(ref[hr]),
                               atol=atol_hr)


@pytest.mark.parametrize('band', ['lw', 'sw'])
def test_f32_extreme_water_no_nan(band):
    """30x the water vapour (test_radiation_fastpath.py:109-124): the
    EXPEPS clamp keeps 1/exp(-tau) finite in float32."""
    c = radiation_columns()
    c['h2o'] = c['h2o'] * 30.0
    out = (port_lw if band == 'lw' else port_sw)(c, torch.float32)
    for arr in out:
        assert torch.isfinite(arr).all()


@pytest.mark.parametrize('band', ['lw', 'sw'])
def test_f32_inputs_give_f32_outputs(columns, band):
    out = (port_lw if band == 'lw' else port_sw)(columns, torch.float32)
    assert all(a.dtype == torch.float32 for a in out)


@pytest.mark.parametrize('which', ['columns', 'varying_ps'])
def test_taumol_groups_match_jax_f64(which):
    """The port's five kernel-B groups, run on the CPU, against the JAX
    taumol_lw (lw_spectral.py:396) and taumol_sw (sw_spectral.py:247) at
    float64: the same gathers, summed in another order, so within 1e-10
    of max."""
    c = radiation_columns() if which == 'columns' else varying_ps_columns()
    ref = jax_taumol(c)
    groups = port_taumol_groups(c, torch.float64)
    for name, group in groups.items():
        out = group.run()
        assert out.dtype == torch.float64, name
        assert rel_err(out, ref[name]) < 1e-10, name


# (call, dtype, case): the LW tables of torch_helpers.lw_table_case or a
# subset of the cross-section gases; the SW solar modes of
# torch_helpers.solar_case
TERM_CASES = [(call, dtype, case)
              for dtype in ('float32', 'float64')
              for call, cases in (('lw', LW_TABLE_CASES + ('wx_subset',)),
                                  ('sw', ('ref', 'svar', 'band')))
              for case in cases]


# taumol_columns of the term tests: 28 levels and the 64 columns of
# varying_ps_columns, so that the JAX operations compiled for
# test_taumol_groups_match_jax_f64 serve them too
TERM_COLUMNS = dict(nz=28, ncol=64)
# float32 groups against the JAX package's float64 path, relative to the
# group's max: the float64 path itself, fed the term columns rounded to
# float32, moves LW taug by 7.42e-6 and SW taug by 2.0e-7 of max; the
# port's float32 groups read at most 4.48e-6 (LW taug) and 4.9e-7 (SW
# taug); 1e-5, 84 float32 epsilons, lies just above the float64 path's 7.42e-6
TERM_F32_TOL = 1e-5


@pytest.fixture(scope='module')
def jax_terms():
    """The JAX taumol_lw / taumol_sw groups at float64 on the term columns,
    computed once per (call, case) and shared by both dtypes."""
    c = taumol_columns(**TERM_COLUMNS)
    refs = {}

    def ref(call, case):
        if (call, case) not in refs:
            if call == 'lw':
                tables = lw_table_case('surrogate' if case == 'wx_subset'
                                       else case)
                tables = {k: v.detach().numpy() if torch.is_tensor(v) else v
                          for k, v in tables.items()}
                refs[call, case] = jax_taumol(
                    c, tables, sw=False, wx_names=('ccl4', 'cfc12')
                    if case == 'wx_subset' else None)
            else:
                refs[call, case] = {
                    k: v for k, v in jax_taumol(
                        c, solar=solar_case(case)).items()
                    if k.startswith('sw_')}
        return refs[call, case]
    return ref


@pytest.mark.parametrize('call, dtype, case', TERM_CASES)
def test_taumol_terms_match_jax_f64(jax_terms, call, dtype, case):
    """taumol_lw_terms / taumol_sw_terms on the CPU (the term plan written
    by term_writer.taumol_terms_plain, summed by kernel B's plain version)
    against the JAX taumol_lw (lw_spectral.py:396) and taumol_sw
    (sw_spectral.py:247) at float64 on columns with and without a
    tropopause crossing, with jp short of the solar reference layers and
    every gas varied, with each LW table case and SW solar mode of the
    card tests: the same gathers, summed in another order, so float64
    within 1e-10 of max; float32 within TERM_F32_TOL."""
    dt = getattr(torch, dtype)
    cs, wx, css = taumol_coefs(taumol_columns(**TERM_COLUMNS), dt)
    if call == 'lw':
        tables = lw_table_case('surrogate' if case == 'wx_subset' else case)
        if case == 'wx_subset':
            wx = {gas: wx[gas] for gas in ('ccl4', 'cfc12')}
        groups = TL.taumol_lw_terms(cs, wx, dt, tables)
        plan = TL.lw_term_plan(tables, tuple(sorted(wx)))
        names = ('lw_taug', 'lw_fracs')
    else:
        isolvar, solar = solar_case(case)
        groups = TS.taumol_sw_terms(css, isolvar, *solar, dt)
        plan = TS.sw_term_plan(case)
        names = ('sw_taug', 'sw_taur', 'sw_sflux')
    ref = jax_terms(call, case)
    assert sorted(ref) == sorted(names)
    for name, group in zip(names, groups):
        out = group.run()
        assert out.dtype == dt, name
        assert rel_err(out, ref[name]) < (
            1e-10 if dtype == 'float64' else TERM_F32_TOL), name
    kinds = {r[0] for r in plan.records}
    if call == 'lw' and case == 'eta_fracs':
        assert term_writer.KIND['frac_lin'] in kinds
    trop = cs['trop']
    assert bool(trop.all(0).any()) and bool((~trop).all(0).any())


@pytest.mark.parametrize('direction', ['upward', 'downward'])
def test_grey_longwave_fluxes_match_jax(direction):
    """upward_longwave_flux and downward_longwave_flux
    (climt_tpu/components/radiation.py:27, :43) on 12 levels x 20
    columns, the optical depth growing with the level index as
    Frierson06LongwaveOpticalDepth's does."""
    from climt_tpu.components import radiation as JR
    from climt_tpu_torch.components import radiation as TR
    rng = np.random.RandomState(9)
    nz, ncol, sigma = 12, 20, 5.67e-8
    T = 200.0 + 100.0 * rng.rand(nz, ncol)
    tau = np.cumsum(rng.rand(nz + 1, ncol), axis=0)
    Ts = 280.0 + 20.0 * rng.rand(ncol)
    if direction == 'upward':
        got = TR.upward_longwave_flux(*map(torch.as_tensor, (T, Ts, tau)),
                                      sigma)
        ref = JR.upward_longwave_flux(*map(jnp.asarray, (T, Ts, tau)), sigma)
    else:
        got = TR.downward_longwave_flux(torch.as_tensor(T),
                                        torch.as_tensor(tau), sigma)
        ref = JR.downward_longwave_flux(jnp.asarray(T), jnp.asarray(tau),
                                        sigma)
    assert got.shape == (nz + 1, ncol)
    assert rel_err(got, ref) < 1e-13
