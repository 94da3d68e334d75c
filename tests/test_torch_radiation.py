"""climt_tpu_torch's RRTMG LW and SW pipelines against the JAX package,
on the physical columns of tests/test_radiation_fastpath.py.

The port computes every taumol interpolation as a direct gather (the
JAX f64 path), so at float64 the two agree to roundoff; at float32 the
port is held to the JAX package's own fast-path bounds against f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import (AVOG, G, jax_lw, jax_sw, port_lw, port_sw,
                           port_taumol_groups, radiation_columns, rel_err,
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


def _jax_taumol(c):
    """JAX taumol_lw (taug, fracs) and taumol_sw (taug, taur, sflux) at
    float64 on columns ``c``, set up as the JAX rrtmg_lw_fluxes and
    rrtmg_sw_fluxes set them up."""
    from climt_tpu.components.rrtmg import lw_spectral as JL
    from climt_tpu.components.rrtmg import sw_spectral as JS
    j = {k: jnp.asarray(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = j['zero']
    vmr = dict(h2o=j['h2o'], co2=j['co2'], o3=j['o3'], n2o=z, co=z, ch4=z,
               o2=j['o2'])
    coldry, wkl, wbroad, _ = JL.inatm_lw(j['play'], j['plev'], j['tlay'],
                                         vmr, G, AVOG)
    wx = {name: coldry * z * 1.0e-20
          for name in ('ccl4', 'cfc11', 'cfc12', 'cfc22')}
    cs = JL.setcoef_lw(j['play'], j['tlay'], j['tlev'], j['tsfc'],
                       j['emis'], coldry, wkl, wbroad)
    cs['pavel'] = j['play']
    lw = JL.taumol_lw(cs, wx, jnp.float64)
    pdp = j['plev'][:-1] - j['plev'][1:]
    h2o = j['h2o']
    amm = (1.0 - h2o) * JS.AMD + h2o * JS.AMW
    coldry = pdp * 1.0e3 * AVOG / (1.0e2 * G * amm * (1.0 + h2o))
    wkl = {g: v * coldry for g, v in (
        ('h2o', h2o), ('co2', j['co2']), ('o3', j['o3']), ('n2o', z),
        ('ch4', z), ('o2', j['o2']))}
    css = JS.setcoef_sw(j['play'], j['tlay'], coldry, wkl)
    sw = JS.taumol_sw(css, -1, *JS.solar_variability(-1, 0.0)[:6],
                      jnp.float64)
    return dict(zip(('lw_taug', 'lw_fracs', 'sw_taug', 'sw_taur',
                     'sw_sflux'), lw + sw))


@pytest.mark.parametrize('which', ['columns', 'varying_ps'])
def test_taumol_groups_match_jax_f64(which):
    """The port's five kernel-B groups, run on the CPU, against the JAX
    taumol_lw (lw_spectral.py:396) and taumol_sw (sw_spectral.py:247) at
    float64: the same gathers, summed in another order, so within 1e-10
    of max."""
    c = radiation_columns() if which == 'columns' else varying_ps_columns()
    ref = _jax_taumol(c)
    groups = port_taumol_groups(c, torch.float64)
    for name, group in groups.items():
        out = group.run()
        assert out.dtype == torch.float64, name
        assert rel_err(out, ref[name]) < 1e-10, name
