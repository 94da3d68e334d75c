"""Shared inputs and comparisons for the climt_tpu_torch parity tests.

Inputs are made once with numpy from a seed and handed to both packages:
JAX through ``jnp.asarray``, the port through ``to_torch``.  The module
imports neither jax nor climt_tpu at its top, so ``chip_smoke.py`` runs the
examples through ``port_example`` too.
"""

import functools
import importlib.util
import os
import re
import sys
import time
import types

import numpy as np
import torch

G, AVOG, CPD = 9.80665, 6.022140857e23, 1004.64
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples')


def port_example(name, device=None, bind=()):
    """(main, calls) of examples/<name>.py, run from the file's own text
    with ``climt_tpu`` replaced by ``climt_tpu_torch``.  The names in
    ``bind`` (GFSDynamicalCore and the components the example builds) are
    given ``device=`` wherever the example reaches them, as ``ct.Name`` or
    as a module global; with device None the example runs as written, on
    the card.  ``calls.seconds`` gets the host seconds of each
    GFSDynamicalCore call (the card synchronized), ``calls.dycores`` each
    GFSDynamicalCore the example builds."""
    path = os.path.join(EXAMPLES, name + '.py')
    with open(path) as f:
        source = re.sub(r'\bclimt_tpu\b', 'climt_tpu_torch', f.read())
    example = {'__name__': name + '_example_torch', '__file__': path}
    exec(compile(source, 'examples/%s.py' % name, 'exec'), example)
    ct = example['ct']
    calls = types.SimpleNamespace(seconds=[], dycores=[])

    class TimedDycore(ct.GFSDynamicalCore):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            calls.dycores.append(self)

        def __call__(self, state, timestep):
            t0 = time.perf_counter()
            out = super().__call__(state, timestep)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            calls.seconds.append(time.perf_counter() - t0)
            return out

    classes = dict(vars(ct), GFSDynamicalCore=TimedDycore)
    if device is not None:
        for cls in bind:
            classes[cls] = functools.partial(classes[cls], device=device)
    for cls in set(bind) | {'GFSDynamicalCore'}:
        if cls in example:
            example[cls] = classes[cls]
    example['ct'] = types.SimpleNamespace(**classes)
    return example['main'], calls


# every name the examples build on a device
EXAMPLE_BIND = ('GFSDynamicalCore', 'HeldSuarez', 'EmanuelConvection',
                'SimplePhysics', 'RRTMGLongwave', 'RRTMGShortwave',
                'SlabSurface', 'GrayLongwaveRadiation',
                'Frierson06LongwaveOpticalDepth', 'Instellation',
                'DcmipInitialConditions', 'DryConvectiveAdjustment',
                'GridScaleCondensation', 'IceSheet', 'SeaIce', 'LandIce',
                'SimpleBoundaryLayer', 'BucketHydrology', 'SecondBEST',
                'LandMask', 'DataOcean', 'BergerSolarInsolation')


def jax_example(name):
    """main of examples/<name>.py as written, in the JAX package."""
    spec = importlib.util.spec_from_file_location(
        'example_' + name, os.path.join(EXAMPLES, name + '.py'))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module.main


def run_both_examples(name, port_kw=None, jax_kw=None, **kw):
    """examples/<name>.py in the port (on the CPU) and in JAX, with
    ``kw`` and each package's own ``port_kw``/``jax_kw`` (an output file
    each); returns (port result, JAX result, number of port dycore
    calls)."""
    main, calls = port_example(name, 'cpu', EXAMPLE_BIND)
    st = main(verbose=False, **kw, **(port_kw or {}))
    sj = jax_example(name)(verbose=False, **kw, **(jax_kw or {}))
    return st, sj, len(calls.seconds)


def assert_states_match(st, sj, tol=1e-10):
    """Every numeric field of the JAX state, to ``tol`` of its max."""
    assert set(st) == set(sj)
    for name, value in sj.items():
        if name == 'time' or np.asarray(value.values).dtype.kind != 'f':
            continue
        assert st[name].dims == value.dims, name
        assert rel_err(st[name].values, value.values) <= tol, name


def reset_port_registries():
    """The port keeps its own constants and tracer registries; its test
    files reset them around each test, as tests/conftest.py resets the
    JAX package's constants."""
    from climt_tpu_torch.core import constants, tracers
    constants.reset_constants()
    constants.set_constant('top_of_model_pressure', 20., 'Pa')
    tracers.reset_tracers()
    tracers.reset_packers()


def assert_outputs_match(outs_t, outs_j, tol=1e-10):
    """The port's outputs (a dict of DataArrays, or a tuple of them)
    against JAX's: the same names and units, every floating field as a
    tensor within ``tol`` of its max, every other field (area_type, the
    scalar outputs) exactly."""
    if isinstance(outs_j, dict):
        outs_t, outs_j = (outs_t,), (outs_j,)
    for o_t, o_j in zip(outs_t, outs_j):
        assert set(o_t) == set(o_j)
        for name in o_j:
            assert o_t[name].units == o_j[name].units, name
            a = o_t[name].transpose(*o_j[name].dims).values
            b = o_j[name].values
            if np.asarray(b).dtype.kind == 'f' and np.ndim(b):
                assert isinstance(a, torch.Tensor), name
                assert rel_err(a, b) <= tol, name
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b)), name


AREA_KINDS = np.array(['sea', 'land', 'land_ice', 'sea_ice'])


def surface_fields(state, rng):
    """Radiative and turbulent surface fluxes, a lapse-rate atmosphere
    with winds and moisture, and a mix of area types, for ``state``'s
    grid."""
    p = np.asarray(state['air_pressure'].values)
    shape = p.shape[1:]
    nlev = state['air_pressure_on_interface_levels'].shape[0]

    def column(value, spread):
        return np.broadcast_to(value + spread * rng.rand(*shape),
                               (nlev,) + shape)

    return {
        'area_type': AREA_KINDS[rng.randint(0, 4, shape)],
        'air_temperature': np.maximum(295.0 * (p / 1e5) ** 0.2, 210.0)
        + rng.randn(*p.shape),
        'specific_humidity': 0.012 * (p / 1e5) ** 3,
        'eastward_wind': 6.0 * rng.randn(*p.shape),
        'northward_wind': 3.0 * rng.randn(*p.shape),
        'surface_temperature': 285.0 + 15.0 * rng.rand(*shape),
        'surface_specific_humidity': 0.01 + 0.01 * rng.rand(*shape),
        'downwelling_longwave_flux_in_air': column(300.0, 80.0),
        'downwelling_shortwave_flux_in_air': column(50.0, 400.0),
        'upwelling_longwave_flux_in_air': column(330.0, 80.0),
        'upwelling_shortwave_flux_in_air': column(20.0, 80.0),
        'surface_upward_sensible_heat_flux': 40.0 * rng.randn(*shape),
        'surface_upward_latent_heat_flux': 60.0 * rng.rand(*shape),
    }


def ice_fields(state, rng):
    """Snow and ice of 0.3-3 m over sea ice, land and land ice (some
    columns bare), temperature profiles from the base to a surface that
    is melting in a quarter of the columns."""
    fields = surface_fields(state, rng)
    shape = fields['surface_temperature'].shape
    nlev = state['height_on_ice_interface_levels'].shape[0]
    top = np.where(rng.rand(*shape) < 0.25, 273.15,
                   250.0 + 20.0 * rng.rand(*shape))
    frac = np.linspace(0.0, 1.0, nlev).reshape((nlev,) + (1,) * len(shape))
    base = np.where(fields['area_type'] == 'sea_ice', 271.0,
                    268.0 + 4.0 * rng.rand(*shape))
    bare = rng.rand(*shape) < 0.2
    fields.update({
        'snow_and_ice_temperature': base + (top - base) * frac,
        'sea_ice_thickness': np.where(bare, 0.0, 0.3 + 2.7 * rng.rand(
            *shape)),
        'land_ice_thickness': np.where(bare, 0.0, 0.3 + 2.7 * rng.rand(
            *shape)),
        'surface_snow_thickness': np.where(rng.rand(*shape) < 0.5, 0.0,
                                           0.05 + rng.rand(*shape)),
        'soil_surface_temperature': base,
        'heat_flux_into_sea_water_due_to_sea_ice': 10.0 * rng.randn(*shape),
        'sea_surface_temperature': 271.0 + rng.rand(*shape),
    })
    return fields


def to_torch(x, dtype=torch.float64, device='cpu'):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def rel_err(a, b):
    """max |a - b| / max |b| of two arrays (numpy, jax or torch)."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def radiation_columns(nz=40, ncol=16):
    """The physical columns of tests/test_radiation_fastpath.py:25-54, as
    float64 numpy arrays."""
    rng = np.random.RandomState(42)
    p_sfc = 1013.0
    plev1 = np.linspace(p_sfc, 0.3, nz + 1)
    play1 = 0.5 * (plev1[:-1] + plev1[1:])

    def cols(profile, jitter=0.0):
        base = np.repeat(np.asarray(profile)[:, None], ncol, 1)
        if jitter:
            base = base * (1.0 + jitter * rng.randn(*base.shape))
        return base

    tlay1 = np.maximum(300.0 - 60.0 * (1 - play1 / p_sfc) / 0.8, 205.0)
    tlev1 = np.concatenate([[302.0], 0.5 * (tlay1[:-1] + tlay1[1:]),
                            [tlay1[-1]]])
    play, plev = cols(play1), cols(plev1)
    tlay, tlev = cols(tlay1, 0.005), cols(tlev1)
    tsfc = 295.0 + 10.0 * rng.rand(ncol)
    h2o = cols(0.016 * (play1 / p_sfc) ** 3, 0.05)
    o3 = cols(5e-6 * np.exp(-0.5 * ((np.log(play1) - np.log(20.0))
                                    / 1.2) ** 2))
    return dict(play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc,
                h2o=h2o, o3=o3, co2=np.full_like(play, 355e-6),
                o2=np.full_like(play, 0.21), zero=np.zeros_like(play),
                emis=np.ones((16, ncol)),
                mu0=np.linspace(1e-6, 1.0, ncol), alb=np.full(ncol, 0.2),
                nz=nz, ncol=ncol)


def varying_ps_columns(nz=28, ncol=64):
    """Columns whose surface pressure runs from 550 to 1050 hPa, so that
    one model level spans several taumol pressure blocks across columns
    (float64 numpy, same keys as radiation_columns)."""
    rng = np.random.RandomState(7)
    psfc = np.linspace(550.0, 1050.0, ncol)
    plev = np.maximum(np.linspace(1.0, 0.0, nz + 1)[:, None] * psfc, 0.3)
    play = 0.5 * (plev[:-1] + plev[1:])
    tlay = np.maximum(300.0 - 60.0 * (1 - play / 1013.0) / 0.8, 205.0)
    tlev = np.concatenate([np.full((1, ncol), 302.0),
                           0.5 * (tlay[:-1] + tlay[1:]), tlay[-1:]])
    h2o = 0.016 * (play / 1013.0) ** 3 * (1 + 0.05 * rng.randn(nz, ncol))
    o3 = 5e-6 * np.exp(-0.5 * ((np.log(play) - np.log(20.0)) / 1.2) ** 2)
    return dict(play=play, plev=plev, tlay=tlay, tlev=tlev,
                tsfc=295.0 + 10.0 * rng.rand(ncol), h2o=h2o, o3=o3,
                co2=np.full_like(play, 355e-6), o2=np.full_like(play, 0.21),
                zero=np.zeros_like(play), emis=np.ones((16, ncol)),
                mu0=np.full(ncol, 0.6), alb=np.full(ncol, 0.2),
                nz=nz, ncol=ncol)


def port_lw(c, dtype, device='cpu'):
    from climt_tpu_torch.components.rrtmg.lw_spectral import rrtmg_lw_fluxes
    t = {k: to_torch(v, dtype, device) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = t['zero']
    z16 = torch.zeros((c['nz'], c['ncol'], 16), dtype=dtype, device=device)
    return rrtmg_lw_fluxes(
        t['play'], t['plev'], t['tlay'], t['tlev'], t['tsfc'], t['h2o'],
        t['o3'], t['co2'], z, z, t['o2'], z, z, z, z, t['emis'], z, z16,
        z, z, torch.full_like(z, 25.0), torch.full_like(z, 10.0), z16,
        G, AVOG, CPD, use_tables=False)


def port_sw(c, dtype, device='cpu'):
    from climt_tpu_torch.components.rrtmg.sw_spectral import (
        rrtmg_sw_fluxes, solar_variability)
    t = {k: to_torch(v, dtype, device) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = t['zero']
    z14 = torch.zeros((c['nz'], c['ncol'], 14), dtype=dtype, device=device)
    alb = t['alb']
    return rrtmg_sw_fluxes(
        t['play'], t['plev'], t['tlay'], t['h2o'], t['o3'], t['co2'], z, z,
        t['o2'], alb, alb, alb, alb, t['mu0'], z, (z14,) * 4, (z14,) * 3,
        1.0, -1, 0.0, -1, solar_variability(-1, 0.0), G, AVOG, CPD,
        icld=0, use_tables=False)


def jax_lw(c, dtype, use_tables):
    import jax.numpy as jnp
    from climt_tpu.components.rrtmg.lw_spectral import rrtmg_lw_fluxes
    j = {k: jnp.asarray(v, dtype) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = j['zero']
    z16 = jnp.zeros((c['nz'], c['ncol'], 16), dtype)
    return rrtmg_lw_fluxes(
        j['play'], j['plev'], j['tlay'], j['tlev'], j['tsfc'], j['h2o'],
        j['o3'], j['co2'], z, z, j['o2'], z, z, z, z, j['emis'], z, z16,
        z, z, jnp.full_like(z, 25.0), jnp.full_like(z, 10.0), z16,
        G, AVOG, CPD, use_tables=use_tables)


def jax_sw(c, dtype, use_tables):
    import jax.numpy as jnp
    from climt_tpu.components.rrtmg.sw_spectral import (
        rrtmg_sw_fluxes, solar_variability)
    j = {k: jnp.asarray(v, dtype) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = j['zero']
    z14 = jnp.zeros((c['nz'], c['ncol'], 14), dtype)
    alb = j['alb']
    return rrtmg_sw_fluxes(
        j['play'], j['plev'], j['tlay'], j['h2o'], j['o3'], j['co2'], z, z,
        j['o2'], alb, alb, alb, alb, j['mu0'], z, (z14,) * 4, (z14,) * 3,
        1.0, -1, 0.0, -1, solar_variability(-1, 0.0), G, AVOG, CPD,
        icld=0, use_tables=use_tables)


def port_taumol_groups(c, dtype, device='cpu'):
    """The port's five taumol kernel-B groups (LW taug, LW fracs, SW taug,
    SW taur, SW sflux) of columns ``c``, unlaunched, by name."""
    from climt_tpu_torch.components.rrtmg import lw_spectral as TL
    from climt_tpu_torch.components.rrtmg import sw_spectral as TS
    t = {k: to_torch(v, dtype, device) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = t['zero']
    cs, wx, _ = TL.gas_coefs_lw(
        t['play'], t['plev'], t['tlay'], t['tlev'], t['tsfc'], t['emis'],
        t['h2o'], t['o3'], t['co2'], z, z, t['o2'], z, z, z, z, G, AVOG)
    css = TS.gas_coefs_sw(t['play'], t['plev'], t['tlay'], t['h2o'],
                          t['o3'], t['co2'], z, z, t['o2'], G, AVOG)
    solar = TS.solar_variability(-1, 0.0)
    groups = (TL.taumol_lw_terms(cs, wx, dtype)
              + TS.taumol_sw_terms(css, -1, *solar[:6], dtype))
    return dict(zip(('lw_taug', 'lw_fracs', 'sw_taug', 'sw_taur',
                     'sw_sflux'), groups))


# bands of unequal width, none of them all multiples of 4; the last one
# has no terms
RAGGED_NG = (2, 14, 16, 6, 12, 4)


def ragged_bands(cells=(7, 33), seed=3):
    """Synthetic kernel-B bands: [(ng, [(table, idx, w), ...]), ...] with
    parts of several row counts (one-row tables included) and indices that
    run past both ends of their table (float64 numpy)."""
    rng = np.random.RandomState(seed)
    bands = []
    for b, ng in enumerate(RAGGED_NG):
        shapes = ((17 + 5 * b, 4), (1, 1), (9, 2))[:2 + b % 2]
        parts = []
        for rows, nt in (shapes if b < len(RAGGED_NG) - 1 else ()):
            parts.append((rng.rand(rows, ng),
                          rng.randint(-3, rows + 3, (nt,) + cells),
                          rng.randn(nt, *cells)))
        bands.append((ng, parts))
    return bands


def ragged_group(bands, dtype, device='cpu'):
    """(layout, idx, w) of ``ragged_bands`` for fused_mix.mix_groups."""
    from climt_tpu_torch.components.rrtmg.fused_mix import Layout
    parts = [(b, table, i.shape[0]) for b, (_, ps) in enumerate(bands)
             for table, i, _ in ps]
    idx = np.concatenate([i for _, ps in bands for _, i, _ in ps])
    w = np.concatenate([wt for _, ps in bands for _, _, wt in ps])
    return (Layout([ng for ng, _ in bands], parts, dtype, device),
            torch.as_tensor(idx, dtype=torch.int32, device=device),
            to_torch(w, dtype, device))
