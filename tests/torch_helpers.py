"""Shared inputs and comparisons for the climt_tpu_torch parity tests.

Inputs are made once with numpy from a seed and handed to both packages:
JAX through ``jnp.asarray``, the port through ``to_torch``.  The module
imports neither jax nor climt_tpu at its top, so ``chip_smoke.py`` runs the
examples through ``port_example`` too.
"""

import bisect
import contextlib
import functools
import importlib.util
import os
import re
import sys
import time
import types

import numpy as np
import torch

# One torch thread in each pytest-xdist worker: the suite runs six
# workers on the host's cores, and torch's default of one OpenMP thread
# per core in every worker oversubscribes them; its spinning threads then
# starve everything else, the spawned gloo ranks and JAX's compiles among
# them (the files of tests/test_torch_parallel_gcm.py and five others
# took 385 s on 6 workers, 139 s with one thread each).
if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

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


def assert_carries_close(port_np, jax_np, sht, tol):
    """Every field of a moist-GCM carry (numpy, port's and JAX's) within
    tol of its max; complex spectral fields compared in grid space through
    the JAX ``sht``, grid q as it is."""
    import jax.numpy as jnp
    for i in range(4):
        for key, b in jax_np[i].items():
            a = port_np[i][key]
            if np.iscomplexobj(b):
                assert np.iscomplexobj(a), (i, key)
                a = np.asarray(sht.synthesize(jnp.asarray(a)))
                b = np.asarray(sht.synthesize(jnp.asarray(b)))
            assert rel_err(a, b) < tol, (i, key, rel_err(a, b))
    assert int(port_np[4]) == int(jax_np[4])


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


# one effective temperature inside each region of the Parmentier
# coefficients (T_eff_boundaries 0, 200, 300, 600, 1400, 2000, inf), each
# more than 1% from a boundary: the region picks the coefficients
CORK_T_EFF = np.array([150.0, 250.0, 450.0, 1000.0, 1700.0, 2500.0])
# Freedman's fit switches branch at 800 K; the hot columns sit above it
CORK_HOT_SHIFT = 700.0


def cork_profiles(p, ps, rng, hot=False):
    """(T, q, co2, T_surf, T_irr, T_int) for CORK on levels ``p`` (nlev,
    *columns) over surface pressures ``ps`` (*columns): a lapse-rate
    temperature floored at 205 K, humidity falling as (p/ps)^3, CO2 at
    400-600 ppm, and irradiation temperatures that put the columns'
    T_eff in turn in each Parmentier region (``CORK_T_EFF``, internal
    temperature 100 K).  ``hot`` adds ``CORK_HOT_SHIFT`` to every other
    column, so Freedman's fit runs both branches."""
    cols = ps.shape
    Ts = 285.0 + 15.0 * rng.rand(*cols)
    T = (np.maximum(Ts * (p / ps) ** 0.19, 205.0)
         * (1.0 + 0.003 * rng.randn(*p.shape)))
    if hot:
        T = T + CORK_HOT_SHIFT * (np.arange(ps.size) % 2).reshape(cols)
    q = 0.015 * (p / ps) ** 3 * (1.0 + 0.1 * rng.rand(*p.shape))
    co2 = 400e-6 * (1.0 + 0.5 * rng.rand(*p.shape))
    T_int = np.full(cols, 100.0)
    T_irr = np.resize(((CORK_T_EFF ** 4 - 100.0 ** 4) / 0.25) ** 0.25, cols)
    return T, q, co2, T[0] + 1.5, T_irr, T_int


def cork_columns(nband, nlev=28, ncol=16, seed=0, hot=False):
    """The array_call state of CorkLongwaveRadiation (its aliases) for
    ``ncol`` columns with surface pressures 550-1050 hPa: ``cork_profiles``,
    emissivity 0.90-0.99, and cloud of optical depth up to 0.6 per band
    in levels 5-8."""
    rng = np.random.RandomState(seed)
    ps = np.linspace(55000.0, 105000.0, ncol)
    p_int = np.linspace(1.0, 0.002, nlev + 1)[:, None] * ps[None, :]
    p = 0.5 * (p_int[1:] + p_int[:-1])
    T, q, co2, T_surf, T_irr, T_int = cork_profiles(p, ps, rng, hot)
    cloud = np.zeros((nlev, ncol, nband))
    cloud[5:9] = 0.6 * rng.rand(4, ncol, nband)
    return dict(T=T, p=p, p_int=p_int, T_surf=T_surf, h2o=q, co2=co2,
                emissivity=0.9 + 0.09 * rng.rand(nband, ncol),
                tau_cloud_lw=cloud, T_irr=T_irr, T_int=T_int)


def cork_fields(state, rng, hot=False):
    """``cork_profiles`` and ``cork_columns``' emissivity and cloud for a
    default state's grid (only the fields the state holds)."""
    p = np.asarray(state['air_pressure'].values)
    ps = np.asarray(state['surface_air_pressure'].values)
    T, q, co2, T_surf, T_irr, T_int = cork_profiles(p, ps, rng, hot)
    emis = state['surface_longwave_emissivity'].values.shape
    cloud = np.zeros(state['longwave_optical_thickness_due_to_cloud']
                     .values.shape)
    cloud[5:9] = 0.6 * rng.rand(*cloud[5:9].shape)
    fields = {'air_temperature': T, 'specific_humidity': q,
              'mole_fraction_of_carbon_dioxide_in_air': co2,
              'surface_temperature': T_surf,
              'irradiation_temperature': T_irr,
              'internal_temperature': T_int,
              'surface_longwave_emissivity': 0.9 + 0.09 * rng.rand(*emis),
              'longwave_optical_thickness_due_to_cloud': cloud}
    return {k: v for k, v in fields.items() if k in state}


def esft_table(seed=5):
    """A synthetic two-gas (H2O, CO2) k-table whose gases overlap by ESFT:
    3 bands of 2 g-points on 6 temperatures and 5 log-pressures, k
    log-uniform in 1e-5-1e-1 m^2/kg.  No shipped table has two gases."""
    rng = np.random.RandomState(seed)
    nband, ngpt, nT, nP = 3, 2, 6, 5
    frac = rng.rand(nband, ngpt, nT)
    return {
        'k_coefficients': 10.0 ** rng.uniform(-5.0, -1.0,
                                              (2, nband, ngpt, nT, nP)),
        'gpoint_weights': np.tile([0.7, 0.3], (nband, 1)),
        'temperature_grid': np.linspace(150.0, 350.0, nT),
        'pressure_grid_log': np.linspace(np.log(100.0), np.log(1.1e5), nP),
        'planck_fraction': frac / frac.sum(axis=(0, 1)),
        'gas_names': np.array(['h2o', 'co2']),
        'overlap_method': np.array('esft'),
    }


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


def seeded_lw_tables(path, seed=0, sigma=0.3):
    """Write to ``path`` the surrogate LW k-tables with every absorption
    array (key-species absa/absb, selfref, forref, the minor-gas and
    cross-section tables) times exp(sigma N(0, 1)), drawn per element
    from ``seed``; the Planck fractions (fracref*) as they are.  The AER
    layout with new numbers and the surrogate's shapes.  Returns path."""
    from climt_tpu_torch import data
    rng = np.random.default_rng(seed)
    tables = dict(data.load_npz(data.LW_KDIST))
    for key in sorted(tables):
        if 'fracref' not in key:
            tables[key] = tables[key] * np.exp(
                sigma * rng.standard_normal(tables[key].shape))
    np.savez(path, **tables)
    return path


def port_lw(c, dtype, device='cpu', **kw):
    """The port's rrtmg_lw_fluxes on columns ``c`` (analytic
    transmittance); ``kw`` goes to it (``tables=``)."""
    from climt_tpu_torch.components.rrtmg.lw_spectral import rrtmg_lw_fluxes
    t = {k: to_torch(v, dtype, device) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = t['zero']
    z16 = torch.zeros((c['nz'], c['ncol'], 16), dtype=dtype, device=device)
    return rrtmg_lw_fluxes(
        t['play'], t['plev'], t['tlay'], t['tlev'], t['tsfc'], t['h2o'],
        t['o3'], t['co2'], z, z, t['o2'], z, z, z, z, t['emis'], z, z16,
        z, z, torch.full_like(z, 25.0), torch.full_like(z, 10.0), z16,
        G, AVOG, CPD, use_tables=False, **kw)


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


def jax_lw(c, dtype, use_tables, **kw):
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
        G, AVOG, CPD, use_tables=use_tables, **kw)


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


def port_taumol_groups(c, dtype, device='cpu', tables=None):
    """The port's five taumol kernel-B groups (LW taug, LW fracs, SW taug,
    SW taur, SW sflux) of columns ``c``, unlaunched, by name; the LW ones
    from the k-tables ``tables`` (None: the installed ones)."""
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
    groups = (TL.taumol_lw_terms(cs, wx, dtype, tables)
              + TS.taumol_sw_terms(css, -1, *solar[:6], dtype))
    return dict(zip(('lw_taug', 'lw_fracs', 'sw_taug', 'sw_taur',
                     'sw_sflux'), groups))


def jax_taumol(c, tables=None, sw=True, wx_names=None, solar=None):
    """JAX taumol_lw (taug, fracs) and, with ``sw``, taumol_sw (taug,
    taur, sflux) at float64 on columns ``c``, set up as the JAX
    rrtmg_lw_fluxes and rrtmg_sw_fluxes set them up, by port group name;
    the LW ones from the k-tables ``tables`` (None: the installed ones)
    with the cross-section gases ``wx_names`` (None: all four), the SW
    ones in the solar mode ``solar`` (an (isolvar, six factors) pair of
    ``solar_case``; None: the reference spectrum).  CH4, N2O, the CFCs and
    CCl4 are zero where ``c`` holds none."""
    import jax.numpy as jnp
    from climt_tpu.components.rrtmg import lw_spectral as JL
    from climt_tpu.components.rrtmg import sw_spectral as JS
    j = {k: jnp.asarray(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    z = jnp.zeros_like(j['play'])
    gas = {g: j.get(g, z) for g in ('ch4', 'n2o', 'cfc11', 'cfc12', 'cfc22',
                                    'ccl4')}
    vmr = dict(h2o=j['h2o'], co2=j['co2'], o3=j['o3'], n2o=gas['n2o'], co=z,
               ch4=gas['ch4'], o2=j['o2'])
    coldry, wkl, wbroad, _ = JL.inatm_lw(j['play'], j['plev'], j['tlay'],
                                         vmr, G, AVOG)
    wx = {name: coldry * gas[name] * 1.0e-20
          for name in (wx_names or ('ccl4', 'cfc11', 'cfc12', 'cfc22'))}
    cs = JL.setcoef_lw(j['play'], j['tlay'], j['tlev'], j['tsfc'],
                       j['emis'], coldry, wkl, wbroad)
    cs['pavel'] = j['play']
    lw = JL.taumol_lw(cs, wx, jnp.float64, tables=tables)
    if not sw:
        return dict(zip(('lw_taug', 'lw_fracs'), lw))
    pdp = j['plev'][:-1] - j['plev'][1:]
    h2o = j['h2o']
    amm = (1.0 - h2o) * JS.AMD + h2o * JS.AMW
    coldry = pdp * 1.0e3 * AVOG / (1.0e2 * G * amm * (1.0 + h2o))
    wkl = {g: v * coldry for g, v in (
        ('h2o', h2o), ('co2', j['co2']), ('o3', j['o3']), ('n2o', gas['n2o']),
        ('ch4', gas['ch4']), ('o2', j['o2']))}
    css = JS.setcoef_sw(j['play'], j['tlay'], coldry, wkl)
    isolvar, factors = solar or (-1, JS.solar_variability(-1, 0.0)[:6])
    sw = JS.taumol_sw(css, isolvar, *factors, jnp.float64)
    return dict(zip(('lw_taug', 'lw_fracs', 'sw_taug', 'sw_taur',
                     'sw_sflux'), lw + sw))


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


# the contention patterns of kernel B's backward (contention_bands)
CONTENTION_CASES = ('one_row', 'own_row', 'every_1', 'every_4', 'every_8',
                    'every_64', 'past_ends', 'one_row_parts', 'ragged_ng',
                    'big_band', 'huge_band', 'ncell_ragged', 'ncell_1',
                    'ncell_nz')


def contention_bands(case):
    """Kernel-B bands (``ragged_bands``' form) whose indices make one of
    CONTENTION_CASES for the backward: every cell on one row, every cell
    on its own row, rows changing every 1, 4, 8 and 64 cells, indices
    past both ends of a table, one-row parts, bands of ng 1 to 16, bands
    of 2000 and 9000 rows (256 KB and 1.1 MB of float64 at ng 16), and
    1536 cells save for 'ncell_ragged' (231: not a multiple of a tile),
    'ncell_1' and 'ncell_nz' (28: one column).  Cells (nz, ncol), level
    major as the LW groups lay them out; seeded by the case."""
    rng = np.random.RandomState(CONTENTION_CASES.index(case))
    cells = {'ncell_ragged': (7, 33), 'ncell_1': (1,),
             'ncell_nz': (28,)}.get(case, (6, 256))
    ncell = int(np.prod(cells))
    cell = np.arange(ncell).reshape(cells)
    rows, nt, ngs = 40, 3, (16, 12, 7, 3)
    if case == 'ragged_ng':
        ngs = tuple(range(1, 17))
    if case == 'own_row':
        rows = ncell
    if case in ('big_band', 'huge_band'):
        rows, ngs = (2000 if case == 'big_band' else 9000), (16, 5)
    bands = []
    for ng in ngs:
        parts = []
        for part_rows in ((1,) if case == 'one_row_parts' else (rows, 9)):
            shape = (nt,) + cells
            if case == 'one_row':
                idx = np.full(shape, 5)
            elif case == 'own_row':
                idx = np.broadcast_to(cell, shape)
            elif case.startswith('every_'):
                k = int(case.split('_')[1])
                idx = np.broadcast_to(cell // k, shape) % part_rows
                idx = (idx + np.arange(nt).reshape((nt,) + (1,) * len(cells))
                       ) % part_rows
            elif case == 'past_ends':
                idx = rng.randint(-6, part_rows + 6, shape)
            else:
                # rows that drift slowly along the cells, some jumps
                idx = (np.broadcast_to(cell // 37, shape)
                       + rng.randint(0, 2, shape)) % part_rows
            parts.append((rng.rand(part_rows, ng), np.ascontiguousarray(idx),
                          rng.rand(*shape) + 0.5))
        bands.append((ng, parts))
    return bands


def smoke_constant(name):
    """A name of chip_smoke.py (its tolerances, its capture of the moist
    GCM's convection inputs), read from the script itself so that the
    tests and the smoke share one definition."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_constants', os.path.join(os.path.dirname(EXAMPLES),
                                             'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


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


# -- ranks of a torch.distributed world, spawned ---------------------------

def spawn_ranks(target, world, out_dir, timeout=240.0, device='cpu',
                **kwargs):
    """Run ``torch_helpers.<target>(rank, world, **kwargs)`` on ``world``
    ranks through the package's ``parallel.spawn_ranks`` (a FileStore in
    ``out_dir``): gloo ranks on the CPU, or with ``device='cuda'`` NCCL
    ranks, rank r on card r; returns each rank's result."""
    from climt_tpu_torch.parallel import spawn_ranks as spawn
    return spawn(globals()[target], world, kwargs, device=device,
                 timeout=timeout, out_dir=out_dir)


@contextlib.contextmanager
def world_of_one(out_dir):
    """A gloo world of one in this process, left when the block ends."""
    import torch.distributed as dist
    from climt_tpu_torch.parallel import initialize_distributed
    if dist.is_initialized():
        raise RuntimeError('a process group is already running here')
    size = initialize_distributed(
        'file://' + os.path.join(str(out_dir), 'store'), 1, 0, device='cpu')
    try:
        yield size
    finally:
        dist.destroy_process_group()


def _block(x, sht):
    """A rank's block of a global numpy field: spectral (complex) by
    m-block, M padded; grid by latitude rows."""
    x = torch.as_tensor(np.array(x))
    if x.is_complex():
        return sht.pad_spec(x)[..., sht.m_rows, :].contiguous()
    return x[..., sht.rows, :].contiguous()


def sht_rank_results(dsht, grids):
    """Every transform of a DistributedSHT on the rank's blocks of two
    global (nz, nlat, nlon) fields, each gathered to the global layout."""
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
    full = SphericalHarmonicTransform(
        dsht.nlon, dsht.nlat, dsht.truncation, dtype=torch.float64,
        device='cpu')
    a, b = (torch.as_tensor(np.array(g)) for g in grids)
    sa, sb = (_block(full.analyze(g), dsht) for g in (a, b))
    ga, gb = _block(a, dsht), _block(b, dsht)
    rows, ms = dsht.gather_rows, dsht.gather_m
    out = {'analyze': ms(dsht.analyze(ga)),
           'synthesize': rows(dsht.synthesize(sa)),
           'roundtrip': ms(dsht.analyze(dsht.synthesize(sa))),
           'synthesize_dmu': rows(dsht.synthesize_dmu(sa)),
           'synthesize_dlambda': rows(dsht.synthesize_dlambda(sa)),
           'analyze_rank2': ms(dsht.analyze(ga[0])),
           'synthesize_rank2': rows(dsht.synthesize(sa[0])),
           'laplacian': ms(dsht.laplacian(sa)),
           'inverse_laplacian': ms(dsht.inverse_laplacian(sa)),
           'filter_spec': ms(dsht.filter_spec(sa + 1.0)),
           'total_wavenumber': ms(dsht.total_wavenumber)}
    out['gradient'] = tuple(rows(x) for x in dsht.gradient(sa))
    out['uv_from_vort_div'] = tuple(
        rows(x) for x in dsht.uv_from_vort_div(sa, sb))
    out['vort_div_analysis'] = tuple(
        ms(x) for x in dsht.vort_div_analysis(ga, gb))
    return {k: tuple(x.numpy() for x in v) if isinstance(v, tuple)
            else v.numpy() for k, v in out.items()}


def parallel_ops_rank(rank, world, sht_cases, fv_case):
    """The parallel layer on one rank of a CPU world: start-up, meshes,
    DistributedSHT on each case of ``sht_cases`` ({name: (nlon, nlat,
    truncation, (grid_a, grid_b), fft_impl)}), and FVAdvection with the
    latitude halo on ``fv_case`` ((mu, w, nlon, dt), (q, dp, u, v,
    mdot))."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from climt_tpu_torch.ops.fv_advection import FVAdvection
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
    from climt_tpu_torch.parallel import (
        DistributedSHT, grid_sharding, initialize_distributed, make_lat_halo,
        make_mesh, process_info, replicated)
    out = {'process_info': process_info(),
           'initialize_again': initialize_distributed(device='cpu'),
           'backend': dist.get_backend()}
    mesh = make_mesh(world, mesh_shape=(world, 1), device='cpu')
    default = make_mesh(device='cpu')
    out['default_shape'] = tuple(default.shape)
    out['placements'] = (tuple(map(str, grid_sharding(mesh))),
                         tuple(map(str, grid_sharding(mesh, ndim=2))),
                         tuple(map(str, replicated(mesh))))
    # DTensor's own shard of a grid field is the rank's block
    x = torch.arange(2 * 16 * 3, dtype=torch.float64).reshape(2, 16, 3)
    local = distribute_tensor(x, mesh, grid_sharding(mesh)).to_local()
    n = 16 // world
    out['dtensor_block'] = bool(torch.equal(
        local, x[:, rank * n:(rank + 1) * n]))
    for name, (nlon, nlat, truncation, grids, fft_impl) in sht_cases.items():
        dsht = DistributedSHT(SphericalHarmonicTransform(
            nlon, nlat, truncation, dtype=torch.float64, device='cpu',
            fft_impl=fft_impl), mesh)
        out[name] = sht_rank_results(dsht, grids)
        out[name]['M_padded'] = dsht.M_padded
        out[name]['fft_impl'] = dsht.fft_impl
    (mu, w, nlon, dt), fields = fv_case
    fv = FVAdvection(mu, w, nlon, 6.371e6, dt, dtype=torch.float64,
                     device='cpu', halo_exchange=make_lat_halo(mesh))
    grid = DistributedSHT(SphericalHarmonicTransform(
        nlon, len(mu), dtype=torch.float64, device='cpu'), mesh)
    q, dp, u, v, mdot = (_block(f, grid) for f in fields)
    out['fv_advect'] = grid.gather_rows(
        fv.advect(q, dp, u, v, mdot, dt)).numpy()
    out['fv_mass'] = fv_mass_pass(fv, q, dp, u, v, mdot, dt)
    out['fv_bands'] = fv.zonal_bands
    return out


def water_fixer_closure(step_fn, carry):
    """(target, fixed, unfixed): the water total the fixer aims at over one
    step from ``carry``, the total after the fix, and before it, each
    summed over the sphere (all-reduced under a mesh)."""
    model = step_fn.__self__
    dycore = model.dycore
    prev, now, grids, aux, k = carry
    phys, _, _ = model.physics(grids, aux, k)
    _, new, _ = dycore.step(prev, now, phys=phys)
    fixed = model._fix_water(new, prev, phys)

    def half_levels(state):
        ps = torch.exp(dycore.sht.synthesize(state['lnps']))
        return dycore._vertical_structures(ps)[0]

    ph_prev, ph_new = half_levels(prev), half_levels(new)
    src = dycore.sht.global_sum(model.wlat * phys['dq']
                                * (ph_prev[1:] - ph_prev[:-1]))
    target = (model._total_water(dycore._q_grid(prev), ph_prev)
              + 2.0 * model.dt * src)
    return (float(target),
            float(model._total_water(dycore._q_grid(fixed), ph_new)),
            float(model._total_water(torch.clamp(dycore._q_grid(new),
                                                 min=0.0), ph_new)))


def fv_mass_pass(fv, q, dp, u, v, mdot, dt):
    """(before, after): an FV operator's total tracer mass over one pass
    of its three sweeps, with the pseudo-density the sweeps carry."""
    m0 = float(fv.total_mass(q, dp))
    qdp, dps = fv._zonal(q, dp, u, dt)
    qdp, dps = fv._meridional(qdp, dps, v, dt)
    qdp, dps = fv._vertical(qdp, dps, mdot, dt)
    return m0, float(fv.total_mass(qdp, dps))


def conservation_failures(fv_mass=(), water=()):
    """The failures, as messages, of the conservation checks that the CPU
    files and the cards share, given by rank: each FV mass pass (before,
    after) of ``fv_mass_pass`` keeps its total to 1e-12 and every rank
    starts from one total (each sums the whole sphere); each closure
    (target, fixed, unfixed) of ``water_fixer_closure`` reaches its
    target to 1e-12 with more than 1e-8 to close."""
    fails = ['rank %d: FV mass %r -> %r' % (rank, m0, m1)
             for rank, (m0, m1) in enumerate(fv_mass)
             if not abs(m1 - m0) / m0 < 1e-12]
    starts = sorted({m0 for m0, _ in fv_mass})
    if len(starts) > 1:
        fails.append('the ranks start from FV masses %s' % starts)
    for rank, (target, fixed, unfixed) in enumerate(water):
        if not abs(fixed - target) / target < 1e-12:
            fails.append('rank %d: the water fixer reaches %r, not its '
                         'target %r' % (rank, fixed, target))
        if not abs(unfixed - target) / target > 1e-8:
            fails.append('rank %d: the water fixer had nothing to close '
                         '(%r against the target %r)' % (rank, unfixed,
                                                         target))
    return fails


# -- the counters of one step ----------------------------------------------

def reset_counters():
    """Set the parallel layer's collective counters (calls and bytes) and
    both kernels' launch counters to 0."""
    from climt_tpu_torch.components.rrtmg import fused_mix, rtrn_kernel
    from climt_tpu_torch.parallel import dist_sht, halo, rep_sht
    for counter in (dist_sht.transpose, halo.LatHalo, rep_sht.all_reduce_sum,
                    rep_sht.all_gather_cat):
        counter.calls = counter.bytes = 0
    fused_mix.mix_groups_cuda.launches = 0
    rtrn_kernel.rtrn_lw_cuda.launches = 0


def read_counters():
    """{'collectives': (all_to_all transposes, halo calls, all_reduce
    calls, all_gather calls), 'bytes': the bytes each handed to the
    collectives, 'launches': (kernel B, kernel A)} since
    ``reset_counters``."""
    from climt_tpu_torch.components.rrtmg import fused_mix, rtrn_kernel
    from climt_tpu_torch.parallel import dist_sht, halo, rep_sht
    counters = (dist_sht.transpose, halo.LatHalo, rep_sht.all_reduce_sum,
                rep_sht.all_gather_cat)
    return {'collectives': tuple(c.calls for c in counters),
            'bytes': tuple(c.bytes for c in counters),
            'launches': (fused_mix.mix_groups_cuda.launches,
                         rtrn_kernel.rtrn_lw_cuda.launches)}


def synchronize():
    """Wait for the card, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def counted_step(step_fn, carry):
    """(carry, diagnostics, ``read_counters()``) of one step, the counters
    set to 0 before it and the card synchronized after it."""
    reset_counters()
    carry, diag = step_fn(carry)
    synchronize()
    return carry, diag, read_counters()


# (all_to_all transposes, halo calls, all_reduce calls, all_gather calls)
# of a model's first step on every rank, by (layout, model), as the gloo
# ranks of tests/test_torch_parallel_gcm.py and
# tests/test_torch_parallel_layouts*.py count them: the m-sharded
# transforms' transposes (a 'lon' extent repeats them), the FV halo on a
# latitude-sharded grid, the water fixer's one reduction (spectral and
# SL; the replicated layout also reduces each dycore stage's analyses,
# and the fixer's sums over 'lon' under shard_lon), and the gathers of
# the grid transports (SL always, FV under shard_lon) and of the whole
# rows before an analysis under shard_lon
STEP_COLLECTIVES = {
    ('m_sharded', 'spectral'): (19, 0, 1, 0),
    ('m_sharded', 'fv'): (12, 7, 0, 0),
    ('m_sharded', 'sl'): (14, 0, 1, 1),
    ('replicated', 'spectral'): (0, 0, 3, 0),
    ('replicated_lon', 'spectral'): (0, 0, 4, 2),
    ('replicated', 'fv'): (0, 7, 1, 0),
    ('replicated_lon', 'fv'): (0, 0, 1, 3),
    ('replicated', 'sl'): (0, 0, 2, 1),
    ('replicated_lon', 'sl'): (0, 0, 3, 3),
    ('replicated', 'held_suarez'): (0, 0, 1, 0),
    ('replicated_lon', 'held_suarez'): (0, 0, 1, 1),
}


def mesh_gcm_run(mesh, mode, kw, steps, early=None, dtype=torch.float64,
                 device='cpu', checks=False, start=None):
    """build_moist_gcm(mesh=mesh) run for ``steps`` steps from seed 0, or
    from the global numpy carry ``start`` cut to the rank by
    ``carry_to_rank``: {'final': the gathered (carry, diagnostics),
    'counts': the counters of the first step (``counted_step``)} and,
    with ``early``, the gathered carry after that many steps; with
    ``start``, 'own_init', the model's own initial carry gathered; with
    ``checks``, FV's mass pass ('fv') or the water fixer's closure ('sl')
    from the initial carry."""
    from climt_tpu_torch.convert import carry_to_global, carry_to_rank
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    dycore, init_fn, step_fn, run_fn = build_moist_gcm(
        mesh=mesh, dtype=dtype, device=device, moisture_advection=mode,
        **kw)
    out = {}
    if start is None:
        carry = init_fn(0)
    else:
        out['own_init'] = carry_to_global(init_fn(0), dycore.sht)
        carry = carry_to_rank(start, dycore.sht, device, dtype)
    if checks and mode == 'fv':
        # the centre state's moisture on its own winds and mass fluxes
        u, v, dp, mdot = dycore.diagnose_mass_fluxes(carry[1])
        out['fv_mass'] = fv_mass_pass(dycore.fv, carry[1]['q'], dp, u, v,
                                      mdot, 2.0 * dycore.dt)
    if checks and mode == 'sl':
        out['water'] = water_fixer_closure(step_fn, carry)
    carry, diag, out['counts'] = counted_step(step_fn, carry)
    done = 1
    if early:
        carry, _ = run_fn(carry, early - done)
        out['early'] = carry_to_global(carry, dycore.sht)
        done = early
    if steps > done:
        carry, diag = run_fn(carry, steps - done)
    out['final'] = carry_to_global(carry + (diag,), dycore.sht)
    return out


def parallel_gcm_rank(rank, world, kw, modes, steps, early, starts):
    """The moist GCM on one rank of a CPU world: each moisture mode on a
    (world, 1) mesh, the spectral model on the default (2, 2) mesh, and
    one spectral step from each global carry of ``starts`` ({name: numpy
    carry}) cut to the rank by ``carry_to_rank``."""
    from climt_tpu_torch.convert import carry_to_global, carry_to_rank
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import make_mesh
    mesh = make_mesh(world, mesh_shape=(world, 1), device='cpu')
    out = {mode: mesh_gcm_run(mesh, mode, kw, steps, early, checks=True)
           for mode in modes}
    dycore, _, step_fn, _ = build_moist_gcm(
        mesh=mesh, dtype=torch.float64, device='cpu', **kw)
    out['from'] = {name: carry_to_global(step_fn(carry_to_rank(
        carry, dycore.sht, 'cpu', torch.float64))[0], dycore.sht)
        for name, carry in starts.items()}
    square = make_mesh(device='cpu')
    out['spectral_2x2'] = mesh_gcm_run(square, 'spectral', kw, steps)
    out['mesh_shapes'] = (tuple(mesh.shape), tuple(square.shape))
    return out


def shared_card_rank(rank, world, kw, steps, modes):
    """The float64 moist GCM on one rank of a world whose ranks share the
    first card (gloo): {mode: (gathered carry and diagnostics, seconds to
    build, start and run ``steps`` steps)}, on a (world, 1) mesh."""
    from climt_tpu_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    mesh = make_mesh(world, mesh_shape=(world, 1), device='cuda')
    out = {}
    for mode in modes:
        t0 = time.perf_counter()
        final = mesh_gcm_run(mesh, mode, kw, steps, device='cuda')['final']
        out[mode] = (final, time.perf_counter() - t0)
    return out



# -- the replicated-spectral layout (parallel.shard_model_state) ------------

# the meshes of the layout tests on 4 ranks, as (mesh shape, shard_lon):
# lat-only, lat-only with each block repeated on 2 'lon' ranks, and
# latitude x longitude blocks
LAYOUTS = (((4, 1), False), ((2, 2), False), ((2, 2), True), ((1, 4), True))


def layout_name(layout):
    (lat, lon), shard_lon = layout
    return '%dx%d%s' % (lat, lon, '_lon' if shard_lon else '')


def _local_spectral(carry):
    """Every complex (spectral) field of a placed carry's states, as the
    rank holds it, in numpy."""
    return {(i, k): v.to_local().cpu().numpy() for i in (0, 1)
            for k, v in carry[i].items() if v.is_complex()}


def layout_gcm_run(model, mesh, shard_lon, steps, checks=True):
    """The (dycore, init_fn, step_fn, run_fn) of build_moist_gcm without
    a mesh, its carry placed by shard_model_state and stepped by run_fn:
    {'final': the gathered carry and diagnostics, 'spectral': the rank's
    own spectral fields, 'counts': the counters of the first step from
    the placed carry (``counted_step``)} and, with ``checks``, 'fv_mass'
    (FV) or 'water' (SL): FV's mass pass or the water fixer's closure on
    the twin's blocks from the initial carry."""
    from climt_tpu_torch.convert import carry_to_global
    from climt_tpu_torch.dycore.spectral_dynamics import GatheredTransport
    from climt_tpu_torch.parallel import shard_model_state
    from climt_tpu_torch.parallel.mesh import unwrap_carry
    _, init_fn, step_fn, run_fn = model
    mode = step_fn.__self__.dycore.moisture_advection
    carry = shard_model_state(mesh, *init_fn(0), shard_lon=shard_lon)
    twin = step_fn.__self__._layout_twin(carry)[0]
    local = unwrap_carry(carry)
    out = {}
    if checks and mode == 'fv':
        u, v, dp, mdot = twin.dycore.diagnose_mass_fluxes(local[1])
        fields, fv = (local[1]['q'], dp, u, v, mdot), twin.dycore.fv
        if isinstance(fv, GatheredTransport):
            fields = tuple(twin.dycore.sht.gather_rows(x) for x in fields)
            fv = fv.op
        out['fv_mass'] = fv_mass_pass(fv, *fields, 2.0 * twin.dt)
    if checks and mode == 'sl':
        out['water'] = water_fixer_closure(twin.step, local)
    carry, diag, out['counts'] = counted_step(step_fn, carry)
    if steps > 1:
        carry, diag = run_fn(carry, steps - 1)
    out['spectral'] = _local_spectral(carry)
    out['final'] = carry_to_global(carry + (diag,))
    return out


def layout_gcm_rank(rank, world, kw, mode, steps, layouts=LAYOUTS):
    """The moist GCM of ``layout_gcm_run`` on one rank of a CPU world, on
    each mesh layout of ``layouts``: one model, a twin per layout."""
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import make_mesh
    model = build_moist_gcm(dtype=torch.float64, device='cpu',
                            moisture_advection=mode, **kw)
    out = {}
    for shape, shard_lon in layouts:
        mesh = make_mesh(world, mesh_shape=shape, device='cpu')
        out[layout_name((shape, shard_lon))] = layout_gcm_run(
            model, mesh, shard_lon, steps)
    return out


def layout_sht_results(sht, grids):
    """Every transform of a ReplicatedSHT on the rank's blocks of two
    global (nz, nlat, nlon) fields, grid results gathered to the global
    layout, spectral ones as the rank holds them (whole)."""
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
    a, b = (torch.as_tensor(np.array(g)) for g in grids)
    one = SphericalHarmonicTransform(sht.nlon, sht.nlat, sht.truncation,
                                     dtype=torch.float64, device='cpu')
    sa, sb = one.analyze(a), one.analyze(b)
    ga, gb = (x[..., sht.rows, sht.cols] for x in (a, b))
    rows = sht.gather_rows
    out = {'analyze': sht.analyze(ga),
           'synthesize': rows(sht.synthesize(sa)),
           'roundtrip': sht.analyze(sht.synthesize(sa)),
           'synthesize_dmu': rows(sht.synthesize_dmu(sa)),
           'synthesize_dlambda': rows(sht.synthesize_dlambda(sa)),
           'analyze_rank2': sht.analyze(ga[0]),
           'synthesize_rank2': rows(sht.synthesize(sa[0])),
           'laplacian': sht.laplacian(sa),
           'inverse_laplacian': sht.inverse_laplacian(sa),
           'filter_spec': sht.filter_spec(sa + 1.0),
           'total_wavenumber': sht.total_wavenumber,
           'global_sum': sht.global_sum(ga * sht.coslat)}
    out['gradient'] = tuple(rows(x) for x in sht.gradient(sa))
    out['uv_from_vort_div'] = tuple(
        rows(x) for x in sht.uv_from_vort_div(sa, sb))
    out['vort_div_analysis'] = sht.vort_div_analysis(ga, gb)
    specs, pairs = sht.analyze_many([ga, gb[0]], [(ga, gb)])
    out['analyze_many'] = tuple(specs) + pairs[0]
    return {k: tuple(x.numpy() for x in v) if isinstance(v, tuple)
            else v.numpy() for k, v in out.items()}


def layout_hs_run(model, mesh, shard_lon, steps):
    """build_held_suarez_model's (dycore, init_fn, step_fn, run_fn), its
    carry placed by shard_model_state and run ``steps`` steps: {'final':
    the gathered carry, 'spectral': the rank's own spectral fields,
    'counts': the counters of the first step}."""
    from climt_tpu_torch.convert import carry_to_global
    from climt_tpu_torch.parallel import shard_model_state
    _, init_fn, step_fn, run_fn = model
    carry = shard_model_state(mesh, *init_fn(0), shard_lon=shard_lon)
    carry, _, counts = counted_step(step_fn, carry)
    if steps > 1:
        carry = run_fn(carry, steps - 1)
    return {'final': carry_to_global(carry),
            'spectral': _local_spectral(carry), 'counts': counts}


def layout_hs_rank(rank, world, kw, steps, grids, layouts=LAYOUTS):
    """On one rank of a CPU world, for each mesh layout of ``layouts``:
    the ReplicatedSHT's transforms of ``grids`` (``layout_sht_results``)
    and ``layout_hs_run`` of build_held_suarez_model at float64."""
    from climt_tpu_torch.dycore.compiled import build_held_suarez_model
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
    from climt_tpu_torch.parallel import ReplicatedSHT, make_mesh
    model = build_held_suarez_model(dtype=torch.float64, device='cpu',
                                    **kw)
    nz, nlat, nlon = np.shape(grids[0])
    out = {}
    for shape, shard_lon in layouts:
        mesh = make_mesh(world, mesh_shape=shape, device='cpu')
        sht = ReplicatedSHT(SphericalHarmonicTransform(
            nlon, nlat, dtype=torch.float64, device='cpu'), mesh, shard_lon)
        res = layout_hs_run(model, mesh, shard_lon, steps)
        res['sht'] = layout_sht_results(sht, grids)
        out[layout_name((shape, shard_lon))] = res
    return out


def layout_shared_card_rank(rank, world, kw, steps, modes, meshes):
    """The float64 moist GCM built without a mesh, its carry placed by
    shard_model_state and run ``steps`` steps, on one rank of a world
    whose ranks share the first card (gloo): {(mesh shape, shard_lon,
    mode): (gathered carry and diagnostics, seconds to build, place and
    run)}."""
    from climt_tpu_torch.convert import carry_to_global
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import make_mesh, shard_model_state
    torch.cuda.set_device(0)
    out = {}
    for shape, shard_lon in meshes:
        mesh = make_mesh(world, mesh_shape=shape, device='cuda')
        for mode in modes:
            t0 = time.perf_counter()
            _, init_fn, _, run_fn = build_moist_gcm(
                dtype=torch.float64, device='cuda', moisture_advection=mode,
                **kw)
            carry = shard_model_state(mesh, *init_fn(0), shard_lon=shard_lon)
            carry, diag = run_fn(carry, steps)
            final = carry_to_global(carry + (diag,))
            out[(shape, shard_lon, mode)] = (final, time.perf_counter() - t0)
    return out


# -- the mesh layouts across cards (tests/test_torch_gpu_mesh.py and
# chip_smoke.py phase 28) ---------------------------------------------------

# the two sizes of the card cases, as (moist GCM keywords, dtype, steps):
# 7 float64 steps at 64x32x10 (radiation refreshed at steps 0 and 6), and
# one float32 refresh step of phase 6's T85 model
CARD_SIZES = {
    'small': (dict(nlon=64, nlat=32, nz=10, rad_every=6,
                   rad_col_chunk=2048), torch.float64, 7),
    't85': (dict(nlon=256, nlat=128, nz=28, timestep=600.0, rad_every=6,
                 rad_col_chunk=8192), torch.float32, 1),
}
# the small size's limit against one card: the layouts change only the
# order of the transforms' and the fixer's sums (chip_smoke.py phases
# 20 (b) and 21 (b)); T85 is held to entry_points.compare_steps's float32
# limits
CARD_SMALL_TOL = 1e-9
CARD_MODELS = ('spectral', 'fv', 'sl', 'held_suarez')
# the join timeout of the card cases' ranks, in seconds
CARD_TIMEOUT = 900.0
# phase 28's timed models: T85 float32 with these moisture modes, in
# windows of CARD_WINDOW steps
CARD_TIMING_MODES = ('spectral', 'fv')
CARD_WINDOW = 12


def card_meshes(world):
    """(m-sharded mesh shapes, replicated layouts) of the card cases on
    ``world`` ranks: (4, 1) and (2, 2), and every layout of LAYOUTS, on
    4; otherwise (n, 1), and (n, 1) and (1, n) with shard_lon."""
    if world == 4:
        return ((4, 1), (2, 2)), LAYOUTS
    return ((world, 1),), (((world, 1), False), ((1, world), True))


def refresh_launches(kw, shape, shard_lon, dtype):
    """(kernel B, kernel A) launches of one radiation refresh on one rank
    of a (lat, lon) mesh, worked out from the code: the rank radiates its
    own columns (nlat/lat rows of nlon columns, of nlon/lon with
    shard_lon; the m-sharded layout repeats whole rows on each 'lon'
    rank) in chunks of rad_col_chunk where that divides them, else in one
    (MoistGCM.rad_chunks); each chunk launches kernel B once for each of
    its six taumol outputs (LW planck, taug, fracs; SW taug, taur, sflux)
    and kernel A once in float32 (float64 takes the plain table sweep)."""
    lat, lon = shape
    ncol = (kw['nlat'] // lat) * (kw['nlon'] // lon if shard_lon
                                  else kw['nlon'])
    chunk = kw['rad_col_chunk']
    chunks = max(1, ncol // chunk) if ncol % chunk == 0 else 1
    return 6 * chunks, chunks if dtype == torch.float32 else 0


def limit_share(ref, got, sht):
    """(largest share, field) of ``entry_points.step_errors``'s float32
    limits of the carry ``got`` against ``ref``, spectral fields
    synthesized by ``sht``; a step index that differs counts as inf."""
    from climt_tpu_torch.entry_points import step_errors

    def synthesize(spec):
        return sht.synthesize(torch.as_tensor(
            spec, device=sht.P.device)).cpu().numpy()

    if len(ref) > 4 and int(got[4]) != int(ref[4]):
        return float('inf'), 'step index'
    errors = step_errors(ref, got, synthesize)
    worst = max(errors, key=lambda name: errors[name]['of_limit'])
    return errors[worst]['of_limit'], worst


def _card_record(run, ref, sht, small, mesh, start=None):
    """A card case's record: the gathered carry of ``run`` held against
    the one-card carry ``ref`` (every field's max |a - b| / max |b| at the
    small size, ``limit_share`` at T85), 'err', the worst 'field' and the
    'limit'; the run's counters and checks; where the run holds the
    model's own initial carry, its ``limit_share`` against the one-card
    initial carry ``start``, 'init_err' and 'init_field'."""
    rec = {k: run[k] for k in ('counts', 'fv_mass', 'water') if k in run}
    rec['mesh'] = mesh
    got = run['final']
    if 'own_init' in run:
        rec['init_err'], rec['init_field'] = limit_share(
            start, run['own_init'], sht)
    if not small:
        err, field = limit_share(ref, got, sht)
        rec.update(err=err, field=field, limit=1.0)
        return rec
    errs = {}
    for i, part in enumerate(ref):
        if isinstance(part, dict):
            for key, b in part.items():
                errs['%d %s' % (i, key)] = float(rel_err(got[i][key], b))
        elif int(got[i]) != int(part):
            errs['step index'] = float('inf')
    worst = max(errs, key=errs.get)
    rec.update(err=errs[worst], field=worst, limit=CARD_SMALL_TOL)
    return rec


def card_mesh_rank(rank, world, device='cuda', timing=False):
    """The card cases on one rank of a world, NCCL ranks one a card (gloo
    ranks with ``device='cpu'``, to rehearse): for each size of
    CARD_SIZES and each model of CARD_MODELS (the moist GCM with each
    moisture mode, and Held-Suarez), the model built without a mesh on
    the rank's own device and run from seed 0 (the one-card run), then
    the same model in each layout of ``card_meshes(world)``: the
    m-sharded one (``build_moist_gcm(mesh=...)``; moist models) and the
    replicated one (``shard_model_state``), each held to the one-card run
    (``_card_record``).  Both layouts start from the one-card model's
    initial carry at T85 (``carry_to_rank``, ``shard_model_state``), and
    the m-sharded model's own initial carry is held to that one: a
    float32 radiation refresh is not continuous at roundoff (RRTMG's
    table lookups), so a step from the m-sharded model's own initial
    state, the same to roundoff, can move a few columns' surface
    radiation past the step's limits.  With ``timing``, 'own_step':
    {mode: ``limit_share`` of that step on the (n, 1) mesh}, which phase
    28 prints.  At the small size the m-sharded model starts from its
    own ``init_fn``.  One mesh per shape serves every case.  Returns
    {(size, 'm_sharded' or 'replicated', layout name, model): record}
    and, with ``timing``, 'own_step' and 'timing': ``card_timing``."""
    from climt_tpu_torch.convert import carry_to_numpy
    from climt_tpu_torch.dycore.compiled import build_held_suarez_model
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import make_mesh
    m_shapes, layouts = card_meshes(world)
    # every rank makes the meshes, and so their process groups, in one
    # order
    meshes = {shape: make_mesh(world, mesh_shape=shape, device=device)
              for shape in sorted(set(m_shapes) | {s for s, _ in layouts})}
    out = {'own_step': {}} if timing else {}
    for size, (kw, dtype, steps) in CARD_SIZES.items():
        small = size == 'small'
        for name in CARD_MODELS:
            if name == 'held_suarez':
                model = build_held_suarez_model(
                    dtype=dtype, device=device, **{
                        k: kw[k] for k in ('nlon', 'nlat', 'nz', 'timestep')
                        if k in kw})
                ref = carry_to_numpy(model[3](model[1](0), steps))
            else:
                model = build_moist_gcm(dtype=dtype, device=device,
                                        moisture_advection=name, **kw)
                start = carry_to_numpy(model[1](0))
                carry, diag = model[3](model[1](0), steps)
                ref = carry_to_numpy(carry + (diag,))
                if timing and not small:
                    own = mesh_gcm_run(meshes[m_shapes[0]], name, kw, steps,
                                       dtype=dtype, device=device)['final']
                    out['own_step'][name] = limit_share(ref, own,
                                                        model[0].sht)
                for shape in m_shapes:
                    run = mesh_gcm_run(meshes[shape], name, kw, steps,
                                       dtype=dtype, device=device,
                                       checks=small,
                                       start=None if small else start)
                    layout = (shape, False)
                    out[(size, 'm_sharded', layout_name(layout), name)] = \
                        _card_record(run, ref, model[0].sht, small, layout,
                                     start)
            for layout in layouts:
                shape, shard_lon = layout
                run = (layout_hs_run(model, meshes[shape], shard_lon, steps)
                       if name == 'held_suarez' else layout_gcm_run(
                           model, meshes[shape], shard_lon, steps,
                           checks=small))
                out[(size, 'replicated', layout_name(layout), name)] = \
                    _card_record(run, ref, model[0].sht, small, layout)
            del model
    if timing:
        out['timing'] = card_timing(rank, world, device, meshes)
    return out


def card_mesh_failures(ranks, world, what, kind=None, model=None):
    """The failures, as messages, of every rank's ``card_mesh_rank``
    records under one check: 'answers' (the small size within
    CARD_SMALL_TOL of max of the one-card run, T85 within compare_steps's
    float32 limits, and there the m-sharded model's own initial carry
    within them of the one-card one), 'collectives' (each first step
    makes STEP_COLLECTIVES), 'launches' (each first step, a radiation
    refresh, launches the kernels ``refresh_launches`` works out;
    Held-Suarez none), 'conservation' (at the small size,
    ``conservation_failures`` over the ranks of each case) or 'complete'
    (every case on every rank, and every T85 m-sharded case's own
    initial carry); only the cases of layout ``kind`` and ``model`` where
    given."""
    m_shapes, layouts = card_meshes(world)
    cases = set()
    for size in CARD_SIZES:
        for name in CARD_MODELS:
            if name != 'held_suarez':
                cases |= {(size, 'm_sharded', layout_name((s, False)), name)
                          for s in m_shapes}
            cases |= {(size, 'replicated', layout_name(l), name)
                      for l in layouts}
    chosen = sorted(key for key in cases if kind in (None, key[1])
                    and model in (None, key[3]))
    fails = []
    if what == 'conservation':
        for key in chosen:
            rows = [recs[key] for recs in ranks if key in recs]
            if key[0] == 'small':
                fails += ['%s %s %s %s: %s' % (key + (msg,))
                          for msg in conservation_failures(
                              [r['fv_mass'] for r in rows if 'fv_mass' in r],
                              [r['water'] for r in rows if 'water' in r])]
        return fails
    for rank, recs in enumerate(ranks):
        if what == 'complete':
            fails += ['rank %d lacks %s' % (rank, key)
                      for key in sorted(cases - set(recs))]
            fails += ['rank %d lacks the own initial carry of %s' % (
                rank, key) for key in sorted(cases & set(recs))
                if key[:2] == ('t85', 'm_sharded')
                and 'init_err' not in recs[key]]
            continue
        for key in [key for key in chosen if key in recs]:
            rec = recs[key]
            size, layout, mesh_name, name = key
            tag = 'rank %d: %s %s %s %s' % ((rank,) + key)
            if what == 'answers' and not rec['err'] <= rec['limit']:
                fails.append('%s: %s at %.3g, over its limit %g' % (
                    tag, rec['field'], rec['err'], rec['limit']))
            if what == 'answers' and not rec.get('init_err', 0.0) <= 1.0:
                fails.append('%s: its own initial carry, %s at %.3g of '
                             'the limit' % (tag, rec['init_field'],
                                            rec['init_err']))
            elif what == 'collectives':
                lon = mesh_name.endswith('_lon')
                want = STEP_COLLECTIVES[(
                    layout if layout == 'm_sharded' else
                    'replicated_lon' if lon else 'replicated', name)]
                got = rec['counts']['collectives']
                if got != want:
                    fails.append('%s: collectives %s, the CPU makes %s' % (
                        tag, got, want))
            elif what == 'launches':
                kw, dtype, _ = CARD_SIZES[size]
                want = ((0, 0) if name == 'held_suarez' else
                        refresh_launches(kw, *rec['mesh'], dtype))
                got = rec['counts']['launches']
                if tuple(got) != want:
                    fails.append('%s: kernel (B, A) launches %s, the code '
                                 'gives %s' % (tag, tuple(got), want))
    return fails


def _intervals_overlap(spans, others):
    """The time of ``spans`` ((start, end) pairs) during which any span
    of ``others`` runs."""
    merged = []
    for start, end in sorted(others):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    starts = [m[0] for m in merged]
    total = 0.0
    for start, end in spans:
        i = max(0, bisect.bisect_right(starts, start) - 1)
        while i < len(merged) and merged[i][0] < end:
            total += max(0.0, min(end, merged[i][1])
                         - max(start, merged[i][0]))
            i += 1
    return total


def nccl_trace(step_fn, carry):
    """(carry, record) of one step traced by torch.profiler on the card:
    'wall' (s, the profiler's overhead included), 'kernel_s' (every device
    activity summed; the profiler's annotations of the collectives on the
    device timeline are left out), 'nccl_s' (that of the NCCL kernels,
    their waits for the other ranks included), 'overlap_s' (the time in
    which an NCCL kernel ran beside another kernel), 'launches' and
    'nccl_launches'."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        carry, _ = step_fn(carry)
        synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end, 'nccl' in e.name.lower())
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation]
    nccl = [(a, b) for a, b, is_nccl in spans if is_nccl]
    other = [(a, b) for a, b, is_nccl in spans if not is_nccl]
    return carry, {
        'wall': wall, 'kernel_s': sum(b - a for a, b, _ in spans) / 1e6,
        'nccl_s': sum(b - a for a, b in nccl) / 1e6,
        'overlap_s': _intervals_overlap(nccl, other) / 1e6,
        'launches': len(spans), 'nccl_launches': len(nccl)}


def card_lon_shape(world):
    """The mesh of phase 28's timed shard_lon layout: the default (lat,
    lon) mesh where its 'lon' extent is above 1, else (1, world)."""
    from climt_tpu_torch.parallel.mesh import default_mesh_shape
    shape = default_mesh_shape(world)
    return shape if shape[1] > 1 else (1, world)


def card_timing(rank, world, device, meshes):
    """Phase 28's times on one rank: the T85 float32 moist GCM with each
    moisture mode of CARD_TIMING_MODES on one card (rank 0 alone) and on
    every rank in three layouts: m-sharded on (world, 1), replicated on
    (world, 1), replicated with shard_lon on ``card_lon_shape(world)``.
    Windows of CARD_WINDOW steps in the order one card, m-sharded,
    replicated, replicated_lon and back, each model going on from its own
    carry, every window after a barrier, each step synchronized and timed
    on the host; the counters summed over each model's windows; then one
    traced refresh step and one traced plain step of each model
    (``nccl_trace``).  Returns {mode: {model: {'s': step seconds,
    'counts': summed counters, 'refresh', 'plain': traces}}}; ranks other
    than 0 have no 'one card'."""
    import torch.distributed as dist
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import make_mesh, shard_model_state
    kw, dtype, _ = CARD_SIZES['t85']
    lon_shape = card_lon_shape(world)
    if lon_shape not in meshes:
        meshes[lon_shape] = make_mesh(world, mesh_shape=lon_shape,
                                      device=device)
    lat_mesh = meshes[(world, 1)]
    order = ('one card', 'm_sharded', 'replicated', 'replicated_lon')
    out = {}
    for mode in CARD_TIMING_MODES:
        _, init_fn, step_fn, _ = build_moist_gcm(
            dtype=dtype, device=device, moisture_advection=mode, **kw)
        _, m_init, m_step, _ = build_moist_gcm(
            mesh=lat_mesh, dtype=dtype, device=device,
            moisture_advection=mode, **kw)
        steps = {'one card': step_fn, 'm_sharded': m_step,
                 'replicated': step_fn, 'replicated_lon': step_fn}
        carries = {'m_sharded': m_init(0),
                   'replicated': shard_model_state(lat_mesh, *init_fn(0)),
                   'replicated_lon': shard_model_state(
                       meshes[lon_shape], *init_fn(0), shard_lon=True)}
        kinds = order[1:]
        if rank == 0:
            carries['one card'] = init_fn(0)
            kinds = order
        rec = {kind: {'s': [], 'counts': None} for kind in kinds}
        for kind in order + order[::-1]:
            dist.barrier()
            if kind not in kinds:
                continue
            reset_counters()
            for _ in range(CARD_WINDOW):
                t0 = time.perf_counter()
                carries[kind], _ = steps[kind](carries[kind])
                synchronize()
                rec[kind]['s'].append(time.perf_counter() - t0)
            counts = read_counters()
            if rec[kind]['counts'] is not None:
                counts = {k: tuple(a + b for a, b in zip(
                    v, rec[kind]['counts'][k])) for k, v in counts.items()}
            rec[kind]['counts'] = counts
        # 2 CARD_WINDOW steps done: a refresh step, then a plain one, each
        # after a barrier (a rank's trace ends with its own processing)
        for kind in order:
            for label in ('refresh', 'plain'):
                dist.barrier()
                if kind in kinds:
                    carries[kind], rec[kind][label] = nccl_trace(
                        steps[kind], carries[kind])
        dist.barrier()
        out[mode] = rec
        del carries
    return out


def taumol_columns(nz=28, ncol=48, seed=7):
    """Columns for the gas optics' terms, as float64 numpy arrays, in
    three kinds a third each: surface to 0.3 hPa (a tropopause crossing),
    surface to 300 hPa (troposphere only: no crossing, and jp never
    reaches the upper bands' solar reference layers) and 90 to 0.3 hPa
    (above the tropopause only).  Every gas varies by column: CO2 0.5 to 4
    times 355 ppm and N2O 0 to 3 times 0.32 ppm, so some adjusted minor
    columns take the power law; CH4, CO2 floored at zero in a few
    columns, the CFCs and CCl4."""
    rng = np.random.RandomState(seed)
    kind = np.arange(ncol) % 3
    p_top = np.array([0.3, 300.0, 0.3])[kind]
    p_bot = np.array([1013.0, 1013.0, 90.0])[kind] * (
        1.0 + 0.01 * rng.randn(ncol))
    frac = np.linspace(0.0, 1.0, nz + 1)[:, None]
    plev = np.exp(np.log(p_bot) + frac * (np.log(p_top) - np.log(p_bot)))
    play = 0.5 * (plev[:-1] + plev[1:])
    tlay = np.maximum(300.0 - 60.0 * (1 - play / 1013.0) / 0.8, 205.0) * (
        1.0 + 0.01 * rng.randn(nz, ncol))
    tlev = np.concatenate([tlay[:1] + 2.0, 0.5 * (tlay[:-1] + tlay[1:]),
                           tlay[-1:]])

    def per_col(lo, hi):
        return np.repeat(rng.uniform(lo, hi, ncol)[None], nz, 0)

    co2 = 355e-6 * per_col(0.5, 4.0)
    co2[:, :2] = 0.0
    return dict(
        play=play, plev=plev, tlay=tlay, tlev=tlev,
        tsfc=290.0 + 10.0 * rng.rand(ncol),
        h2o=0.016 * (play / 1013.0) ** 3 * per_col(0.5, 1.5),
        o3=5e-6 * np.exp(-0.5 * ((np.log(play) - np.log(20.0)) / 1.2) ** 2),
        co2=co2, ch4=1.7e-6 * per_col(0.0, 2.0),
        n2o=0.32e-6 * per_col(0.0, 3.0), o2=np.full_like(play, 0.21),
        cfc11=2.6e-10 * per_col(0.0, 2.0), cfc12=5.0e-10 * per_col(0.0, 2.0),
        cfc22=1.0e-10 * per_col(0.0, 2.0), ccl4=1.0e-10 * per_col(0.0, 2.0),
        emis=np.ones((16, ncol)), nz=nz, ncol=ncol)


def taumol_coefs(c, dtype, device='cpu'):
    """(cs, wx, css): setcoef's LW coefficients and cross-section amounts
    and the SW coefficients of columns ``c`` (``taumol_columns``)."""
    from climt_tpu_torch.components.rrtmg import lw_spectral as TL
    from climt_tpu_torch.components.rrtmg import sw_spectral as TS
    t = {k: to_torch(v, dtype, device) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    cs, wx, _ = TL.gas_coefs_lw(
        t['play'], t['plev'], t['tlay'], t['tlev'], t['tsfc'], t['emis'],
        t['h2o'], t['o3'], t['co2'], t['ch4'], t['n2o'], t['o2'],
        t['cfc11'], t['cfc12'], t['cfc22'], t['ccl4'], G, AVOG)
    css = TS.gas_coefs_sw(t['play'], t['plev'], t['tlay'], t['h2o'],
                          t['o3'], t['co2'], t['ch4'], t['n2o'], t['o2'],
                          G, AVOG)
    return cs, wx, css


LW_TABLE_CASES = ('surrogate', 'pruned', 'eta_fracs', 'grad')


def lw_table_case(name):
    """LW k-tables for the term tests: the installed ones; those without
    band 1's lower N2 table and band 3's upper Planck fractions; with
    (ng, 9) and (ng, 5) Planck fractions in every band that has their
    eta species (the AER layout); or built by ``lw_surrogate`` from
    parameters that require grad."""
    from climt_tpu_torch.components.rrtmg import lw_spectral as TL
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    t = TL.load_kdist()
    if name == 'surrogate':
        return t
    if name == 'pruned':
        return {k: v for k, v in t.items()
                if k not in ('b1_ka_mn2', 'b3_fracrefb')}
    if name == 'eta_fracs':
        rng = np.random.RandomState(11)
        out = dict(t)
        for bd in TL.BANDS_LW:
            for side, neta in (('lo', 9), ('up', 5)):
                key = 'b%d_fracref%s' % (bd['num'], 'a' if side == 'lo'
                                         else 'b')
                if bd.get('planck_' + side) and key in t:
                    out[key] = rng.rand(t[key].shape[0], neta)
        return out
    theta = torch.as_tensor(lw_surrogate.load_calibrated_params())
    return lw_surrogate.build_tables(theta.requires_grad_(True))


def solar_case(mode):
    """(isolvar, the six factors of ``solar_variability``) of an SW solar
    mode ('ref', 'svar', 'band'); in 'band' the three tables' factors
    are made distinct (``solar_variability`` gives them one array), so
    that a term reading another table's factor shows."""
    from climt_tpu_torch.components.rrtmg import sw_spectral as TS
    isolvar = dict(ref=-1, svar=1, band=3)[mode]
    solar = list(TS.solar_variability(isolvar, 1360.85)[:6])
    if mode == 'band':
        solar[3:] = [np.asarray(x) * f
                     for x, f in zip(solar[3:], (1.0, 1.1, 1.2))]
    return isolvar, solar


def _term_ulps(a, b):
    """Per element, the distance in units in the last place between two
    float tensors of one type."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.view(it).long() - b.view(it).long()).abs()


def power_terms(plan):
    """{(group, term): name} of the terms whose weight holds the power of
    an adjusted minor-gas column (adjn2o, adjco2)."""
    from climt_tpu_torch.components.rrtmg import term_writer as TW
    out, band = {}, 0
    for rec in plan.records:
        if rec[0] == TW.KIND['lw_band']:
            band += 1
        if rec[0] == TW.KIND['lw_minor'] and rec[5] == 1:
            name = 'LW band %d %s %s' % (
                band, plan.fields[rec[6]][3:],
                'lower' if rec[8] == TW.TROP else 'upper')
            out[(rec[1], rec[2])] = out[(rec[1], rec[2] + 1)] = name
    return out


def term_writer_check(call, dtype, nz, ncol, device, case=None):
    """The term-writer kernel (``taumol_lw_terms`` or ``taumol_sw_terms``
    on the card) on ``taumol_columns(nz, ncol)`` against its plain version
    (``term_writer.taumol_terms_plain``, the same call on the CPU) on the
    same coefficients, by group name:
    terms, multi-row indices that differ, the largest absolute difference
    of a weight (0 only where every weight is equal), the largest ulp
    distance of a weight outside the power terms and of one inside them
    (``power_terms``), the largest relative difference there in epsilons
    of the type, and the names of the power terms that differ.
    ``case``: an LW table case (``lw_table_case``) or 'wx_subset'; an SW
    solar mode ('ref', 'svar', 'band')."""
    from climt_tpu_torch.components.rrtmg import lw_spectral as TL
    from climt_tpu_torch.components.rrtmg import sw_spectral as TS
    cs, wx, css = taumol_coefs(taumol_columns(nz, ncol), dtype, device)

    def cpu(d):
        return {k: v.cpu() if torch.is_tensor(v) else v for k, v in d.items()}

    if call == 'lw':
        case = case or 'surrogate'
        tables = lw_table_case('surrogate' if case == 'wx_subset' else case)
        if case == 'wx_subset':
            wx = {gas: wx[gas] for gas in ('ccl4', 'cfc12')}
        got = TL.taumol_lw_terms(cs, wx, dtype, tables)
        ref = TL.taumol_lw_terms(cpu(cs), cpu(wx), dtype, tables)
        plan = TL.lw_term_plan(tables, tuple(sorted(wx)))
        names = ('lw_taug', 'lw_fracs')
    else:
        case = case or 'ref'
        isolvar, solar = solar_case(case)
        got = TS.taumol_sw_terms(css, isolvar, *solar, dtype)
        ref = TS.taumol_sw_terms(cpu(css), isolvar, *solar, dtype)
        plan = TS.sw_term_plan(case)
        names = ('sw_taug', 'sw_taur', 'sw_sflux')
    power = power_terms(plan)
    report = {}
    for g, (name, gg, rg) in enumerate(zip(names, got, ref)):
        layout, ri, rw = rg.finish()
        _, gi, gw = gg.finish()
        many = torch.as_tensor([rows > 1 for _, rows in layout.terms])
        gw = gw.cpu()
        ulps = _term_ulps(gw, rw).reshape(layout.nterms, -1).amax(1)
        rel = ((gw - rw).abs() / rw.abs().clamp(min=torch.finfo(
            rw.dtype).tiny)).reshape(layout.nterms, -1).amax(1) / \
            torch.finfo(rw.dtype).eps
        is_power = torch.as_tensor([(g, t) in power
                                    for t in range(layout.nterms)],
                                   dtype=torch.bool)
        report[name] = dict(
            terms=layout.nterms,
            idx_mismatch=int((gi.cpu()[many] != ri[many]).sum()),
            max_abs_err=float((gw - rw).abs().max()),
            max_ulp=int(ulps[~is_power].max()) if bool((~is_power).any())
            else 0,
            power_max_ulp=int(ulps[is_power].max()) if bool(is_power.any())
            else 0,
            power_eps=float(rel[is_power].max()) if bool(is_power.any())
            else 0.0,
            power_terms=sorted({power[(g, t)] for t in range(layout.nterms)
                                if (g, t) in power and int(ulps[t]) > 0}))
    return report
