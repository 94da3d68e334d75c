"""climt_tpu_torch's grid numerics, spherical harmonic transform and
spectral dynamical core against the JAX package at float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu.core import grid as jgrid
from climt_tpu.core import util as jutil
from climt_tpu.dycore.spectral_dynamics import SpectralDycore as JDycore
from climt_tpu.ops.sht import SphericalHarmonicTransform as JSHT
from climt_tpu_torch.core import grid as tgrid
from climt_tpu_torch.core import util as tutil
from climt_tpu_torch.dycore.spectral_dynamics import SpectralDycore as TDycore
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform as TSHT

from torch_helpers import rel_err, to_torch

NLON, NLAT, NZ = 32, 16, 10


def test_grid_copies_are_exact():
    for n in (16, 64, 128):
        for a, b in zip(tgrid.gauss_legendre_nodes(n),
                        jgrid.gauss_legendre_nodes(n)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tgrid.hybrid_sigma_pressure_coefficients(29, 1e5, 20.0),
                    jgrid.hybrid_sigma_pressure_coefficients(29, 1e5, 20.0)):
        np.testing.assert_array_equal(a, b)


def test_util_matches_jax():
    rng = np.random.RandomState(3)
    T = 200.0 + 100.0 * rng.rand(NZ, 20)
    p = np.sort(1e3 + 1e5 * rng.rand(NZ + 1, 20), axis=0)[::-1].copy()
    pm = 0.5 * (p[1:] + p[:-1])
    ts = 290.0 + rng.rand(20)
    ref = jutil.get_interface_values(jnp.asarray(T), jnp.asarray(ts),
                                     jnp.asarray(pm), jnp.asarray(p))
    out = tutil.get_interface_values(to_torch(T), to_torch(ts),
                                     to_torch(pm), to_torch(p))
    assert rel_err(out, ref) < 1e-14
    ref = jutil.bolton_q_sat(jnp.asarray(T), jnp.asarray(pm), 287.0, 461.5)
    out = tutil.bolton_q_sat(to_torch(T), to_torch(pm), 287.0, 461.5)
    assert rel_err(out, ref) < 1e-14


@pytest.fixture(scope='module')
def shts():
    return (JSHT(NLON, NLAT, dtype=jnp.float64),
            TSHT(NLON, NLAT, dtype=torch.float64, device='cpu'))


def _spectral(sht, rng, lead=(NZ,)):
    shape = lead + tuple(sht.mask.shape)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)) * np.asarray(sht.mask)


def test_sht_analyze_synthesize(shts):
    jsht, tsht = shts
    rng = np.random.RandomState(4)
    g = rng.randn(NZ, NLAT, NLON)
    assert rel_err(tsht.analyze(to_torch(g)),
                   jsht.analyze(jnp.asarray(g))) < 1e-12
    s = _spectral(jsht, rng)
    out = tsht.synthesize(torch.as_tensor(s))
    assert out.dtype == torch.float64
    assert rel_err(out, jsht.synthesize(jnp.asarray(s))) < 1e-12


def test_sht_vector_transforms(shts):
    jsht, tsht = shts
    rng = np.random.RandomState(5)
    vort, div = _spectral(jsht, rng), _spectral(jsht, rng)
    for a, b in zip(tsht.uv_from_vort_div(torch.as_tensor(vort),
                                          torch.as_tensor(div)),
                    jsht.uv_from_vort_div(jnp.asarray(vort),
                                          jnp.asarray(div))):
        assert rel_err(a, b) < 1e-12
    U, V = rng.randn(2, NZ, NLAT, NLON)
    for a, b in zip(tsht.vort_div_analysis(to_torch(U), to_torch(V)),
                    jsht.vort_div_analysis(jnp.asarray(U), jnp.asarray(V))):
        assert rel_err(a, b) < 1e-12


@pytest.mark.parametrize('entry', ['inverse_laplacian', 'filter_spec',
                                   'total_wavenumber', 'dBnp'])
def test_transform_and_dycore_entry_points_match_jax(shts, entry):
    """SphericalHarmonicTransform.inverse_laplacian, filter_spec and
    total_wavenumber (sht.py:279-288) and SpectralDycore.dBnp
    (spectral_dynamics.py:235) against JAX's."""
    jsht, tsht = shts
    if entry == 'dBnp':
        ak, bk = tgrid.hybrid_sigma_pressure_coefficients(NZ + 1, 1e5, 20.0)
        got = TDycore(NLON, NLAT, NZ, ak, bk, dtype=torch.float64,
                      device='cpu').dBnp()
        ref = JDycore(NLON, NLAT, NZ, ak, bk, dtype=jnp.float64).dBnp()
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    elif entry == 'total_wavenumber':
        got, ref = tsht.total_wavenumber, jsht.total_wavenumber
        assert got.dtype == torch.int64 and ref.dtype == jnp.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        # unmasked coefficients, so that filter_spec has work to do
        rng = np.random.RandomState(8)
        shape = (NZ,) + tuple(jsht.mask.shape)
        s = rng.randn(*shape) + 1j * rng.randn(*shape)
        got = getattr(tsht, entry)(torch.as_tensor(s))
        ref = getattr(jsht, entry)(jnp.asarray(s))
        assert got.dtype == torch.complex128
        assert rel_err(got, ref) < 1e-14


def test_dycore_initial_step_and_three_steps():
    """One initial_step and 3 leapfrog steps with grid physics
    tendencies, from the same seeded state."""
    ak, bk = tgrid.hybrid_sigma_pressure_coefficients(NZ + 1, 1e5, 20.0)
    kw = dict(timestep=600.0, number_of_damped_levels=3)
    jd = JDycore(NLON, NLAT, NZ, ak, bk, dtype=jnp.float64, **kw)
    td = TDycore(NLON, NLAT, NZ, ak, bk, dtype=torch.float64, device='cpu',
                 **kw)
    rng = np.random.RandomState(6)
    shape = (NZ, NLAT, NLON)
    mu = jd.sht.mu[:, None]
    u = 20.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape)
    v = rng.randn(*shape)
    T = 250.0 + 30.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape)
    q = 1e-3 * rng.rand(*shape)
    lnps = np.log(1e5) + 0.01 * rng.randn(NLAT, NLON)
    phys = {k: 1e-5 * rng.randn(*shape) for k in ('du', 'dv', 'dT')}
    phys['dq'] = 1e-9 * rng.randn(*shape)

    jprev, jnow = jd.initial_step(jd.spectral_state_from_grid(
        *[jnp.asarray(x) for x in (u, v, T, q, lnps)]))
    tprev, tnow = td.initial_step(td.spectral_state_from_grid(
        *[to_torch(x) for x in (u, v, T, q, lnps)]))
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


def _dycore_pair_and_state(seed):
    ak, bk = tgrid.hybrid_sigma_pressure_coefficients(NZ + 1, 1e5, 20.0)
    kw = dict(timestep=600.0, number_of_damped_levels=3)
    jd = JDycore(NLON, NLAT, NZ, ak, bk, dtype=jnp.float64, **kw)
    td = TDycore(NLON, NLAT, NZ, ak, bk, dtype=torch.float64, device='cpu',
                 **kw)
    rng = np.random.RandomState(seed)
    shape = (NZ, NLAT, NLON)
    mu = jd.sht.mu[:, None]
    grid = (20.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape),
            rng.randn(*shape),
            250.0 + 30.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape),
            1e-3 * rng.rand(*shape),
            np.log(1e5) + 0.01 * rng.randn(NLAT, NLON))
    return (jd, jd.spectral_state_from_grid(*map(jnp.asarray, grid)),
            td, td.spectral_state_from_grid(*map(to_torch, grid)))


def _relaxation(gs):
    """A grid physics function of the dycore's grid-state dict, for
    either package's arrays."""
    return {'du': -1e-5 * gs['u'], 'dv': -1e-5 * gs['v'],
            'dT': -1e-5 * (gs['T'] - 250.0),
            'dq': -1e-6 * gs['q'] * (gs['ps'] / 1e5)[None]}


@pytest.mark.parametrize('route', ['physics_fn_prev_grids', 'physics_fn',
                                   'explicit_dt'])
def test_step_and_initial_step_take_jax_keywords(route):
    """step(prev, now, phys, dt, physics_fn, prev_grids) and
    initial_step(now, phys, dt, physics_fn) with JAX's semantics
    (spectral_dynamics.py:458-460, :558): physics_fn on prev_grids when
    both are given (lagged), on the centre grids otherwise; dt the
    construction timestep when None.  Two steps after the start."""
    jd, jnow, td, tnow = _dycore_pair_and_state(7)
    if route == 'explicit_dt':
        jkw, tkw = dict(dt=450.0), dict(dt=450.0)
    else:
        jkw, tkw = dict(physics_fn=_relaxation), dict(physics_fn=_relaxation)
    jprev, jnow = jd.initial_step(jnow, **jkw)
    tprev, tnow = td.initial_step(tnow, **tkw)
    jgrids, tgrids = jd.grids_of(jprev), td.grids_of(tprev)
    for _ in range(2):
        if route == 'physics_fn_prev_grids':
            jkw['prev_grids'], tkw['prev_grids'] = jgrids, tgrids
        jprev, jnow, jgrids = jd.step(jprev, jnow, **jkw)
        tprev, tnow, tgrids = td.step(tprev, tnow, **tkw)
    for key in jnow:
        assert rel_err(tnow[key], jnow[key]) < 1e-10, key
        assert rel_err(tprev[key], jprev[key]) < 1e-10, key
    for key in jgrids:
        assert rel_err(tgrids[key], jgrids[key]) < 1e-10, key
