"""climt_tpu_torch's Held-Suarez forcing, GFSDynamicalCore and fused
Held-Suarez model against the JAX package, on the CPU at float64."""

import importlib.util
import os
import sys
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.dycore.compiled import build_held_suarez_model as jbuild
from climt_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from climt_tpu_torch.core import constants as tconstants
from climt_tpu_torch.core import tracers as ttracers
from climt_tpu_torch.dycore.compiled import build_held_suarez_model as tbuild

from torch_helpers import EXAMPLE_BIND, EXAMPLES, port_example, rel_err

NX, NY, NZ = 32, 16, 10
DT = timedelta(minutes=15)
HS_STEPS = 20
# port float32 against JAX float64 after 20 steps of 600 s at 32x16x10,
# max abs difference on the grid: measured 1.6e-4 K, 7.9e-4 and 8.2e-4
# m/s and 0.12 Pa on the CPU (float32 roundoff of a ~290 K, 1e5 Pa
# state); the bounds leave about 3x room (K, m/s, Pa)
F32_BOUNDS = {'T': 5e-4, 'u': 2.5e-3, 'v': 2.5e-3, 'ps': 0.4}


@pytest.fixture(autouse=True)
def _reset_port_registries():
    """The port keeps its own constants and tracer registries; reset them
    as tests/conftest.py resets the JAX package's constants."""
    _reset_port()
    yield
    _reset_port()


def _reset_port():
    tconstants.reset_constants()
    tconstants.set_constant('top_of_model_pressure', 20., 'Pa')
    ttracers.reset_tracers()
    ttracers.reset_packers()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _states(components_t, components_j, moist=False):
    """Both packages' default states at NX x NY x NZ with the same 0.1 K
    temperature perturbation as examples/held_suarez.py, and humidity
    when ``moist``."""
    st = tct.get_default_state(
        components_t, grid_state=tct.get_grid(nx=NX, ny=NY, nz=NZ))
    sj = jct.get_default_state(
        components_j, grid_state=jct.get_grid(nx=NX, ny=NY, nz=NZ))
    rng = np.random.RandomState(42)
    dT = 0.1 * rng.randn(*st['air_temperature'].shape)
    q = 2e-3 * rng.rand(*dT.shape) - 2e-4        # a few negative values
    for s in (st, sj):
        s['air_temperature'].values[:] += dT
        if moist:
            s['specific_humidity'].values[:] = q
    return st, sj


def _assert_fields_match(st, sj, names, tol):
    for name in names:
        assert st[name].dims == sj[name].dims, name
        assert st[name].units == sj[name].units, name
        assert rel_err(st[name].values, sj[name].values) <= tol, name


def test_held_suarez_tendencies_match_jax():
    st, sj = _states([tct.HeldSuarez(device='cpu')], [jct.HeldSuarez()])
    rng = np.random.RandomState(3)
    shape = st['air_temperature'].shape
    for name, scale in (('eastward_wind', 20.0), ('northward_wind', 5.0)):
        value = scale * rng.randn(*shape)
        st[name].values[:] = value
        sj[name].values[:] = value
    kw = dict(sigma_boundary_layer_top=0.75, k_f=1 / 43200.)
    for hs_t, hs_j in ((tct.HeldSuarez(device='cpu'), jct.HeldSuarez()),
                       (tct.HeldSuarez(device='cpu', **kw),
                        jct.HeldSuarez(**kw))):
        tend_t, diag_t = hs_t(st)
        tend_j, diag_j = hs_j(sj)
        assert diag_t == {} and set(tend_t) == set(tend_j)
        for name in tend_j:
            assert isinstance(tend_t[name].values, torch.Tensor)
        _assert_fields_match(tend_t, tend_j, tend_j, 1e-12)


GFS_OUTPUTS = ('eastward_wind', 'northward_wind', 'air_temperature',
               'specific_humidity', 'surface_air_pressure', 'air_pressure',
               'air_pressure_on_interface_levels', 'divergence_of_wind',
               'atmosphere_relative_vorticity')


def _run_gfs(components_t, components_j, n_calls, moist):
    kw = dict(number_of_damped_levels=5)
    if not moist:
        kw['moist'] = False
    dyc_t = tct.GFSDynamicalCore(components_t, device='cpu', **kw)
    dyc_j = jct.GFSDynamicalCore(components_j, **kw)
    st, sj = _states([dyc_t], [dyc_j], moist=moist)
    for _ in range(n_calls):
        for dycore, state in ((dyc_t, st), (dyc_j, sj)):
            diagnostics, new_state = dycore(state, DT)
            assert diagnostics == {}
            state.update(new_state)
            state['time'] += DT
        # every output field after every call, to 1e-10 of its max
        _assert_fields_match(st, sj, GFS_OUTPUTS, 1e-10)
    return st


@pytest.mark.parametrize('moist', [False, True])
def test_gfs_with_held_suarez_matches_jax(moist):
    """5 calls through the component API; the first takes the forward
    start."""
    st = _run_gfs([tct.HeldSuarez(device='cpu')], [jct.HeldSuarez()], 5,
                  moist)
    for name in GFS_OUTPUTS:
        assert isinstance(st[name].values, torch.Tensor), name
    if moist:
        assert float(st['specific_humidity'].values.min()) >= 0.0


def test_gfs_without_components_matches_jax():
    _run_gfs([], [], 3, moist=True)


def test_fused_model_matches_jax():
    """20 steps at 32x16x10: the port at float64 against JAX at float64
    to 1e-10 of max, and the port at float32 within F32_BOUNDS."""
    kw = dict(nlon=NX, nlat=NY, nz=NZ, timestep=600.0)
    jd, jinit, _, jrun = jbuild(dtype=jnp.float64, **kw)
    jcarry = carry_to_numpy_jax(jrun(jinit(0), HS_STEPS))
    for dtype in (torch.float64, torch.float32):
        td, tinit, _, trun = tbuild(dtype=dtype, device='cpu', **kw)
        tcarry = carry_to_numpy(trun(tinit(0), HS_STEPS))
        if dtype == torch.float64:
            for tpart, jpart in zip(tcarry, jcarry):
                assert set(tpart) == set(jpart)
                for key in jpart:
                    assert rel_err(tpart[key], jpart[key]) <= 1e-10, key
            continue
        now_t, now_j = tcarry[1], jcarry[1]
        sht = jd.sht
        diffs = {
            'T': _np(sht.synthesize(jnp.asarray(now_t['T'], jnp.complex128))
                     - sht.synthesize(jnp.asarray(now_j['T']))),
            'ps': np.exp(_np(sht.synthesize(jnp.asarray(
                now_t['lnps'], jnp.complex128))))
            - np.exp(_np(sht.synthesize(jnp.asarray(now_j['lnps'])))),
        }
        for name, a, b in zip('uv', sht.uv_from_vort_div(
                jnp.asarray(now_t['vort'], jnp.complex128),
                jnp.asarray(now_t['div'], jnp.complex128)),
                sht.uv_from_vort_div(jnp.asarray(now_j['vort']),
                                     jnp.asarray(now_j['div']))):
            diffs[name] = _np(a) - _np(b)
        for name, bound in F32_BOUNDS.items():
            assert np.abs(diffs[name]).max() <= bound, (
                name, np.abs(diffs[name]).max())


def carry_to_numpy_jax(carry):
    return tuple({k: np.asarray(v) for k, v in part.items()}
                 for part in carry)


def test_convert_round_trip():
    """JAX carry -> port carry -> numpy gives it back exactly; the port's
    carry handed to JAX steps as it does in the port."""
    kw = dict(nlon=NX, nlat=NY, nz=NZ, timestep=600.0)
    _, jinit, jstep, _ = jbuild(dtype=jnp.float64, **kw)
    _, tinit, tstep, _ = tbuild(dtype=torch.float64, device='cpu', **kw)
    jcarry = carry_to_numpy_jax(jinit(0))
    tcarry = carry_from_numpy(jcarry, 'cpu', torch.float64)
    assert isinstance(tcarry[2]['T'], torch.Tensor)
    assert tcarry[0]['T'].dtype == torch.complex128
    for back, orig in zip(carry_to_numpy(tcarry), jcarry):
        for key in orig:
            np.testing.assert_array_equal(back[key], orig[key])
    # port -> JAX: one step on each side from the port's own carry
    tcarry = tstep(tinit(0))[0]
    jnext, _ = jstep(jax.tree.map(jnp.asarray, carry_to_numpy(tcarry)),
                     None)
    tnext, _ = tstep(tcarry)
    for tpart, jpart in zip(carry_to_numpy(tnext),
                            carry_to_numpy_jax(jnext)):
        for key in jpart:
            assert rel_err(tpart[key], jpart[key]) <= 1e-10, key


def test_example_body_matches_jax_example():
    """examples/held_suarez.py at 32x16x10 and n_days=0.02, as
    tests/test_examples.py runs it, in both packages."""
    kw = dict(n_days=0.02, nx=NX, ny=NY, nz=NZ, dt_minutes=15)
    main, calls = port_example('held_suarez', 'cpu', EXAMPLE_BIND)
    st = main(**kw)                    # the printout included
    assert len(calls.seconds) == 1
    spec = importlib.util.spec_from_file_location(
        'example_held_suarez', os.path.join(EXAMPLES, 'held_suarez.py'))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    sj = module.main(verbose=False, **kw)
    assert set(st) == set(sj)
    _assert_fields_match(st, sj, GFS_OUTPUTS, 1e-10)


def test_default_device_is_cuda():
    """Without a card, the defaults raise naming the device."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the defaults build there')
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tct.HeldSuarez()
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tct.GFSDynamicalCore([tct.HeldSuarez(device='cpu')])
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tbuild(nlon=NX, nlat=NY, nz=NZ)


def test_unported_options_raise():
    """A mesh that is not a torch.distributed DeviceMesh is refused with
    the type it expected; an unknown moisture scheme too."""
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    with pytest.raises(TypeError, match='DeviceMesh'):
        build_moist_gcm(mesh=object(), device='cpu')
    with pytest.raises(ValueError):
        build_moist_gcm(nlon=32, nlat=16, nz=10, moisture_advection='upwind',
                        device='cpu')
