"""Installable LW gas k-tables in climt_tpu_torch against the JAX package,
on the CPU at float64.

The tables are the surrogate's with every absorption array scaled by
exp(0.3 N(0, 1)) from a seed (``torch_helpers.seeded_lw_tables``): the
AER layout with new numbers and the surrogate's shapes, the case in which
a layout cached by shape alone would go on gathering from the old tables.

- ``rrtmg_lw_fluxes`` and the LW taumol groups at nz 9 and 28, the port's
  tables installed or passed with ``tables=``, against JAX's ``tables=``:
  fluxes to 1e-9 (tests/test_torch_radiation.py's bound), groups to 1e-10;
- ``RRTMGLongwave`` at 16x8x8 and two steps of ``build_moist_gcm`` at
  32x16x10 with rad_every=1, both packages' tables installed (JAX's jit
  caches cleared after the install): 1e-10 and 1e-8, the bounds of
  tests/test_torch_rrtmg_components.py and tests/test_torch_moist_gcm.py;
- a surrogate call, an install and a call again (the stale-layout
  regression), ``tables=`` and a reinstall of a rewritten file;
- the order of preference (installed, $CLIMT_TPU_LW_KTABLES, the drop-in,
  the surrogate) and bad paths.

Each test starts and ends with no tables installed in either package and
JAX's caches cleared, so the files after this one in a worker find the
surrogate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.components.rrtmg import lw_spectral as JL
from climt_tpu.dycore.moist_gcm import build_moist_gcm as jax_build
from climt_tpu_torch import data
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.convert import carry_to_numpy
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm as port_build

from torch_helpers import (assert_carries_close, assert_outputs_match,
                           jax_lw, jax_taumol, port_lw, port_taumol_groups,
                           radiation_columns, rel_err,
                           reset_port_registries, seeded_lw_tables)

NZS = (9, 28)
NCOL = 4
FLUX_TOL, GROUP_TOL, COMPONENT_TOL, GCM_TOL = 1e-9, 1e-10, 1e-10, 1e-8
GCM_KW = dict(nlon=32, nlat=16, nz=10, rad_every=1, rad_col_chunk=128)
LW_GROUPS = ('lw_taug', 'lw_fracs')


def _uninstall():
    JL._KDIST_OVERRIDE[0] = None
    TL._KDIST_OVERRIDE[0] = None
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _no_tables_installed():
    _uninstall()
    reset_port_registries()
    yield
    _uninstall()
    reset_port_registries()


@pytest.fixture(scope='module')
def seeded(tmp_path_factory):
    """(path, tables) of the seeded k-tables."""
    path = seeded_lw_tables(str(tmp_path_factory.mktemp('ktables')
                                / 'seeded.npz'))
    return path, data.load_npz(path)


@pytest.fixture(scope='module')
def jax_refs(seeded):
    """{nz: (fluxes, lw groups)} of JAX with ``tables=`` the seeded
    tables, one jit each (JAX's own f64 path, analytic transmittance)."""
    tables = seeded[1]
    refs = {}
    for nz in NZS:
        c = radiation_columns(nz=nz, ncol=NCOL)
        fluxes, groups = jax.jit(lambda c=c: (
            jax_lw(c, jnp.float64, False, tables=tables),
            jax_taumol(c, tables=tables, sw=False)))()
        refs[nz] = (c, [np.asarray(x) for x in fluxes],
                    {k: np.asarray(v) for k, v in groups.items()})
    return refs


def _install_both(path):
    JL.load_aer_tables(path)
    TL.load_aer_tables(path)
    jax.clear_caches()


@pytest.mark.parametrize('route', ['installed', 'tables'])
@pytest.mark.parametrize('nz', NZS)
def test_fluxes_and_groups_match_jax(seeded, jax_refs, nz, route):
    path, tables = seeded
    c, ref_fluxes, ref_groups = jax_refs[nz]
    if route == 'installed':
        TL.load_aer_tables(path)
        kw = {}
    else:
        kw = dict(tables=tables)
    out = port_lw(c, torch.float64, **kw)
    assert len(out) == len(ref_fluxes) == 6
    for a, b in zip(out, ref_fluxes):
        assert rel_err(a, b) < FLUX_TOL
    groups = port_taumol_groups(c, torch.float64, **kw)
    for name in LW_GROUPS:
        assert rel_err(groups[name].run(), ref_groups[name]) < GROUP_TOL
    # the tables take effect: far from the surrogate's fluxes
    surrogate = port_lw(c, torch.float64, tables=data.load_numpy(data.LW_KDIST))
    assert min(rel_err(a, b) for a, b in zip(surrogate, out)) > 1e-4


def test_install_after_a_call_repacks_and_uninstall_goes_back(seeded,
                                                              jax_refs,
                                                              tmp_path):
    """Surrogate call, install, call: the second call reads the installed
    tables (a layout cached by shape alone would not).  Then ``tables=``,
    a call without it, a rewritten file installed again at the same path,
    and the override removed: each call reads the tables it should, and
    the surrogate's result comes back bitwise."""
    path, tables = seeded
    c, ref_fluxes, _ = jax_refs[NZS[0]]
    before = port_lw(c, torch.float64)
    TL.load_aer_tables(path)
    for a, b in zip(port_lw(c, torch.float64), ref_fluxes):
        assert rel_err(a, b) < FLUX_TOL
    by_arg = port_lw(c, torch.float64, tables=data.load_numpy(data.LW_KDIST))
    assert all(torch.equal(a, b) for a, b in zip(by_arg, before))
    for a, b in zip(port_lw(c, torch.float64), ref_fluxes):
        assert rel_err(a, b) < FLUX_TOL
    rewritten = seeded_lw_tables(str(tmp_path / 'rewritten.npz'), seed=1)
    TL.load_aer_tables(rewritten)
    first = port_lw(c, torch.float64)
    seeded_lw_tables(rewritten, seed=2)
    TL.load_aer_tables(rewritten)
    second = port_lw(c, torch.float64)
    expect = port_lw(c, torch.float64, tables=data.load_npz(rewritten))
    assert all(torch.equal(a, b) for a, b in zip(second, expect))
    assert rel_err(first[0], second[0]) > 1e-4
    TL._KDIST_OVERRIDE[0] = None
    assert all(torch.equal(a, b)
               for a, b in zip(port_lw(c, torch.float64), before))


def test_rrtmg_longwave_component_matches_jax(seeded):
    """RRTMGLongwave on get_default_state's 16x8x8 state with cloud, both
    packages' tables installed."""
    _install_both(seeded[0])
    comps = (tct.RRTMGLongwave(device='cpu'), jct.RRTMGLongwave())
    states = []
    for pkg, comp in zip((tct, jct), comps):
        st = pkg.get_default_state([comp], grid_state=pkg.get_grid(
            nx=16, ny=8, nz=8))
        st['cloud_area_fraction_in_atmosphere_layer'].values[3:5] = 0.5
        st['mass_content_of_cloud_ice_in_atmosphere_layer'
           ].values[3:5] = 0.3
        states.append(st)
    outs_t, outs_j = comps[0](states[0]), comps[1](states[1])
    assert_outputs_match(outs_t, outs_j, tol=COMPONENT_TOL)
    TL._KDIST_OVERRIDE[0] = None
    surrogate = comps[0](states[0])[1]['upwelling_longwave_flux_in_air']
    assert rel_err(surrogate.values,
                   outs_t[1]['upwelling_longwave_flux_in_air'].values) > 1e-4


def test_moist_gcm_two_steps_match_jax(seeded):
    """Two steps of the moist GCM, radiation every step, both packages'
    tables installed before the models are built."""
    _install_both(seeded[0])
    jd, j_init, _, j_run = jax_build(dtype=jnp.float64, **GCM_KW)
    _, p_init, _, p_run = port_build(dtype=torch.float64, device='cpu',
                                     **GCM_KW)
    j_carry, j_diag = j_run(j_init(0), 2)
    p_carry, p_diag = p_run(p_init(0), 2)
    assert_carries_close(carry_to_numpy(p_carry),
                         jax.tree_util.tree_map(np.asarray, j_carry),
                         jd.sht, GCM_TOL)
    for key in j_diag:
        assert rel_err(p_diag[key], j_diag[key]) < GCM_TOL, key
    TL._KDIST_OVERRIDE[0] = None
    _, s_diag = p_run(p_init(0), 2)
    assert rel_err(s_diag['olr'], p_diag['olr']) > 1e-4


# -- the order of preference and bad paths ------------------------------------

def _marker(path, which):
    np.savez(path, which=np.array(which))
    return str(path)


@pytest.mark.parametrize('case', ['installed', 'env', 'drop_in',
                                  'surrogate'])
def test_preference_order_matches_jax(case, tmp_path, monkeypatch):
    """Installed tables, then $CLIMT_TPU_LW_KTABLES, then the drop-in,
    then the surrogate, in both packages (one-key marker files)."""
    env = _marker(tmp_path / 'env.npz', 'env')
    drop_in = _marker(tmp_path / 'drop_in.npz', 'drop_in')
    if case in ('installed', 'env'):
        monkeypatch.setenv('CLIMT_TPU_LW_KTABLES', env)
    else:
        monkeypatch.delenv('CLIMT_TPU_LW_KTABLES', raising=False)
    if case == 'surrogate':
        drop_in = str(tmp_path / 'absent.npz')
    monkeypatch.setattr(JL, '_AER_KDIST', drop_in)
    monkeypatch.setattr(data, 'LW_KDIST_AER', drop_in)
    if case == 'installed':
        installed = _marker(tmp_path / 'installed.npz', 'installed')
        assert set(TL.load_aer_tables(installed)) == {'which'}
        JL.load_aer_tables(installed)
    got, ref = TL.load_kdist(), JL.load_kdist()
    assert set(got) == set(ref)
    for key in ref:
        assert np.array_equal(got[key], ref[key]), key
    if case == 'surrogate':
        assert 'b1_absa' in got
    else:
        assert str(got['which']) == case
    assert TL.load_kdist() is got


@pytest.mark.parametrize('bad', ['missing', 'not_npz', 'env_missing'])
def test_bad_paths_raise(bad, tmp_path, monkeypatch):
    """A missing file or one that is not an npz archive raises in both
    packages' load_aer_tables.  A $CLIMT_TPU_LW_KTABLES that names no file
    raises in the port, where JAX goes on to the surrogate."""
    missing = str(tmp_path / 'missing.npz')
    monkeypatch.setattr(JL, '_AER_KDIST', missing)
    monkeypatch.setattr(data, 'LW_KDIST_AER', missing)
    if bad == 'env_missing':
        monkeypatch.setenv('CLIMT_TPU_LW_KTABLES', missing)
        with pytest.raises(FileNotFoundError):
            TL.load_kdist()
        assert 'b1_absa' in JL.load_kdist()
        return
    path, error = missing, FileNotFoundError
    if bad == 'not_npz':
        path, error = str(tmp_path / 'not_npz.npz'), ValueError
        with open(path, 'w') as f:
            f.write('not an archive\n')
    with pytest.raises(error):
        JL.load_aer_tables(path)
    with pytest.raises(error):
        TL.load_aer_tables(path)
    assert TL._KDIST_OVERRIDE[0] is None
