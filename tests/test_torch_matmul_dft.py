"""The matmul zonal DFT (``fft_impl='matmul'``) of climt_tpu_torch against
the JAX package's, on the CPU at float64: the transform (1e-12 of max),
``SpectralDycore`` (1e-10 after an initial step and 3 steps) and
``build_moist_gcm`` at 32x16x10 over 7 steps (1e-8), and the replicated
transform of a gloo world of one built on it.  The distributed transform
with the matmul DFT is a case of tests/test_torch_parallel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu.dycore.moist_gcm import build_moist_gcm as jax_build
from climt_tpu.dycore.spectral_dynamics import SpectralDycore as JDycore
from climt_tpu.ops.sht import SphericalHarmonicTransform as JSHT
from climt_tpu_torch.convert import carry_to_numpy
from climt_tpu_torch.core.grid import hybrid_sigma_pressure_coefficients
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm as port_build
from climt_tpu_torch.dycore.spectral_dynamics import SpectralDycore as TDycore
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform as TSHT
from climt_tpu_torch.parallel import ReplicatedSHT, make_mesh

from torch_helpers import layout_sht_results, rel_err, world_of_one

NLON, NLAT, NZ = 32, 16, 10
KW = dict(nlon=NLON, nlat=NLAT, nz=NZ, rad_every=6, rad_col_chunk=128)
TRANSFORMS = ('analyze', 'synthesize', 'synthesize_dmu',
              'synthesize_dlambda', 'gradient', 'uv_from_vort_div',
              'vort_div_analysis')


def _fields(seed=4):
    """Two grid fields and two spectral fields (masked to n >= m)."""
    rng = np.random.RandomState(seed)
    a, b = rng.randn(2, NZ, NLAT, NLON)
    M = min((2 * NLAT - 1) // 3, (NLON - 1) // 3) + 1
    mask = np.arange(M)[None, :] >= np.arange(M)[:, None]
    sa, sb = ((rng.randn(NZ, M, M) + 1j * rng.randn(NZ, M, M)) * mask
              for _ in range(2))
    return a, b, sa, sb


def _results(sht, arrays):
    a, b, sa, sb = arrays
    return {'analyze': sht.analyze(a), 'synthesize': sht.synthesize(sa),
            'synthesize_dmu': sht.synthesize_dmu(sa),
            'synthesize_dlambda': sht.synthesize_dlambda(sa),
            'gradient': sht.gradient(sa),
            'uv_from_vort_div': sht.uv_from_vort_div(sa, sb),
            'vort_div_analysis': sht.vort_div_analysis(a, b)}


@pytest.fixture(scope='module')
def transforms():
    """{name: (port matmul, JAX matmul, port fft)} results."""
    arrays = _fields()
    port = _results(TSHT(NLON, NLAT, dtype=torch.float64, device='cpu',
                         fft_impl='matmul'),
                    [torch.as_tensor(x) for x in arrays])
    ref = _results(JSHT(NLON, NLAT, dtype=jnp.float64, fft_impl='matmul'),
                   [jnp.asarray(x) for x in arrays])
    fft = _results(TSHT(NLON, NLAT, dtype=torch.float64, device='cpu'),
                   [torch.as_tensor(x) for x in arrays])
    return {k: tuple(zip(*(v if isinstance(v, tuple) else (v,)
                           for v in (port[k], ref[k], fft[k]))))
            for k in TRANSFORMS}


@pytest.mark.parametrize('name', TRANSFORMS)
def test_matmul_transform_matches_jax(transforms, name):
    for got, ref, fft in transforms[name]:
        assert rel_err(got, np.asarray(ref)) <= 1e-12
        # and the torch.fft transform to roundoff
        assert rel_err(got, fft) <= 1e-13


def test_matmul_transform_holds_its_dft_matrices():
    sht = TSHT(NLON, NLAT, dtype=torch.float32, device='cpu',
               fft_impl='matmul')
    M = sht.truncation + 1
    assert sht.dft_cos.shape == (NLON, M) and sht.idft_sin.shape == (M,
                                                                     NLON)
    assert all(getattr(sht, n).dtype == torch.float32
               for n in ('dft_cos', 'dft_sin', 'idft_cos', 'idft_sin'))
    assert not hasattr(TSHT(NLON, NLAT, device='cpu'), 'dft_cos')
    with pytest.raises(ValueError, match='fft_impl'):
        TSHT(NLON, NLAT, device='cpu', fft_impl='dft')


def test_spectral_dycore_with_matmul_dft_matches_jax():
    """One initial_step and 3 leapfrog steps with grid physics
    tendencies, from the same seeded state."""
    ak, bk = hybrid_sigma_pressure_coefficients(NZ + 1, 1e5, 20.0)
    kw = dict(timestep=600.0, number_of_damped_levels=3, fft_impl='matmul')
    jd = JDycore(NLON, NLAT, NZ, ak, bk, dtype=jnp.float64, **kw)
    td = TDycore(NLON, NLAT, NZ, ak, bk, dtype=torch.float64, device='cpu',
                 **kw)
    assert td.sht.fft_impl == 'matmul'
    rng = np.random.RandomState(6)
    shape = (NZ, NLAT, NLON)
    mu = jd.sht.mu[:, None]
    grid = (20.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape),
            rng.randn(*shape),
            250.0 + 30.0 * np.sqrt(1.0 - mu ** 2) + rng.randn(*shape),
            1e-3 * rng.rand(*shape),
            np.log(1e5) + 0.01 * rng.randn(NLAT, NLON))
    phys = {k: 1e-5 * rng.randn(*shape) for k in ('du', 'dv', 'dT')}
    phys['dq'] = 1e-9 * rng.randn(*shape)
    jprev, jnow = jd.initial_step(jd.spectral_state_from_grid(
        *map(jnp.asarray, grid)))
    tprev, tnow = td.initial_step(td.spectral_state_from_grid(
        *(torch.as_tensor(x) for x in grid)))
    jphys = {k: jnp.asarray(x) for k, x in phys.items()}
    tphys = {k: torch.as_tensor(x) for k, x in phys.items()}
    for _ in range(3):
        jprev, jnow, jgrids = jd.step(jprev, jnow, phys=jphys)
        tprev, tnow, tgrids = td.step(tprev, tnow, phys=tphys)
    for key in jnow:
        assert rel_err(tnow[key], np.asarray(jnow[key])) < 1e-10, key
        assert rel_err(tprev[key], np.asarray(jprev[key])) < 1e-10, key
    for key in jgrids:
        assert rel_err(tgrids[key], np.asarray(jgrids[key])) < 1e-10, key


def test_moist_gcm_with_matmul_dft_matches_jax_f64():
    jd, j_init, _, j_run = jax_build(dtype=jnp.float64, fft_impl='matmul',
                                     **KW)
    pd, p_init, _, p_run = port_build(dtype=torch.float64, device='cpu',
                                      fft_impl='matmul', **KW)
    assert pd.sht.fft_impl == 'matmul'
    j_carry, j_diag = j_run(j_init(0), 7)
    p_carry, p_diag = p_run(p_init(0), 7)
    j_np = jax.tree_util.tree_map(np.asarray, j_carry)
    p_np = carry_to_numpy(p_carry)
    for i in range(4):
        for key, b in j_np[i].items():
            a = p_np[i][key]
            if i < 2:       # prev, now: complex spectral, held in grid space
                a, b = (np.asarray(jd.sht.synthesize(jnp.asarray(x)))
                        for x in (a, b))
            assert rel_err(a, b) < 1e-8, (i, key)
    assert int(p_np[4]) == int(j_np[4])
    assert set(p_diag) == set(j_diag)
    for key in j_diag:
        assert rel_err(p_diag[key], np.asarray(j_diag[key])) < 1e-8, key


@pytest.mark.parametrize('shard_lon', [False, True])
def test_replicated_transform_keeps_the_matmul_dft(tmp_path, shard_lon):
    """On a world of one the replicated transform is the single-device
    matmul transform, whole rows gathered before the DFT."""
    one = TSHT(NLON, NLAT, dtype=torch.float64, device='cpu',
               fft_impl='matmul')
    a, b, _, _ = _fields(5)
    with world_of_one(tmp_path):
        rep = ReplicatedSHT(one, make_mesh(1, mesh_shape=(1, 1),
                                           device='cpu'),
                            shard_lon=shard_lon)
        assert rep.fft_impl == 'matmul'
        got = layout_sht_results(rep, (a, b))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert rel_err(got['analyze'], one.analyze(ta)) <= 1e-13
    assert rel_err(got['synthesize'],
                   one.synthesize(one.analyze(ta))) <= 1e-13
    for g, r in zip(got['vort_div_analysis'], one.vort_div_analysis(ta, tb)):
        assert rel_err(g, r) <= 1e-13
