"""climt_tpu_torch's parallel layer (climt_tpu_torch/parallel/) on a CPU
world of 4 gloo ranks, against the port's single-device operators and the
JAX package's parallel layer on a 4-device JAX mesh.

The ranks are spawned once for the file (``tests/torch_helpers.py:
spawn_ranks``, which imports no jax): they start up, build meshes, run
``DistributedSHT`` at 48x24 (nz=5, JAX's ``tests/test_dist_sht.py`` grid)
and at 32x16 T10 (M=11 padded to 12), and ``FVAdvection`` with the
latitude halo at 64x32 (nz=4), each result gathered to the global layout.
Every check is its own test on those results.  The JAX side runs in the
pytest process on 4 of its 8 forced host devices, with the matmul DFT as
every JAX mesh test does.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from climt_tpu.ops.fv_advection import FVAdvection as JFV
from climt_tpu.ops.sht import SphericalHarmonicTransform as JSHT
from climt_tpu.parallel import DistributedSHT as JDistributedSHT
from climt_tpu.parallel import make_mesh as jax_make_mesh
from climt_tpu.parallel.halo import make_lat_halo as jax_make_lat_halo
from climt_tpu_torch.ops.fv_advection import FVAdvection as TFV
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform as TSHT
from climt_tpu_torch.parallel import (
    DistributedSHT, grid_sharding, initialize_distributed, make_mesh,
    process_info, replicated)
from climt_tpu_torch.parallel.mesh import default_mesh_shape

from torch_helpers import (conservation_failures, rel_err, sht_rank_results,
                           spawn_ranks)
from torch_helpers import world_of_one as gloo_world_of_one

RANKS = 4
RADIUS = 6.371e6
# the same tensors and contractions in another blocking: measured 0 to
# 4e-16 of max against the single-device transform, on the CPU
SHT_TOL = 1e-12
# the halo'd FV pass does the single-device operations on each row
FV_TOL = 1e-13
TRANSFORMS = ('analyze', 'synthesize', 'roundtrip', 'synthesize_dmu',
              'synthesize_dlambda', 'analyze_rank2', 'synthesize_rank2',
              'laplacian', 'inverse_laplacian', 'filter_spec',
              'total_wavenumber', 'gradient', 'uv_from_vort_div',
              'vort_div_analysis')


def _sht_cases():
    """{name: (nlon, nlat, truncation, (grid_a, grid_b), fft_impl)}: JAX's
    test_dist_sht grid (its first field from the same seed), a T10 grid
    whose M=11 pads to 12 on 4 ranks, and the first again with the matmul
    zonal DFT."""
    rng = np.random.RandomState(3)
    cases = {'48x24': (48, 24, None, (rng.randn(5, 24, 48),
                                      rng.randn(5, 24, 48)), 'fft'),
             '32x16_T10': (32, 16, 10, (rng.randn(3, 16, 32),
                                        rng.randn(3, 16, 32)), 'fft')}
    cases['48x24_matmul'] = cases['48x24'][:4] + ('matmul',)
    return cases


def _fv_case(nlat=32, nlon=64, nz=4, seed=0):
    """((mu, w, nlon, dt), (q, dp, u, v, mdot)): test_fv_advection's grid
    with tests/test_torch_transport.py's noisy winds, which flip the
    limiter and the upwind side across the block edges."""
    sht = TSHT(nlon, nlat, dtype=torch.float64, device='cpu')
    mu, w = sht.mu, sht.weights
    rng = np.random.RandomState(seed)
    L, F = np.meshgrid(2 * np.pi * np.arange(nlon) / nlon, np.arcsin(mu))
    q = 1e-3 * (1.0 + 0.8 * np.exp(
        -((F - 0.3) ** 2 / 0.08 + (L - np.pi) ** 2 / 0.3)))
    q = np.broadcast_to(q, (nz, nlat, nlon)) * (1 + 0.1 * rng.rand(nz, 1, 1))
    dp = 2000.0 + 3000.0 * rng.rand(nz, nlat, nlon)
    u = 20.0 * np.cos(F)[None] + 30.0 * rng.randn(nz, nlat, nlon)
    v = (5.0 * np.sin(2 * F) * np.cos(L))[None] + 5.0 * rng.randn(
        nz, nlat, nlon)
    mdot = 0.01 * rng.randn(nz - 1, nlat, nlon)
    return (mu, w, nlon, 1200.0), (q, dp, u, v, mdot)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every rank's results of torch_helpers.parallel_ops_rank."""
    return spawn_ranks('parallel_ops_rank', RANKS,
                       tmp_path_factory.mktemp('parallel_ops'),
                       sht_cases=_sht_cases(), fv_case=_fv_case())


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of one in this process, torn down after the test."""
    with gloo_world_of_one(tmp_path) as size:
        yield size


def _single_device(name, grids, nlon, nlat, truncation, fft_impl='fft'):
    """The single-device port transform's result of TRANSFORMS[name]."""
    sht = TSHT(nlon, nlat, truncation, dtype=torch.float64, device='cpu',
               fft_impl=fft_impl)
    a, b = (torch.as_tensor(g) for g in grids)
    sa, sb = sht.analyze(a), sht.analyze(b)
    return {
        'analyze': lambda: sa, 'synthesize': lambda: sht.synthesize(sa),
        'roundtrip': lambda: sht.analyze(sht.synthesize(sa)),
        'synthesize_dmu': lambda: sht.synthesize_dmu(sa),
        'synthesize_dlambda': lambda: sht.synthesize_dlambda(sa),
        'analyze_rank2': lambda: sht.analyze(a[0]),
        'synthesize_rank2': lambda: sht.synthesize(sa[0]),
        'laplacian': lambda: sht.laplacian(sa),
        'inverse_laplacian': lambda: sa * sht.inv_laplacian_eig,
        'filter_spec': lambda: (sa + 1.0) * sht.mask,
        'total_wavenumber': lambda: torch.arange(
            sht.truncation + 1.0, dtype=torch.float64)[None, :].expand(
                sht.truncation + 1, -1),
        'gradient': lambda: sht.gradient(sa),
        'uv_from_vort_div': lambda: sht.uv_from_vort_div(sa, sb),
        'vort_div_analysis': lambda: sht.vort_div_analysis(a, b),
    }[name]()


def _pairs(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    return zip(got, ref)


# -- start-up and meshes ----------------------------------------------------

def test_four_ranks_start_and_report(ranks):
    for rank, out in enumerate(ranks):
        assert out['process_info'] == (rank, RANKS, 1, RANKS)
        assert out['initialize_again'] == RANKS      # idempotent
        assert out['backend'] == 'gloo'


def test_make_mesh_default_shapes_follow_the_jax_rule(ranks):
    assert ranks[0]['default_shape'] == (2, 2)
    for n in range(1, len(jax.devices()) + 1):
        assert default_mesh_shape(n) == jax_make_mesh(n).devices.shape, n


def test_grid_sharding_placements(ranks):
    assert ranks[0]['placements'] == (('S(1)', 'R'), ('S(0)', 'R'),
                                      ('R', 'R'))
    # DTensor's own shard of a field laid out so is the rank's block
    assert all(out['dtensor_block'] for out in ranks)


def test_world_of_one_in_process(world_of_one):
    assert world_of_one == 1
    assert process_info() == (0, 1, 1, 1)
    assert initialize_distributed(device='cpu') == 1
    with pytest.raises(ValueError, match='all 1 ranks'):
        make_mesh(2, device='cpu')
    default = make_mesh(device='cpu')
    assert tuple(default.shape) == (1, 1)
    assert replicated(default) == (Replicate(), Replicate())
    assert grid_sharding(default, shard_lon=True) == (Shard(1), Shard(2))
    assert grid_sharding(default, 2, shard_lon=True) == (Shard(0), Shard(1))
    mesh = make_mesh(1, mesh_shape=(1, 1), device='cpu')
    (nlon, nlat, trunc, grids, _) = _sht_cases()['48x24']
    dsht = DistributedSHT(TSHT(nlon, nlat, trunc, dtype=torch.float64,
                               device='cpu'), mesh)
    got = sht_rank_results(dsht, grids)
    for name in TRANSFORMS:
        ref = _single_device(name, grids, nlon, nlat, trunc)
        for g, r in _pairs(got[name], ref):
            assert rel_err(g, r) < SHT_TOL, name


def test_no_cluster_runs_single_process(monkeypatch, caplog):
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR'):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    with caplog.at_level(logging.INFO):
        assert initialize_distributed(device='cpu') == 1
    assert 'no cluster is described' in caplog.text
    assert not dist.is_initialized()
    assert process_info() == (0, 1, 1, 1)
    with pytest.raises(RuntimeError, match='initialize_distributed'):
        make_mesh(device='cpu')


def test_a_described_but_broken_cluster_raises(monkeypatch):
    for key in ('WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv('RANK', '0')
    with pytest.raises((ValueError, RuntimeError)):
        initialize_distributed(device='cpu')
    with pytest.raises(ValueError, match='num_processes'):
        initialize_distributed('localhost:29500', device='cpu')
    assert not dist.is_initialized()


def test_cuda_without_nccl_raises_and_never_takes_gloo(monkeypatch):
    monkeypatch.setattr(dist, 'is_nccl_available', lambda: False)
    monkeypatch.setenv('RANK', '0')
    with pytest.raises(RuntimeError, match='NCCL'):
        initialize_distributed(device='cuda')
    assert not dist.is_initialized()


def test_spawn_ranks_defaults_to_the_cards_and_refuses_without_them(
        monkeypatch, tmp_path):
    """spawn_ranks's default device is the card: with fewer cards than
    ranks it raises before it writes its inputs or starts a rank, and it
    never falls back to gloo ranks on the CPU."""
    import multiprocessing
    from climt_tpu_torch.parallel import distributed, spawn_ranks
    if torch.cuda.device_count() >= 2:
        pytest.skip('two CUDA cards are present: the default runs there')

    def no_process(*args, **kwargs):
        raise AssertionError('a rank was started')

    monkeypatch.setattr(multiprocessing, 'get_context', no_process)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards, one per "
                                           "rank; this machine has"):
        spawn_ranks(distributed.process_info, 2, out_dir=tmp_path)
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError, match='expected cuda or cpu'):
        spawn_ranks(distributed.process_info, 2, device='meta',
                    out_dir=tmp_path)


# -- DistributedSHT -----------------------------------------------------------

@pytest.mark.parametrize('name', TRANSFORMS)
@pytest.mark.parametrize('case', list(_sht_cases()))
def test_distributed_sht_matches_single_device(ranks, case, name):
    nlon, nlat, trunc, grids, fft_impl = _sht_cases()[case]
    assert ranks[0][case]['fft_impl'] == fft_impl
    ref = _single_device(name, grids, nlon, nlat, trunc, fft_impl)
    for got in (ranks[0][case][name], ranks[-1][case][name]):
        for g, r in _pairs(got, ref):
            assert rel_err(g, r) < SHT_TOL


JAX_TRANSFORMS = ('analyze', 'synthesize', 'synthesize_dmu', 'gradient',
                  'uv_from_vort_div', 'vort_div_analysis', 'analyze_rank2')


@pytest.fixture(scope='module')
def jax_dist():
    """{case: ({JAX_TRANSFORMS name: the JAX DistributedSHT's result on a
    4-device mesh, spectral M unpadded}, its M_padded)}, all transforms
    of a case in one jit.  JAX runs the matmul DFT for every case, so a
    case that differs from an earlier one only in the port's fft_impl
    takes that one's results."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(RANKS, 1),
                ('lat', 'lon'))
    out = {}
    done = {}
    for case, (nlon, nlat, trunc, (a, b), _) in _sht_cases().items():
        if (nlon, nlat, trunc) in done:
            out[case] = out[done[nlon, nlat, trunc]]
            continue
        done[nlon, nlat, trunc] = case
        sht = JSHT(nlon, nlat, trunc, dtype=jnp.float64, fft_impl='matmul')
        dsht = JDistributedSHT(sht, mesh)
        grid = NamedSharding(mesh, dsht.grid_spec)
        spec = NamedSharding(mesh, dsht.spec_spec)
        ga, gb = (jax.device_put(jnp.asarray(x), grid) for x in (a, b))
        sa, sb = (jax.device_put(dsht.pad_spec(sht.analyze(jnp.asarray(
            x))), spec) for x in (a, b))
        unpad = dsht.unpad_spec

        def transforms(ga, gb, sa, sb):
            return {'analyze': unpad(dsht.analyze(ga)),
                    'synthesize': dsht.synthesize(sa),
                    'synthesize_dmu': dsht.synthesize_dmu(sa),
                    'gradient': dsht.gradient(sa),
                    'uv_from_vort_div': dsht.uv_from_vort_div(sa, sb),
                    'vort_div_analysis': tuple(
                        unpad(x) for x in dsht.vort_div_analysis(ga, gb)),
                    'analyze_rank2': unpad(dsht.analyze(ga[0][None]))[0]}

        with mesh:
            results = jax.jit(transforms)(ga, gb, sa, sb)
        out[case] = (jax.tree_util.tree_map(np.asarray, results),
                     dsht.M_padded)
    return out


@pytest.mark.parametrize('name', JAX_TRANSFORMS)
@pytest.mark.parametrize('case', list(_sht_cases()))
def test_distributed_sht_matches_jax_distributed_sht(ranks, jax_dist, case,
                                                     name):
    ref, M_padded = jax_dist[case]
    assert ranks[0][case]['M_padded'] == M_padded
    for g, r in _pairs(ranks[0][case][name], ref[name]):
        assert rel_err(g, r) < SHT_TOL


# -- the latitude halo and FV -------------------------------------------------

def test_halo_fv_matches_the_single_device_operator(ranks):
    (mu, w, nlon, dt), fields = _fv_case()
    fv = TFV(mu, w, nlon, RADIUS, dt, dtype=torch.float64, device='cpu')
    ref = fv.advect(*(torch.as_tensor(np.array(f)) for f in fields), dt)
    assert rel_err(ranks[0]['fv_advect'], ref) < FV_TOL


def test_halo_fv_matches_jax_halo_fv(ranks):
    """Against JAX's FVAdvection with its ppermute halo on a 4-device mesh
    (tests/test_fv_advection.py:161-184)."""
    (mu, w, nlon, dt), fields = _fv_case()
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(RANKS, 1),
                ('lat', 'lon'))
    fv = JFV(mu, w, nlon, RADIUS, dt, dtype=jnp.float64,
             halo_exchange=jax_make_lat_halo(mesh))
    sh = NamedSharding(mesh, P(None, 'lat', None))
    args = [jax.device_put(jnp.asarray(f), sh) for f in fields]
    with mesh:
        ref = jax.jit(lambda *a: fv.advect(*a, dt))(*args)
    assert rel_err(ranks[0]['fv_advect'], np.asarray(ref)) < FV_TOL


def test_halo_fv_conserves_mass_across_ranks(ranks):
    """Each rank keeps the mass and sums the whole sphere (all-reduced)."""
    failures = conservation_failures([out['fv_mass'] for out in ranks])
    assert not failures, '\n'.join(failures)


def test_halo_fv_band_loops_run_over_the_rank_rows(ranks):
    """Each rank's zonal bands cover its own 8 rows only; the polar ranks
    carry the substepped bands (the load imbalance PERF.md notes)."""
    (mu, w, nlon, dt), _ = _fv_case()
    whole = TFV(mu, w, nlon, RADIUS, dt, dtype=torch.float64,
                device='cpu').zonal_bands
    rows = {}
    for rank, out in enumerate(ranks):
        assert out['fv_bands'][0][0] == 0 and out['fv_bands'][-1][1] == 8
        for j0, j1, n in out['fv_bands']:
            for j in range(j0, j1):
                rows[8 * rank + j] = n
    assert rows == {j: n for j0, j1, n in whole for j in range(j0, j1)}
    assert max(n for _, _, n in ranks[0]['fv_bands']) > 1
