"""climt_tpu_torch's moist GCM over a torch.distributed mesh
(``build_moist_gcm(mesh=...)``) on a CPU world of 4 gloo ranks, against
the port's single-device model, the JAX package's float64 model, and the
JAX package's own mesh model on a 4-device JAX mesh.

At tests/test_torch_moist_gcm.py's parity size (32x16x10,
rad_col_chunk=128), float64, 7 steps (radiation refreshes at steps 0 and
6) for spectral, FV and SL moisture.  The ranks are spawned once for the
file (``tests/torch_helpers.py:parallel_gcm_rank``); each gathers its
carries to the global layout (``convert.carry_to_global``), and every
check is its own test on them.  The JAX mesh model uses the matmul DFT,
as every JAX mesh test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from climt_tpu.dycore.moist_gcm import build_moist_gcm as jax_build
from climt_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm as port_build
from climt_tpu_torch.parallel import make_mesh

from torch_helpers import (STEP_COLLECTIVES, conservation_failures,
                           mesh_gcm_run, rel_err, spawn_ranks, world_of_one)

RANKS = 4
KW = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128)
STEPS, EARLY = 7, 2
MODES = ('spectral', 'fv', 'sl')
# the mesh changes only the summation order of the transforms' and the
# fixer's sums: 3e-13 to 6e-13 of max measured on the CPU
MESH_TOL = 1e-9
# the port's float64 parity with the JAX package (test_torch_moist_gcm)
JAX_TOL = 1e-8
WORLD_OF_ONE_TOL = 1e-12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close(got, ref, tol, sht=None):
    """Carries (prev, now, grids, aux, k[, diag]) within tol of max, field
    by field; with a JAX ``sht``, spectral fields compared in grid space
    (a padded m extent dropped first)."""
    for i in [i for i in (0, 1, 2, 3, 5) if i < len(ref)]:
        assert set(got[i]) == set(ref[i]), i
        for key, b in ref[i].items():
            a = got[i][key]
            if np.iscomplexobj(b) and sht is not None:
                M = sht.truncation + 1
                a, b = (np.asarray(sht.synthesize(jnp.asarray(x[..., :M, :])))
                        for x in (a, b))
            assert rel_err(a, b) < tol, (i, key, rel_err(a, b))
    assert int(got[4]) == int(ref[4])


def _put(mesh, tree):
    spec3 = NamedSharding(mesh, P(None, 'lat', None))
    spec2 = NamedSharding(mesh, P('lat', None))
    return {k: jax.device_put(v, spec3 if v.ndim == 3 else spec2)
            for k, v in tree.items()}


@pytest.fixture(scope='module')
def jax_runs():
    """({mode: (sht, initial carry, carry and diagnostics after STEPS)} of
    the single-device float64 models, {mode: (initial carry, carry after
    EARLY steps)} of the 4-device JAX mesh models)."""
    single = {}
    for mode in MODES:
        jd, j_init, _, j_run = jax_build(dtype=jnp.float64,
                                         moisture_advection=mode, **KW)
        j0 = j_init(0)
        carry, diag = j_run(j0, STEPS)
        single[mode] = (jd.sht, _np(j0), _np(carry) + (_np(diag),))
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(RANKS, 1),
                ('lat', 'lon'))
    sharded = {}
    for mode in ('spectral', 'fv'):
        _, j_init, _, j_run = jax_build(
            dtype=jnp.float64, fft_impl='matmul', mesh=mesh,
            moisture_advection=mode, **KW)
        prev, now, grids, aux, k = j_init()
        carry = (_put(mesh, prev), _put(mesh, now), _put(mesh, grids),
                 _put(mesh, aux), k)
        sharded[mode] = (_np((prev, now, grids, aux, k)),
                         _np(j_run(carry, EARLY)[0]))
    return single, sharded


@pytest.fixture(scope='module')
def ranks(jax_runs, tmp_path_factory):
    """Every rank's results of torch_helpers.parallel_gcm_rank."""
    single, sharded = jax_runs
    starts = {'jax': single['spectral'][1],
              'jax_mesh': sharded['spectral'][0]}
    return spawn_ranks('parallel_gcm_rank', RANKS,
                       tmp_path_factory.mktemp('parallel_gcm'), kw=KW,
                       modes=MODES, steps=STEPS, early=EARLY, starts=starts)


@pytest.fixture(scope='module')
def port_single():
    """{mode: the single-device port's carry and diagnostics after STEPS}."""
    out = {}
    for mode in MODES:
        _, init_fn, _, run_fn = port_build(
            dtype=torch.float64, device='cpu', moisture_advection=mode, **KW)
        carry, diag = run_fn(init_fn(0), STEPS)
        out[mode] = carry_to_numpy(carry + (diag,))
    return out


@pytest.mark.parametrize('mode', MODES)
def test_mesh_model_matches_the_single_device_port(ranks, port_single,
                                                   mode):
    _assert_close(ranks[0][mode]['final'], port_single[mode], MESH_TOL)


@pytest.mark.parametrize('mode', MODES)
def test_mesh_model_matches_jax_f64(ranks, jax_runs, mode):
    sht, _, ref = jax_runs[0][mode]
    _assert_close(ranks[0][mode]['final'], ref, JAX_TOL, sht)


@pytest.mark.parametrize('mode', ['spectral', 'fv'])
def test_mesh_model_matches_the_jax_mesh_model(ranks, jax_runs, mode):
    """2 steps against JAX's build_moist_gcm(mesh=...) on 4 devices
    (tests/test_multichip.py:132-143, :184-195); JAX's carry has M padded
    to 12, the gathered one M=11."""
    sht = jax_runs[0][mode][0]
    ref = jax_runs[1][mode][1]
    assert ref[1]['T'].shape[-2] == 12
    _assert_close(ranks[0][mode]['early'], ref, JAX_TOL, sht)


@pytest.mark.parametrize('mode', MODES)
def test_one_step_makes_the_counted_collectives(ranks, mode):
    """The (all_to_all transposes, halo calls, all_reduce, all_gather) of
    the first step on every rank, torch_helpers.STEP_COLLECTIVES, which
    the card's ranks make too (tests/test_torch_gpu_mesh.py); the (2, 2)
    mesh's 'lon' extent repeats the (4, 1) mesh's collectives."""
    expected = STEP_COLLECTIVES[('m_sharded', mode)]
    for out in ranks:
        assert out[mode]['counts']['collectives'] == expected
        if mode == 'spectral':
            assert out['spectral_2x2']['counts']['collectives'] == expected


def test_every_rank_gathers_the_same_carry(ranks):
    for out in ranks[1:]:
        _assert_close(out['spectral']['final'],
                      ranks[0]['spectral']['final'], 0.0 + 1e-300)


def test_2x2_mesh_matches_the_single_device_port(ranks, port_single):
    """A 'lon' extent of 2 repeats each latitude block; collectives run on
    the 'lat' groups only."""
    assert ranks[0]['mesh_shapes'] == ((4, 1), (2, 2))
    for out in ranks:
        _assert_close(out['spectral_2x2']['final'], port_single['spectral'],
                      MESH_TOL)


def test_fv_mass_is_conserved_across_ranks(ranks):
    failures = conservation_failures(
        fv_mass=[out['fv']['fv_mass'] for out in ranks])
    assert not failures, '\n'.join(failures)


def test_the_water_fixer_closes_in_sl_mode_on_four_ranks(ranks):
    failures = conservation_failures(
        water=[out['sl']['water'] for out in ranks])
    assert not failures, '\n'.join(failures)


@pytest.mark.parametrize('start', ['jax', 'jax_mesh'])
def test_carry_to_rank_takes_a_jax_carry(ranks, jax_runs, start):
    """One step of the 4-rank model from JAX's global carry (its single
    device's, and its mesh model's with M padded) cut by carry_to_rank,
    gathered back, against one single-device port step from JAX's carry."""
    _, j0, _ = jax_runs[0]['spectral']
    _, _, step_fn, _ = port_build(dtype=torch.float64, device='cpu', **KW)
    ref = carry_to_numpy(step_fn(carry_from_numpy(
        j0, 'cpu', torch.float64))[0])
    _assert_close(ranks[0]['from'][start], ref, 1e-10)


@pytest.mark.parametrize('mode', MODES)
def test_world_of_one_matches_the_single_device_port(port_single, tmp_path,
                                                     mode):
    with world_of_one(tmp_path):
        mesh = make_mesh(1, device='cpu')
        got = mesh_gcm_run(mesh, mode, KW, STEPS)['final']
    _assert_close(got, port_single[mode], WORLD_OF_ONE_TOL)
