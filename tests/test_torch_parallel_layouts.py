"""The replicated-spectral layout of climt_tpu_torch.parallel
(``shard_model_state``, ``grid_sharding(shard_lon=True)``,
``ReplicatedSHT``) with the Held-Suarez model, on a CPU world of 4 gloo
ranks, and its placement API in a world of one.

The ranks are spawned once for the file (``tests/torch_helpers.py:
layout_hs_rank``).  On each mesh of ``torch_helpers.LAYOUTS`` ((4, 1) and
(2, 2) lat-only, (2, 2) and (1, 4) with shard_lon=True) they run every
transform of ``ReplicatedSHT`` at 48x24 (nz=5, JAX's test_dist_sht grid)
and build_held_suarez_model's carry at 32x16x8 float64, placed by
shard_model_state, for 3 steps.  The model is held against the
single-device port, the JAX package's single-device model and JAX's own
shard_model_state run on its 8 host devices (tests/torch_layout_cases.py:
JAX_MESHES, one lat-only and one longitude-sharded mesh).  JAX's
build_held_suarez_model has no fft_impl and XLA's CPU FFT refuses the
sharded layouts, so that run is JAX's model assembled from its own
SpectralDycore (fft_impl='matmul', as every JAX mesh test runs it) and
held_suarez_physics_fn, as compiled.py:55-95 assembles it.  The moist GCM
in this layout is tests/test_torch_parallel_layouts_*.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from climt_tpu.core.grid import \
    hybrid_sigma_pressure_coefficients as jax_coefficients
from climt_tpu.dycore.compiled import build_held_suarez_model as jax_hs
from climt_tpu.dycore.compiled import held_suarez_physics_fn as jax_physics
from climt_tpu.dycore.spectral_dynamics import SpectralDycore as JaxDycore
from climt_tpu.parallel.mesh import shard_model_state as jax_shard
from climt_tpu_torch.convert import (carry_from_numpy, carry_to_global,
                                     carry_to_layout, carry_to_numpy)
from climt_tpu_torch.dycore.compiled import build_held_suarez_model
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
from climt_tpu_torch.parallel import make_mesh, shard_model_state

from torch_helpers import (LAYOUTS, STEP_COLLECTIVES, layout_name, rel_err,
                           spawn_ranks, world_of_one)
from torch_layout_cases import (JAX_MESHES, JAX_TOL, PORT_TOL, RANKS,
                                assert_close, jax_mesh, np_tree)

HS = dict(nlon=32, nlat=16, nz=8)
STEPS = 3
NAMES = [layout_name(layout) for layout in LAYOUTS]
# the same tensors and contractions on fewer rows, summed over the ranks:
# measured 0 to 4e-16 of max against the single-device transform
SHT_TOL = 1e-12
WORLD_OF_ONE_TOL = 1e-12


def _sht_grids():
    rng = np.random.RandomState(3)
    return rng.randn(5, 24, 48), rng.randn(5, 24, 48)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every rank's results of torch_helpers.layout_hs_rank."""
    return spawn_ranks('layout_hs_rank', RANKS,
                       tmp_path_factory.mktemp('layouts_hs'), kw=HS,
                       steps=STEPS, grids=_sht_grids())


@pytest.fixture(scope='module')
def port_single():
    _, init_fn, _, run_fn = build_held_suarez_model(
        dtype=torch.float64, device='cpu', **HS)
    return carry_to_numpy(run_fn(init_fn(0), STEPS))


@pytest.fixture(scope='module')
def jax_single():
    dycore, init_fn, _, run_fn = jax_hs(dtype=jnp.float64, **HS)
    return dycore.sht, np_tree(run_fn(init_fn(0), STEPS))


def _jax_matmul_hs(nlon, nlat, nz, timestep=600.0, dtype=jnp.float64):
    """(init_fn, run_fn) of JAX's Held-Suarez model (compiled.py:55-95)
    on the matmul DFT."""
    ak, bk = jax_coefficients(nz + 1, 1e5, 20.0)
    dycore = JaxDycore(nlon, nlat, nz, ak, bk, timestep=timestep,
                       number_of_damped_levels=5, dtype=dtype,
                       fft_impl='matmul')
    physics = jax_physics(dycore)

    def init_fn(seed=0):
        rng = np.random.RandomState(seed)
        shape = (nz, nlat, nlon)
        T = 290.0 + 0.1 * rng.randn(*shape)
        zeros = jnp.zeros(shape, dtype)
        spec = dycore.spectral_state_from_grid(
            zeros, zeros, jnp.asarray(T, dtype), zeros,
            jnp.full((nlat, nlon), np.log(1e5), dtype))
        prev, now = dycore.initial_step(spec, physics_fn=physics)
        return prev, now, dycore.grids_of(prev)

    def step_fn(carry, _):
        prev, now, prev_grids = carry
        filtered, new, now_grids = dycore.step(
            prev, now, physics_fn=physics, prev_grids=prev_grids)
        return (filtered, new, now_grids), None

    @partial(jax.jit, static_argnums=(1,))
    def run_fn(carry, n_steps):
        return jax.lax.scan(step_fn, carry, None, length=n_steps)[0]

    return init_fn, run_fn


@pytest.fixture(scope='module')
def jax_sharded():
    """{shard_lon: JAX's carry after its shard_model_state on
    JAX_MESHES[shard_lon] and 3 steps}."""
    init_fn, run_fn = _jax_matmul_hs(**HS)
    out = {}
    for shard_lon, shape in JAX_MESHES.items():
        mesh = jax_mesh(shape)
        carry = jax_shard(mesh, *init_fn(0), shard_lon=shard_lon)
        with mesh:
            out[shard_lon] = np_tree(run_fn(carry, STEPS))
    return out


# -- the layout transform -----------------------------------------------------

@pytest.mark.parametrize('layout', NAMES)
def test_replicated_sht_matches_the_single_device_transform(ranks, layout):
    a, b = (torch.as_tensor(g) for g in _sht_grids())
    sht = SphericalHarmonicTransform(48, 24, dtype=torch.float64,
                                     device='cpu')
    sa, sb = sht.analyze(a), sht.analyze(b)
    vd = sht.vort_div_analysis(a, b)
    ref = {
        'analyze': sa, 'synthesize': sht.synthesize(sa),
        'roundtrip': sht.analyze(sht.synthesize(sa)),
        'synthesize_dmu': sht.synthesize_dmu(sa),
        'synthesize_dlambda': sht.synthesize_dlambda(sa),
        'analyze_rank2': sht.analyze(a[0]),
        'synthesize_rank2': sht.synthesize(sa[0]),
        'laplacian': sht.laplacian(sa),
        'inverse_laplacian': sa * sht.inv_laplacian_eig,
        'filter_spec': (sa + 1.0) * sht.mask,
        'total_wavenumber': torch.arange(
            sht.truncation + 1.0, dtype=torch.float64)[None, :].expand(
                sht.truncation + 1, -1),
        'global_sum': sht.global_sum(a * sht.coslat),
        'gradient': sht.gradient(sa),
        'uv_from_vort_div': sht.uv_from_vort_div(sa, sb),
        'vort_div_analysis': vd,
        'analyze_many': (sa, sht.analyze(b[0])) + vd,
    }
    for out in ranks:
        got = out[layout]['sht']
        assert set(got) == set(ref)
        for name, r in ref.items():
            g = got[name]
            pairs = zip(g, r) if isinstance(r, tuple) else [(g, r)]
            for x, y in pairs:
                assert rel_err(x, y) < SHT_TOL, (name, rel_err(x, y))


# -- Held-Suarez in the layout ----------------------------------------------

@pytest.mark.parametrize('layout', NAMES)
def test_held_suarez_matches_the_single_device_port(ranks, port_single,
                                                    layout):
    for out in ranks:
        assert_close(out[layout]['final'], port_single, PORT_TOL)


@pytest.mark.parametrize('layout', NAMES)
def test_held_suarez_matches_jax_f64(ranks, jax_single, layout):
    sht, ref = jax_single
    assert_close(ranks[0][layout]['final'], ref, JAX_TOL, sht)


@pytest.mark.parametrize('layout', NAMES)
def test_held_suarez_matches_jax_shard_model_state(ranks, jax_single,
                                                   jax_sharded, layout):
    assert_close(ranks[0][layout]['final'],
                 jax_sharded[layout.endswith('_lon')], JAX_TOL, jax_single[0])


@pytest.mark.parametrize('layout', NAMES)
def test_held_suarez_spectral_state_is_bitwise_equal_on_every_rank(
        ranks, layout):
    ref = ranks[0][layout]['spectral']
    for out in ranks[1:]:
        for key, value in out[layout]['spectral'].items():
            assert np.array_equal(value, ref[key]), key


@pytest.mark.parametrize('layout', NAMES)
def test_held_suarez_step_makes_one_reduction(ranks, layout):
    """The dycore's analyses go through one all_reduce, and under
    shard_lon one all_gather of the whole rows; no transpose and no halo
    (torch_helpers.STEP_COLLECTIVES)."""
    gathers = 1 if layout.endswith('_lon') else 0
    kind = 'replicated_lon' if layout.endswith('_lon') else 'replicated'
    assert STEP_COLLECTIVES[(kind, 'held_suarez')] == (0, 0, 1, gathers)
    for out in ranks:
        assert out[layout]['counts']['collectives'] == (0, 0, 1, gathers)


# -- the placement API in a world of one ------------------------------------

@pytest.mark.parametrize('shard_lon', [False, True])
def test_shard_model_state_places_the_carry(tmp_path, shard_lon):
    """DTensors of the JAX placements (mesh.py:57-77): spectral states
    replicated, grid and aux fields in grid blocks, one-dimensional aux
    replicated, the step index an int; full_tensor gives the carry back."""
    _, init_fn, _, _ = build_moist_gcm(dtype=torch.float64, device='cpu',
                                       **HS)
    prev, now, grids, aux, k = init_fn(0)
    aux = dict(aux, scalar=torch.ones(3, dtype=torch.float64))
    with world_of_one(tmp_path):
        mesh = make_mesh(device='cpu')
        placed = shard_model_state(mesh, prev, now, grids, aux, k,
                                   shard_lon=shard_lon)
        assert len(placed) == 5 and placed[4] == 0
        for part, src in zip(placed[:4], (prev, now, grids, aux)):
            for key, v in part.items():
                assert isinstance(v, DTensor), key
                nd = src[key].ndim
                if src[key].is_complex() or nd < 2:
                    expected = (Replicate(), Replicate())
                else:
                    expected = (Shard(nd - 2),
                                Shard(nd - 1) if shard_lon else Replicate())
                assert v.placements == expected, key
                assert torch.equal(v.full_tensor(), src[key]), key
        # the Held-Suarez carry has no aux and no step index
        assert len(shard_model_state(mesh, prev, now, grids)) == 3


@pytest.mark.parametrize('shard_lon', [False, True])
def test_world_of_one_layout_step_matches_the_single_device_step(
        tmp_path, shard_lon):
    """A world of one through carry_to_layout and carry_to_global: one
    Held-Suarez step of the placed carry against one single-device step
    (the moist GCM's steps are the 4-rank files')."""
    _, init_fn, step_fn, _ = build_held_suarez_model(
        dtype=torch.float64, device='cpu', **HS)
    start = carry_to_numpy(init_fn(0))
    ref = carry_to_numpy(step_fn(carry_from_numpy(
        start, 'cpu', torch.float64))[0])
    with world_of_one(tmp_path):
        mesh = make_mesh(device='cpu')
        placed = carry_to_layout(start, mesh, 'cpu', torch.float64,
                                 shard_lon=shard_lon)
        assert carry_to_global(placed)[1]['T'].tobytes() == \
            start[1]['T'].tobytes()
        got = carry_to_global(step_fn(placed)[0])
    assert_close(got, ref, WORLD_OF_ONE_TOL)


def test_a_mesh_model_refuses_a_placed_carry(tmp_path):
    with world_of_one(tmp_path):
        mesh = make_mesh(device='cpu')
        _, init_fn, step_fn, _ = build_moist_gcm(
            dtype=torch.float64, device='cpu', mesh=mesh, **HS)
        placed = shard_model_state(mesh, *init_fn(0))
        with pytest.raises(ValueError, match='without a mesh'):
            step_fn(placed)
