"""The parity tests of the replicated-spectral layout for one moisture
mode of the moist GCM, shared by tests/test_torch_parallel_layouts_*.py.

``parallel.shard_model_state`` places the carry of a port model built
without a mesh on 4 gloo ranks, on each mesh of
``torch_helpers.LAYOUTS``, and the model's own run_fn steps it
(tests/test_multichip.py:43-89 with climt_tpu replaced by
climt_tpu_torch).  At JAX's test size 32x16x8, float64, each layout's
gathered carry and diagnostics are held against the single-device port,
the JAX package's single-device model, and JAX's own shard_model_state
run on its 8 forced host devices as tests/test_multichip.py:82 runs it
(the matmul DFT, the (4, 2) mesh with shard_lon=True; compiling a JAX
model takes 15-20 s, so each file compiles one sharded run), compared in
grid space.  The ranks are spawned once per file, with every layout in
the one spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from climt_tpu.dycore.moist_gcm import build_moist_gcm as jax_build
from climt_tpu.parallel.mesh import shard_model_state as jax_shard
from climt_tpu_torch.convert import carry_to_numpy
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm as port_build

from torch_helpers import (LAYOUTS, STEP_COLLECTIVES, conservation_failures,
                           layout_name, rel_err, spawn_ranks)

RANKS = 4
# JAX's multichip test size (tests/test_multichip.py:50)
KW = dict(nlon=32, nlat=16, nz=8)
# the layout changes only the order of the Legendre and global sums:
# 1e-16 to 1e-13 of max measured on the CPU
PORT_TOL = 1e-9
# the port's float64 parity with the JAX package (test_torch_moist_gcm)
JAX_TOL = 1e-8


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# JAX's meshes of tests/test_multichip.py:60,82, by shard_lon; the moist
# GCM's files run the second
JAX_MESHES = {False: (8, 1), True: (4, 2)}


def jax_mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ('lat', 'lon'))


def assert_close(got, ref, tol, sht=None):
    """Carries (dicts, step indices) within tol of max, field by field;
    with a JAX ``sht``, spectral fields compared in grid space."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if not isinstance(r, dict):
            assert int(g) == int(r)
            continue
        assert set(g) == set(r)
        for key, b in r.items():
            a = g[key]
            if np.iscomplexobj(b) and sht is not None:
                a, b = (np.asarray(sht.synthesize(jnp.asarray(x)))
                        for x in (a, b))
            assert rel_err(a, b) < tol, (key, rel_err(a, b))


def moist_layout_tests(mode, steps, rad_every, layouts=LAYOUTS):
    """The fixtures and tests of one moisture mode on ``layouts`` ((mesh
    shape, shard_lon) pairs), by name, for a test module's globals.
    ``rad_every`` puts a second radiation refresh inside the steps (k = 0
    is the first)."""
    kw = dict(KW, rad_every=rad_every)
    names = [layout_name(layout) for layout in layouts]
    by_name = dict(zip(names, layouts))

    @pytest.fixture(scope='module')
    def ranks(tmp_path_factory):
        """Every rank's results of torch_helpers.layout_gcm_rank."""
        return spawn_ranks('layout_gcm_rank', RANKS,
                           tmp_path_factory.mktemp('layouts_' + mode), kw=kw,
                           mode=mode, steps=steps, layouts=layouts)

    @pytest.fixture(scope='module')
    def port_single():
        _, init_fn, _, run_fn = port_build(
            dtype=torch.float64, device='cpu', moisture_advection=mode, **kw)
        carry, diag = run_fn(init_fn(0), steps)
        return carry_to_numpy(carry + (diag,))

    @pytest.fixture(scope='module')
    def jax_single():
        dycore, init_fn, _, run_fn = jax_build(
            dtype=jnp.float64, moisture_advection=mode, **kw)
        carry, diag = run_fn(init_fn(0), steps)
        return dycore.sht, np_tree(carry) + (np_tree(diag),)

    @pytest.fixture(scope='module')
    def jax_sharded():
        """JAX's carry and diagnostics after its shard_model_state on
        JAX_MESHES[True] with shard_lon and its run_fn."""
        _, init_fn, _, run_fn = jax_build(
            dtype=jnp.float64, fft_impl='matmul', moisture_advection=mode,
            **kw)
        mesh = jax_mesh(JAX_MESHES[True])
        carry = jax_shard(mesh, *init_fn(0), shard_lon=True)
        with mesh:
            carry, diag = run_fn(carry, steps)
            return np_tree(carry) + (np_tree(diag),)

    @pytest.mark.parametrize('layout', names)
    def test_layout_matches_the_single_device_port(ranks, port_single,
                                                   layout):
        for out in ranks:
            assert_close(out[layout]['final'], port_single, PORT_TOL)

    @pytest.mark.parametrize('layout', names)
    def test_layout_matches_jax_f64(ranks, jax_single, layout):
        sht, ref = jax_single
        assert_close(ranks[0][layout]['final'], ref, JAX_TOL, sht)

    @pytest.mark.parametrize('layout', names)
    def test_layout_matches_jax_shard_model_state(ranks, jax_single,
                                                  jax_sharded, layout):
        assert_close(ranks[0][layout]['final'], jax_sharded, JAX_TOL,
                     jax_single[0])

    @pytest.mark.parametrize('layout', names)
    def test_every_rank_holds_the_same_spectral_state(ranks, layout):
        ref = ranks[0][layout]['spectral']
        assert ref
        for out in ranks[1:]:
            for key, value in out[layout]['spectral'].items():
                assert np.array_equal(value, ref[key]), key

    @pytest.mark.parametrize('layout', names)
    def test_one_step_makes_the_counted_collectives(ranks, layout):
        """The (transposes, halo calls, all_reduce, all_gather) of one
        step, torch_helpers.STEP_COLLECTIVES, which the card's ranks make
        too (tests/test_torch_gpu_mesh.py)."""
        kind = 'replicated_lon' if by_name[layout][1] else 'replicated'
        expected = STEP_COLLECTIVES[(kind, mode)]
        for out in ranks:
            assert out[layout]['counts']['collectives'] == expected

    tests = dict(ranks=ranks, port_single=port_single,
                 jax_single=jax_single, jax_sharded=jax_sharded,
                 test_layout_matches_the_single_device_port=(
                     test_layout_matches_the_single_device_port),
                 test_layout_matches_jax_f64=test_layout_matches_jax_f64,
                 test_layout_matches_jax_shard_model_state=(
                     test_layout_matches_jax_shard_model_state),
                 test_every_rank_holds_the_same_spectral_state=(
                     test_every_rank_holds_the_same_spectral_state),
                 test_one_step_makes_the_counted_collectives=(
                     test_one_step_makes_the_counted_collectives))

    if mode == 'fv':
        @pytest.mark.parametrize('layout', names)
        def test_fv_mass_is_conserved_on_every_rank(ranks, layout):
            failures = conservation_failures(
                fv_mass=[out[layout]['fv_mass'] for out in ranks])
            assert not failures, '\n'.join(failures)
        tests['test_fv_mass_is_conserved_on_every_rank'] = (
            test_fv_mass_is_conserved_on_every_rank)
    if mode == 'sl':
        @pytest.mark.parametrize('layout', names)
        def test_the_water_fixer_closes_on_every_rank(ranks, layout):
            failures = conservation_failures(
                water=[out[layout]['water'] for out in ranks])
            assert not failures, '\n'.join(failures)
        tests['test_the_water_fixer_closes_on_every_rank'] = (
            test_the_water_fixer_closes_on_every_rank)
    return tests
