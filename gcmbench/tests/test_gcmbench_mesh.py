"""The four-card driver rehearsed on four gloo ranks of the CPU at a
small size: a sound run is correct, and runs with a fault planted in
every rank are not: the transposes leave out the exchange between ranks
(each keeps its own chunks), a step returns its state unchanged, half
of each rank's radiation chunks are left out, or a step's answer is
altered where it is produced (one grid temperature zeroed).  The card's NCCL run is the
cell itself."""

import time

import pytest
import torch

from gcmbench import harness
from gcmbench.drivers import mesh

SMALL = {'build': dict(nlon=32, nlat=16, nz=10, timestep=300.0,
                       rad_every=12, rad_col_chunk=64, dtype='float32')}


def context():
    return harness.Context(
        workload={'name': 'gcm_t170_mesh4', 'chips': 4}, config=SMALL,
        traffic=harness.load_json(harness.HERE, 'traffic',
                                  'spectral_moisture.json'),
        cell=harness.load_json(harness.HERE, 'workloads',
                               'gcm_t170_mesh4.json'),
        seed=2 ** 31 + 77, seconds=0.5, trace=False,
        t_start=time.perf_counter(), device='cpu')


def rank_without_exchange(rank, world, ctx):
    """A rank whose all-to-all transposes hand nothing over."""
    from climt_tpu_torch.parallel import dist_sht

    def no_exchange(x, group):
        return x.contiguous()
    no_exchange.calls = no_exchange.bytes = 0
    dist_sht.transpose = no_exchange
    return mesh_rank_main(rank, world, ctx)


def rank_with_altered_answer(rank, world, ctx):
    """A rank whose steps zero one grid temperature of their output."""
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    real = MoistGCM.step

    def step(self, carry, _=None):
        (prev, now, grids, aux, k), diag = real(self, carry)
        T = grids['T'].clone()
        T[0, 1, 5] = 0.0
        return (prev, now, dict(grids, T=T), aux, k), diag
    MoistGCM.step = step
    return mesh_rank_main(rank, world, ctx)


def rank_with_unchanged_state(rank, world, ctx):
    """A rank whose steps hand back the state they were given."""
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    real = MoistGCM.step

    def step(self, carry, _=None):
        _, diag = real(self, carry)
        prev, now, grids, aux, k = carry
        return (prev, now, grids, aux, k + 1), diag
    MoistGCM.step = step
    return mesh_rank_main(rank, world, ctx)


def rank_with_half_the_chunks(rank, world, ctx):
    """A rank whose refresh leaves every second radiation chunk at 0."""
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    real = MoistGCM._radiation_chunk
    calls = [0]

    def chunk(self, *args):
        out = real(self, *args)
        calls[0] += 1
        return out if calls[0] % 2 else tuple(
            torch.zeros_like(x) for x in out)
    MoistGCM._radiation_chunk = chunk
    return mesh_rank_main(rank, world, ctx)


def load_stub_jax_package():
    """Put a module whose top-level name is the JAX package's into this
    process, as an import of it would."""
    import sys
    import types
    sys.modules['climt_tpu'] = types.ModuleType('climt_tpu')


def last_rank_loading_as_it_gathers(rank, world, ctx):
    """The last rank loads the JAX package's name as it gathers its
    states, after its window."""
    real = mesh.gathered

    def gathered(*args):
        if rank == world - 1:
            load_stub_jax_package()
        return real(*args)
    mesh.gathered = gathered
    return mesh_rank_main(rank, world, ctx)


def rank0_loading_in_the_reference(rank, world, ctx):
    """Rank 0 loads the JAX package's name as the reference runs."""
    real = mesh.gcm.stage_outputs

    def stage_outputs(*args):
        load_stub_jax_package()
        return real(*args)
    mesh.gcm.stage_outputs = stage_outputs
    return mesh_rank_main(rank, world, ctx)


mesh_rank_main = mesh.rank_main


def test_sound_mesh_run_is_correct():
    result = mesh.run(context())
    assert harness.correct_of(result.checks), result.checks
    assert result.device['count'] == 4
    assert result.record['collective_bytes']['transpose'] > 0


@pytest.mark.parametrize('fault', [rank_without_exchange,
                                   rank_with_unchanged_state,
                                   rank_with_half_the_chunks,
                                   rank_with_altered_answer],
                         ids=lambda f: f.__name__)
def test_broken_mesh_run_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(mesh, 'rank_main', fault)
    result = mesh.run(context())
    assert not harness.correct_of(result.checks), result.checks


@pytest.mark.parametrize('loader', [last_rank_loading_as_it_gathers,
                                    rank0_loading_in_the_reference],
                         ids=lambda f: f.__name__)
def test_a_rank_that_loads_jax_after_its_window_fails_the_run(
        loader, monkeypatch):
    monkeypatch.setattr(mesh, 'rank_main', loader)
    with pytest.raises(RuntimeError, match='a rank loaded climt_tpu'):
        mesh.run(context())
