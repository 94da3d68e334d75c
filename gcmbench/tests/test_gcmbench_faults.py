"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small size, with one fault planted in the program:
a step that returns its state unchanged, half of the batch left out
(half the radiation chunks of a refresh, or half the columns of a
call), and an answer altered where it is produced.  The cells' own
limits decide; a sound run at the same size passes them."""

import time

import pytest
import torch

from gcmbench import harness
from gcmbench.drivers import gcm, rad

GCM_SMALL = {'build': dict(nlon=32, nlat=16, nz=10, timestep=600.0,
                           rad_every=6, rad_col_chunk=256,
                           dtype='float32')}
RAD_SMALL = {'layers': 20, 'columns': 128, 'dtype': 'float32'}
BENCH = harness.load_json(harness.ROOT, 'BENCHMARK.json')


def small_context(cell, config):
    ctx = harness.cell_context(BENCH, cell, 2 ** 31 + 17, 0.3, False,
                               time.perf_counter(), device='cpu')
    ctx.config = config
    if 'reference_block' in ctx.cell:
        ctx.cell = dict(ctx.cell, reference_block=config['columns'])
    return ctx


def is_correct(result):
    return harness.correct_of(result.checks)


GCM_CELLS = [w['name'] for w in BENCH['workloads']
             if harness.load_json(harness.HERE, 'workloads', w['name']
                                  + '.json')['driver'] == 'gcm']
RAD_CELLS = [w['name'] for w in BENCH['workloads']
             if harness.load_json(harness.HERE, 'workloads', w['name']
                                  + '.json')['driver'] == 'rad']


def unchanged_step(monkeypatch):
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    real = MoistGCM.step

    def step(self, carry, _=None):
        _, diag = real(self, carry)
        prev, now, grids, aux, k = carry
        return (prev, now, grids, aux, k + 1), diag
    monkeypatch.setattr(MoistGCM, 'step', step)


def half_the_chunks(monkeypatch):
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    real = MoistGCM._radiation_chunk
    calls = [0]

    def chunk(self, *args):
        out = real(self, *args)
        calls[0] += 1
        if calls[0] % 2:
            return out
        return tuple(torch.zeros_like(x) for x in out)
    monkeypatch.setattr(MoistGCM, '_radiation_chunk', chunk)


def altered_answer(monkeypatch):
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    real = MoistGCM.step

    def step(self, carry, _=None):
        (prev, now, grids, aux, k), diag = real(self, carry)
        T = grids['T'].clone()
        T[0, 3, 5] += 1.0
        return (prev, now, dict(grids, T=T), aux, k), diag
    monkeypatch.setattr(MoistGCM, 'step', step)


@pytest.mark.parametrize('cell', GCM_CELLS)
def test_sound_gcm_run_is_correct(cell):
    result = gcm.run(small_context(cell, GCM_SMALL))
    assert is_correct(result), result.checks
    assert result.failed == 0 and result.attempted >= 6


@pytest.mark.parametrize('fault', [unchanged_step, half_the_chunks,
                                   altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize('cell', GCM_CELLS)
def test_broken_gcm_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = gcm.run(small_context(cell, GCM_SMALL))
    assert not is_correct(result), result.checks
    assert result.failed >= 1


def half_the_columns(monkeypatch):
    from climt_tpu_torch.components.rrtmg import lw_spectral
    real = lw_spectral.rrtmg_lw_fluxes

    def lw(*args, **kw):
        out = real(*args, **kw)
        half = out[0].shape[1] // 2
        return tuple(torch.cat([x[:, :half], torch.zeros_like(
            x[:, half:])], dim=1) if x.dim() == 2 else x for x in out)
    monkeypatch.setattr(lw_spectral, 'rrtmg_lw_fluxes', lw)


def altered_flux(monkeypatch):
    from climt_tpu_torch.components.rrtmg import sw_spectral
    real = sw_spectral.rrtmg_sw_fluxes

    def sw(*args, **kw):
        out = list(real(*args, **kw))
        dn = out[1].clone()
        dn[:, int(torch.argmax(dn[-1]))] *= 0.9
        out[1] = dn
        return tuple(out)
    monkeypatch.setattr(sw_spectral, 'rrtmg_sw_fluxes', sw)


@pytest.mark.parametrize('cell', RAD_CELLS)
def test_sound_radiation_run_is_correct(cell):
    result = rad.run(small_context(cell, RAD_SMALL))
    assert is_correct(result), result.checks


@pytest.mark.parametrize('fault', [half_the_columns, altered_flux],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize('cell', RAD_CELLS)
def test_broken_radiation_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = rad.run(small_context(cell, RAD_SMALL))
    assert not is_correct(result), result.checks
