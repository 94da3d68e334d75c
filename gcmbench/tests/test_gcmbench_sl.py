"""The SL cell's own files: its driver, reference, cost and calibration
modules load no JAX and the reference nothing of the program; its counts
by hand; its reader; its driver on a program without the gather counter;
and on the CPU at a small size a sound run reads correct and a run with
each planted SL fault (``tools/calibrate_sl.FAULTS``) not correct, at
the cell's own limits.

The faults run at 32x16x10 on a seed whose check falls on the window's
first cycle, when the winds of the adjustment from rest are weakest,
except one trajectory iteration: its error grows with the wind's change
along the trajectory, and stands clear of a sound run's rounding only
some cycles in, here at 64x32x10 on the ninth (PERF.md gives its
readings on the card cycle by cycle)."""

import os
import subprocess
import sys
import time

import pytest

from gcmbench import harness
from gcmbench.costs import gcm as gcm_cost
from gcmbench.costs import gcm_sl as sl_cost
from gcmbench.drivers import gcm, gcm_sl
from gcmbench.tools import calibrate_sl

BENCH = harness.load_json(harness.ROOT, 'BENCHMARK.json')
CELL = 'gcm_t85_sl'
NEW = ['gcmbench.drivers.gcm_sl', 'gcmbench.costs.gcm_sl',
       'gcmbench.tools.calibrate_sl', 'gcmbench.reference.gcm_sl',
       'gcmbench.reference.sl']
REFERENCE = ['gcmbench.reference.gcm_sl', 'gcmbench.reference.sl']
CODE = r'''
import importlib, sys
from gcmbench import harness
for name in sys.argv[1:]:
    importlib.import_module(name)
harness.load_module('metrics', 'sl_gather_mb_per_step')
print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))
'''


def top_level_names(modules):
    out = subprocess.run([sys.executable, '-c', CODE] + modules,
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=240,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_new_modules_load_no_jax():
    names = top_level_names(NEW)
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_sl_reference_loads_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert not names & (set(harness.FORBIDDEN) | {'climt_tpu_torch'})


def test_sl_step_flops_by_hand():
    nlon, nlat, nz = 8, 4, 2
    pairs = 6                                         # truncation 2
    synthesis = 4 * pairs * nlat + 2.5 * 8 * 3 * nlat
    fv = gcm_cost.dynamics_flops(nlon, nlat, nz, 'fv')
    assert sl_cost.dynamics_flops(nlon, nlat, nz) == pytest.approx(
        fv + 2 * synthesis)
    step = sl_cost.dynamics_flops(nlon, nlat, nz) + gcm_cost.physics_flops(
        nlon, nlat, nz)
    assert sl_cost.cycle_flops(nlon, nlat, nz, 6) == pytest.approx(
        6 * step + gcm_cost.rrtmg.call_flops(nz, 32))
    assert fv < sl_cost.dynamics_flops(nlon, nlat, nz) < \
        gcm_cost.dynamics_flops(nlon, nlat, nz, 'spectral')


def test_gather_reader():
    reader = harness.load_module('metrics', 'sl_gather_mb_per_step')
    assert reader.read({'sl_gather_bytes': 6 * 293_601_280,
                        'steps': 6}) == pytest.approx(293.60128)
    assert reader.read({'sl_gather_bytes': None, 'steps': 6}) is None
    assert reader.read({'steps': 6}) is None


def test_a_program_without_the_counter_reads_none(monkeypatch):
    from climt_tpu_torch.ops.sl_advection import SLAdvection
    assert isinstance(gcm_sl.gather_bytes(), int)
    monkeypatch.delattr(SLAdvection, 'gather_bytes')
    assert gcm_sl.gather_bytes() is None


def test_fault_seeds_check_the_asked_cycles():
    seeds = calibrate_sl.seeds_for_picks(3000000001, [0, 3, 10], 180, 6)
    assert [gcm.check_cycle(s, 180, 6) for s in seeds] == [0, 3, 10]
    assert min(seeds) >= 3000000001


def small_run(size, pick):
    """``gcm_sl.run`` on the CPU at ``size`` (nlon, nlat, nz), its check
    on cycle ``pick`` of the window."""
    nlon, nlat, nz = size
    seed, = calibrate_sl.seeds_for_picks(2 ** 31, [pick], 180, 6)
    ctx = harness.cell_context(BENCH, CELL, seed, 0.3, False,
                               time.perf_counter(), device='cpu')
    ctx.config = {'build': dict(nlon=nlon, nlat=nlat, nz=nz,
                                timestep=600.0, rad_every=6,
                                rad_col_chunk=nlon * nlat // 2,
                                dtype='float32')}
    return gcm_sl.run(ctx)


SMALL = (32, 16, 10)
# where one trajectory iteration stands clear of a sound run's rounding
WIDER = (64, 32, 10)


@pytest.mark.parametrize('size,pick', [(SMALL, 0), (WIDER, 8)])
def test_sound_sl_run_is_correct(size, pick):
    result = small_run(size, pick)
    assert harness.correct_of(result.checks), result.checks
    assert result.failed == 0 and result.attempted >= 6
    # five interpolations of four gathers a step, 16 B a point in float32
    assert result.record['sl_gather_bytes'] == (
        result.attempted * 20 * size[0] * size[1] * size[2] * 16)


@pytest.mark.parametrize('fault,size,pick', [
    ('arrival_points', SMALL, 0), ('corner_dropped', SMALL, 0),
    ('fixer_skipped', SMALL, 0), ('one_iteration', WIDER, 8)])
def test_broken_sl_run_is_not_correct(fault, size, pick):
    with calibrate_sl.FAULTS[fault]():
        result = small_run(size, pick)
    assert not harness.correct_of(result.checks), result.checks
    assert result.failed >= 1
