"""The frozen plain reference against the program on the CPU, where the
program takes its own plain versions of kernels A and B: the moist GCM
at 32x16x10 with spectral and FV moisture from one seed over two
radiation cycles, and the radiation calls on a slice of drawn columns.
Both sides run the same arithmetic here, so they agree exactly."""

import json
import os

import pytest
import torch

from gcmbench import compare, harness
from gcmbench.drivers import gcm, rad
from gcmbench.reference.gcm import MoistGCM as ReferenceGCM

SMALL = dict(nlon=32, nlat=16, nz=10, timestep=600.0, rad_every=6,
             rad_col_chunk=256, dtype=torch.float32)


@pytest.mark.parametrize('moisture', ['spectral', 'fv'])
def test_reference_gcm_steps_as_the_program(moisture):
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    _, init_fn, step_fn, _ = build_moist_gcm(
        device='cpu', moisture_advection=moisture, **SMALL)
    reference = ReferenceGCM(device='cpu', moisture_advection=moisture,
                             **SMALL)
    seed = gcm.init_seed(2 ** 31 + 99)
    mine, ref = init_fn(seed), reference.init(seed)
    assert compare.gaps(mine, ref)[:2] == (0.0, 0.0)
    for _ in range(12):
        mine_out, ref_out = step_fn(mine), reference.step(mine)
        assert compare.gaps(mine_out, ref_out)[:2] == (0.0, 0.0)
        mine = mine_out[0]
    assert mine[4] == 12


def test_reference_radiation_as_the_program():
    traffic = harness.load_json(harness.HERE, 'traffic',
                                'global_slices.json')
    ctx = harness.Context(workload={}, config={'layers': 20, 'columns': 96,
                                               'dtype': 'float32'},
                          traffic=traffic, cell={}, seed=2 ** 31 + 5,
                          seconds=1.0, trace=False, t_start=0.0,
                          device='cpu')
    data = rad.slices(ctx)
    assert len(data) == traffic['slices']
    day = data[0][10]
    assert 0 < int(day.sum()) < day.numel()
    out = rad.pair(data[1])
    assert compare.gaps(out, rad.reference_pair(data[1], 96))[:2] == (
        0.0, 0.0)
    # in blocks of columns only the float32 rounding of the g-point sums
    # moves
    assert max(compare.gaps(out, rad.reference_pair(data[1], 40))[:2]) \
        < 1e-5
    assert float(out['lw_up'].min()) > 50.0


def test_compare_reads_each_gap():
    a = {'x': torch.tensor([1.0, 2.0]), 'k': 3,
         'z': torch.tensor([1 + 1j, 0j])}
    b = {'x': torch.tensor([1.0, 2.5]), 'k': 3,
         'z': torch.tensor([1 + 1j, 0j])}
    l2, mx, worst = compare.gaps(b, a)
    assert worst == '/x'
    assert l2 == pytest.approx(0.5 / 5 ** 0.5)
    assert mx == pytest.approx(0.25)
    assert compare.gaps(dict(a, k=4), a)[0] == float('inf')
    nan = dict(a, x=torch.tensor([float('nan'), 2.0]))
    assert compare.gaps(nan, a)[1] == float('inf')
