"""The control of each kind of cell comes out not correct: the plain
reference, put in the program's place and computed in the next
precision below the configuration's, against the reference itself, at
a size a test run holds: TF32 matrix products for the GCM cells, the
gas optics' tables and weights in bfloat16 for the radiation cell.  It
needs a CUDA card (TF32 exists only there) and skips itself elsewhere;
at the cells' own sizes the same readings come from
``gcmbench/tools/calibrate.py`` (PERF.md gives them)."""

import pytest
import torch

from gcmbench import compare, harness
from gcmbench.drivers import gcm, rad
from gcmbench.reference import matmul_precision
from gcmbench.reference.gcm import MoistGCM as ReferenceGCM
from gcmbench.tools.calibrate import bf16_gas_optics

BENCH = harness.load_json(harness.ROOT, 'BENCHMARK.json')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (torch.cuda.is_available() is false)')
    return 'cuda'


@pytest.mark.gpu
@pytest.mark.parametrize('moisture,cell', [('spectral', 'gcm_t85'),
                                           ('fv', 'gcm_t85_fv'),
                                           ('spectral', 'gcm_t170_mesh4')])
def test_tf32_control_fails_a_gcm_cell(cuda, moisture, cell):
    args = dict(nlon=128, nlat=64, nz=28, timestep=600.0, rad_every=6,
                rad_col_chunk=8192, dtype=torch.float32,
                moisture_advection=moisture)
    limits = harness.load_json(harness.HERE, 'workloads',
                               cell + '.json')['limits']
    reference = ReferenceGCM(device=cuda, **args)
    carry = reference.init(11)
    for _ in range(6):
        carry, _ = reference.step(carry)
    with matmul_precision('float32'):
        refresh = reference.step(carry)
        refs = {'refresh': refresh, 'plain': reference.step(refresh[0])}
    with matmul_precision('tf32'):
        ctrl = {'refresh': reference.step(carry),
                'plain': reference.step(refresh[0])}
    found = {s: compare.gaps(ctrl[s], refs[s], gcm.state_field)
             for s in refs}
    failed = [s for s in refs for i, kind in enumerate(('l2', 'max'))
              if found[s][i] > limits['%s.%s' % (s, kind)]]
    assert failed


@pytest.mark.gpu
def test_control_fails_the_radiation_cell(cuda):
    traffic = harness.load_json(harness.HERE, 'traffic',
                                'global_slices.json')
    cell = harness.load_json(harness.HERE, 'workloads', 'rrtmg_l60.json')
    ctx = harness.Context(workload={}, config={'layers': 60,
                                               'columns': 4096,
                                               'dtype': 'float32'},
                          traffic=traffic, cell=cell, seed=2 ** 31 + 3,
                          seconds=1.0, trace=False, t_start=0.0,
                          device=cuda)
    inputs = rad.slices(ctx)[0]
    with matmul_precision('float32'):
        ref = rad.reference_pair(inputs, 4096)
        with bf16_gas_optics():
            ctrl = rad.reference_pair(inputs, 4096)
    found = rad.pair_gaps(ctrl, ref)
    assert any(v > cell['limits'][k] for k, v in found.items()), found
