"""The semi-Lagrangian transport's span and counters on the CPU: its
``climt.transport`` span inside ``climt.dynamics`` in a profiled step of
the moist GCM with SL moisture (32x16x10, the model of
tests/test_torch_spans.py), and ``SLAdvection.gathers`` and
``.gather_bytes``: four gathers of n points per bilinear interpolation,
each n (2 itemsize + 8) bytes, five interpolations a step (u and v at
the midpoint of each of two iterations, then q)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
from climt_tpu_torch.ops.sl_advection import SLAdvection

KW = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128)


def spans_of(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith('climt.')]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def counted(fn):
    """(gathers, bytes) that ``fn`` adds to the class's counters."""
    before = SLAdvection.gathers, SLAdvection.gather_bytes
    fn()
    return (SLAdvection.gathers - before[0],
            SLAdvection.gather_bytes - before[1])


@pytest.fixture(scope='module')
def sl_model():
    _, init_fn, step_fn, _ = build_moist_gcm(
        dtype=torch.float32, device='cpu', moisture_advection='sl', **KW)
    return init_fn, step_fn


@pytest.mark.parametrize('k', [0, 1], ids=['refresh', 'plain'])
def test_transport_span_encloses_the_sl_advect_inside_dynamics(sl_model,
                                                                k):
    init_fn, step_fn = sl_model
    carry = init_fn(0)
    for _ in range(k):
        carry, _ = step_fn(carry)
    spans = spans_of(lambda: step_fn(carry))
    dynamics, = named(spans, 'climt.dynamics')
    transport, = named(spans, 'climt.transport')
    fixer, = named(spans, 'climt.fixer')
    assert inside(transport, dynamics)
    assert fixer[1] >= dynamics[2]


@pytest.mark.parametrize('dtype,itemsize', [(torch.float32, 4),
                                            (torch.float64, 8)])
def test_a_gcm_step_counts_twenty_gathers(dtype, itemsize):
    _, init_fn, step_fn, _ = build_moist_gcm(
        dtype=dtype, device='cpu', moisture_advection='sl', **KW)
    carry = init_fn(0)
    points = 10 * 16 * 32
    gathers, nbytes = counted(lambda: step_fn(carry))
    assert gathers == 20
    assert nbytes == 20 * points * (2 * itemsize + 8)


def test_a_t85_advect_moves_the_stated_bytes():
    """20 gathers x 917,504 points x 16 B = 293,601,280 B at T85 in
    float32: the number ``sl_gather_mb_per_step`` reads per step."""
    nlon, nlat, nz = 256, 128, 28
    sht = SphericalHarmonicTransform(nlon, nlat, dtype=torch.float32,
                                     device='cpu')
    op = SLAdvection(sht.mu, sht.weights, nlon, 6.371e6, 1200.0,
                     dtype=torch.float32, device='cpu')
    shape = (nz, nlat, nlon)
    q = torch.full(shape, 1e-3)
    wind = torch.full(shape, 10.0)
    gathers, nbytes = counted(lambda: op.advect(
        q, torch.full(shape, 3000.0), wind, wind,
        torch.zeros((nz - 1, nlat, nlon)), 1200.0))
    assert gathers == 20
    assert nbytes == 293_601_280


def test_counters_are_shared_by_every_operator():
    sht = SphericalHarmonicTransform(32, 16, dtype=torch.float64,
                                     device='cpu')
    ops = [SLAdvection(sht.mu, sht.weights, 32, 6.371e6, 1200.0,
                       dtype=torch.float64, device='cpu') for _ in range(2)]
    shape = (3, 16, 32)
    x = torch.ones(shape, dtype=torch.float64)

    def both():
        for op in ops:
            op.advect(x, x, x, x, torch.zeros((2, 16, 32),
                                              dtype=torch.float64), 600.0)
    assert counted(both) == (40, 40 * 3 * 16 * 32 * 24)
