"""The yardstick's byte and operation counts against hand counts at a
small shape, and the readers of the rooflines and shares against a
made-up trace."""

import math

import pytest

from gcmbench import harness
from gcmbench.costs import gcm, peaks, rrtmg
from gcmbench.tracing import Trace


def test_kernel_b_bytes_by_hand():
    nz, ncol, tables = 2, 3, 100
    cells = nz * ncol                                   # 6
    inputs = 2 * 6 * cells + (2 + 3 + 1) * ncol         # 72 + 18
    outputs = (2 * cells * 140 + 2 * cells * 112 + ncol * 112
               + (2 + 3 + 1) * ncol * 16)               # 1680+1344+336+288
    assert inputs == 90 and outputs == 3648
    assert rrtmg.kernel_b_bytes(nz, ncol, tables) == 4 * (90 + 3648 + 100)


def test_table_elements_are_the_data_files():
    # LW surrogate 130742, SW gas tables 96332 less the aerosol tables,
    # totplnk 181 x 16
    n = rrtmg.table_elements()
    assert 130742 + 2896 < n < 130742 + 96332 + 2896


def test_kernel_a_bytes_and_flops_by_hand():
    nz, ncol = 2, 3
    inputs = 2 * 2 * 3 * 140 + (2 + 3) * 3 * 16 + 2 * 3 * 16   # 1680+240+96
    outputs = 4 * 3 * 3
    assert rrtmg.kernel_a_bytes(nz, ncol) == 4 * (inputs + outputs)
    assert rrtmg.kernel_a_flops(nz, ncol) == 80 * 140 * 6
    assert rrtmg.call_flops(nz, ncol) == 80 * 140 * 6 + 100 * 112 * 6


def test_gcm_step_flops_by_hand():
    nlon, nlat, nz = 8, 4, 2
    m = gcm.truncation(nlon, nlat)                       # min(2, 2) = 2
    assert m == 2
    pairs = 6
    legendre = 4 * pairs * nlat * ((14 + 8) * nz + (5 + 1))
    ffts = 2.5 * 8 * 3 * nlat * ((14 + 6) * nz + (5 + 1))
    implicit = 16 * nz * nz * pairs
    assert gcm.dynamics_flops(nlon, nlat, nz, 'spectral') == pytest.approx(
        legendre + ffts + implicit)
    physics = 32 * (140 * nz + 4 * nz ** 3)
    assert gcm.physics_flops(nlon, nlat, nz) == physics
    cycle = gcm.cycle_flops(nlon, nlat, nz, 6, 'fv')
    step = gcm.dynamics_flops(nlon, nlat, nz, 'fv') + physics
    assert cycle == pytest.approx(6 * step + rrtmg.call_flops(nz, 32))
    assert gcm.dynamics_flops(nlon, nlat, nz, 'fv') < \
        gcm.dynamics_flops(nlon, nlat, nz, 'spectral')


def test_bound_takes_the_larger():
    assert peaks.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def made_up_trace():
    device = [('void mix_groups_kernel<float, 16>(x)', 0.0, 1e-3),
              ('rtrn_lw_kernel(Inputs)', 2e-3, 4e-3),
              ('Memcpy DtoD', 5e-3, 6e-3),
              ('elementwise_kernel', 5.5e-3, 7e-3)]
    host = [('aten::mul', 0.0, 9e-3), ('aten::add', 4.1e-3, 4.9e-3)]
    return Trace(device, host, 1e-2)


def test_trace_reduction():
    t = made_up_trace()
    assert t.busy_s() == pytest.approx(5e-3)
    assert len(t.kernels()) == 3
    assert [g[0] for g in t.longest_gaps()] == ['aten::mul', 'aten::add']


def test_readers_on_a_made_up_record():
    t = made_up_trace()
    rec = dict(trace=t, trace_calls=1, trace_steps=2, kernel_b_bytes=1e9,
               kernel_a_bytes=2e9, kernel_a_flops=0.0, calls=10,
               window_s=20.0, window_flops=3e12,
               refresh_s=[0.2, 0.4], plain_s=[1.0, 2.0], plain_steps=10,
               lw_s=[0.1], sw_s=[0.3, 0.1])

    def read(name):
        return harness.load_module('metrics', name).read(rec)

    assert read('kernel_b_roofline') == pytest.approx(
        100 * 1e9 / 3.35e12 / 1e-3)
    assert read('kernel_a_roofline') == pytest.approx(
        100 * 2e9 / 3.35e12 / 2e-3)
    for kind in ('gcm', 'rad', 'mesh'):
        assert read('idle_share.' + kind) == pytest.approx(50.0)
        assert read('mfu.' + kind) == pytest.approx(100 * 3e12 / 20 / 67e12)
    assert read('launches_per_step') == 1.5
    assert harness.load_module('metrics', 'mfu.mesh').read(
        dict(rec, chips=4)) == pytest.approx(100 * 3e12 / 20 / 67e12 / 4)
    assert read('step_ms.refresh') == pytest.approx(300.0)
    assert read('step_ms.plain') == pytest.approx(300.0)
    assert read('sw_call_ms') == pytest.approx(200.0)
    assert math.isclose(read('lw_call_ms'), 100.0)
