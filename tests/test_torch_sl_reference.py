"""The moist GCM with semi-Lagrangian moisture against the benchmark's
plain reference (``gcmbench/reference/gcm_sl.py`` and ``sl.py``) on the
CPU at 64x32x10: the start, a refresh step and a plain step from seeded
initial states, in float64 and float32; the SL operator alone on seeded
fields; and the faults that the tolerances must catch (a skipped water
fixer, a single trajectory iteration, the arrival points).

Tolerances, each on ``l2`` (the largest ||p - r|| / ||r|| over the
fields) and ``max`` (the largest max|p - r| / max|r|):
- float64, 3e-8: the program finds a latitude's row from a fine uniform
  table refined once against the grid rows, the reference by
  ``searchsorted``; where the table lands one row off, near the poles,
  the row moves by up to 2e-7, which reads up to 6e-9 after a step (the
  rest is float64 rounding, 1e-15).
- float32, 2e-6: float32 rounding of q (one ulp is 6e-8 of it) through
  the departure points, the interpolation and the fixer's sums reads
  up to 5.2e-7 (two dozen roundings along a step).
- the operator alone on winds of tens of m/s that vary over a few grid
  lengths, float64 1e-7 and float32 1e-6: the same row lookup (up to
  1.9e-8 of max q here, where q changes steeply between polar rows) and
  rounding (3.4e-7), on one transport step.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gcmbench import compare  # noqa: E402
from gcmbench.reference.gcm_sl import MoistGCM as ReferenceGCM  # noqa: E402
from gcmbench.reference.sl import SLAdvection as ReferenceSL  # noqa: E402
from gcmbench.tools import calibrate_sl  # noqa: E402

from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm  # noqa: E402
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform  # noqa: E402
from climt_tpu_torch.ops.sl_advection import SLAdvection  # noqa: E402

SMALL = dict(nlon=64, nlat=32, nz=10, timestep=600.0, rad_every=6,
             rad_col_chunk=512)
DTYPES = {'float64': torch.float64, 'float32': torch.float32}
TOLERANCE = {'float64': 3e-8, 'float32': 2e-6}
OPERATOR_TOLERANCE = {'float64': 1e-7, 'float32': 1e-6}
SEED = 20261018


@pytest.fixture(scope='module')
def models():
    """{dtype name: (init_fn, step_fn, reference)}."""
    out = {}
    for name, dtype in DTYPES.items():
        _, init_fn, step_fn, _ = build_moist_gcm(
            device='cpu', moisture_advection='sl', dtype=dtype, **SMALL)
        reference = ReferenceGCM(device='cpu', moisture_advection='sl',
                                 dtype=dtype, **SMALL)
        out[name] = (init_fn, step_fn, reference)
    return out


@pytest.fixture(scope='module')
def windy_carry(models):
    """The float64 program's carry after five steps, when the winds of
    the adjustment from rest have grown: the input of a plain step."""
    init_fn, step_fn, _ = models['float64']
    carry = init_fn(SEED)
    for _ in range(5):
        carry, _ = step_fn(carry)
    return carry


def gaps(program, reference):
    return compare.gaps(program, reference)[:2]


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_start_refresh_and_plain_step_match_the_reference(models, dtype):
    init_fn, step_fn, reference = models[dtype]
    tol = TOLERANCE[dtype]
    carry = init_fn(SEED)
    assert max(gaps(carry, reference.init(SEED))) <= tol
    refresh = step_fn(carry)
    assert max(gaps(refresh, reference.step(carry))) <= tol
    plain = step_fn(refresh[0])
    assert max(gaps(plain, reference.step(refresh[0]))) <= tol
    assert plain[0][4] == 2


@pytest.mark.parametrize('fault', ['fixer_skipped', 'one_iteration'])
def test_faults_exceed_the_tolerance(models, windy_carry, fault):
    _, step_fn, reference = models['float64']
    expected = reference.step(windy_carry)
    assert max(gaps(step_fn(windy_carry), expected)) <= TOLERANCE['float64']
    with calibrate_sl.FAULTS[fault]():
        broken = step_fn(windy_carry)
    assert min(gaps(broken, expected)) > TOLERANCE['float64']


def seeded_flow(dtype, nz=6, nlat=32, nlon=64):
    """(mu, weights, q, dp, u, v, mdot) of a seeded flow: a smooth
    positive q and winds of tens of m/s with structure on a few grid
    lengths."""
    sht = SphericalHarmonicTransform(nlon, nlat, dtype=dtype, device='cpu')
    g = torch.Generator().manual_seed(SEED)
    mu = torch.as_tensor(sht.mu, dtype=dtype)
    lon = torch.arange(nlon, dtype=dtype) * (2 * torch.pi / nlon)
    lev = torch.arange(nz, dtype=dtype)[:, None, None]
    phase = torch.rand(4, generator=g, dtype=dtype) * 2 * torch.pi

    def wave(k, m, p):
        return torch.cos(k * lon[None, None, :] + p) * torch.sin(
            m * torch.arcsin(mu)[None, :, None] + lev)

    q = 0.01 * (1.5 + wave(3, 2, phase[0]) + 0.3 * wave(7, 5, phase[1]))
    u = 40.0 * wave(2, 1, phase[2]) + 20.0 * wave(9, 4, phase[3])
    v = 30.0 * wave(5, 3, phase[1]) + 10.0 * wave(11, 6, phase[0])
    dp = 2000.0 + 100.0 * torch.rand(nz, nlat, nlon, generator=g,
                                     dtype=dtype)
    mdot = 0.02 * torch.randn(nz - 1, nlat, nlon, generator=g, dtype=dtype)
    return sht.mu, sht.weights, q, dp, u, v, mdot


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_advect_matches_the_reference_operator(dtype):
    mu, w, q, dp, u, v, mdot = seeded_flow(DTYPES[dtype])
    program = SLAdvection(mu, w, 64, 6.371e6, 1200.0, dtype=DTYPES[dtype],
                          device='cpu')
    reference = ReferenceSL(mu, 64, 6.371e6, dtype=DTYPES[dtype],
                            device='cpu')
    expected = reference.advect(q, dp, u, v, mdot, 1200.0)
    out = program.advect(q, dp, u, v, mdot, 1200.0)
    assert max(gaps(out, expected)) <= OPERATOR_TOLERANCE[dtype]
    # a transport that moves nothing, or that stops after one iteration,
    # is far outside
    assert min(gaps(q, expected)) > 1e-2
    program.n_iter = 1
    assert min(gaps(program.advect(q, dp, u, v, mdot, 1200.0),
                    expected)) > 100 * OPERATOR_TOLERANCE[dtype]
