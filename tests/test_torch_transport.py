"""climt_tpu_torch's grid-space transport operators (ops/fv_advection.py,
ops/sl_advection.py) against the JAX package's, and the JAX property
tests of tests/test_fv_advection.py and tests/test_sl_advection.py
mirrored on the port, on the CPU.

The parity grid is 64x32 at dt_max 1200 s, where FV's zonal pass has
five latitude bands (substeps 4, 2, 1, 2, 4), so the band grouping and
the substep loop are both exercised.  Inputs come from numpy with a seed.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu.ops.fv_advection import FVAdvection as JFV
from climt_tpu.ops.sht import SphericalHarmonicTransform
from climt_tpu.ops.sl_advection import SLAdvection as JSL
from climt_tpu_torch.ops.fv_advection import FVAdvection as TFV
from climt_tpu_torch.ops.sl_advection import SLAdvection as TSL

from torch_helpers import rel_err

RADIUS = 6.371e6
# float64 parity: the same operations in the same order; measured 6e-14
# of max (FV; XLA fuses the elementwise chain) and 0 (SL)
F64_TOL = 1e-12
# the port at float32 against JAX at float64, one step: measured 2.2e-6
# (FV) and 2.7e-7 (SL) of max
F32_TOL = 2e-5


def _grid(nlat=32, nlon=64):
    sht = SphericalHarmonicTransform(nlon, nlat, dtype=jnp.float64)
    return np.asarray(sht.mu), np.asarray(sht.weights), nlon


def _fields(mu, nlon, nz=4, seed=0):
    """A blob on a moist layer, divergent winds with noise strong enough
    to flip the limiter and the upwind side, a vertical mass flux."""
    rng = np.random.RandomState(seed)
    nlat = mu.shape[0]
    lat = np.arcsin(mu)
    lon = 2 * np.pi * np.arange(nlon) / nlon
    L, F = np.meshgrid(lon, lat)
    q = 1e-3 * (1.0 + 0.8 * np.exp(
        -((F - 0.3) ** 2 / 0.08 + (L - np.pi) ** 2 / 0.3)))
    q = np.broadcast_to(q, (nz, nlat, nlon)) * (1 + 0.1 * rng.rand(nz, 1, 1))
    dp = 2000.0 + 3000.0 * rng.rand(nz, nlat, nlon)
    u = 20.0 * np.cos(F)[None] + 30.0 * rng.randn(nz, nlat, nlon)
    v = (5.0 * np.sin(2 * F) * np.cos(L))[None] + 5.0 * rng.randn(
        nz, nlat, nlon)
    mdot = 0.01 * rng.randn(nz - 1, nlat, nlon)
    return q, dp, u, v, mdot


def _t(*xs, dtype=torch.float64):
    return tuple(torch.as_tensor(np.array(x), dtype=dtype) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


OPERATORS = {'fv': (JFV, TFV), 'sl': (JSL, TSL)}


def _make(kind, mu, w, nlon, dt=1200.0, dtype=torch.float64, **kw):
    return OPERATORS[kind][1](mu, w, nlon, RADIUS, dt, dtype=dtype,
                              device='cpu', **kw)


@pytest.mark.parametrize('kind', ['fv', 'sl'])
def test_operator_matches_jax_f64(kind):
    mu, w, nlon = _grid()
    fields = _fields(mu, nlon)
    op_j = OPERATORS[kind][0](mu, w, nlon, RADIUS, 1200.0,
                              dtype=jnp.float64)
    op_t = _make(kind, mu, w, nlon)
    if kind == 'fv':
        assert len(op_t.zonal_bands) >= 3
        assert op_t.zonal_bands == op_j.zonal_bands
    for dt in (1200.0, 600.0):
        ref = op_j.advect(*_j(*fields), dt)
        out = op_t.advect(*_t(*fields), dt)
        assert out.dtype == torch.float64
        assert rel_err(out, ref) <= F64_TOL, (dt, rel_err(out, ref))


@pytest.mark.parametrize('kind', ['fv', 'sl'])
def test_operator_f32_tracks_jax_f64(kind):
    mu, w, nlon = _grid()
    fields = _fields(mu, nlon)
    ref = OPERATORS[kind][0](mu, w, nlon, RADIUS, 1200.0,
                             dtype=jnp.float64).advect(*_j(*fields), 1200.0)
    out = _make(kind, mu, w, nlon, dtype=torch.float32).advect(
        *_t(*fields, dtype=torch.float32), 1200.0)
    assert out.dtype == torch.float32
    assert rel_err(out, ref) <= F32_TOL


@pytest.mark.parametrize('kind', ['fv', 'sl'])
def test_tracer_batch_equals_one_call_per_tracer(kind):
    """A (ntr, nz, nlat, nlon) batch on one set of winds gives each
    tracer its own call's result, as JAX's vmap over tracers does."""
    mu, w, nlon = _grid()
    q, dp, u, v, mdot = _fields(mu, nlon)
    op = _make(kind, mu, w, nlon)
    rng = np.random.RandomState(5)
    batch = np.stack([q, rng.rand(*q.shape), np.full(q.shape, 0.25)])
    out = op.advect(*_t(batch, dp, u, v, mdot), 1200.0)
    assert out.shape == batch.shape
    for i in range(batch.shape[0]):
        one = op.advect(*_t(batch[i], dp, u, v, mdot), 1200.0)
        assert rel_err(out[i], one) <= 1e-14


def test_zonal_groups_pair_the_mirrored_bands():
    """At 256x128 and dt_max 1200 s (T85 under leapfrog) the zonal pass
    has 13 bands and 253 band-substeps; rows of equal substep count go
    through one loop, 127 substeps in all."""
    mu, w, nlon = _grid(nlat=128, nlon=256)
    fv = _make('fv', mu, w, nlon)
    assert len(fv.zonal_bands) == 13
    assert sum(n for _, _, n in fv.zonal_bands) == 253
    assert fv.zonal_counts == [1, 2, 4, 8, 16, 32, 64]
    assert sum(fv.zonal_counts) == 127


# -- tests/test_fv_advection.py, mirrored ----------------------------------

def _fv_case(nz=4):
    mu, w, nlon = _grid()
    rng = np.random.RandomState(0)
    nlat = mu.shape[0]
    lat = np.arcsin(mu)
    lon = 2 * np.pi * np.arange(nlon) / nlon
    L, F = np.meshgrid(lon, lat)
    q = 1e-3 * (1.0 + 0.8 * np.exp(
        -((F - 0.3) ** 2 / 0.08 + (L - np.pi) ** 2 / 0.3)))
    q = np.broadcast_to(q, (nz, nlat, nlon)) * (1 + 0.1 * rng.rand(nz, 1, 1))
    dp = np.broadcast_to(np.linspace(2000.0, 5000.0, nz)[:, None, None],
                         (nz, nlat, nlon))
    u = 20.0 * np.cos(F)[None] * np.ones((nz, 1, 1))
    v = 5.0 * (np.sin(2 * F) * np.cos(L))[None] * np.ones((nz, 1, 1))
    mdot = 0.01 * rng.randn(nz - 1, nlat, nlon)
    return (mu, w, nlon), _t(q, dp, u, v, mdot)


def test_fv_constant_field_preserved_exactly():
    (mu, w, nlon), (q, dp, u, v, mdot) = _fv_case()
    out = _make('fv', mu, w, nlon).advect(torch.full_like(q, 3.7e-4), dp,
                                          u, v, mdot, 1200.0)
    np.testing.assert_allclose(out.numpy(), 3.7e-4, rtol=1e-12)


def test_fv_total_mass_conserved_locally():
    (mu, w, nlon), (q, dp, u, v, mdot) = _fv_case()
    fv = _make('fv', mu, w, nlon)
    m0 = float(fv.total_mass(q, dp))
    qdp1, dps = fv._zonal(q, dp, u, 1200.0)
    qdp1, dps = fv._meridional(qdp1, dps, v, 1200.0)
    qdp1, dps = fv._vertical(qdp1, dps, mdot, 1200.0)
    assert abs(float(fv.total_mass(qdp1, dps)) - m0) / m0 < 1e-12
    ones = fv.advect(torch.ones_like(q), dp, u, v, mdot, 1200.0)
    assert float((ones - 1.0).abs().max()) < 1e-12


def test_fv_zonal_solid_body_translation():
    """Solid-body rotation moves a blob east by the expected angle,
    conserves mass and makes no new extrema, at Courant > 1 near the
    poles (substepped)."""
    mu, w, nlon = _grid(nlat=24, nlon=48)
    nz, nlat = 2, mu.shape[0]
    lat = np.arcsin(mu)
    lon = 2 * np.pi * np.arange(nlon) / nlon
    L, F = np.meshgrid(lon, lat)
    q = torch.as_tensor(np.broadcast_to(np.exp(-((L - np.pi) / 0.5) ** 2),
                                        (nz, nlat, nlon)).copy())
    dp = torch.full((nz, nlat, nlon), 3000.0, dtype=torch.float64)
    omega_rot = 2 * np.pi / (40 * 86400.0)
    u = torch.as_tensor(np.broadcast_to(omega_rot * RADIUS * np.cos(F),
                                        (nz, nlat, nlon)).copy())
    v = torch.zeros_like(q)
    mdot = torch.zeros((nz - 1, nlat, nlon), dtype=torch.float64)
    dt, steps = 3600.0, 30
    fv = _make('fv', mu, w, nlon, dt=dt)
    m0 = float(fv.total_mass(q, dp))
    q1 = q
    for _ in range(steps):
        q1 = fv.advect(q1, dp, u, v, mdot, dt)
    assert abs(float(fv.total_mass(q1, dp)) - m0) / m0 < 1e-11
    shift = omega_rot * steps * dt / (2 * np.pi / nlon)
    com0 = np.angle(np.sum(q[0].numpy() * np.exp(1j * L), (0, 1)))
    com1 = np.angle(np.sum(q1[0].numpy() * np.exp(1j * L), (0, 1)))
    moved = (com1 - com0) % (2 * np.pi) / (2 * np.pi / nlon)
    assert abs(moved - shift) < 0.15 * shift + 0.5
    assert float(q1.min()) >= -1e-12
    assert float(q1.max()) <= float(q.max()) + 1e-9


def test_fv_meridional_transport_moves_mass_poleward():
    mu, w, nlon = _grid()
    nz, nlat = 2, mu.shape[0]
    lat = np.arcsin(mu)
    q = torch.as_tensor(np.broadcast_to(np.exp(-(lat / 0.3) ** 2)[
        None, :, None], (nz, nlat, nlon)).copy())
    dp = torch.full_like(q, 3000.0)
    u = torch.zeros_like(q)
    v = torch.full_like(q, 5.0)                    # northward everywhere
    mdot = torch.zeros((nz - 1, nlat, nlon), dtype=torch.float64)
    q1 = _make('fv', mu, w, nlon).advect(q, dp, u, v, mdot, 1200.0)

    def com(qq):
        qq = qq[0, :, 0].numpy()
        return float((qq * lat * w).sum() / (qq * w).sum())

    assert com(q1) > com(q)
    assert float(q1.min()) >= -1e-12


def test_fv_vertical_upwind_conserves_columns():
    mu, w, nlon = _grid(nlat=8, nlon=16)
    nz, nlat = 6, mu.shape[0]
    rng = np.random.RandomState(1)
    q, dp, mdot = _t(rng.rand(nz, nlat, nlon),
                     1000.0 + 500.0 * rng.rand(nz, nlat, nlon),
                     0.05 * rng.randn(nz - 1, nlat, nlon))
    Q1, dp1 = _make('fv', mu, w, nlon)._vertical(q, dp, mdot, 1200.0)
    np.testing.assert_allclose((Q1 * dp1).sum(0).numpy(),
                               (q * dp).sum(0).numpy(), rtol=1e-12)


# -- tests/test_sl_advection.py, mirrored ----------------------------------

def _blob(mu, nlon, nz=3):
    lat = np.arcsin(mu)
    lon = 2 * np.pi * np.arange(nlon) / nlon
    L, F = np.meshgrid(lon, lat)
    q = np.exp(-((F - 0.2) ** 2 / 0.05 + (L - np.pi) ** 2 / 0.2))
    return torch.as_tensor(np.broadcast_to(q, (nz,) + q.shape).copy())


def _zonal_wind(mu, like, speed):
    """u = speed cos(phi) on ``like``'s shape."""
    return torch.as_tensor(speed * np.sqrt(1 - mu ** 2))[:, None] \
        * torch.ones_like(like)


def _still(q):
    return (torch.zeros_like(q),
            torch.zeros((q.shape[0] - 1,) + q.shape[1:], dtype=q.dtype))


def test_sl_constant_field_preserved_exactly():
    mu, w, nlon = _grid()
    q = torch.full((3, mu.shape[0], nlon), 4.2e-4, dtype=torch.float64)
    dp = torch.full_like(q, 3000.0)
    v = torch.full_like(q, 4.0)
    mdot = torch.full((2, mu.shape[0], nlon), 0.01, dtype=torch.float64)
    out = _make('sl', mu, w, nlon).advect(q, dp, _zonal_wind(mu, q, 35.0),
                                          v, mdot, 1200.0)
    np.testing.assert_allclose(out.numpy(), 4.2e-4, rtol=1e-12)


def test_sl_integer_zonal_shift_is_exact():
    mu, w, nlon = _grid()
    q = _blob(mu, nlon)
    dt, n_cells = 1800.0, 2
    U = n_cells * (2 * np.pi / nlon) * RADIUS / dt
    v, mdot = _still(q)
    out = _make('sl', mu, w, nlon).advect(q, torch.full_like(q, 3000.0),
                                          _zonal_wind(mu, q, U), v, mdot, dt)
    np.testing.assert_allclose(out.numpy(),
                               torch.roll(q, n_cells, -1).numpy(), atol=1e-12)


def test_sl_large_courant_number_stable():
    mu, w, nlon = _grid()
    q = _blob(mu, nlon)
    v, mdot = _still(q)
    sl = _make('sl', mu, w, nlon)
    out = q
    for _ in range(10):
        out = sl.advect(out, torch.full_like(q, 3000.0),
                        _zonal_wind(mu, q, 90.0), v, mdot, 3600.0)
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= -1e-12
    assert float(out.max()) <= float(q.max()) + 1e-12


def test_sl_monotone_no_new_extrema():
    mu, w, nlon = _grid()
    q = torch.as_tensor(np.random.RandomState(3).rand(2, mu.shape[0], nlon))
    mdot = torch.zeros((1, mu.shape[0], nlon), dtype=torch.float64)
    out = _make('sl', mu, w, nlon).advect(
        q, torch.full_like(q, 3000.0), _zonal_wind(mu, q, 25.0),
        torch.full_like(q, 6.0), mdot, 1800.0)
    assert float(out.min()) >= float(q.min()) - 1e-12
    assert float(out.max()) <= float(q.max()) + 1e-12


def test_sl_trajectory_iteration_tracks_rotation():
    """One full solid-body revolution returns the blob's peak to its
    cell with only the bilinear scheme's diffusive loss (nz = 1: no
    vertical faces)."""
    mu, w, nlon = _grid(nlat=24, nlon=48)
    q = _blob(mu, nlon, nz=1)
    n_steps, dt = 48, 1800.0
    omega = 2 * np.pi / (n_steps * dt)
    v, mdot = _still(q)
    sl = _make('sl', mu, w, nlon)
    out = q
    for _ in range(n_steps):
        out = sl.advect(out, torch.full_like(q, 3000.0),
                        _zonal_wind(mu, q, omega * RADIUS), v, mdot, dt)
    q0, out = q.numpy(), out.numpy()
    p0 = np.unravel_index(np.argmax(q0[0]), q0[0].shape)
    p1 = np.unravel_index(np.argmax(out[0]), out[0].shape)
    dlon = min(abs(p1[1] - p0[1]), nlon - abs(p1[1] - p0[1]))
    assert dlon <= 1 and abs(p1[0] - p0[0]) <= 1
    assert out.max() > 0.35 * q0.max()


@pytest.mark.parametrize('kind', ['fv', 'sl'])
def test_operator_defaults_to_the_card(kind, monkeypatch):
    """Built with no device, FVAdvection and SLAdvection compute on
    'cuda', and without a card they raise rather than fall back to the
    CPU, as every other entry point of the port does."""
    mu, w, nlon = _grid(16, 32)
    cls = OPERATORS[kind][1]
    assert inspect.signature(cls).parameters['device'].default == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cls(mu, w, nlon, RADIUS, 1200.0)
