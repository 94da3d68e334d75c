"""climt_tpu_torch.entry_points against the repository's entry points
(__graft_entry__.py), on the CPU.

``entry(device='cpu')``'s step runs on JAX's ``entry()`` carry, carried
across as numpy, and both temperatures are compared in grid space.
``dryrun_multichip(4, device='cpu')`` runs on 4 spawned gloo ranks (once
for the file), and its single-device reference is held against JAX's
``_build(32, 16, 8, fft_impl='matmul')`` step from JAX's carry.  Both use
__graft_entry__.py's float32 limits.  The JAX models are jitted, as a
caller of ``entry()`` jits ``fn``.
"""

import importlib.util
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from climt_tpu_torch import entry_points
from climt_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform

import torch_helpers  # noqa: F401  (one torch thread per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4


def _graft():
    spec = importlib.util.spec_from_file_location(
        'graft_entry', os.path.join(ROOT, '__graft_entry__.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _synthesizer(nlon, nlat):
    """Spectral numpy array -> grid numpy array, one float64 transform
    for both packages' fields."""
    sht = SphericalHarmonicTransform(nlon, nlat, dtype=torch.float64,
                                     device='cpu')
    return lambda spec: sht.synthesize(
        torch.as_tensor(np.array(spec), dtype=torch.complex128)).numpy()


def _of_limit(a, b, tol):
    return float(np.max(np.abs(a - b) / (tol['atol'] + tol['rtol']
                                          * np.abs(b))))


@pytest.fixture(scope='module')
def graft():
    return _graft()


def test_entry_step_matches_jax_entry(graft):
    """JAX's fn (jitted) and the port's fn on JAX's initial carry: the
    spectral temperature of JAX's shape, complex64 (the float32 model's;
    JAX's comes out complex128 under the tests' x64 mode), in grid space
    within rtol 2e-4, atol 1e-5 (__graft_entry__.py:101)."""
    j_fn, (j_carry,) = graft.entry()
    ref = np.asarray(jax.jit(j_fn)(j_carry))
    fn, (carry,) = entry_points.entry(device='cpu')
    assert carry[1]['T'].device.type == 'cpu'
    got = fn(carry_from_numpy(_np(j_carry), 'cpu', torch.float32))
    assert got.device.type == 'cpu'
    assert tuple(got.shape) == ref.shape
    assert got.dtype == torch.complex64
    synthesize = _synthesizer(32, 16)
    a, b = synthesize(got.numpy()), synthesize(ref)
    assert np.isfinite(a).all()
    assert _of_limit(a, b, entry_points.FIELD_TOL) <= 1.0


@pytest.fixture(scope='module')
def reference_steps(graft):
    """(JAX's one step, the port's one step from JAX's initial carry) of
    the single-device model of dryrun_multichip(4), as numpy carries."""
    _, j_init, j_step, _ = graft._build(32, 16, 8, fft_impl='matmul')
    j0 = j_init()
    j1 = jax.jit(lambda c: j_step(c, None)[0])(j0)
    _, _, step_fn, _ = entry_points._build(32, 16, 8, fft_impl='matmul',
                                           device='cpu')
    p1 = step_fn(carry_from_numpy(_np(j0), 'cpu', torch.float32))[0]
    return _np(j1), carry_to_numpy(p1)


def test_dryrun_reference_matches_jax(reference_steps):
    """The port's single-device reference of dryrun_multichip(4) against
    JAX's, under the check's own limits."""
    ref, got = reference_steps
    errors = entry_points.compare_steps(ref, got, _synthesizer(32, 16))
    assert set(errors) == set(entry_points.FIELDS) | {
        'aux ' + k for k in ref[3]}


@pytest.fixture(scope='module')
def dryrun():
    return entry_points.dryrun_multichip(RANKS, device='cpu')


def test_dryrun_multichip_on_four_gloo_ranks(dryrun):
    """One m-sharded step on a (4, 1) mesh at 32x16x8 against one device:
    every field under its limit, and the limits are JAX's."""
    assert {k for k in dryrun if not k.startswith('aux ')} == set(
        entry_points.FIELDS)
    assert {'aux olr', 'aux hr_rad', 'aux Ts'} <= set(dryrun)
    for name, err in dryrun.items():
        tol = (entry_points.AUX_TOL if name.startswith('aux ')
               else entry_points.FIELD_TOL)
        assert (err['rtol'], err['atol']) == (tol['rtol'], tol['atol'])
        assert 0.0 <= err['of_limit'] <= 1.0, (name, err)
    assert entry_points.FIELD_TOL == dict(rtol=2e-4, atol=1e-5)
    assert entry_points.AUX_TOL == dict(rtol=5e-4, atol=5e-3)


@pytest.mark.parametrize('field', ['T', 'q', 'lnps', 'aux olr', 'k'])
def test_the_limits_bite(reference_steps, field):
    """A carry with one field moved by 10 times its limit (a uniform
    shift in grid space: the (0, 0) coefficient) fails the comparison."""
    _, ref = reference_steps
    sht = SphericalHarmonicTransform(32, 16, dtype=torch.float64,
                                     device='cpu')
    synthesize = _synthesizer(32, 16)
    out = tuple(dict(part) if isinstance(part, dict) else part
                for part in ref)
    if field == 'k':
        out = out[:4] + (out[4] + 1,)
    elif field.startswith('aux '):
        name, tol = field[4:], entry_points.AUX_TOL
        b = out[3][name]
        out[3][name] = b + 10 * (tol['atol'] + tol['rtol'] * np.abs(b))
    else:
        tol = entry_points.FIELD_TOL
        grid = synthesize(ref[1][field])
        shift = np.full(grid.shape, 10 * (tol['atol'] + tol['rtol']
                                          * np.abs(grid).max()))
        out[1][field] = ref[1][field] + sht.analyze(
            torch.as_tensor(shift)).numpy().astype(ref[1][field].dtype)
    with pytest.raises(AssertionError, match='m-sharded vs single'):
        entry_points.compare_steps(ref, out, synthesize)


def test_cuda_without_cards_raises_and_starts_nothing(monkeypatch):
    """The default device is the card: without enough cards
    dryrun_multichip raises before any rank starts, and entry() raises
    instead of building on the CPU."""
    if torch.cuda.device_count() >= 2:
        pytest.skip('two CUDA cards are present: the default runs there')

    def no_run(*args, **kwargs):
        raise AssertionError('a rank was started')

    monkeypatch.setattr(multiprocessing, 'get_context', no_run)
    monkeypatch.setattr(entry_points, '_dryrun_rank', no_run)
    with pytest.raises(RuntimeError, match='needs 2 CUDA cards'):
        entry_points.dryrun_multichip(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            entry_points.entry()
