"""climt_tpu_torch's simple physics and Emanuel convection against the
JAX package at float64, on the columns of the moist GCM's state at
32x16x10: its initial state, and the state 6 steps later, when the
convective mass flux memory is non-zero.  Then what the CPU can check of
the convection kernel's wrapper: CPU tensors take the plain version, and
the launcher's refusals, which come before any launch.  The kernel itself
is held to the plain version on a card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu.components.emanuel_convection import (
    emanuel_convect as j_emanuel)
from climt_tpu.components.simple_physics import (
    simple_physics_step as j_simple)
from climt_tpu.core.util import bolton_q_sat
from climt_tpu_torch.components import emanuel_convection as E
from climt_tpu_torch.components.emanuel_convection import (
    emanuel_convect as t_emanuel)
from climt_tpu_torch.components.simple_physics import (
    simple_physics_step as t_simple)
from climt_tpu_torch.convert import carry_to_numpy
from climt_tpu_torch.dycore.moist_gcm import EMANUEL_PARAMS, build_moist_gcm

from torch_helpers import rel_err, to_torch

NZ = 10
DT = 600.0
SIMPLE_CONSTS = (9.80665, 1004.64, 287.0, 461.5, 2.5e6, 1000.0,
                 85000.0, 20000.0, 0.0011, 0.0007, 0.000065, 0.002)


@pytest.fixture(scope='module', params=[0, 6], ids=['initial', 'step6'])
def columns(request):
    """(nz, ncol) bottom-up columns of the GCM state, float64 numpy."""
    _, init_fn, _, run_fn = build_moist_gcm(
        nlon=32, nlat=16, nz=NZ, dtype=torch.float64, device='cpu',
        rad_col_chunk=128)
    carry = init_fn(0)
    if request.param:
        carry, _ = run_fn(carry, request.param)
    _, _, grids, aux, _ = carry_to_numpy(carry)

    def cols(x):
        return x.reshape(x.shape[0], -1)[::-1].copy()

    p_half = cols(grids['p_half'])
    return dict(u=cols(grids['u']), v=cols(grids['v']), T=cols(grids['T']),
                q=np.clip(cols(grids['q']), 0.0, None),
                ps=grids['ps'].reshape(-1), p_half=p_half,
                p_mid=0.5 * (p_half[1:] + p_half[:-1]),
                Ts=aux['Ts'].reshape(-1), cbmf=aux['cbmf'].reshape(-1))


def test_simple_physics_matches_jax(columns):
    c = columns
    names = ('T', 'q', 'u', 'v', 'p_mid', 'p_half', 'ps', 'Ts')
    flags = (True, True, True, False)
    ref = j_simple(*[jnp.asarray(c[k]) for k in names],
                   jnp.zeros_like(jnp.asarray(c['ps'])), DT,
                   *SIMPLE_CONSTS, *flags)
    out = t_simple(*[to_torch(c[k]) for k in names],
                   torch.zeros(c['ps'].shape, dtype=torch.float64), DT,
                   *SIMPLE_CONSTS, *flags)
    # T, q, u, v, precipitation, sensible, latent
    for a, b in zip(out, ref):
        if np.abs(np.asarray(b)).max() > 0:
            assert rel_err(a, b) < 1e-10
        else:
            assert float(a.abs().max()) == 0.0


def test_emanuel_matches_jax(columns):
    c = columns
    qs = np.asarray(bolton_q_sat(jnp.asarray(c['T']),
                                 jnp.asarray(c['p_mid']), 287.0, 461.5))
    args = [c['T'].T, c['q'].T, qs.T, c['u'].T, c['v'].T,
            (c['p_mid'] / 100.0).T, (c['p_half'] / 100.0).T]
    ref = j_emanuel(*[jnp.asarray(a) for a in args],
                    jnp.asarray(c['cbmf']), DT, NZ - 3, EMANUEL_PARAMS)
    out = t_emanuel(*[to_torch(a) for a in args], to_torch(c['cbmf']), DT,
                    NZ - 3, EMANUEL_PARAMS)
    # the comparison has teeth only if some columns convect
    assert int((np.asarray(ref['iflag']) > 0).sum()) > 0
    np.testing.assert_array_equal(out['iflag'].numpy(),
                                  np.asarray(ref['iflag']))
    for key in ('ft', 'fq', 'fu', 'fv', 'precip', 'wd', 'tprime', 'qprime',
                'cbmf', 'cape'):
        a, b = out[key], ref[key]
        if np.abs(np.asarray(b)).max() > 0:
            assert rel_err(a, b) < 1e-10, key
        else:
            assert float(a.abs().max()) == 0.0, key


def test_emanuel_cpu_tensors_take_the_plain_version(columns):
    """On CPU tensors emanuel_convect is emanuel_convect_plain, bit for
    bit, for the GCM's transposed (nz, ncol) fields as for contiguous
    ones, and the kernel's launch counter does not move."""
    c = columns
    qs = np.asarray(bolton_q_sat(jnp.asarray(c['T']),
                                 jnp.asarray(c['p_mid']), 287.0, 461.5))
    fields = [to_torch(c[k]) for k in ('T', 'q')] + [to_torch(qs)] + [
        to_torch(c[k]) for k in ('u', 'v')] + [
        to_torch(c['p_mid']) / 100.0, to_torch(c['p_half']) / 100.0]
    before = E.emanuel_convect_cuda.launches
    for args in ([x.T for x in fields], [x.T.contiguous() for x in fields]):
        out = t_emanuel(*args, to_torch(c['cbmf']), DT, NZ - 3,
                        EMANUEL_PARAMS)
        ref = E.emanuel_convect_plain(*args, to_torch(c['cbmf']), DT,
                                      NZ - 3, EMANUEL_PARAMS)
        assert out.keys() == ref.keys()
        for key in out:
            assert torch.equal(out[key], ref[key]), key
    assert E.emanuel_convect_cuda.launches == before


def _kernel_args(ncol=6, nz=10, dtype=torch.float64, nl=None):
    """Well-shaped CPU arguments of emanuel_convect_cuda."""
    def col(*shape):
        return torch.ones(shape, dtype=dtype)
    p_half = torch.linspace(1000.0, 10.0, nz + 1, dtype=dtype).expand(
        ncol, nz + 1)
    return [280.0 * col(ncol, nz), 0.01 * col(ncol, nz),
            0.012 * col(ncol, nz), col(ncol, nz), col(ncol, nz),
            0.5 * (p_half[:, 1:] + p_half[:, :-1]), p_half,
            torch.zeros(ncol, dtype=dtype), DT,
            nz - 3 if nl is None else nl, EMANUEL_PARAMS]


def _refused(args, error):
    before = E.emanuel_convect_cuda.launches
    with pytest.raises(error):
        E.emanuel_convect_cuda(*args)
    assert E.emanuel_convect_cuda.launches == before


@pytest.mark.parametrize('dtype', [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_emanuel_kernel_refuses_other_dtypes(dtype):
    _refused(_kernel_args(dtype=dtype), TypeError)


def test_emanuel_kernel_refuses_mixed_dtypes():
    args = _kernel_args()
    args[7] = args[7].float()
    _refused(args, TypeError)


@pytest.mark.parametrize('nz', [3, E.MAX_NZ + 1, 60])
def test_emanuel_kernel_refuses_level_counts_it_cannot_hold(nz):
    """A column's levels are one lane each of a warp: at most MAX_NZ."""
    _refused(_kernel_args(nz=nz, nl=1), ValueError)


@pytest.mark.parametrize('nl', [0, 10])
def test_emanuel_kernel_refuses_nl_outside_the_column(nl):
    _refused(_kernel_args(nz=10, nl=nl), ValueError)


def test_emanuel_kernel_refuses_a_wrong_shape():
    args = _kernel_args()
    args[6] = args[6][:, 1:]
    _refused(args, ValueError)


def test_emanuel_kernel_refuses_inputs_that_require_grad():
    """The kernel has no backward: with grad mode on, an input that
    requires grad raises rather than give a result without a gradient;
    with grad mode off the next check (the device) refuses instead."""
    args = _kernel_args()
    args[0] = args[0].clone().requires_grad_()
    _refused(args, NotImplementedError)
    with torch.no_grad():
        _refused(args, ValueError)


def test_emanuel_kernel_refuses_cpu_tensors():
    """Well-formed CPU arguments reach the device check: the launcher
    takes CUDA tensors only, and emanuel_convect gives CPU tensors to the
    plain version."""
    _refused(_kernel_args(), ValueError)
