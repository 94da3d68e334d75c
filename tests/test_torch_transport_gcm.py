"""build_moist_gcm's grid-space moisture modes in climt_tpu_torch
against the JAX package's, on the CPU at float64: 'fv' (conservative, the
water fixer off) and 'sl' (the fixer on grid q), 7 steps at 32x16x10 with
radiation refreshes at steps 0 and 6, and the fv carry through
climt_tpu_torch.convert.  This grid has one zonal band; the substeps are
covered at 64x32 in tests/test_torch_transport_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu.dycore.moist_gcm import build_moist_gcm as jax_build
from climt_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm as port_build

from torch_helpers import assert_carries_close, rel_err

GCM_KW = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128)


# -- build_moist_gcm --------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def fv_models():
    return (jax_build(dtype=jnp.float64, moisture_advection='fv', **GCM_KW),
            port_build(dtype=torch.float64, device='cpu',
                       moisture_advection='fv', **GCM_KW))


@pytest.mark.parametrize('mode', ['fv', 'sl'])
def test_moist_gcm_grid_moisture_seven_steps_match_jax(mode, fv_models):
    if mode == 'fv':
        (jd, j_init, _, j_run), (_, p_init, p_step, p_run) = fv_models
    else:
        jd, j_init, _, j_run = jax_build(dtype=jnp.float64,
                                         moisture_advection=mode, **GCM_KW)
        _, p_init, p_step, p_run = port_build(
            dtype=torch.float64, device='cpu', moisture_advection=mode,
            **GCM_KW)
    # the fixer is off for the conservative FV and on for SL
    assert p_step.__self__.conserve_water == (mode == 'sl')
    j_carry, j_diag = j_run(j_init(0), 7)
    p_carry, p_diag = p_run(p_init(0), 7)
    q = p_carry[1]['q']
    assert q.shape == (10, 16, 32) and not q.is_complex()
    assert float(q.min()) >= 0.0
    assert_carries_close(carry_to_numpy(p_carry), _np(j_carry), jd.sht,
                          1e-8)
    assert set(p_diag) == set(j_diag)
    for key in j_diag:
        assert rel_err(p_diag[key], j_diag[key]) < 1e-8, key


def test_fv_carry_round_trip(fv_models):
    """A JAX fv carry (real grid q) -> numpy -> port -> one port step
    equals one JAX step, and back to JAX for the next."""
    (jd, j_init, _, j_run), (_, _, p_step, _) = fv_models
    j0 = j_init(0)
    carry = carry_from_numpy(_np(j0), 'cpu', torch.float64)
    assert carry[1]['q'].dtype == torch.float64
    assert carry[1]['T'].is_complex()
    p1, _ = p_step(carry)
    j1, _ = j_run(j0, 1)
    assert_carries_close(carry_to_numpy(p1), _np(j1), jd.sht, 1e-10)
    back = jax.tree_util.tree_map(jnp.asarray, carry_to_numpy(p1))
    j2_via_port, _ = j_run(back, 1)
    j2, _ = j_run(j1, 1)
    assert_carries_close(_np(j2_via_port), _np(j2), jd.sht, 1e-10)
