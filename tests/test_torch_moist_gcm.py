"""The slice as a whole: climt_tpu_torch's fused moist GCM against the JAX
package's, built by both ``build_moist_gcm``s at 32x16x10.

7 steps cover radiation refreshes at steps 0 and 6 and, with
rad_col_chunk=128, 4 radiation column chunks.  Carry fields are compared
in grid space.  No tolerance is loosened for an Emanuel threshold: at
float64 the two models stay within 1e-10 of each other over the run.
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

KW = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def jax_model():
    return jax_build(dtype=jnp.float64, **KW)


@pytest.fixture(scope='module')
def port_model():
    return port_build(dtype=torch.float64, device='cpu', **KW)


def test_seven_steps_match_jax_f64(jax_model, port_model):
    jd, j_init, _, j_run = jax_model
    _, p_init, _, p_run = port_model
    j_carry, j_diag = j_run(j_init(0), 7)
    p_carry, p_diag = p_run(p_init(0), 7)
    assert_carries_close(carry_to_numpy(p_carry), _np(j_carry), jd.sht,
                          1e-8)
    assert set(p_diag) == set(j_diag)
    for key in j_diag:
        assert rel_err(p_diag[key], j_diag[key]) < 1e-8, key


def test_f32_port_tracks_jax_f64(jax_model):
    _, j_init, _, j_run = jax_model
    _, p_init, _, p_run = port_build(dtype=torch.float32, device='cpu', **KW)
    j_carry, _ = j_run(j_init(0), 2)
    p_carry, _ = p_run(p_init(0), 2)
    T_port = p_carry[2]['T']
    assert T_port.dtype == torch.float32 and torch.isfinite(T_port).all()
    assert np.abs(T_port.double().numpy()
                  - np.asarray(j_carry[2]['T'])).max() < 0.05   # K


def test_converter_round_trip(jax_model, port_model):
    """JAX carry -> numpy -> port -> one port step equals one JAX step;
    that port carry -> numpy -> JAX -> one JAX step equals two JAX
    steps."""
    jd, j_init, _, j_run = jax_model
    _, _, p_step, _ = port_model
    j0 = j_init(0)
    p1, _ = p_step(carry_from_numpy(_np(j0), 'cpu', torch.float64))
    j1, _ = j_run(j0, 1)
    assert_carries_close(carry_to_numpy(p1), _np(j1), jd.sht, 1e-10)

    back = jax.tree_util.tree_map(jnp.asarray, carry_to_numpy(p1))
    j2_via_port, _ = j_run(back, 1)
    j2, _ = j_run(j0, 2)
    assert_carries_close(_np(j2_via_port), _np(j2), jd.sht, 1e-10)


def test_default_device_is_the_card_and_never_the_cpu():
    """build_moist_gcm() with no device builds on CUDA; on a machine
    without a card it raises an error that names the device instead of
    building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default builds there')
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        port_build(nlon=32, nlat=16, nz=10)
