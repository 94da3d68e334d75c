"""climt_tpu_torch.components.rrtmg.lw_surrogate against the JAX module.

The parameter layout, the priors and the g-point probits equal JAX's;
``build_tables`` at the prior and the calibrated theta equals JAX's and
the shipped npz to 1e-14 of max per table, keeps theta's dtype, and its
gradient with respect to theta equals ``jax.grad`` of the same scalar of
the tables.  ``save_params`` writes where ``_PARAMS_JSON`` points (a
temporary file here: no test writes under ``climt_tpu/``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climt_tpu.components.rrtmg import lw_surrogate as J
from climt_tpu_torch import data
from climt_tpu_torch.components.rrtmg import lw_surrogate as P

from torch_helpers import rel_err

THETAS = {'default': J.default_params, 'calibrated': J.load_calibrated_params}
# JAX's build_tables jitted: the same function, compiled once for the
# file instead of dispatched op by op
JAX_BUILD = jax.jit(J.build_tables)


def test_param_layout_priors_and_gpoints_equal_jax():
    assert P.param_layout() == J.param_layout()
    assert sum(n for _, n in P.param_layout()) == 805
    a, b = P.default_params(), J.default_params()
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)
    for mine, theirs in zip(P.gpoint_positions(), J.gpoint_positions()):
        assert len(mine) == len(theirs) == 16
        for x, y in zip(mine, theirs):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(P.load_calibrated_params(),
                                  J.load_calibrated_params())
    theta = torch.arange(805, dtype=torch.float64)
    assert {k: v.tolist() for k, v in P.unpack_params(theta).items()} == {
        k: np.asarray(v).tolist()
        for k, v in J.unpack_params(np.arange(805.0)).items()}


@pytest.mark.parametrize('which', sorted(THETAS))
def test_build_tables_matches_jax(which):
    theta = THETAS[which]()
    ref = JAX_BUILD(theta)
    got = P.build_tables(torch.as_tensor(theta))
    # (a jitted function returns its dict sorted; the npz test below
    # holds the order)
    assert sorted(got) == sorted(ref) and len(got) == 114
    for name, table in ref.items():
        assert got[name].dtype == torch.float64
        assert rel_err(got[name], table) <= 1e-14, name


def test_calibrated_tables_are_the_shipped_npz():
    shipped = data.load_npz(data.LW_KDIST)
    got = P.build_tables(P.load_calibrated_params())     # numpy theta
    assert list(got) == list(shipped)
    for name, table in shipped.items():
        assert tuple(got[name].shape) == table.shape
        assert rel_err(got[name], table) <= 1e-14, name


def test_build_tables_keeps_the_dtype_of_theta():
    theta = torch.as_tensor(P.default_params(), dtype=torch.float32)
    tables = P.build_tables(theta)
    ref = P.build_tables(torch.as_tensor(P.default_params()))
    for name, table in tables.items():
        assert table.dtype == torch.float32 and table.device == theta.device
        assert rel_err(table, ref[name]) <= 1e-5, name


def test_gradient_of_the_tables_matches_jax():
    """d/dtheta of sum_k <c_k, log table_k> (seeded c_k): autograd
    through build_tables against jax.grad of JAX's."""
    theta = P.load_calibrated_params()
    shapes = {k: np.shape(v) for k, v in JAX_BUILD(theta).items()}
    rng = np.random.RandomState(7)
    coef = {k: rng.randn(*s) for k, s in sorted(shapes.items())}

    def jax_scalar(th):
        tables = J.build_tables(th)
        return sum(jnp.sum(coef[k] * jnp.log(tables[k])) for k in coef)

    ref = np.asarray(jax.jit(jax.grad(jax_scalar))(jnp.asarray(theta)))
    th = torch.as_tensor(theta).requires_grad_(True)
    tables = P.build_tables(th)
    scalar = sum(torch.sum(torch.as_tensor(coef[k]) * torch.log(tables[k]))
                 for k in coef)
    got, = torch.autograd.grad(scalar, th)
    assert int((ref != 0).sum()) > 700
    assert rel_err(got, ref) <= 1e-12


def test_save_params_writes_where_the_loader_reads(tmp_path, monkeypatch):
    path = tmp_path / 'params.json'
    monkeypatch.setattr(P, '_PARAMS_JSON', str(path))
    theta = torch.as_tensor(P.default_params() + 0.25).requires_grad_(True)
    P.save_params(theta, meta={'steps': 3, 'loss': 1.5})
    np.testing.assert_array_equal(P.load_calibrated_params(),
                                  P.default_params() + 0.25)
    path.unlink()
    np.testing.assert_array_equal(P.load_calibrated_params(),
                                  P.default_params())
