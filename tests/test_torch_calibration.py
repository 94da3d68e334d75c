"""The LW k-table calibration of climt_tpu_torch against the JAX package,
on the CPU at float64.

The loss is the one tools/calibrate_lw_ktables.py:169-215 writes, on one
training case (TestRRTMGLongwave's nz=30 column with targets drawn from a
seed), the two tropical anchors and the prior.  JAX's side is written
out here as the tool writes it, its gradient taken by the chain rule
through one jitted LW value-and-vector-Jacobian function (one compile
serves the three nz=30 calls, where the tool's jit of the whole loss
compiles each); the port's is
``climt_tpu_torch.tools.calibrate_lw_ktables.loss_fn``.

- the tool's inputs (``case_inputs``, ``tropical_inputs``) equal those
  JAX's components gather (1e-14);
- the loss and its gradient with respect to theta equal JAX's
  ``jax.value_and_grad`` (1e-10 and 1e-8 of max), and three Adam steps
  give JAX's theta (1e-8);
- the gradient of the LW taumol outputs with respect to the tables dict
  equals ``jax.grad``'s (1e-12 of max);
- kernel B's plain backward (``mix_groups_bwd_plain``) equals autograd of
  its plain forward on ragged bands (1e-12 of max in float64, 1e-5 in
  float32);
- a layout packed from tables that require grad is never cached, so two
  steps on one tables dict each get their own graph;
- both tools: without the reference caches ``main`` raises
  FileNotFoundError; the build tool writes the shipped npz (to a
  temporary path).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climt_tpu as jct
from climt_tpu.components.rrtmg import lw_spectral as JL
from climt_tpu.components.rrtmg import lw_surrogate as JS
from climt_tpu_torch import data
from climt_tpu_torch.components.rrtmg import fused_mix
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import lw_surrogate as TS
from climt_tpu_torch.convert import lw_params_to_torch
from climt_tpu_torch.tools import build_lw_surrogate_ktables as build_tool
from climt_tpu_torch.tools import calibrate_lw_ktables as cal

from torch_helpers import (jax_taumol, port_taumol_groups, radiation_columns,
                           ragged_bands, ragged_group, rel_err,
                           reset_port_registries)

VALUE_TOL, GRAD_TOL, THETA_TOL = 1e-10, 1e-8, 1e-8
ADAM_STEPS, LR, DECAY_STEPS = 3, 2e-2, 4000
FAMILY = ('TestRRTMGLongwave', 'column')


@pytest.fixture(autouse=True)
def _registries():
    reset_port_registries()
    yield
    reset_port_registries()


def _numpy(inputs):
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in inputs.items()}


@pytest.fixture(scope='module')
def cases():
    """The port's training case (seeded targets: the calibrated tables'
    fluxes and heating rates times 1 + 5% N(0, 1)), anchors and prior on
    the CPU."""
    reset_port_registries()
    inputs, flags = cal.case_inputs(*FAMILY, device='cpu')
    rng = np.random.RandomState(11)
    tables = TS.build_tables(TS.load_calibrated_params())
    tgt = {k: v * (1.0 + 0.05 * rng.randn(*v.shape)) for k, v in
           cal.synthetic_targets(inputs, flags, tables).items()}
    return dict(train=[(inputs, flags, tgt)],
                trop=cal.tropical_inputs(device='cpu'),
                trop2x=cal.tropical_inputs(co2_scale=2.0, device='cpu'),
                prior=TS.default_params())


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_flux_vjp(theta, inputs, cot, flag_items):
    """JAX's LW fluxes on JAX's tables at theta, and the gradient in
    theta of their inner product with ``cot``: one compile serves every
    nz=30 call."""
    def lin(th):
        out = JL.rrtmg_lw_fluxes(tables=JS.build_tables(th),
                                 use_tables=False, **inputs,
                                 **dict(flag_items))
        return sum(jnp.sum(c * o) for c, o in zip(cot, out)), out

    (_, out), grad = jax.value_and_grad(lin, has_aux=True)(theta)
    return out, grad


def _jax_loss(fluxes, theta, train_cases, trop, prior):
    """tools/calibrate_lw_ktables.py:169-215 with each flux_fn call's
    result taken in order from ``fluxes``."""
    calls = iter(fluxes)

    def flux_fn(inputs, tables, flags):
        return next(calls)

    flux_names, hr_names = cal.FLUX_NAMES, cal.HR_NAMES
    tables = trop2x = flags0 = None     # the names the text passes
    total = 0.0
    # (1) cache flux/heating-rate match
    for inputs, flags, tgt in train_cases:
        up, dn, hr, upc, dnc, hrc = flux_fn(inputs, tables, flags)
        model = {
            'upwelling_longwave_flux_in_air': up[:, 0],
            'downwelling_longwave_flux_in_air': dn[:, 0],
            'upwelling_longwave_flux_in_air_assuming_clear_sky':
                upc[:, 0],
            'downwelling_longwave_flux_in_air_assuming_clear_sky':
                dnc[:, 0],
            'air_temperature': hr[:, 0],
            'air_temperature_tendency_from_longwave': hr[:, 0],
            'air_temperature_tendency_from_longwave_assuming_clear_sky':
                hrc[:, 0]}
        for name in flux_names:
            if name in tgt:
                t = jnp.asarray(tgt[name])
                total = total + jnp.mean(
                    ((model[name] - t) / jnp.maximum(jnp.abs(t), 5.0))
                    ** 2)
        for name in hr_names:
            if name in tgt:
                t = jnp.asarray(tgt[name])
                total = total + 0.5 * jnp.mean((model[name] - t) ** 2)
    # (2) physical H2O anchors (soft)
    upT, dnT, hrT, _, _, _ = flux_fn(trop, tables, flags0)
    olr, dlr = upT[-1, 0], dnT[0, 0]
    up2, _, _, _, _, _ = flux_fn(trop2x, tables, flags0)
    forcing = olr - up2[-1, 0]
    total = total + 2e-3 * ((olr - 288.5) ** 2 + (dlr - 392.0) ** 2
                            + 4.0 * (forcing - 2.8) ** 2)
    p_trop = trop['play'][:, 0]
    mask = p_trop > 100.0
    hr_t = hrT[:, 0]
    total = total + 1e-2 * jnp.sum(
        jnp.where(mask, jnp.maximum(-hr_t - 6.0, 0.0) ** 2
                  + jnp.maximum(hr_t - 2.0, 0.0) ** 2, 0.0))
    # (3) prior regularization
    total = total + 1e-4 * jnp.mean((theta - prior) ** 2)
    return total


def _jax_value_and_grad(theta, train_cases, trop, trop2x, prior):
    """The loss and d loss / d theta by the chain rule: the loss's
    gradient in the fluxes (and in theta, the prior's), then each LW
    call's vector-Jacobian product in theta."""
    calls = [(inputs, tuple(sorted(flags.items())))
             for inputs, flags, _ in train_cases]
    flags0 = tuple(sorted(cal.FLAGS0.items()))
    calls += [(trop, flags0), (trop2x, flags0)]

    def zeros(inputs):
        nz, ncol = inputs['play'].shape
        return tuple(jnp.zeros((n, ncol)) for n in (nz + 1, nz + 1, nz,
                                                     nz + 1, nz + 1, nz))

    fluxes = [_jax_flux_vjp(theta, inputs, zeros(inputs), flags)[0]
              for inputs, flags in calls]
    val, (d_fluxes, grad) = jax.value_and_grad(_jax_loss, argnums=(0, 1))(
        fluxes, theta, train_cases, trop, prior)
    for (inputs, flags), cot in zip(calls, d_fluxes):
        grad = grad + _jax_flux_vjp(theta, inputs, tuple(cot), flags)[1]
    return val, grad


@pytest.fixture(scope='module')
def jax_run(cases):
    """JAX's value and gradient at the prior, and theta after each of
    three Adam steps of the tool's hand-written optimizer."""
    def jx(inputs):
        return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in _numpy(inputs).items()}

    args = ([(jx(i), f, t) for i, f, t in cases['train']],
            jx(cases['trop']), jx(cases['trop2x']), cases['prior'])
    b1, b2, eps = 0.9, 0.999, 1e-8
    theta = jnp.asarray(cases['prior'])
    m = jnp.zeros_like(theta)
    v = jnp.zeros_like(theta)
    out = dict(values=[], grads=[], thetas=[])
    for i in range(ADAM_STEPS):
        val, grad = _jax_value_and_grad(theta, *args)
        out['values'].append(float(val))
        out['grads'].append(np.asarray(grad))
        i = jnp.asarray(float(i))
        lr = LR * (0.05 ** (i / DECAY_STEPS))
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        mhat = m / (1 - b1 ** (i + 1))
        vhat = v / (1 - b2 ** (i + 1))
        theta = theta - lr * mhat / (jnp.sqrt(vhat) + eps)
        out['thetas'].append(np.asarray(theta))
    return out


def _port_args(cases):
    return (cases['train'], cases['trop'], cases['trop2x'],
            torch.as_tensor(cases['prior']))


def _jax_lw_inputs(comp, state):
    raw, _ = comp._extract(state)
    return {k: np.asarray(v) if hasattr(v, 'shape') else v
            for k, v in comp._gather_inputs(raw).items()}


@pytest.mark.parametrize('family,desc', cal.TRAIN)
def test_case_inputs_match_jax(family, desc):
    """The JAX tool's pipeline_case inputs (its one-column cut of the
    family's default state) against the port's case_inputs."""
    comp = jct.RRTMGLongwave(**cal.FAMILIES[family]['kwargs'])
    nz = 30 if desc == 'column' else 28
    grid = (jct.get_grid(nx=None, ny=None, nz=nz) if desc == 'column'
            else jct.get_grid(nx=32, ny=16, nz=nz))
    ref = _jax_lw_inputs(comp, jct.get_default_state([comp],
                                                     grid_state=grid))
    got, flags = cal.case_inputs(family, desc, device='cpu')
    assert flags == dict(inflag=comp._cloud_optics, iceflag=comp._ice_props,
                         liqflag=comp._liquid_props)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if not isinstance(v, np.ndarray):
            assert got[k] == v
            continue
        one = v[:, :1] if v.ndim == 3 else v[..., :1]
        assert tuple(got[k].shape) == one.shape, k
        assert rel_err(got[k], one) <= 1e-14, k


@pytest.mark.parametrize('co2_scale', [1.0, 2.0])
def test_tropical_inputs_match_jax(co2_scale):
    """The JAX tool's tropical_inputs, written out with JAX's component,
    against the port's."""
    comp = jct.RRTMGLongwave()
    state = jct.get_default_state(
        [comp], grid_state=jct.get_grid(nx=None, ny=None, nz=30))
    p = np.asarray(state['air_pressure'].values).ravel()
    state['air_temperature'].values[:] = np.maximum(
        300.0 * (p / p[0]) ** (2.0 / 7.0 * 0.8), 200.0).reshape(
            state['air_temperature'].shape)
    state['specific_humidity'].values[:] = (0.017 * (p / p[0]) ** 3).reshape(
        state['specific_humidity'].shape)
    state['surface_temperature'].values[:] = 300.0
    state['mole_fraction_of_carbon_dioxide_in_air'].values[:] *= co2_scale
    ref = _jax_lw_inputs(comp, state)
    got = cal.tropical_inputs(co2_scale=co2_scale, device='cpu')
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert rel_err(got[k], v) <= 1e-14, k
        else:
            assert got[k] == v


def test_loss_and_gradient_match_jax(cases, jax_run):
    theta, _ = lw_params_to_torch(cases['prior'])
    val, grad = cal.value_and_grad(theta, *_port_args(cases))
    ref = jax_run['values'][0]
    assert abs(float(val) - ref) <= VALUE_TOL * abs(ref)
    assert int((grad != 0).sum()) > 700
    assert rel_err(grad, jax_run['grads'][0]) <= GRAD_TOL


def test_three_adam_steps_match_jax(cases, jax_run):
    theta, _ = lw_params_to_torch(cases['prior'])
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    for i in range(ADAM_STEPS):
        val, grad = cal.value_and_grad(theta, *_port_args(cases))
        assert abs(float(val) - jax_run['values'][i]) <= (
            VALUE_TOL * abs(jax_run['values'][i]))
        theta, m, v = cal.adam_step(i, theta, m, v, grad, LR, DECAY_STEPS)
        assert float(np.abs(theta.numpy() - jax_run['thetas'][i]).max()) \
            <= THETA_TOL
    assert jax_run['values'][-1] < jax_run['values'][0]


def test_taumol_gradient_in_the_tables_matches_jax():
    """d/dtables of <c1, taug> + <c2, fracs> at nz 9, 3 columns: the
    port's tables dict as leaf tensors (convert.lw_params_to_torch),
    packed by kernel B's layout, against jax.grad over JAX's dict."""
    c = radiation_columns(nz=9, ncol=3)
    theta = TS.load_calibrated_params()
    tables_np = data.load_npz(data.LW_KDIST)    # JAX's build_tables(theta)
    rng = np.random.RandomState(5)
    coef = [rng.randn(9, 3, 140) for _ in range(2)]

    def jax_scalar(tables):
        out = jax_taumol(c, tables=tables, sw=False)
        return (jnp.sum(coef[0] * out['lw_taug'])
                + jnp.sum(coef[1] * out['lw_fracs']))

    ref = jax.jit(jax.grad(jax_scalar))({k: jnp.asarray(v)
                                for k, v in tables_np.items()})
    _, tables = lw_params_to_torch(theta, tables_np, requires_grad=True)
    groups = port_taumol_groups(c, torch.float64, tables=tables)
    scalar = sum(torch.sum(torch.as_tensor(cf) * groups[name].run())
                 for cf, name in zip(coef, ('lw_taug', 'lw_fracs')))
    grads = torch.autograd.grad(scalar, list(tables.values()))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    worst = max(float(np.abs(g.numpy() - np.asarray(ref[k])).max())
                for k, g in zip(tables, grads))
    assert scale > 0 and worst <= 1e-12 * scale


@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_plain_backward_matches_autograd_of_the_plain_forward(dtype, tol):
    layout, idx, w = ragged_group(ragged_bands(), dtype)
    table = layout.table.detach().clone().requires_grad_(True)
    layout.table = table
    out = fused_mix.mix_groups_plain(layout, idx, w)
    gout = torch.as_tensor(np.random.RandomState(1).randn(*out.shape),
                           dtype=dtype)
    ref, = torch.autograd.grad(out, table, gout)
    got = fused_mix.mix_groups_bwd_plain(layout, idx, w, gout)
    assert got.dtype == dtype and got.shape == table.shape
    assert rel_err(got, ref) <= tol
    # the padding columns of the packed rows get nothing
    for ng, ngp, _, _, _, tab0, tablen in layout.bands:
        pad = got[tab0:tab0 + tablen].view(-1, ngp)[:, ng:]
        assert not bool(pad.any())


def test_tables_that_require_grad_are_packed_per_call(cases):
    """Two losses on one tables dict: each backward has its own graph and
    the same gradient; no cached layout holds a graph, and the surrogate's
    numpy tables are still cached afterwards."""
    fused_mix.Group._LAYOUTS.clear()
    theta, _ = lw_params_to_torch(TS.load_calibrated_params(),
                                  requires_grad=True)
    tables = TS.build_tables(theta)
    inputs, flags, _ = cases['train'][0]
    grads = []
    for _ in range(2):
        olr = cal.flux_fn(inputs, tables, flags)[0][-1, 0]
        grads.append(torch.autograd.grad(olr, theta, retain_graph=True)[0])
        assert not any(layout.table.requires_grad
                       for layout in fused_mix.Group._LAYOUTS.values())
    assert torch.equal(grads[0], grads[1])
    assert int((grads[0] != 0).sum()) > 100
    cal.flux_fn(inputs, None, flags)
    sources = [layout.source for layout in fused_mix.Group._LAYOUTS.values()]
    assert TL.load_kdist() in sources


def test_calibration_reads_the_caches_where_golden_says():
    """The tool reads the reference caches from tests/golden.py's
    CACHE_DIR, as the JAX package's tool and tests do."""
    import golden
    assert cal.CACHE_DIR == golden.CACHE_DIR


def test_calibration_without_the_caches_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cal, 'CACHE_DIR', str(tmp_path))
    with pytest.raises(FileNotFoundError, match='TestRRTMGLongwave-column'):
        cal.main(['--steps', '1'], device='cpu')


def test_build_tool_writes_the_shipped_npz(tmp_path, monkeypatch, capsys):
    out = tmp_path / 'surrogate.npz'
    monkeypatch.setattr(build_tool, 'OUT', str(out))
    build_tool.main(device='cpu')
    assert '114 arrays' in capsys.readouterr().out
    written = data.load_npz(str(out))
    shipped = data.load_npz(data.LW_KDIST)
    assert list(written) == list(shipped)
    for name, table in shipped.items():
        assert written[name].dtype == np.float64
        assert rel_err(written[name], table) <= 1e-14, name
