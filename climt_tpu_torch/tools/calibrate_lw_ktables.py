"""Calibrate the surrogate RRTMG-LW k-tables on the port
(tools/calibrate_lw_ktables.py).

The surrogate tables (``components/rrtmg/lw_surrogate.py``) are fitted
end to end through the LW pipeline with autograd: each step builds the
tables from theta, runs ``rrtmg_lw_fluxes(tables=..., use_tables=False)``
on the training cases and the tropical anchors, and takes an Adam step on
the gradient of ``loss_fn`` with respect to theta.  On the card the
float64 pipeline reads the tables through kernel B, whose backward kernel
(``csrc/mix_rows_bwd.cu``) carries the gradient back to them.

TRAINING targets
  1. The reference CliMT's regression caches (clear sky) of
     TestRRTMGLongwave and
     TestRRTMGLongwaveWithExternalInterfaceTemperature, column and 3d: flux
     profiles in W/m^2 and heating rates in K/day.
  2. Physical integral anchors for the H2O parameters on a tropical
     profile (Ts=300 K, 40 mm precipitable water): clear-sky OLR ~ 288.5
     W/m^2, surface downwelling ~ 392 W/m^2, CO2-doubling forcing ~ 2.8
     W/m^2, and tropospheric cooling within -6..2 K/day.
  3. An L2 pull toward the physical priors.

HELD-OUT validation (reported, never trained on): the WithClouds families.

Writes the parameter file and the npz that the JAX package and the port
share (``climt_tpu/data/rrtmg_lw_surrogate_params.json``,
``rrtmg_lw_kdist_surrogate.npz``), then prints the per-family
max-error table.  The caches are read from where the repo's test helper
``tests/golden.py`` says they are (its ``CACHE_DIR``); without them
``main`` raises FileNotFoundError.

Run:  python -m climt_tpu_torch.tools.calibrate_lw_ktables [--steps N]
      [--lr LR] [--resume]
(on the CUDA card; ``main(argv, device='cpu')`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import ast
import glob
import os

import numpy as np
import torch
from scipy.io import netcdf_file

from .. import data
from ..components.rrtmg import lw_surrogate
from ..components.rrtmg.longwave import RRTMGLongwave
from ..components.rrtmg.lw_spectral import rrtmg_lw_fluxes
from ..core.grid import get_grid
from ..core.initialization import get_default_state
from ..core.util import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _golden_cache_dir():
    """``CACHE_DIR`` of the repo's test helper ``tests/golden.py``, read
    without importing it: the one place that says where the reference
    CliMT's regression caches are, for the JAX tests and tools and for
    this tool.  None when the checkout has no ``tests/golden.py``."""
    path = os.path.join(ROOT, 'tests', 'golden.py')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, 'id', None) == 'CACHE_DIR' for t in node.targets):
            return ast.literal_eval(node.value)
    return None


# the reference CliMT's regression caches (NetCDF classic files written
# by its test harness)
CACHE_DIR = _golden_cache_dir()
NPZ_OUT = os.path.join(data.DATA_DIR, data.LW_KDIST)

FAMILIES = {
    'TestRRTMGLongwave': dict(kwargs={}),
    'TestRRTMGLongwaveWithClouds': dict(
        kwargs=dict(cloud_optical_properties='single_cloud_type')),
    'TestRRTMGLongwaveWithExternalInterfaceTemperature': dict(
        kwargs=dict(calculate_interface_temperature=False)),
}
TRAIN = [('TestRRTMGLongwave', 'column'), ('TestRRTMGLongwave', '3d'),
         ('TestRRTMGLongwaveWithExternalInterfaceTemperature', 'column'),
         ('TestRRTMGLongwaveWithExternalInterfaceTemperature', '3d')]
HELDOUT = [('TestRRTMGLongwaveWithClouds', 'column'),
           ('TestRRTMGLongwaveWithClouds', '3d')]
# the tropical anchors' component flags
FLAGS0 = dict(inflag=2, iceflag=1, liqflag=1)
FLUX_NAMES = [
    'upwelling_longwave_flux_in_air',
    'downwelling_longwave_flux_in_air',
    'upwelling_longwave_flux_in_air_assuming_clear_sky',
    'downwelling_longwave_flux_in_air_assuming_clear_sky']
HR_NAMES = ['air_temperature',
            'air_temperature_tendency_from_longwave',
            'air_temperature_tendency_from_longwave_assuming_clear_sky']
# Adam (the JAX tool's hand-written one, with exponential lr decay)
B1, B2, EPS = 0.9, 0.999, 1e-8


# ---- the cache reader (tests/golden.py's load_cache and
# load_cached_outputs) ----------------------------------------------------

def load_cache(filename):
    """One cache file -> {name: (array, units, dims)}."""
    f = netcdf_file(filename, 'r', mmap=False)
    out = {}
    for name, var in f.variables.items():
        units = getattr(var, 'units', b'')
        if isinstance(units, bytes):
            units = units.decode()
        out[name] = (np.array(var.data), units, var.dimensions)
    f.close()
    return out


def load_cached_outputs(test_name, descriptor):
    """The ordered list of cached output dicts of a reference test;
    FileNotFoundError when there is none."""
    if CACHE_DIR is None:
        raise FileNotFoundError('tests/golden.py: no CACHE_DIR')
    pattern = os.path.join(CACHE_DIR,
                           '{}-{}-*.cache'.format(test_name, descriptor))
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(pattern)
    return [load_cache(f) for f in files]


# ---- cases -----------------------------------------------------------------

def case_inputs(family, descriptor, device='cuda'):
    """(pipeline inputs with 1 column, component flags) of a cache
    family's default state: nz 30 for 'column', 28 for '3d' (32x16), whose
    states are horizontally uniform."""
    comp = RRTMGLongwave(device=device, **FAMILIES[family]['kwargs'])
    nz = 30 if 'column' in descriptor else 28
    if 'column' in descriptor:
        grid = get_grid(nx=None, ny=None, nz=nz)
    else:
        grid = get_grid(nx=32, ny=16, nz=nz)
    state = get_default_state([comp], grid_state=grid)
    raw, _ = comp._extract(state)
    inputs = comp._gather_inputs(raw)
    one = {}
    for k, v in inputs.items():
        if torch.is_tensor(v) and v.dim() >= 2:
            one[k] = v[..., :1] if v.dim() == 2 else v[:, :1]
        elif torch.is_tensor(v) and v.dim() == 1:
            one[k] = v[:1]
        else:
            one[k] = v
    flags = dict(inflag=comp._cloud_optics, iceflag=comp._ice_props,
                 liqflag=comp._liquid_props)
    return one, flags


def pipeline_case(family, descriptor, device='cuda'):
    """(inputs dict with 1 column, component flags, cached outputs)."""
    cached = load_cached_outputs(family, descriptor)
    one, flags = case_inputs(family, descriptor, device)
    return one, flags, cached


def cache_targets(cached):
    """Stack cached outputs -> dict of 1-column numpy arrays."""
    tgt = {}
    for d in cached:
        for name, (vals, units, dims) in d.items():
            if name == 'time':
                continue
            arr = np.asarray(vals, np.float64)
            tgt[name] = arr.reshape(arr.shape[0], -1)[:, 0]
    return tgt


def tropical_inputs(nz=30, q_scale=1.0, co2_scale=1.0, device='cuda'):
    """Pipeline inputs of the tropical anchor profile (one column)."""
    comp = RRTMGLongwave(device=device)
    state = get_default_state(
        [comp], grid_state=get_grid(nx=None, ny=None, nz=nz))
    p = np.asarray(state['air_pressure'].values).ravel()
    Ts = 300.0
    state['air_temperature'].values[:] = np.maximum(
        Ts * (p / p[0]) ** (2.0 / 7.0 * 0.8), 200.0).reshape(
            state['air_temperature'].shape)
    state['specific_humidity'].values[:] = (
        q_scale * 0.017 * (p / p[0]) ** 3).reshape(
            state['specific_humidity'].shape)
    state['surface_temperature'].values[:] = Ts
    state['mole_fraction_of_carbon_dioxide_in_air'].values[:] *= co2_scale
    raw, _ = comp._extract(state)
    return comp._gather_inputs(raw)


def flux_fn(inputs, tables, flags):
    return rrtmg_lw_fluxes(tables=tables, use_tables=False,
                           **inputs, **flags)


def model_fields(fluxes):
    """{cache name: (nz[+1],) column} of one ``flux_fn`` result."""
    up, dn, hr, upc, dnc, hrc = fluxes[:6]
    return {
        'upwelling_longwave_flux_in_air': up[:, 0],
        'downwelling_longwave_flux_in_air': dn[:, 0],
        'upwelling_longwave_flux_in_air_assuming_clear_sky': upc[:, 0],
        'downwelling_longwave_flux_in_air_assuming_clear_sky': dnc[:, 0],
        'air_temperature': hr[:, 0],
        'air_temperature_tendency_from_longwave': hr[:, 0],
        'air_temperature_tendency_from_longwave_assuming_clear_sky':
            hrc[:, 0]}


def synthetic_targets(inputs, flags, tables):
    """Targets in ``cache_targets``' form from the port's own fluxes on
    ``tables``: a training case where no cache is available."""
    with torch.no_grad():
        model = model_fields(flux_fn(inputs, tables, flags))
    return {name: model[name].cpu().numpy() for name in FLUX_NAMES + HR_NAMES}


# ---- the loss and the optimizer ---------------------------------------------

def loss_fn(theta, train_cases, trop, trop2x, prior):
    """The calibration loss of tools/calibrate_lw_ktables.py:169-215 at
    theta (a tensor): the cache flux and heating-rate misfit of each
    (inputs, flags, targets) training case, the tropical anchors ``trop``
    and ``trop2x`` (doubled CO2), and the pull toward ``prior``."""
    tables = lw_surrogate.build_tables(theta)

    def target(values):
        return torch.as_tensor(values, dtype=theta.dtype, device=theta.device)

    total = 0.0
    # (1) cache flux/heating-rate match
    for inputs, flags, tgt in train_cases:
        model = model_fields(flux_fn(inputs, tables, flags))
        for name in FLUX_NAMES:
            if name in tgt:
                t = target(tgt[name])
                total = total + torch.mean(
                    ((model[name] - t) / torch.clamp(t.abs(), min=5.0)) ** 2)
        for name in HR_NAMES:
            if name in tgt:
                t = target(tgt[name])
                total = total + 0.5 * torch.mean((model[name] - t) ** 2)
    # (2) physical H2O anchors (soft)
    upT, dnT, hrT = flux_fn(trop, tables, FLAGS0)[:3]
    olr, dlr = upT[-1, 0], dnT[0, 0]
    up2 = flux_fn(trop2x, tables, FLAGS0)[0]
    forcing = olr - up2[-1, 0]
    total = total + 2e-3 * ((olr - 288.5) ** 2 + (dlr - 392.0) ** 2
                            + 4.0 * (forcing - 2.8) ** 2)
    # tropospheric cooling on the tropical profile stays physical
    mask = trop['play'][:, 0] > 100.0
    hr_t = hrT[:, 0]
    total = total + 1e-2 * torch.sum(torch.where(
        mask, torch.clamp(-hr_t - 6.0, min=0.0) ** 2
        + torch.clamp(hr_t - 2.0, min=0.0) ** 2, 0.0))
    # (3) prior regularization
    return total + 1e-4 * torch.mean((theta - prior) ** 2)


def value_and_grad(theta, train_cases, trop, trop2x, prior):
    """(loss, d loss / d theta) at theta, both detached."""
    theta = theta.detach().requires_grad_(True)
    val = loss_fn(theta, train_cases, trop, trop2x, prior)
    grad, = torch.autograd.grad(val, theta)
    return val.detach(), grad


def adam_step(i, theta, m, v, grad, lr, steps):
    """Step i (from 0) of Adam with the learning rate decayed to 5% over
    ``steps``: (theta, m, v)."""
    rate = lr * (0.05 ** (i / steps))
    m = B1 * m + (1 - B1) * grad
    v = B2 * v + (1 - B2) * grad * grad
    mhat = m / (1 - B1 ** (i + 1))
    vhat = v / (1 - B2 ** (i + 1))
    return theta - rate * mhat / (torch.sqrt(vhat) + EPS), m, v


# ---- the tool --------------------------------------------------------------

def _max_errors(tables, inputs, flags, tgt):
    with torch.no_grad():
        model = model_fields(flux_fn(inputs, tables, flags))

    def err(names):
        return max(float(torch.max(torch.abs(
            model[n] - torch.as_tensor(tgt[n], device=model[n].device))))
            for n in names if n in tgt)

    return err(FLUX_NAMES), err(HR_NAMES)


def main(argv=None, device='cuda'):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=4000)
    ap.add_argument('--lr', type=float, default=2e-2)
    ap.add_argument('--resume', action='store_true',
                    help='start from the saved calibrated params')
    args = ap.parse_args(argv)

    caches = [load_cached_outputs(family, desc) for family, desc in TRAIN]
    device = resolve_device(device)
    train_cases = []
    for (family, desc), cached in zip(TRAIN, caches):
        inputs, flags = case_inputs(family, desc, device)
        train_cases.append((inputs, flags, cache_targets(cached)))
    trop = tropical_inputs(device=device)
    trop2x = tropical_inputs(co2_scale=2.0, device=device)

    theta0 = (lw_surrogate.load_calibrated_params() if args.resume
              else lw_surrogate.default_params())
    prior = torch.as_tensor(lw_surrogate.default_params(), device=device)
    theta = torch.as_tensor(theta0, device=device)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    for i in range(args.steps):
        val, grad = value_and_grad(theta, train_cases, trop, trop2x, prior)
        theta, m, v = adam_step(i, theta, m, v, grad, args.lr, args.steps)
        if i % 200 == 0 or i == args.steps - 1:
            print('step %5d  loss %.6g' % (i, float(val)))

    lw_surrogate.save_params(theta, meta={'steps': args.steps,
                                          'loss': float(val)})
    with torch.no_grad():
        tables = lw_surrogate.build_tables(theta)
    np.savez_compressed(NPZ_OUT, **{k: v.cpu().numpy().astype(np.float64)
                                    for k, v in tables.items()})
    print('saved params + npz')

    # ---- residual report: train + held-out families ----
    print('\n%-64s %10s %10s' % ('family', 'max|dF|Wm2', 'max|dHR|K/d'))
    for family, desc in TRAIN + HELDOUT:
        try:
            inputs, flags, cached = pipeline_case(family, desc, device)
        except FileNotFoundError:
            continue
        df, dh = _max_errors(tables, inputs, flags, cache_targets(cached))
        print('%-64s %10.3f %10.3f' % ('%s-%s' % (family, desc), df, dh))

    with torch.no_grad():
        upT, dnT = flux_fn(trop, tables, FLAGS0)[:2]
        up2 = flux_fn(trop2x, tables, FLAGS0)[0]
    print('\ntropical anchors: OLR %.2f (target 288.5)  DLR %.2f '
          '(target 392.0)  2xCO2 forcing %.2f (target 2.8)'
          % (float(upT[-1, 0]), float(dnT[0, 0]),
             float(upT[-1, 0] - up2[-1, 0])))


if __name__ == '__main__':
    main()
