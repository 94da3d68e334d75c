"""One card calling RRTMG LW and SW on whole global fields of columns, as
offline radiation (radiative-kernel studies, reanalysis diagnostics)
does: the calls and arguments of ``MoistGCM.radiation``, clear sky,
analytic transmittance, without the GCM around them.

The traffic file gives the layers, the columns of a call and the number
of distinct slices, and the ranges the columns are drawn from; the
columns are made on the card from the seed (``columns``).  Set-up makes
the slices and warms one LW and one SW call.  The window calls LW and
SW on slice after slice, back to back, and ends at the first completed
pair after ``--seconds``.  A traced run times each LW and each SW call
with a synchronize around it, then profiles one more pair.

The check: the seed picks ``check_calls`` of the window's first
``check_first`` pairs (fewer than the slowest measured window ran);
their fluxes and heating rates are kept, and after the window the plain
reference computes the same slices in blocks of columns.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from gcmbench import compare, harness, tracing
from gcmbench.costs import rrtmg as rrtmg_cost
from gcmbench.reference import data as ref_data
from gcmbench.reference import gcm as ref_gcm
from gcmbench.reference import matmul_precision
from gcmbench.reference.grid import hybrid_sigma_pressure_coefficients
from gcmbench.reference.sw import solar_variability

DTYPES = {'float32': torch.float32, 'float64': torch.float64}
OUTPUTS = ('lw_up', 'lw_dn', 'lw_hr', 'sw_up', 'sw_dn', 'sw_hr')
RD, G = 287.0, 9.80665


def _uniform(gen, lo_hi, n, device, dtype):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                       dtype=dtype)


def columns(traffic, nz, ncol, gen, device, dtype):
    """One slice of ``ncol`` columns of ``nz`` layers drawn from ``gen``:
    the radiation inputs (play, plev, T, tlev, Ts, h2o, o3, co2, o2, mu0,
    day, emis) of ``ref_gcm.radiation_inputs``, bottom-up, hPa.

    Surface pressure, surface temperature, the tropospheric lapse rate,
    the tropopause temperature and the relative humidity are uniform
    over the traffic's ranges per column; the temperature falls with the
    lapse rate to the tropopause temperature and rises by
    ``strat_warming`` K from 100 hPa to the model top; water vapour is
    the relative humidity times Bolton's saturation below the
    tropopause, ``strat_h2o`` above it; ozone is the climatological
    profile; the sun stands at a uniform latitude (by area) and hour
    angle of an equinox, so about half the columns are in the night."""
    kw = dict(device=device, dtype=torch.float64)
    ak, bk = hybrid_sigma_pressure_coefficients(
        nz + 1, 1e5, traffic['model_top_pa'])
    ak = torch.as_tensor(ak, **kw)[:, None]
    bk = torch.as_tensor(bk, **kw)[:, None]
    ps = _uniform(gen, traffic['ps_pa'], ncol, **kw)
    p_half = ak + bk * (ps - traffic['model_top_pa'])[None]
    p_mid = 0.5 * (p_half[1:] + p_half[:-1])
    ts = _uniform(gen, traffic['ts_k'], ncol, **kw)
    lapse = _uniform(gen, traffic['lapse_k_per_km'], ncol, **kw) * 1e-3
    ttrop = _uniform(gen, traffic['tropopause_k'], ncol, **kw)
    rh = _uniform(gen, traffic['relative_humidity'], ncol, **kw)
    t_trop = ts * (p_mid / ps) ** (RD * lapse / G)
    strat = torch.clamp(torch.log(1e4 / p_mid) / math.log(
        1e4 / traffic['model_top_pa']), min=0.0)
    T = torch.maximum(t_trop, ttrop) + traffic['strat_warming_k'] * strat
    es = 611.2 * torch.exp(17.67 * (T - 273.15) / (T - 29.65))
    qsat = 0.622 * es / torch.clamp(p_mid - 0.378 * es, min=1.0)
    troposphere = (t_trop > ttrop) & (p_mid > 1e4)
    q = torch.where(troposphere, torch.clamp(rh * qsat, max=0.025),
                    traffic['strat_h2o'])
    lat = torch.asin(_uniform(gen, (-1.0, 1.0), ncol, **kw))
    hour = _uniform(gen, (0.0, 2.0 * math.pi), ncol, **kw)
    o3_logp = torch.as_tensor(
        np.log(1e5 * np.linspace(0.998, 0.001, 30)[::-1]).copy(), **kw)
    o3_vals = torch.as_tensor(
        ref_data.load_numpy(ref_data.OZONE)[::-1].copy(), **kw)
    T, q, p_mid, p_half, ts = (x.to(dtype) for x in (T, q, p_mid, p_half,
                                                     ts))
    return ref_gcm.radiation_inputs(
        T, q, p_mid, p_half, ts, torch.zeros((), dtype=dtype,
                                             device=device),
        torch.cos(lat).to(dtype), hour.to(dtype), o3_logp.to(dtype),
        o3_vals.to(dtype))


def slices(ctx):
    """The traffic's distinct slices of columns, made on the card."""
    t, dtype = ctx.traffic, DTYPES[ctx.config['dtype']]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % (2 ** 63))
    return [columns(t, ctx.config['layers'], ctx.config['columns'], gen,
                    ctx.device, dtype) for _ in range(t['slices'])]


def program_lw(play, plev, T, tlev, Ts, h2o, o3, co2, o2, mu0, day, emis):
    """The program's LW call with ``MoistGCM._radiation_chunk``'s
    arguments: (up, down, heating rate)."""
    from climt_tpu_torch.components.rrtmg.lw_spectral import \
        rrtmg_lw_fluxes
    nz, nc = play.shape
    zero = torch.zeros_like(play)
    z16 = torch.zeros((nz, nc, 16), dtype=play.dtype, device=play.device)
    lw = rrtmg_lw_fluxes(
        play, plev, T, tlev, Ts, h2o, o3, co2, zero, zero, o2, zero,
        zero, zero, zero, emis, zero, z16, zero, zero,
        torch.full_like(play, 25.0), torch.full_like(play, 10.0), z16,
        ref_gcm.G, ref_gcm.AVOGADRO, ref_gcm.CPD, use_tables=False)
    return lw[0], lw[1], lw[2]


def program_sw(play, plev, T, tlev, Ts, h2o, o3, co2, o2, mu0, day, emis):
    """The program's SW call with ``MoistGCM._radiation_chunk``'s
    arguments, night columns zeroed: (up, down, heating rate)."""
    from climt_tpu_torch.components.rrtmg import sw_spectral
    nz, nc = play.shape
    dtype, dev = play.dtype, play.device
    zero = torch.zeros_like(play)
    alb = torch.full((nc,), ref_gcm.ALBEDO, dtype=dtype, device=dev)
    nocloud = (torch.zeros((nz, nc, 14), dtype=dtype, device=dev),) * 4
    noaer = (torch.zeros((nz, nc, 14), dtype=dtype, device=dev),) * 3
    up, dn, _, _, hr, _ = sw_spectral.rrtmg_sw_fluxes(
        play, plev, T, h2o, o3, co2, zero, zero, o2, alb, alb, alb, alb,
        mu0, zero, nocloud, noaer, ref_gcm.SOLAR_CONSTANT / 1368.22, -1,
        0.0, -1, sw_spectral.solar_variability(-1, 0.0), ref_gcm.G,
        ref_gcm.AVOGADRO, ref_gcm.CPD, icld=0,
        use_tables=False)
    return tuple(torch.where(day[None, :], x, 0.0) for x in (up, dn, hr))


SOLAR = solar_variability(-1, 0.0)


def reference_pair(inputs, block):
    """The plain reference's six outputs of one slice, ``block`` columns
    at a time."""
    play, plev, T, tlev, Ts, h2o, o3, co2, o2, mu0, day, emis = inputs
    parts = []
    for c0 in range(0, play.shape[1], block):
        c = slice(c0, c0 + block)
        lw = ref_gcm.lw_call(play[:, c], plev[:, c], T[:, c], tlev[:, c],
                             Ts[c], h2o[:, c], o3[:, c], co2[:, c],
                             o2[:, c], emis[:, c])
        sw = ref_gcm.sw_call(play[:, c], plev[:, c], T[:, c], h2o[:, c],
                             o3[:, c], co2[:, c], o2[:, c], mu0[c],
                             ref_gcm.SOLAR_CONSTANT / 1368.22, SOLAR)
        d = day[c][None, :]
        parts.append((lw[0], lw[1], lw[2]) + tuple(
            torch.where(d, sw[i], 0.0) for i in (0, 1, 4)))
    return {k: torch.cat([p[i] for p in parts], dim=-1)
            for i, k in enumerate(OUTPUTS)}


def pair(inputs):
    """The program's LW and SW call on one slice: {output: tensor}."""
    with tracing.span('lw_call'):
        lw = program_lw(*inputs)
    with tracing.span('sw_call'):
        sw = program_sw(*inputs)
    return dict(zip(OUTPUTS, lw + sw))


def picks(seed, first, n):
    """The window's pairs whose outputs are compared, drawn from the
    seed among its first ``first``."""
    rng = np.random.default_rng(int(seed))
    return sorted(int(i) for i in rng.choice(first, size=n, replace=False))


def window(data, seconds, chosen, device, trace):
    rec = dict(calls=0, lw_s=[], sw_s=[])
    kept = {}
    t0 = time.perf_counter()
    while True:
        i = rec['calls']
        inputs = data[i % len(data)]
        if trace:
            harness.sync(device)
            ta = time.perf_counter()
            with tracing.span('lw_call'):
                lw = program_lw(*inputs)
            harness.sync(device)
            tb = time.perf_counter()
            with tracing.span('sw_call'):
                sw = program_sw(*inputs)
            harness.sync(device)
            rec['lw_s'].append(tb - ta)
            rec['sw_s'].append(time.perf_counter() - tb)
            out = dict(zip(OUTPUTS, lw + sw))
        else:
            out = pair(inputs)
        if i in chosen:
            kept[i] = {k: v.clone() for k, v in out.items()}
        rec['calls'] += 1
        if time.perf_counter() - t0 >= seconds and rec['calls'] > chosen[-1]:
            break
    harness.sync(device)
    rec['window_s'] = time.perf_counter() - t0
    return rec, kept


# the outputs each compared number covers: float32 RRTMG-SW moves its
# upward flux and heating rate, and its downward flux at single points,
# by as much as a bfloat16 gas optics does, from roundoff alone, so those
# are left out where they would hide the control (PERF.md)
L2_FIELDS = ('lw_up', 'lw_dn', 'lw_hr', 'sw_dn')
MAX_FIELDS = ('lw_up', 'lw_dn', 'lw_hr')


def pair_gaps(mine, ref):
    """{number: value} of one pair's outputs against the reference's."""
    def pick(out, keys):
        return {k: out[k] for k in keys}
    return {'fluxes.l2': compare.gaps(pick(mine, L2_FIELDS),
                                      pick(ref, L2_FIELDS))[0],
            'lw.max': compare.gaps(pick(mine, MAX_FIELDS),
                                   pick(ref, MAX_FIELDS))[1]}


def readings(data, kept, block):
    """{number: value} of the kept outputs against the reference, the
    worst over every kept pair."""
    found = [pair_gaps(out, reference_pair(data[i % len(data)], block))
             for i, out in kept.items()]
    return {k: max(f[k] for f in found) for k in found[0]}


def run(ctx):
    nz, ncol = ctx.config['layers'], ctx.config['columns']
    # the program's modules load here, a phase of set-up of their own
    import climt_tpu_torch.components.rrtmg.lw_spectral  # noqa: F401
    import climt_tpu_torch.components.rrtmg.sw_spectral  # noqa: F401
    ctx.mark('port import')
    harness.open_card(ctx.device)
    ctx.mark('card')
    if torch.device(ctx.device).type == 'cuda':
        from climt_tpu_torch import _build
        _build.library()
    ctx.mark('kernels')
    data = slices(ctx)
    harness.sync(ctx.device)
    ctx.mark('columns')
    pair(data[0])
    harness.sync(ctx.device)
    ctx.mark('warm-up')
    setup_s = time.perf_counter() - ctx.t_start

    chosen = picks(ctx.seed, ctx.traffic['check_first'],
                   ctx.traffic['check_calls'])
    rec, kept = window(data, ctx.seconds, chosen, ctx.device, ctx.trace)
    breakdown = None
    if ctx.trace:
        _, trace = tracing.profiled(lambda: pair(data[0]), ctx.device)
        rec['trace'] = trace
        rec['trace_calls'] = 1
        breakdown = {'device_ops': trace.top_device_ops(),
                     'idle_gaps': trace.longest_gaps()}
    dev = harness.device_entry(ctx.device)
    if ctx.trace:
        dev.update(busy_s=rec['trace'].busy_s(),
                   window_s=rec['trace'].window_s)
    rec['window_flops'] = rec['calls'] * rrtmg_cost.call_flops(nz, ncol)
    rec['kernel_b_bytes'] = rrtmg_cost.kernel_b_bytes(nz, ncol)
    rec['kernel_a_bytes'] = rrtmg_cost.kernel_a_bytes(nz, ncol)
    rec['kernel_a_flops'] = rrtmg_cost.kernel_a_flops(nz, ncol)
    e2e = {ctx.cell['throughput']: rec['calls'] * ncol / rec['window_s'],
           'setup_s': setup_s}

    gc.collect()
    if torch.device(ctx.device).type == 'cuda':
        torch.cuda.empty_cache()
    with matmul_precision('float32'):
        found = readings(data, kept, ctx.cell['reference_block'])
    checks = [(k, v, ctx.cell['limits'][k]) for k, v in found.items()]
    return harness.Result(
        e2e=e2e, record=rec, checks=checks, attempted=rec['calls'],
        failed=0 if harness.correct_of(checks) else len(kept),
        device=dev, breakdown=breakdown)
